// Gradient / hessian / count histograms for tree boosting on Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
// gpboost_tpu/ops/kernels/histogram.py::histogram_pallas (body _hist_kernel).
//
// Computes, for the rows i with mask[i] != 0,
//   hist_g[f, b] = sum of grad[i], hist_h[f, b] = sum of hess[i],
//   hist_c[f, b] = number of rows            over the rows with bins[f, i] = b
// for every feature f < F and bin b < B (B <= 256).
//
// The TPU kernel contracts a one-hot matrix with the value panel on the
// matrix unit because the TPU has no scatter. A GPU scatters natively, so
// the form here is the one of the reference's own GPU learner
// (treelearner/ocl/histogram256.cl): a block keeps a private histogram of
// its feature tile in shared memory (HIST_F_TILE features x 256 bins x
// (g, h, count) = 24 KB), walks chunks of HIST_ROWS rows in a grid-stride
// loop, reads the mask first and, for rows inside it, grad, hess and one
// byte per feature from the features-major uint8 panel (neighbouring
// threads read neighbouring rows: coalesced), accumulates with shared-memory
// atomics and finally adds its non-empty bins into the zeroed result with
// global atomics. Counts are accumulated as unsigned integers, in shared
// and in global memory, so they are exact and independent of the order; a
// second small kernel converts them to float32 in place. The float sums are
// order-dependent in their last bits (float atomics).
//
// Bound: bytes. A call reads n mask bytes, 8 bytes of grad and hess and F
// bin bytes per row inside the mask and writes 12 F B bytes; it does 3 F
// additions per row. At the sizes in use (n = 1e5, F = 5: 1.4 MB) that is
// under a microsecond of memory time, so in practice the launch (memset,
// two kernels) and the atomics bound it.
//
// Plain C interface (loaded with ctypes); the launcher works on the stream
// it is given, allocates nothing and does not synchronise. It returns
// cudaGetLastError().

#include <cuda_runtime.h>

#define HIST_THREADS 256
#define HIST_ROWS 1024      // rows per chunk of the grid-stride loop
#define HIST_F_TILE 8       // features per block
#define HIST_MAX_BINS 256   // capacity of the shared histogram per feature

namespace {

__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(const unsigned char* __restrict__ bins,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const unsigned char* __restrict__ mask,
            float* __restrict__ out_g, float* __restrict__ out_h,
            unsigned int* __restrict__ out_c, int n, int F, int B) {
  __shared__ float s_g[HIST_F_TILE * HIST_MAX_BINS];
  __shared__ float s_h[HIST_F_TILE * HIST_MAX_BINS];
  __shared__ unsigned int s_c[HIST_F_TILE * HIST_MAX_BINS];

  const int f0 = blockIdx.y * HIST_F_TILE;
  const int nf = min(HIST_F_TILE, F - f0);
  const int slots = nf * HIST_MAX_BINS;
  for (int k = threadIdx.x; k < slots; k += HIST_THREADS) {
    s_g[k] = 0.0f;
    s_h[k] = 0.0f;
    s_c[k] = 0u;
  }
  __syncthreads();

  const unsigned char* tile = bins + (size_t)f0 * (size_t)n;
  const int chunks = (n + HIST_ROWS - 1) / HIST_ROWS;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int row0 = chunk * HIST_ROWS;
    const int row1 = min(n, row0 + HIST_ROWS);
    for (int i = row0 + threadIdx.x; i < row1; i += HIST_THREADS) {
      if (!mask[i]) continue;
      const float g = grad[i];
      const float h = hess[i];
      for (int f = 0; f < nf; ++f) {
        const int k = f * HIST_MAX_BINS + tile[(size_t)f * (size_t)n + i];
        atomicAdd(&s_g[k], g);
        atomicAdd(&s_h[k], h);
        atomicAdd(&s_c[k], 1u);
      }
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < slots; k += HIST_THREADS) {
    const int b = k % HIST_MAX_BINS;
    const unsigned int c = s_c[k];
    if (c != 0u && b < B) {
      const size_t o = (size_t)(f0 + k / HIST_MAX_BINS) * (size_t)B + b;
      atomicAdd(&out_g[o], s_g[k]);
      atomicAdd(&out_h[o], s_h[k]);
      atomicAdd(&out_c[o], c);
    }
  }
}

// counts: unsigned int -> float32, in place
__global__ void count_to_float_kernel(unsigned int* counts, int len) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < len) {
    reinterpret_cast<float*>(counts)[k] = (float)counts[k];
  }
}

__global__ void empty_kernel() {}

int sm_count() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    int sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
    cached = sms;
  }
  return cached;
}

}  // namespace

extern "C" {

int hist_max_bins() { return HIST_MAX_BINS; }

// bins [F, n] uint8 (features-major), grad / hess [n] f32, mask [n] uint8
// (0 = outside), out [3, F, B] 4-byte words: on return out[0] = hist_g,
// out[1] = hist_h, out[2] = hist_c, all float32. Requires n >= 1, F >= 1,
// 1 <= B <= 256.
int histogram_launch(const unsigned char* bins, const float* grad,
                     const float* hess, const unsigned char* mask, float* out,
                     int n, int F, int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t fb = (size_t)F * (size_t)B;
  cudaError_t err = cudaMemsetAsync(out, 0, 3 * fb * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (n + HIST_ROWS - 1) / HIST_ROWS;
  const int tiles = (F + HIST_F_TILE - 1) / HIST_F_TILE;
  // about two blocks per SM over all feature tiles; never less than one
  const int per_tile = (2 * sm_count() + tiles - 1) / tiles;
  dim3 grid(chunks < per_tile ? chunks : per_tile, tiles);
  unsigned int* out_c = reinterpret_cast<unsigned int*>(out + 2 * fb);
  hist_kernel<<<grid, HIST_THREADS, 0, st>>>(bins, grad, hess, mask, out,
                                             out + fb, out_c, n, F, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = (int)fb;
  count_to_float_kernel<<<(len + 255) / 256, 256, 0, st>>>(out_c, len);
  return (int)cudaGetLastError();
}

// one empty kernel on the stream: the floor under any launch, for timing
int histogram_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
