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
// its feature tile in shared memory (up to HIST_F_TILE features x 256 bins
// x (g, h: 64-bit, count: 32-bit) = 40 KB) and fills it with shared-memory
// atomics from the features-major uint8 panel, reading the mask first and,
// for the rows inside it, grad, hess and one byte per feature (neighbouring
// threads read neighbouring rows: coalesced; a thread takes HIST_ILP rows at
// once, so that their loads overlap).
//
// Fixed point: the sums are 64-bit integers. A row adds llrint(g * scale_g)
// and llrint(h * scale_h) with an integer atomicAdd (native on shared
// memory, two's complement in unsigned arithmetic); integer addition is
// associative, so every order of the atomics gives the same sum and the
// histogram is the same bits on every launch. The scales are powers of two
// chosen by the caller once per tree, so that n max|g| scale_g < 2^62 (the
// sum of n rounded terms stays below 2^63 whatever the mask); a term is
// then exact to 2^-63 n max|g|, far below float32's rounding. A sum is
// converted to float once, when it is written (the power-of-two scale
// divides out exactly). Two entries: histogram_launch takes the scales by
// value (a caller that read them on the host), histogram_launch_dev_scales
// reads them from global memory when the kernel starts, so that a grower
// that never reads the host, and a CUDA graph replayed for every tree,
// take each tree's own scales. The same scales give the same bits on both.
//
// One launch does the whole call, with Hopper's thread-block clusters: a
// cluster of C blocks (HIST_CLUSTER_BLOCKS = 16, a non-portable size) per
// feature tile, block r of it taking the row chunks r, r + C,
// ... After a cluster barrier, block r owns a fixed slice of the tile's
// bin slots: it reads the slice from the C blocks' shared memory through
// distributed shared memory, adds the C values and writes g, h and
// float(count) straight into the output, every slot of which some block
// writes. A second cluster barrier keeps every block's shared memory alive
// until the others have read it. So there is no memset, no global atomic
// and no conversion kernel: one stream operation. Counts are unsigned
// integers, exact (to 2^24 rows a bin, where float32 stops counting).
//
// Shared integer atomics are what a call's time goes to (a float atomicAdd
// on shared memory is a compare-and-swap loop on this card, integer atomics
// measured 2.4x faster). So a cluster takes as few features as keep the
// grid within one block an SM (tile = ceil(F C / SMs), 1 .. 8): at F = 5
// five clusters of one feature, 80 SMs; one cluster of 8 features would
// leave every row on 16 SMs. C = 16 measured faster than 8 there.
//
// Bound: bytes. A call reads n mask bytes, 8 bytes of grad and hess and F
// bin bytes per row inside the mask and writes 12 F B bytes; it does 3 F
// additions per row. At the sizes in use (n = 1e5, F = 5: 1.4 MB) that is
// under a microsecond of memory time: in practice the shared atomics and
// the fixed cost of a clustered launch (~5 us at C = 16) bound it.
//
// Plain C interface (loaded with ctypes); the launcher works on the stream
// it is given, allocates nothing and does not synchronise. It returns the
// launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define HIST_THREADS 1024
#define HIST_ILP 4              // rows a thread takes at once
#define HIST_F_TILE 8           // the most features a cluster takes
#define HIST_MAX_BINS 256       // capacity of the shared histogram per feature
#define HIST_CLUSTER_BLOCKS 16  // blocks a cluster (non-portable: above 8)
#define HIST_MAX_DEVICES 64     // devices whose cluster opt-in is remembered
#define HIST_RANKS_AT_ONCE 4    // cluster blocks read together in the sum

namespace {

// a block's histogram of its feature tile, g and h in fixed point
struct HistTile {
  unsigned long long g[HIST_F_TILE * HIST_MAX_BINS];
  unsigned long long h[HIST_F_TILE * HIST_MAX_BINS];
  unsigned int c[HIST_F_TILE * HIST_MAX_BINS];
};

// v * scale rounded to the nearest integer, as the two's complement bits
// that an unsigned atomicAdd adds
__device__ __forceinline__ unsigned long long to_fixed(float v, float scale) {
  return (unsigned long long)__float2ll_rn(v * scale);
}

// tile: features a cluster (<= HIST_F_TILE); blockIdx.y = feature tile.
// One block an SM (1 024 threads): ptxas may take up to 64 registers.
// kDeviceScales: scale_g / scale_h come from scales[0] / scales[1] in
// global memory instead of the arguments.
template <bool kDeviceScales>
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_kernel(const unsigned char* __restrict__ bins,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const unsigned char* __restrict__ mask, float* __restrict__ out,
            int n, int F, int B, int tile, float scale_g, float scale_h,
            const float* __restrict__ scales) {
  __shared__ HistTile hist;
  if (kDeviceScales) {
    scale_g = scales[0];
    scale_h = scales[1];
  }

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int f0 = blockIdx.y * tile;
  const int nf = min(tile, F - f0);
  const int slots = nf * HIST_MAX_BINS;
  for (int k = threadIdx.x; k < slots; k += HIST_THREADS) {
    hist.g[k] = 0ull;
    hist.h[k] = 0ull;
    hist.c[k] = 0u;
  }
  __syncthreads();

  // this block's chunks of HIST_THREADS x HIST_ILP rows
  const unsigned char* panel = bins + (size_t)f0 * (size_t)n;
  const int chunk = HIST_THREADS * HIST_ILP;
  for (int row0 = rank * chunk; row0 < n; row0 += C * chunk) {
    bool in[HIST_ILP];
    unsigned long long g[HIST_ILP], h[HIST_ILP];
#pragma unroll
    for (int q = 0; q < HIST_ILP; ++q) {
      const int i = row0 + q * HIST_THREADS + threadIdx.x;
      in[q] = i < n && mask[i];
    }
#pragma unroll
    for (int q = 0; q < HIST_ILP; ++q) {
      const int i = row0 + q * HIST_THREADS + threadIdx.x;
      g[q] = in[q] ? to_fixed(grad[i], scale_g) : 0ull;
      h[q] = in[q] ? to_fixed(hess[i], scale_h) : 0ull;
    }
    for (int f = 0; f < nf; ++f) {
      const unsigned char* col = panel + (size_t)f * (size_t)n + row0;
      int b[HIST_ILP];
#pragma unroll
      for (int q = 0; q < HIST_ILP; ++q)
        b[q] = in[q] ? col[q * HIST_THREADS + threadIdx.x] : 0;
#pragma unroll
      for (int q = 0; q < HIST_ILP; ++q) {
        if (in[q]) {
          const int k = f * HIST_MAX_BINS + b[q];
          atomicAdd(&hist.g[k], g[q]);
          atomicAdd(&hist.h[k], h[q]);
          atomicAdd(&hist.c[k], 1u);
        }
      }
    }
  }
  // every block's histogram is complete and visible to the cluster
  cluster.sync();

  // block r: slots [lo, hi) of the tile's nf x B, the C blocks' values
  // added (the loads of HIST_RANKS_AT_ONCE ranks issued together)
  const int total = nf * B;
  const int per = (total + C - 1) / C;
  const int lo = rank * per;
  const int hi = min(total, lo + per);
  const size_t fb = (size_t)F * (size_t)B;
  const float inv_g = 1.0f / scale_g;
  const float inv_h = 1.0f / scale_h;
  for (int s = lo + threadIdx.x; s < hi; s += HIST_THREADS) {
    const int f = s / B;
    const int k = f * HIST_MAX_BINS + (s - f * B);
    unsigned long long sg = 0ull, sh = 0ull;
    unsigned int sc = 0u;
    for (int q0 = 0; q0 < C; q0 += HIST_RANKS_AT_ONCE) {
      unsigned long long xg[HIST_RANKS_AT_ONCE], xh[HIST_RANKS_AT_ONCE];
      unsigned int xc[HIST_RANKS_AT_ONCE];
#pragma unroll
      for (int u = 0; u < HIST_RANKS_AT_ONCE; ++u) {
        if (q0 + u < C) {
          const HistTile* other = cluster.map_shared_rank(&hist, q0 + u);
          xg[u] = other->g[k];
          xh[u] = other->h[k];
          xc[u] = other->c[k];
        }
      }
#pragma unroll
      for (int u = 0; u < HIST_RANKS_AT_ONCE; ++u) {
        if (q0 + u < C) {
          sg += xg[u];
          sh += xh[u];
          sc += xc[u];
        }
      }
    }
    const size_t o = (size_t)f0 * (size_t)B + (size_t)s;
    out[o] = __ll2float_rn((long long)sg) * inv_g;
    out[fb + o] = __ll2float_rn((long long)sh) * inv_h;
    out[2 * fb + o] = (float)sc;
  }
  // no block leaves (and frees its shared memory) while another reads it
  cluster.sync();
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

// a cluster of more than 8 blocks needs the kernel's opt-in, which belongs
// to the current device: set once per device and instance, not on every
// call
template <bool kDeviceScales>
cudaError_t allow_cluster() {
  static bool allowed[HIST_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < HIST_MAX_DEVICES && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(hist_kernel<kDeviceScales>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess && dev < HIST_MAX_DEVICES) allowed[dev] = true;
  return err;
}

// one clustered launch of hist_kernel<kDeviceScales> (see the entries)
template <bool kDeviceScales>
int launch(const unsigned char* bins, const float* grad, const float* hess,
           const unsigned char* mask, float* out, int n, int F, int B,
           float scale_g, float scale_h, const float* scales, void* stream) {
  const int C = HIST_CLUSTER_BLOCKS;
  if (n < 1 || F < 1 || B < 1 || B > HIST_MAX_BINS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t allowed = allow_cluster<kDeviceScales>();
  if (allowed != cudaSuccess) return (int)allowed;
  // features a cluster: as few as keep the grid within one block an SM, so
  // that the rows' atomics spread over as many SMs as the features allow
  int tile = (F * C + sm_count() - 1) / sm_count();
  tile = tile < 1 ? 1 : (tile > HIST_F_TILE ? HIST_F_TILE : tile);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (F + tile - 1) / tile);
  cfg.blockDim = dim3(HIST_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, hist_kernel<kDeviceScales>, bins, grad, hess,
                         mask, out, n, F, B, tile, scale_g, scale_h, scales);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hist_max_bins() { return HIST_MAX_BINS; }
int hist_cluster_blocks() { return HIST_CLUSTER_BLOCKS; }

// bins [F, n] uint8 (features-major), grad / hess [n] f32, mask [n] uint8
// (0 = outside), out [3, F, B] float32, written whole (no need to clear it):
// out[0] = hist_g, out[1] = hist_h, out[2] = hist_c. scale_g / scale_h:
// the fixed-point scales, powers of two with n max|grad| scale_g < 2^62
// (likewise for hess). Requires n >= 1, F >= 1, 1 <= B <= 256. One kernel
// launch.
int histogram_launch(const unsigned char* bins, const float* grad,
                     const float* hess, const unsigned char* mask, float* out,
                     int n, int F, int B, float scale_g, float scale_h,
                     void* stream) {
  if (!(scale_g > 0.0f) || !(scale_h > 0.0f))
    return (int)cudaErrorInvalidValue;
  return launch<false>(bins, grad, hess, mask, out, n, F, B, scale_g, scale_h,
                       nullptr, stream);
}

// histogram_launch with the scales read by the kernel from scales[0] (the
// gradients') and scales[1] (the hessians'), float32 in device memory, as
// they are when the kernel runs: a launch in a CUDA graph takes the scales
// the graph's earlier operations wrote. Nothing checks their values (that
// would read the device): a scale that is not finite gives NaN sums.
int histogram_launch_dev_scales(const unsigned char* bins, const float* grad,
                                const float* hess, const unsigned char* mask,
                                float* out, int n, int F, int B,
                                const float* scales, void* stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(bins, grad, hess, mask, out, n, F, B, 1.0f, 1.0f,
                      scales, stream);
}

// one empty kernel on the stream: the floor under any launch, for timing
int histogram_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
