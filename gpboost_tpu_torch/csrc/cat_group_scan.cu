// The min_data_per_group group scan of the categorical split scan, on
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the sequential scan of the JAX package's categorical split
// search, gpboost_tpu/boosting/tree.py:328 (a jax.lax.scan over the bins;
// the reference's feature_histogram.hpp cnt_cur_group loop). It has no
// Pallas kernel: on the TPU it is an XLA while loop.
//
// For each row r < D of counts [D, B] and ok [D, B], walking the bins
// b = 0 .. B - 1 in order:
//   cur      = carry + counts[r, b]
//   out[r,b] = ok[r, b] && cur >= min_data_per_group
//   carry    = out[r, b] ? 0 : cur
// with carry = 0 before bin 0. A position is a boundary once
// min_data_per_group rows have accrued since the last boundary.
//
// The scan is sequential over the bins and independent across the rows, so
// one thread takes one row (D is twice the number of categorical features:
// a handful of threads). The carry is a double whatever the counts' type:
// counts are integers, so every partial sum is exact (below 2^53) and the
// result is the same bits as the float64 plain version and as the host
// numpy scan it replaces. The launcher takes the current stream, so that a
// CUDA graph captures it. One launch a call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void cat_group_scan_kernel(const T* __restrict__ counts,
                                      const unsigned char* __restrict__ ok,
                                      unsigned char* __restrict__ out,
                                      int D, int B, double min_data) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= D) return;
  const T* c = counts + static_cast<long long>(r) * B;
  const unsigned char* o = ok + static_cast<long long>(r) * B;
  unsigned char* w = out + static_cast<long long>(r) * B;
  double carry = 0.0;
  for (int b = 0; b < B; ++b) {
    const double cur = carry + static_cast<double>(c[b]);
    const bool bound = (o[b] != 0) && (cur >= min_data);
    w[b] = bound ? 1 : 0;
    carry = bound ? 0.0 : cur;
  }
}

template <typename T>
int launch(const T* counts, const unsigned char* ok, unsigned char* out,
           int D, int B, double min_data, void* stream) {
  if (D < 1 || B < 1) return 0;
  const int blocks = (D + kThreads - 1) / kThreads;
  cat_group_scan_kernel<T><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      counts, ok, out, D, B, min_data);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// counts [D, B] float32 (or float64 for the _f64 entry), ok [D, B] uint8
// (0 / 1), out [D, B] uint8, all contiguous on one device; stream: a
// cudaStream_t. Returns a CUDA error code (0 = launched).
int cat_group_scan_f32(const float* counts, const unsigned char* ok,
                       unsigned char* out, int D, int B, double min_data,
                       void* stream) {
  return launch<float>(counts, ok, out, D, B, min_data, stream);
}

int cat_group_scan_f64(const double* counts, const unsigned char* ok,
                       unsigned char* out, int D, int B, double min_data,
                       void* stream) {
  return launch<double>(counts, ok, out, D, B, min_data, stream);
}

}  // extern "C"
