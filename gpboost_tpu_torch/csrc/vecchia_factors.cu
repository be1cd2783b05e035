// Fused Vecchia factor kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of
// gpboost_tpu/ops/kernels/vecchia_factors.py:
//   vecchia_factors_pallas  (_factors_kernel  + _block_factors)
//   vecchia_nll_grad_pallas (_nll_grad_kernel + _block_factors)
//
// Per row i with neighbour set N(i) (m slots, -1 = padding):
//   scaled distances -> C = C_NN (+ nugget on the valid diagonal, identity
//   rows for padded slots) and c = c_iN -> Cholesky -> a = C^-1 c,
//   D = var (+ nugget) - c.a
// and, for the NLL kernel, 0.5 [log D + (r_i - a.r_N)^2 / D] together with
// its gradient w.r.t. log(nugget, var, range or rho_1..rho_d).
//
// The TPU kernels keep every pair entry as an (8, 128) tile over a
// 1024-row block and have the host pre-gather the neighbour coordinates
// because Mosaic has no gather; here the threads of a row load its m
// indices and gather its neighbour coordinates from the coordinate table
// (L2-resident at the sizes in use). Both kernels share one block layout,
// the covariance functions, the gather, the fill, the column Cholesky and
// the strided triangular solve chol_solve; element e of a row's array lies
// at [e * st].
//
// Both kernels keep every per-row array in DYNAMIC SHARED MEMORY,
// element-major: a block holds R rows, and element e of row t's arrays sits
// at smem[e * R + t], so the threads of a warp touching the same element of
// their rows hit consecutive banks. A block has 128 threads, R rows of
// 128 / R LANES (R in {32, 16, 8}: the largest whose block fits
// VF_SMEM_BUDGET, 8 always; chosen from (m, d) at launch and exported). The
// per-dimension arrays are registers, unrolled to the tier DMAX in
// {2, 4, 8} >= d (one instance each): nothing of a row goes to local memory.
// One thread a row with the rows in shared memory was tried first for the
// NLL kernel and was slower than a local-memory stack frame: only as many
// rows as fit the SM's 228 KB are in flight (192 at m = 20, d = 2), six warps
// an SM, each stalled on its row's chain of dependent loads and exps. The
// lanes split the gather, the fill and the rows of each Cholesky column (one
// barrier a column).
//
// - factors_kernel: per row the packed triangle (m(m+1)/2 floats,
//   overwritten by its Cholesky factor), the neighbour coordinates (m d), c
//   and a (m each). Lane 0 solves a = C^-1 c and adds D in slot order; the
//   block then stores its R rows of A, R m contiguous floats, together
//   (coalesced) and lane 0 of each row its D.
//
// - nll_grad_kernel: per row the packed triangle (its room also takes the
//   lanes' partial sums at the end), the neighbour coordinates (m d), a and
//   u (m each; a holds c until the solve). R is exported as
//   vf_nll_rows_per_block for the caller's scratch. The two solves run on
//   lanes 0 (a) and 1 (u), and the lanes split the gradient walk, whose
//   partial sums lane 0 adds in lane order.
//
// Bound of factors_kernel: FP32 operations by the roofline (~m^3/3 FLOPs of
// Cholesky, one solve pair, m(m+1)/2 exp/sqrt covariance evaluations),
// ~0.010 ms at n = 1e5, m = 20; the bytes (coordinates, indices, A, D) are
// ~17 MB, ~0.005 ms. In practice the latency of a row's dependent chain at
// the few rows an SM that shared memory holds bounds it, as for the NLL
// kernel.
//
// Bound of nll_grad_kernel: FP32 operations by the roofline (~m^3/3 FLOPs
// of Cholesky, two solves, m(m+1)/2 exp/sqrt covariance evaluations twice:
// the gradient walk recomputes the entries instead of storing dC), ~0.02 ms
// at n = 1e5, m = 20. With the triangle on chip its practical floors are
// shared-memory bandwidth (~2.2-2.7 GB of loads per call, ~0.08-0.09 ms at
// 132 SMs x 128 B/clk) and the latency of a row's dependent chain, which
// the lanes shorten. Tensor cores do not serve here: the work is m
// dependent steps of a 20 x 20 float32 factorisation per row, not a
// product, and TF32 would lose the NLL's 1e-4 and the gradient's 1e-3
// tolerances. The irregular neighbour gather leaves TMA nothing to do.
//
// The gradient is derived by hand (the TPU kernel traced reverse-mode AD
// through its body). With a = C^-1 c, u = C^-1 r_N, D = v - c.a,
// e = r_i - a.r_N, l = 0.5 (log D + e^2 / D) and entry-wise derivatives
// dC, dc, dv of one log-parameter:
//   dD = dv - 2 a.dc + a.dC.a,   de = -u.dc + u.dC.a,
//   dl = 0.5 dD / D + e de / D - 0.5 e^2 dD / D^2.
// The bilinear forms are accumulated by walking the pairs once more. With x
// the scaled distance, q_k = ((p_k - q_k) s_k)^2 its per-dimension parts and
// g(x) = -corr'(x) / x:
//   d corr / d log rho_k = g(x) q_k   (ARD),   g(x) sum_k q_k   (isotropic).
//
// The sum over rows is deterministic: lane 0 of a row adds the lanes'
// partial sums in lane order, the block's R rows are reduced by shuffles
// into one row of a [ceil(n / R), 1 + p] scratch tensor, which the caller
// sums. No float atomics; R depends on (m, d) alone, so two launches give
// the same bits.
//
// Plain C interface (loaded with ctypes); kernels launch on the stream they
// are given, allocate nothing and do not synchronise. Each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#define VF_MAX_M 64
#define VF_MAX_D 8
#define VF_MAX_P (2 + VF_MAX_D)
// the most dynamic shared memory a block of 32 or 16 rows may take (a third
// of the SM's 228 KB, so that at least three blocks share an SM); a block of
// 8 rows is taken whatever it needs (at most 87 040 bytes at m = 64, d = 8)
#define VF_SMEM_BUDGET (76 * 1024)
#define VF_SMEM_DEFAULT_MAX (48 * 1024)  // above: opt in per kernel
#define VF_BLOCK_THREADS 128  // threads a block of either kernel: R rows x lanes
#define VF_NLL_PARTS (7 + 4 * VF_MAX_D)  // partial sums a lane hands on

namespace {

// shape codes: 0 = matern 0.5 (exponential), 1 = matern 1.5, 2 = matern 2.5,
// 3 = gaussian. x is the SCALED distance (range / ARD scales and the matern
// sqrt(3), sqrt(5) multipliers are folded into the coordinate scales).
__device__ __forceinline__ float corr_x(float x, int shape) {
  switch (shape) {
    case 0: return expf(-x);
    case 1: return (1.0f + x) * expf(-x);
    case 2: return (1.0f + x + x * x / 3.0f) * expf(-x);
    default: return expf(-x * x);
  }
}

// correlation and g(x) = -corr'(x) / x from one exponential
__device__ __forceinline__ void corr_and_g(float x, int shape, float& corr,
                                           float& g) {
  switch (shape) {
    case 0: {
      const float e = expf(-x);
      corr = e;
      g = x > 0.0f ? e / x : 0.0f;
      break;
    }
    case 1: {
      const float e = expf(-x);
      corr = (1.0f + x) * e;
      g = e;
      break;
    }
    case 2: {
      const float e = expf(-x);
      corr = (1.0f + x + x * x / 3.0f) * e;
      g = (1.0f + x) * e / 3.0f;
      break;
    }
    default: {
      const float e = expf(-x * x);
      corr = e;
      g = 2.0f * e;
    }
  }
}

// Squared scaled distance between p and q, coordinate k at p[k * ps] and
// q[k * qs]; its per-dimension parts go to parts[k] when asked for. The loop
// is unrolled to the compile-time bound DMAX >= d, so that s and parts,
// indexed by k, stay registers and d = 2 issues no work for 8 dimensions.
// dist = d2 > 0 ? sqrt(d2) : 0 at the call site.
template <int DMAX>
__device__ __forceinline__ float scaled_d2(const float* p, int ps,
                                           const float* q, int qs,
                                           const float* s, int d,
                                           float* parts = nullptr) {
  float d2 = 0.0f;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const float dk = (p[k * ps] - q[k * qs]) * s[k];
      const float qk = dk * dk;
      if (parts) parts[k] = qk;
      d2 += qk;
    }
  }
  return d2;
}

__device__ __forceinline__ float dist_of(float d2) {
  return d2 > 0.0f ? sqrtf(d2) : 0.0f;
}

__host__ __device__ __forceinline__ int tri(int i) {
  return (i * (i + 1)) >> 1;
}

// The per-row arrays below are strided: element e of Lp, xn, c, a, x lies at
// [e * st] (st = R, the rows of a block, for a row in shared memory).

// x <- C^-1 x with the packed factor Lp (reciprocal pivots on the diagonal)
__device__ __forceinline__ void chol_solve(const float* Lp, float* x, int m,
                                           int st) {
  for (int j = 0; j < m; ++j) {
    const float* Lj = Lp + tri(j) * st;
    float s = x[j * st];
    for (int k = 0; k < j; ++k) s -= Lj[k * st] * x[k * st];
    x[j * st] = s * Lj[j * st];
  }
  for (int j = m - 1; j >= 0; --j) {
    float s = x[j * st];
    for (int i = j + 1; i < m; ++i) s -= Lp[(tri(i) + j) * st] * x[i * st];
    x[j * st] = s * Lp[(tri(j) + j) * st];
  }
}

// The device functions below split a row's work over `lanes` threads
// (lane = 0 .. lanes - 1): lane l takes the slots, triangle rows and
// neighbours j with j % lanes == l. Inside a lane the loops work on VF_ILP
// independent entries at once (loads first, then the arithmetic, then the
// stores) for the latency of a load or an exp to overlap. Every entry gets
// the same operations in the same order as in a row-by-row form.
#define VF_ILP 4

// validity bits of the m slots: slot j is valid iff nbr_row[j] >= 0
__device__ __forceinline__ unsigned long long valid_mask(
    const int* __restrict__ nbr_row, int m) {
  unsigned long long vmask = 0ull;
  for (int j = 0; j < m; ++j)
    if (nbr_row[j] >= 0) vmask |= 1ull << j;
  return vmask;
}

// gathers this lane's neighbour coordinates into xn [m, d] (a padded slot
// gets row 0's coordinates, which no valid entry uses)
template <int DMAX>
__device__ __forceinline__ void gather_coords(
    const float* __restrict__ coords, const int* __restrict__ nbr_row,
    float* xn, int m, int d, int st, int lane, int lanes) {
  for (int j0 = lane; j0 < m; j0 += VF_ILP * lanes) {
    float v[VF_ILP][DMAX];
#pragma unroll
    for (int q = 0; q < VF_ILP; ++q) {
      const int j = j0 + q * lanes;
      const int idx = j < m ? nbr_row[j] : -1;
      const float* src = coords + (size_t)(idx >= 0 ? idx : 0) * d;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) v[q][k] = k < d ? src[k] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < VF_ILP; ++q) {
      const int j = j0 + q * lanes;
      if (j < m) {
#pragma unroll
        for (int k = 0; k < DMAX; ++k)
          if (k < d) xn[(j * d + k) * st] = v[q][k];
      }
    }
  }
}

// neighbour j's coordinates into xj[DMAX] (registers)
template <int DMAX>
__device__ __forceinline__ void load_coords(const float* xn, int j, int d,
                                            int st, float* xj) {
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    xj[k] = k < d ? xn[(j * d + k) * st] : 0.0f;
}

// this lane's rows j of C_NN into the packed triangle Lp and c_iN into c;
// invalid pair -> off-diagonal 0, diagonal 1, c 0
template <int DMAX>
__device__ __forceinline__ void fill_cov(const float* row_x,
                                         const float* scale, float var,
                                         float var_ii, const float* xn,
                                         unsigned long long vmask, int m,
                                         int d, int shape, float* Lp,
                                         float* c, int st, int lane,
                                         int lanes) {
  for (int j = lane; j < m; j += lanes) {
    const bool vj = (vmask >> j) & 1ull;
    float xj[DMAX];
    load_coords<DMAX>(xn, j, d, st, xj);
    c[j * st] = vj ? var * corr_x(dist_of(scaled_d2<DMAX>(row_x, 1, xj, 1,
                                                          scale, d)),
                                  shape)
                   : 0.0f;
    float* Bj = Lp + tri(j) * st;
    for (int k0 = 0; k0 < j; k0 += VF_ILP) {
      float v[VF_ILP];
#pragma unroll
      for (int q = 0; q < VF_ILP; ++q) {
        const int k = min(k0 + q, j - 1);
        const bool vk = (vmask >> k) & 1ull;
        v[q] = (vj && vk) ? var * corr_x(dist_of(scaled_d2<DMAX>(
                                             xj, 1, xn + k * d * st, st,
                                             scale, d)),
                                         shape)
                          : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < VF_ILP; ++q)
        if (k0 + q < j) Bj[(k0 + q) * st] = v[q];
    }
    Bj[j * st] = vj ? var_ii : 1.0f;
  }
}

// In-place Cholesky of the packed triangle, column by column; the diagonal
// slot keeps 1 / L_jj. Entry (i, j) is (C_ij - sum_{k<j} L_ik L_jk) * (1 /
// L_jj) with k ascending, as in the row-by-row form. The rows of a
// column are independent: lane l takes rows i > j with i % lanes == l,
// VF_ILP of them sharing each load of L_jk (a slot past the end repeats the
// chunk's first row, which this lane owns, and is not stored). Every lane
// computes the column's pivot itself; lane 0 stores it once no lane reads
// C_jj any more (at the next column). The block synchronises after each
// column: every thread of the block must call.
__device__ __forceinline__ void cholesky(float* Lp, int m, int st, int lane,
                                         int lanes) {
  float pivot = 0.0f;
  for (int j = 0; j < m; ++j) {
    if (lane == 0 && j > 0) Lp[(tri(j - 1) + j - 1) * st] = pivot;
    const float* Lj = Lp + tri(j) * st;
    float sjj = Lj[j * st];
    for (int k = 0; k < j; ++k) sjj -= Lj[k * st] * Lj[k * st];
    pivot = 1.0f / sqrtf(fmaxf(sjj, 1e-30f));
    const int first = j + 1 + ((lane - (j + 1)) % lanes + lanes) % lanes;
    for (int i0 = first; i0 < m; i0 += VF_ILP * lanes) {
      float* Li[VF_ILP];
      float s[VF_ILP];
#pragma unroll
      for (int q = 0; q < VF_ILP; ++q) {
        const int i = i0 + q * lanes;
        Li[q] = Lp + tri(i < m ? i : i0) * st;
        s[q] = Li[q][j * st];
      }
      for (int k = 0; k < j; ++k) {
        const float ljk = Lj[k * st];
#pragma unroll
        for (int q = 0; q < VF_ILP; ++q) s[q] -= Li[q][k * st] * ljk;
      }
#pragma unroll
      for (int q = 0; q < VF_ILP; ++q)
        if (i0 + q * lanes < m) Li[q][j * st] = s[q] * pivot;
    }
    __syncthreads();
  }
  if (lane == 0) Lp[(tri(m - 1) + m - 1) * st] = pivot;
  __syncthreads();
}

// floats of one row's shared-memory arrays in factors_kernel: the packed
// triangle, the neighbour coordinates, c and a
__host__ __device__ __forceinline__ int factors_row_floats(int m, int d) {
  return tri(m) + m * d + 2 * m;
}

// floats of one row's shared-memory arrays in nll_grad_kernel: the packed
// triangle (its room also takes the lanes' partial sums at the end), the
// neighbour coordinates, a and u
__host__ __device__ __forceinline__ int nll_row_floats(int m, int d,
                                                       int lanes) {
  const int tri_room = tri(m) > lanes * VF_NLL_PARTS ? tri(m)
                                                      : lanes * VF_NLL_PARTS;
  return tri_room + m * d + 2 * m;
}

// pars = (var, nugget, scale_1..scale_d), d <= DMAX. The block layout of
// nll_grad_kernel (below): R = rows rows of lanes = VF_BLOCK_THREADS / R
// threads each, thread (lane l, row t) is thread l * R + t; dynamic shared
// memory R * factors_row_floats(m, d) floats.
template <int DMAX>
__global__ void __launch_bounds__(VF_BLOCK_THREADS)
factors_kernel(const float* __restrict__ pars,
               const float* __restrict__ coords,
               const int* __restrict__ neighbors,
               const float* __restrict__ row_coords, float* __restrict__ A,
               float* __restrict__ D, int n, int m, int d, int shape,
               int include_nugget, int rows) {
  extern __shared__ float vf_rows[];
  const int R = rows;
  const int lanes = VF_BLOCK_THREADS / R;
  const int t = threadIdx.x % R;
  const int lane = threadIdx.x / R;
  const int row0 = blockIdx.x * R;
  const int i = row0 + t;
  // a thread past the last row works on the last row (every thread meets
  // every barrier) and stores nothing
  const int row = i < n ? i : n - 1;

  // this row's arrays in shared memory, element e at [e * R]
  float* Lp = vf_rows + t;
  float* xn = Lp + tri(m) * R;
  float* c = xn + m * d * R;
  float* a = c + m * R;
  float scale[DMAX], row_x[DMAX];
  const float var = pars[0];
  const float var_ii = var + (include_nugget ? pars[1] : 0.0f);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    scale[k] = k < d ? pars[2 + k] : 0.0f;
    row_x[k] = k < d ? row_coords[(size_t)row * d + k] : 0.0f;
  }
  const int* nbr_row = neighbors + (size_t)row * m;
  const unsigned long long vmask = valid_mask(nbr_row, m);

  gather_coords<DMAX>(coords, nbr_row, xn, m, d, R, lane, lanes);
  __syncthreads();
  fill_cov<DMAX>(row_x, scale, var, var_ii, xn, vmask, m, d, shape, Lp, c, R,
                 lane, lanes);
  // a starts as c: on the slots this lane has just filled
  for (int j = lane; j < m; j += lanes) a[j * R] = c[j * R];
  __syncthreads();
  cholesky(Lp, m, R, lane, lanes);
  // lane 0: a = C^-1 c, masked; D from the unsolved c, in slot order. The
  // mask and var_ii are read again rather than held through the Cholesky
  // (held, ptxas spilled them at DMAX = 2 and 8)
  if (lane == 0) {
    chol_solve(Lp, a, m, R);
    float d_cond = pars[0] + (include_nugget ? pars[1] : 0.0f);
    for (int j = 0; j < m; ++j) {
      if (nbr_row[j] < 0) a[j * R] = 0.0f;
      d_cond -= c[j * R] * a[j * R];
    }
    if (i < n) D[i] = d_cond;
  }
  __syncthreads();
  // the block's rows of A are R m contiguous floats of the output: the
  // block stores them together, neighbouring threads at neighbouring
  // addresses (element j of row t of the block is a_blk[j * R + t])
  const float* a_blk = vf_rows + (tri(m) + m * d + m) * R;
  float* A_blk = A + (size_t)row0 * m;
  const int len = (n - row0 < R ? n - row0 : R) * m;
  for (int k = threadIdx.x; k < len; k += VF_BLOCK_THREADS) {
    const int tk = k / m;
    A_blk[k] = a_blk[(k - tk * m) * R + tk];
  }
}

// logp = log(nugget, var, range) or log(nugget, var, rho_1..rho_d) (ard),
// d <= DMAX. A block of VF_BLOCK_THREADS threads holds R = rows rows of
// lanes = VF_BLOCK_THREADS / R threads each: thread (lane l, row t) is thread
// l * R + t, so a warp holds one lane of 32 rows (or of two or four lanes
// when R = 16, 8). Dynamic shared memory R * nll_row_floats(m, d, lanes)
// floats. scratch [ceil(n / R), 1 + p], p = 2 + n_ranges: per-block sums of
// (l, dl/dlog nugget, dl/dlog var, dl/dlog range_k...).
template <int DMAX>
__global__ void __launch_bounds__(VF_BLOCK_THREADS)
nll_grad_kernel(const float* __restrict__ logp,
                const float* __restrict__ coords,
                const int* __restrict__ neighbors,
                const float* __restrict__ row_coords,
                const float* __restrict__ r, const float* __restrict__ row_r,
                const float* __restrict__ row_valid,
                float* __restrict__ scratch, int n, int m, int d, int shape,
                int ard, int rows) {
  extern __shared__ float vf_rows[];
  const int R = rows;
  const int lanes = VF_BLOCK_THREADS / R;
  const int t = threadIdx.x % R;
  const int lane = threadIdx.x / R;
  const int i = blockIdx.x * R + t;
  // a thread past the last row works on the last row (every thread meets
  // every barrier) and adds nothing
  const int row = i < n ? i : n - 1;
  const int n_ranges = ard ? d : 1;
  const int p = 2 + n_ranges;

  // this row's arrays in shared memory, element e at [e * R]
  float* Lp = vf_rows + t;
  float* xn = Lp + (nll_row_floats(m, d, lanes) - m * d - 2 * m) * R;
  float* a = xn + m * d * R;
  float* u = a + m * R;
  float scale[DMAX], row_x[DMAX];
  const float nugget = expf(logp[0]);
  const float var = expf(logp[1]);
  const float var_ii = var + nugget;
  const float mc = shape == 1 ? 1.7320508075688772f
                              : (shape == 2 ? 2.23606797749979f : 1.0f);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    scale[k] = k < d ? mc * expf(-logp[2 + (ard ? k : 0)]) : 0.0f;
    row_x[k] = k < d ? row_coords[(size_t)row * d + k] : 0.0f;
  }
  const int* nbr_row = neighbors + (size_t)row * m;
  const unsigned long long vmask = valid_mask(nbr_row, m);

  // this lane's neighbours: coordinates and residuals r_N (masked)
  gather_coords<DMAX>(coords, nbr_row, xn, m, d, R, lane, lanes);
  for (int j = lane; j < m; j += lanes) {
    const int idx = nbr_row[j];
    u[j * R] = idx >= 0 ? r[idx] : 0.0f;
  }
  __syncthreads();
  // C_NN and c (into a), this lane's triangle rows
  fill_cov<DMAX>(row_x, scale, var, var_ii, xn, vmask, m, d, shape, Lp, a, R,
                 lane, lanes);
  __syncthreads();
  cholesky(Lp, m, R, lane, lanes);
  // a = C^-1 c on lane 0, u = C^-1 r_N on lane 1: one call site, so that at
  // R = 16, 8 (both lanes in warp 0) the two solves run side by side, on a
  // pointer computed from the lane (u follows a; a pointer chosen by a select
  // spilled registers at DMAX = 2). Lane 0 then masks a and takes
  // e = r_i - a.r_N (the unsolved residuals, gathered again).
  if (lane < 2) chol_solve(Lp, a + lane * m * R, m, R);
  float e = 0.0f;
  if (lane == 0) {
    e = row_r[row];
    for (int j = 0; j < m; ++j) {
      const int idx = nbr_row[j];
      if (idx < 0) a[j * R] = 0.0f;
      e -= a[j * R] * (idx >= 0 ? r[idx] : 0.0f);
    }
  }
  __syncthreads();

  // bilinear forms over this lane's valid neighbours j and their pairs
  // (j, k < j); a = u = 0 on invalid slots. Also c.a for D, c_j = var
  // corr(row, j).
  float c_a = 0.0f;                              // sum c_j a_j
  float sum_aa = 0.0f, sum_ua = 0.0f;            // sum a_j^2, sum u_j a_j
  float v_aa = 0.0f, v_ua = 0.0f;                // a.C0.a, u.C0.a (C0 = var corr)
  float v_ac = 0.0f, v_uc = 0.0f;                // a.c, u.c
  // per range parameter: a.dC.a, u.dC.a, a.dc, u.dc
  float s_aa[DMAX], s_ua[DMAX], s_ac[DMAX], s_uc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    s_aa[k] = 0.0f; s_ua[k] = 0.0f; s_ac[k] = 0.0f; s_uc[k] = 0.0f;
  }
  for (int j = lane; j < m; j += lanes) {
    if (!((vmask >> j) & 1ull)) continue;
    float xj[DMAX], q[DMAX];
    load_coords<DMAX>(xn, j, d, R, xj);
    const float aj = a[j * R], uj = u[j * R];
    sum_aa += aj * aj;
    sum_ua += uj * aj;
    {
      const float d2 = scaled_d2<DMAX>(row_x, 1, xj, 1, scale, d, q);
      float corr, g;
      corr_and_g(dist_of(d2), shape, corr, g);
      c_a += (var * corr) * aj;
      v_ac += aj * (var * corr);
      v_uc += uj * (var * corr);
      const float vg = var * g;
      if (ard) {
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            s_ac[k] += aj * (vg * q[k]);
            s_uc[k] += uj * (vg * q[k]);
          }
        }
      } else {
        s_ac[0] += aj * (vg * d2);
        s_uc[0] += uj * (vg * d2);
      }
    }
    for (int k0 = 0; k0 < j; k0 += VF_ILP) {
      float d2[VF_ILP], qs[VF_ILP][DMAX], corr[VF_ILP], g[VF_ILP];
      float ak[VF_ILP], uk[VF_ILP];
#pragma unroll
      for (int c = 0; c < VF_ILP; ++c) {
        const int k2 = min(k0 + c, j - 1);
        d2[c] = scaled_d2<DMAX>(xj, 1, xn + k2 * d * R, R, scale, d, qs[c]);
        ak[c] = a[k2 * R];
        uk[c] = u[k2 * R];
      }
#pragma unroll
      for (int c = 0; c < VF_ILP; ++c)
        corr_and_g(dist_of(d2[c]), shape, corr[c], g[c]);
#pragma unroll
      for (int c = 0; c < VF_ILP; ++c) {
        const int k2 = k0 + c;
        if (k2 >= j || !((vmask >> k2) & 1ull)) continue;
        const float w_aa = 2.0f * aj * ak[c];
        const float w_ua = uj * ak[c] + uk[c] * aj;
        v_aa += w_aa * (var * corr[c]);
        v_ua += w_ua * (var * corr[c]);
        const float vg = var * g[c];
        if (ard) {
#pragma unroll
          for (int k = 0; k < DMAX; ++k) {
            if (k < d) {
              s_aa[k] += w_aa * (vg * qs[c][k]);
              s_ua[k] += w_ua * (vg * qs[c][k]);
            }
          }
        } else {
          s_aa[0] += w_aa * (vg * d2[c]);
          s_ua[0] += w_ua * (vg * d2[c]);
        }
      }
    }
  }
  // the lanes' partial sums into the triangle's room (free after the
  // solves), VF_NLL_PARTS floats a lane: 7 forms, then 4 per range
  float* part = Lp + lane * VF_NLL_PARTS * R;
  part[0] = c_a; part[R] = sum_aa; part[2 * R] = sum_ua; part[3 * R] = v_aa;
  part[4 * R] = v_ua; part[5 * R] = v_ac; part[6 * R] = v_uc;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < n_ranges) {
      part[(7 + 4 * k) * R] = s_aa[k];
      part[(8 + 4 * k) * R] = s_ua[k];
      part[(9 + 4 * k) * R] = s_ac[k];
      part[(10 + 4 * k) * R] = s_uc[k];
    }
  }
  __syncthreads();
  if (lane != 0) return;

  // lane 0: the row's sums over the lanes, in lane order, and its terms
  float f[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    s_aa[k] = 0.0f; s_ua[k] = 0.0f; s_ac[k] = 0.0f; s_uc[k] = 0.0f;
  }
  for (int l = 0; l < lanes; ++l) {
    const float* pl = Lp + l * VF_NLL_PARTS * R;
#pragma unroll
    for (int o = 0; o < 7; ++o) f[o] += pl[o * R];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < n_ranges) {
        s_aa[k] += pl[(7 + 4 * k) * R];
        s_ua[k] += pl[(8 + 4 * k) * R];
        s_ac[k] += pl[(9 + 4 * k) * R];
        s_uc[k] += pl[(10 + 4 * k) * R];
      }
    }
  }
  const float d_cond = var_ii - f[0];
  sum_aa = f[1]; sum_ua = f[2];
  // diagonal of C0 is var on valid slots
  v_aa = f[3] + var * sum_aa;
  v_ua = f[4] + var * sum_ua;
  v_ac = f[5]; v_uc = f[6];

  float out[1 + VF_MAX_P];
#pragma unroll
  for (int o = 0; o <= VF_MAX_P; ++o) out[o] = 0.0f;
  if (i < n) {
    const float w = row_valid ? row_valid[i] : 1.0f;
    const float inv_d = 1.0f / d_cond;
    const float e_d = e * inv_d;
    // dl = g_D dD + g_e de
    const float g_D = 0.5f * (inv_d - e_d * e_d) * w;
    const float g_e = e_d * w;
    out[0] = 0.5f * (logf(d_cond) + e * e_d) * w;
    // log nugget: dC = nugget I (valid), dc = 0, dv = nugget
    out[1] = g_D * (nugget + nugget * sum_aa) + g_e * (nugget * sum_ua);
    // log var: dC = C0, dc = c, dv = var
    out[2] = g_D * (var - 2.0f * v_ac + v_aa) + g_e * (v_ua - v_uc);
    // log range(s): dv = 0
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < n_ranges)
        out[3 + k] = g_D * (s_aa[k] - 2.0f * s_ac[k]) +
                     g_e * (s_ua[k] - s_uc[k]);
    }
  }

  // block reduction over the rows: lane 0 of the R rows is threads 0..R-1
  // of the first warp; shuffles within width R (a lane past the end adds
  // its own value and is never read by thread 0), thread 0 writes the
  // block's row of scratch
  const unsigned lanes0 = R == 32 ? 0xffffffffu : (1u << R) - 1u;
#pragma unroll
  for (int o = 0; o <= VF_MAX_P; ++o) {
    if (o <= p) {
      float v = out[o];
      for (int off = R >> 1; off > 0; off >>= 1)
        v += __shfl_down_sync(lanes0, v, off, R);
      if (t == 0) scratch[(size_t)blockIdx.x * (1 + p) + o] = v;
    }
  }
}

// floats of one row of a kernel, for m, d and R = rows rows a block
typedef int (*RowFloats)(int m, int d, int rows);

int factors_floats(int m, int d, int) { return factors_row_floats(m, d); }

int nll_floats(int m, int d, int rows) {
  return nll_row_floats(m, d, VF_BLOCK_THREADS / rows);
}

// rows per block: the largest R in {32, 16} whose block fits
// VF_SMEM_BUDGET, else 8; 0 outside the kernels' limits
int rows_per_block(int m, int d, RowFloats row_floats) {
  if (m < 1 || m > VF_MAX_M || d < 1 || d > VF_MAX_D) return 0;
  int rows = 32;
  while (rows > 8 &&
         rows * row_floats(m, d, rows) * (int)sizeof(float) > VF_SMEM_BUDGET)
    rows >>= 1;
  return rows;
}

int smem_bytes(int m, int d, RowFloats row_floats) {
  const int rows = rows_per_block(m, d, row_floats);
  return rows * row_floats(m, d, rows) * (int)sizeof(float);
}

// above 48 KB of dynamic shared memory a block must opt in (set per launch:
// attributes belong to the current device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= VF_SMEM_DEFAULT_MAX) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DMAX>
int launch_factors(const float* pars, const float* coords,
                   const int* neighbors, const float* row_coords, float* A,
                   float* D, int n, int m, int d, int shape,
                   int include_nugget, cudaStream_t st) {
  const int rows = rows_per_block(m, d, factors_floats);
  const int bytes = smem_bytes(m, d, factors_floats);
  const cudaError_t err = allow_smem(factors_kernel<DMAX>, bytes);
  if (err != cudaSuccess) return (int)err;
  factors_kernel<DMAX><<<(n + rows - 1) / rows, VF_BLOCK_THREADS, bytes,
                         st>>>(pars, coords, neighbors, row_coords, A, D, n,
                               m, d, shape, include_nugget, rows);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_nll_grad(const float* logp, const float* coords,
                    const int* neighbors, const float* row_coords,
                    const float* r, const float* row_r, const float* row_valid,
                    float* scratch, int n, int m, int d, int shape, int ard,
                    cudaStream_t st) {
  const int rows = rows_per_block(m, d, nll_floats);
  const int bytes = smem_bytes(m, d, nll_floats);
  const cudaError_t err = allow_smem(nll_grad_kernel<DMAX>, bytes);
  if (err != cudaSuccess) return (int)err;
  nll_grad_kernel<DMAX><<<(n + rows - 1) / rows, VF_BLOCK_THREADS, bytes,
                          st>>>(logp, coords, neighbors, row_coords, r, row_r,
                                row_valid, scratch, n, m, d, shape, ard, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vf_max_m() { return VF_MAX_M; }
int vf_max_d() { return VF_MAX_D; }

// rows per block of the NLL kernel, and its dynamic shared memory per block
// in bytes, for m neighbours in d dimensions (0 outside the limits); the
// caller sizes scratch as [ceil(n / rows), 1 + p]
int vf_nll_rows_per_block(int m, int d) {
  return rows_per_block(m, d, nll_floats);
}
int vf_nll_smem_bytes(int m, int d) { return smem_bytes(m, d, nll_floats); }

// the same for the factors kernel (its launch geometry, for a report)
int vf_factors_rows_per_block(int m, int d) {
  return rows_per_block(m, d, factors_floats);
}
int vf_factors_smem_bytes(int m, int d) {
  return smem_bytes(m, d, factors_floats);
}

// A [n, m], D [n] from pars = (var, nugget, scale_1..scale_d), coords
// [n_obs, d], neighbors int32 [n, m], row_coords [n, d]. All device
// pointers, f32 / int32, contiguous.
int vecchia_factors_launch(const float* pars, const float* coords,
                           const int* neighbors, const float* row_coords,
                           float* A, float* D, int n, int m, int d, int shape,
                           int include_nugget, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > VF_MAX_M || d < 1 || d > VF_MAX_D || shape < 0 ||
      shape > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 2)
    return launch_factors<2>(pars, coords, neighbors, row_coords, A, D, n, m,
                             d, shape, include_nugget, st);
  if (d <= 4)
    return launch_factors<4>(pars, coords, neighbors, row_coords, A, D, n, m,
                             d, shape, include_nugget, st);
  return launch_factors<VF_MAX_D>(pars, coords, neighbors, row_coords, A, D,
                                  n, m, d, shape, include_nugget, st);
}

// scratch [ceil(n / vf_nll_rows_per_block(m, d)), 3 + n_ranges] per-block
// sums of (nll without the 2 pi constant, gradient w.r.t. logp).
// row_valid may be null (all rows count).
int vecchia_nll_grad_launch(const float* logp, const float* coords,
                            const int* neighbors, const float* row_coords,
                            const float* r, const float* row_r,
                            const float* row_valid, float* scratch, int n,
                            int m, int d, int shape, int ard, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > VF_MAX_M || d < 1 || d > VF_MAX_D || shape < 0 ||
      shape > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 2)
    return launch_nll_grad<2>(logp, coords, neighbors, row_coords, r, row_r,
                              row_valid, scratch, n, m, d, shape, ard, st);
  if (d <= 4)
    return launch_nll_grad<4>(logp, coords, neighbors, row_coords, r, row_r,
                              row_valid, scratch, n, m, d, shape, ard, st);
  return launch_nll_grad<VF_MAX_D>(logp, coords, neighbors, row_coords, r,
                                   row_r, row_valid, scratch, n, m, d, shape,
                                   ard, st);
}

}  // extern "C"
