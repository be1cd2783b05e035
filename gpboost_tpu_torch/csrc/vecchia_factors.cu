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
// Layout: ONE THREAD PER ROW. The TPU kernels keep every pair entry as an
// (8, 128) tile over a 1024-row block and have the host pre-gather the
// neighbour coordinates because Mosaic has no gather; here a thread loads
// its own m indices and gathers its m neighbour coordinates from the
// coordinate table (L2-resident at the sizes in use). The packed lower
// triangle of C (m(m+1)/2 floats), overwritten in place by its Cholesky
// factor, lives in a per-thread local array sized by the template
// capacity MCAP; it does not fit in registers and is served by L1/L2.
//
// Bound: operations, not bytes. A row moves (m + d + 1) * 4 bytes in and
// (m + 1) * 4 bytes out but costs ~m^3/3 FLOPs of Cholesky plus
// m(m+1)/2 exp/sqrt covariance evaluations (twice in the NLL kernel, whose
// gradient pass recomputes the entries instead of storing dC).
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
// The sum over rows is deterministic: every block reduces its rows (warp
// shuffles, then shared memory) into one row of a [grid, 1 + p] scratch
// tensor, which the caller sums. No float atomics.
//
// Plain C interface (loaded with ctypes); kernels launch on the stream they
// are given, allocate nothing and do not synchronise. Each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#define VF_THREADS 128
#define VF_MAX_M 64
#define VF_MAX_D 8
#define VF_MAX_P (2 + VF_MAX_D)

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

// squared scaled distance; dist = d2 > 0 ? sqrt(d2) : 0 at the call site
__device__ __forceinline__ float scaled_d2(const float* p, const float* q,
                                           const float* s, int d) {
  float d2 = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float dk = (p[k] - q[k]) * s[k];
    d2 += dk * dk;
  }
  return d2;
}

__device__ __forceinline__ float dist_of(float d2) {
  return d2 > 0.0f ? sqrtf(d2) : 0.0f;
}

__device__ __forceinline__ int tri(int i) { return (i * (i + 1)) >> 1; }

// x <- C^-1 x with the packed factor Lp (reciprocal pivots on the diagonal)
__device__ __forceinline__ void chol_solve(const float* Lp, float* x, int m) {
  for (int j = 0; j < m; ++j) {
    const float* Lj = Lp + tri(j);
    float s = x[j];
    for (int k = 0; k < j; ++k) s -= Lj[k] * x[k];
    x[j] = s * Lj[j];
  }
  for (int j = m - 1; j >= 0; --j) {
    float s = x[j];
    for (int i = j + 1; i < m; ++i) s -= Lp[tri(i) + j] * x[i];
    x[j] = s * Lp[tri(j) + j];
  }
}

// Factors of one row. On return: xn = gathered neighbour coordinates
// [m, d], vmask = validity bits, c = masked c_iN (unsolved), a = masked
// C^-1 c, Lp = packed Cholesky factor of C; returns D.
template <int MCAP>
__device__ __forceinline__ float row_factors(
    const float* __restrict__ coords, const int* __restrict__ nbr_row,
    const float* row_x, const float* scale, float var, float var_ii, int m,
    int d, int shape, float* Lp, float* xn, float* c, float* a,
    unsigned long long& vmask) {
  vmask = 0ull;
  for (int j = 0; j < m; ++j) {
    const int idx = nbr_row[j];
    const bool valid = idx >= 0;
    if (valid) vmask |= 1ull << j;
    const float* src = coords + (size_t)(valid ? idx : 0) * d;
    for (int k = 0; k < d; ++k) xn[j * d + k] = src[k];
  }
  // covariance entries; invalid pair -> off-diagonal 0, diagonal 1
  for (int j = 0; j < m; ++j) {
    const bool vj = (vmask >> j) & 1ull;
    const float* xj = xn + j * d;
    c[j] = vj ? var * corr_x(dist_of(scaled_d2(row_x, xj, scale, d)), shape)
              : 0.0f;
    float* Bj = Lp + tri(j);
    for (int k = 0; k < j; ++k) {
      const bool vk = (vmask >> k) & 1ull;
      Bj[k] = (vj && vk)
                  ? var * corr_x(
                              dist_of(scaled_d2(xj, xn + k * d, scale, d)),
                              shape)
                  : 0.0f;
    }
    Bj[j] = vj ? var_ii : 1.0f;
  }
  // in-place Cholesky, row by row; the diagonal slot keeps 1 / L_jj
  for (int i = 0; i < m; ++i) {
    float* Li = Lp + tri(i);
    for (int j = 0; j < i; ++j) {
      const float* Lj = Lp + tri(j);
      float s = Li[j];
      for (int k = 0; k < j; ++k) s -= Li[k] * Lj[k];
      Li[j] = s * Lj[j];
    }
    float s = Li[i];
    for (int k = 0; k < i; ++k) s -= Li[k] * Li[k];
    Li[i] = 1.0f / sqrtf(fmaxf(s, 1e-30f));
  }
  for (int j = 0; j < m; ++j) a[j] = c[j];
  chol_solve(Lp, a, m);
  float d_cond = var_ii;
  for (int j = 0; j < m; ++j) {
    if (!((vmask >> j) & 1ull)) a[j] = 0.0f;
    d_cond -= c[j] * a[j];  // D from the unsolved c
  }
  return d_cond;
}

// pars = (var, nugget, scale_1..scale_d)
template <int MCAP>
__global__ void __launch_bounds__(VF_THREADS)
factors_kernel(const float* __restrict__ pars,
               const float* __restrict__ coords,
               const int* __restrict__ neighbors,
               const float* __restrict__ row_coords, float* __restrict__ A,
               float* __restrict__ D, int n, int m, int d, int shape,
               int include_nugget) {
  const int i = blockIdx.x * VF_THREADS + threadIdx.x;
  if (i >= n) return;
  float Lp[MCAP * (MCAP + 1) / 2];
  float xn[MCAP * VF_MAX_D];
  float c[MCAP];
  float a[MCAP];
  float scale[VF_MAX_D];
  float row_x[VF_MAX_D];
  const float var = pars[0];
  const float var_ii = var + (include_nugget ? pars[1] : 0.0f);
  for (int k = 0; k < d; ++k) {
    scale[k] = pars[2 + k];
    row_x[k] = row_coords[(size_t)i * d + k];
  }
  unsigned long long vmask;
  const float d_cond = row_factors<MCAP>(
      coords, neighbors + (size_t)i * m, row_x, scale, var, var_ii, m, d,
      shape, Lp, xn, c, a, vmask);
  float* a_out = A + (size_t)i * m;
  for (int j = 0; j < m; ++j) a_out[j] = a[j];
  D[i] = d_cond;
}

// logp = log(nugget, var, range) or log(nugget, var, rho_1..rho_d) (ard).
// scratch [grid, 1 + p], p = 2 + n_ranges: per-block sums of
// (l, dl/dlog nugget, dl/dlog var, dl/dlog range_k...).
template <int MCAP>
__global__ void __launch_bounds__(VF_THREADS)
nll_grad_kernel(const float* __restrict__ logp,
                const float* __restrict__ coords,
                const int* __restrict__ neighbors,
                const float* __restrict__ row_coords,
                const float* __restrict__ r, const float* __restrict__ row_r,
                const float* __restrict__ row_valid,
                float* __restrict__ scratch, int n, int m, int d, int shape,
                int ard) {
  const int i = blockIdx.x * VF_THREADS + threadIdx.x;
  const int n_ranges = ard ? d : 1;
  const int p = 2 + n_ranges;
  float out[1 + VF_MAX_P];
  for (int t = 0; t <= p; ++t) out[t] = 0.0f;

  if (i < n) {
    float Lp[MCAP * (MCAP + 1) / 2];
    float xn[MCAP * VF_MAX_D];
    float c[MCAP];
    float a[MCAP];
    float u[MCAP];
    float scale[VF_MAX_D];
    float row_x[VF_MAX_D];
    float q[VF_MAX_D];
    // per range parameter: a.dC.a, u.dC.a, a.dc, u.dc
    float s_aa[VF_MAX_D], s_ua[VF_MAX_D], s_ac[VF_MAX_D], s_uc[VF_MAX_D];

    const float nugget = expf(logp[0]);
    const float var = expf(logp[1]);
    const float var_ii = var + nugget;
    const float mc = shape == 1 ? 1.7320508075688772f
                                : (shape == 2 ? 2.23606797749979f : 1.0f);
    for (int k = 0; k < d; ++k) {
      scale[k] = mc * expf(-logp[2 + (ard ? k : 0)]);
      row_x[k] = row_coords[(size_t)i * d + k];
    }
    const int* nbr_row = neighbors + (size_t)i * m;
    unsigned long long vmask;
    const float d_cond = row_factors<MCAP>(coords, nbr_row, row_x, scale,
                                           var, var_ii, m, d, shape, Lp, xn,
                                           c, a, vmask);
    // u = C^-1 r_N (masked residuals), e = r_i - a.r_N
    float e = row_r[i];
    for (int j = 0; j < m; ++j) {
      const int idx = nbr_row[j];
      u[j] = idx >= 0 ? r[idx] : 0.0f;
      e -= a[j] * u[j];
    }
    chol_solve(Lp, u, m);

    // bilinear forms; invalid slots have a = u = 0 and are skipped
    float sum_aa = 0.0f, sum_ua = 0.0f;          // sum a_j^2, sum u_j a_j
    float v_aa = 0.0f, v_ua = 0.0f;              // a.C0.a, u.C0.a (C0 = var corr)
    float v_ac = 0.0f, v_uc = 0.0f;              // a.c, u.c
    for (int k = 0; k < n_ranges; ++k) {
      s_aa[k] = 0.0f; s_ua[k] = 0.0f; s_ac[k] = 0.0f; s_uc[k] = 0.0f;
    }
    for (int j = 0; j < m; ++j) {
      if (!((vmask >> j) & 1ull)) continue;
      const float* xj = xn + j * d;
      const float aj = a[j], uj = u[j];
      sum_aa += aj * aj;
      sum_ua += uj * aj;
      {
        float d2 = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float dk = (row_x[k] - xj[k]) * scale[k];
          q[k] = dk * dk;
          d2 += q[k];
        }
        float corr, g;
        corr_and_g(dist_of(d2), shape, corr, g);
        v_ac += aj * (var * corr);
        v_uc += uj * (var * corr);
        const float vg = var * g;
        if (ard) {
          for (int k = 0; k < d; ++k) {
            s_ac[k] += aj * (vg * q[k]);
            s_uc[k] += uj * (vg * q[k]);
          }
        } else {
          s_ac[0] += aj * (vg * d2);
          s_uc[0] += uj * (vg * d2);
        }
      }
      for (int k2 = 0; k2 < j; ++k2) {
        if (!((vmask >> k2) & 1ull)) continue;
        const float* xk = xn + k2 * d;
        float d2 = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float dk = (xj[k] - xk[k]) * scale[k];
          q[k] = dk * dk;
          d2 += q[k];
        }
        float corr, g;
        corr_and_g(dist_of(d2), shape, corr, g);
        const float w_aa = 2.0f * aj * a[k2];
        const float w_ua = uj * a[k2] + u[k2] * aj;
        v_aa += w_aa * (var * corr);
        v_ua += w_ua * (var * corr);
        const float vg = var * g;
        if (ard) {
          for (int k = 0; k < d; ++k) {
            s_aa[k] += w_aa * (vg * q[k]);
            s_ua[k] += w_ua * (vg * q[k]);
          }
        } else {
          s_aa[0] += w_aa * (vg * d2);
          s_ua[0] += w_ua * (vg * d2);
        }
      }
    }
    // diagonal of C0 is var on valid slots
    v_aa += var * sum_aa;
    v_ua += var * sum_ua;

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
    for (int k = 0; k < n_ranges; ++k)
      out[3 + k] = g_D * (s_aa[k] - 2.0f * s_ac[k]) + g_e * (s_ua[k] - s_uc[k]);
  }

  // block reduction: warp shuffles, then one slot per warp in shared memory
  __shared__ float warp_sums[VF_THREADS / 32][1 + VF_MAX_P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = 0; t <= p; ++t) {
    float v = out[t];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x <= p) {
    float v = 0.0f;
    for (int wi = 0; wi < VF_THREADS / 32; ++wi) v += warp_sums[wi][threadIdx.x];
    scratch[(size_t)blockIdx.x * (1 + p) + threadIdx.x] = v;
  }
}

inline int grid_for(int n) { return (n + VF_THREADS - 1) / VF_THREADS; }

}  // namespace

extern "C" {

int vf_block_threads() { return VF_THREADS; }
int vf_max_m() { return VF_MAX_M; }
int vf_max_d() { return VF_MAX_D; }

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
  const dim3 grid(grid_for(n)), block(VF_THREADS);
  if (m <= 24)
    factors_kernel<24><<<grid, block, 0, st>>>(
        pars, coords, neighbors, row_coords, A, D, n, m, d, shape,
        include_nugget);
  else if (m <= 40)
    factors_kernel<40><<<grid, block, 0, st>>>(
        pars, coords, neighbors, row_coords, A, D, n, m, d, shape,
        include_nugget);
  else
    factors_kernel<VF_MAX_M><<<grid, block, 0, st>>>(
        pars, coords, neighbors, row_coords, A, D, n, m, d, shape,
        include_nugget);
  return (int)cudaGetLastError();
}

// scratch [grid, 3 + n_ranges] per-block sums of (nll without the 2 pi
// constant, gradient w.r.t. logp); grid = ceil(n / vf_block_threads()).
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
  const dim3 grid(grid_for(n)), block(VF_THREADS);
  if (m <= 24)
    nll_grad_kernel<24><<<grid, block, 0, st>>>(
        logp, coords, neighbors, row_coords, r, row_r, row_valid, scratch, n,
        m, d, shape, ard);
  else if (m <= 40)
    nll_grad_kernel<40><<<grid, block, 0, st>>>(
        logp, coords, neighbors, row_coords, r, row_r, row_valid, scratch, n,
        m, d, shape, ard);
  else
    nll_grad_kernel<VF_MAX_M><<<grid, block, 0, st>>>(
        logp, coords, neighbors, row_coords, r, row_r, row_valid, scratch, n,
        m, d, shape, ard);
  return (int)cudaGetLastError();
}

}  // extern "C"
