"""FITC (predictive process) and full-scale tapering (PyTorch port of
``gpboost_tpu/ops/fitc.py``; reference ``CreateREComponentsFITC_FSA``
``re_model_template.h:6919``, ``CalcCovFactorFITC_FSA`` :8770,
``CalcPredFITC_FSA`` :10600):

- FITC (gaussian): Psi = Q + Lambda, Q = C_nm C_mm^-1 C_mn,
  Lambda = diag(sigma1^2 - diag(Q)) + sigma2 I. Every solve goes through the
  Woodbury identity with one [k, k] Cholesky; no [n, n] matrix.
- full-scale tapering: Psi = Q + T o (Sigma - Q) + sigma2 I with a compactly
  supported Wendland taper T, dense (the Cholesky route).

Every dense function takes coordinates with optional leading batch
dimensions (``[..., n, d]``, inducing points ``[..., k, d]``): the equal-size
clusters of a ``cluster_ids`` model run as one batch.

The taper-sparse structure of full-scale tapering's iterative route
(reference ``CGFSA``, ``CG_utils.h:507-900``): the tapered residual
T o (Sigma - Q) has compact support, stored Vecchia-style as [n, k_t]
arrays — the indices of the other points within the taper range
(:func:`taper_neighbors`, -1 padded), their distances and taper values
(:class:`TaperStructure`), and the position of each pair's transpose
(``rev``). The residual's entries (:func:`fsa_taper_values`) and its
product (:func:`fsa_resid_mv`) are gathers, forward and backward: the
support is symmetric, so every transposed sum is a gather through ``rev``
and nothing scatters.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpboost_tpu_torch.ops.cov_fns import CovFunction, wendland_correlation

LOG_2PI = math.log(2.0 * math.pi)
JITTER = 1e-8


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of A [..., k, k]; a matrix that is not positive
    definite (parameters a line search overshot to) gives a NaN factor, so
    the NLL is NaN and the optimizer backs off, instead of an exception."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, math.nan)


def distance(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [..., n1, n2] from the coordinate differences,
    one dimension at a time: exactly 0 where two points coincide (an
    inducing point on a data point, the diagonal), where the inner-product
    formula leaves ~1e-8 of rounding that the covariance's slope turns into
    an error of the same size."""
    d2 = None
    for j in range(c1.shape[-1]):
        dj = c1[..., :, None, j] - c2[..., None, :, j]
        d2 = dj * dj if d2 is None else d2 + dj * dj
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def cov_between(cov_fn: CovFunction, gp_pars: torch.Tensor,
                c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Covariance [..., n1, n2] between two coordinate sets (isotropic:
    through :func:`distance`)."""
    if cov_fn.is_isotropic:
        return cov_fn.cov_matrix(gp_pars, dist=distance(c1, c2))
    return cov_fn.cov_between(gp_pars, c1, c2)


def _log_diag_sum(chol: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)


def inducing_cov(cov_fn: CovFunction, gp_pars: torch.Tensor,
                 ind_points: torch.Tensor) -> torch.Tensor:
    """C_mm with the reference's jitter (1e-8 sigma1^2 on the diagonal)."""
    c_mm = cov_between(cov_fn, gp_pars, ind_points, ind_points)
    return c_mm + JITTER * gp_pars[0] * _eye(ind_points.shape[-2], c_mm)


def fitc_parts(cov_fn: CovFunction, gp_pars: torch.Tensor,
               coords: torch.Tensor, ind_points: torch.Tensor, nugget):
    """(C_nm [..., n, k], L_mm, lambda [..., n], V = L_mm^-1 C_mn
    [..., k, n]); ``gp_pars`` = [sigma1^2, range, ...]."""
    c_nm = cov_between(cov_fn, gp_pars, coords, ind_points)
    l_mm = cholesky(inducing_cov(cov_fn, gp_pars, ind_points))
    v = torch.linalg.solve_triangular(l_mm, c_nm.mT, upper=False)
    lam = gp_pars[0] - torch.sum(v * v, dim=-2) + nugget
    return c_nm, l_mm, lam, v


def _woodbury_factor(c_nm, l_mm, lam):
    """Cholesky of M = C_mm + C_mn Lambda^-1 C_nm."""
    M = l_mm @ l_mm.mT + c_nm.mT @ (c_nm / lam[..., None])
    return cholesky(M)


def fitc_nll(cov_fn: CovFunction, cov_pars_full: torch.Tensor,
             coords: torch.Tensor, ind_points: torch.Tensor,
             r: torch.Tensor) -> torch.Tensor:
    """Gaussian FITC NLL by Woodbury, one value per batch entry;
    ``cov_pars_full`` = [nugget, sigma1^2, range, ...], r [..., n].
    logdet(Psi) = logdet(M) - logdet(C_mm) + sum log lambda."""
    c_nm, l_mm, lam, _ = fitc_parts(cov_fn, cov_pars_full[1:], coords,
                                    ind_points, cov_pars_full[0])
    l_M = _woodbury_factor(c_nm, l_mm, lam)
    rl = r / lam
    t = torch.linalg.solve_triangular(
        l_M, (c_nm.mT @ rl[..., None]), upper=False)[..., 0]
    quad = torch.sum(r * rl, -1) - torch.sum(t * t, -1)
    logdet = (2.0 * _log_diag_sum(l_M) - 2.0 * _log_diag_sum(l_mm)
              + torch.sum(torch.log(lam), -1))
    return 0.5 * (quad + logdet + r.shape[-1] * LOG_2PI)


def fitc_psi_inv_mul(cov_fn: CovFunction, cov_pars_full: torch.Tensor,
                     coords: torch.Tensor, ind_points: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """Psi^-1 R for FITC by Woodbury, R [..., n, q]."""
    c_nm, l_mm, lam, _ = fitc_parts(cov_fn, cov_pars_full[1:], coords,
                                    ind_points, cov_pars_full[0])
    l_M = _woodbury_factor(c_nm, l_mm, lam)
    Rl = R / lam[..., None]
    sol = torch.cholesky_solve(c_nm.mT @ Rl, l_M)
    return Rl - (c_nm @ sol) / lam[..., None]


def fitc_predict(cov_fn: CovFunction, cov_pars_full: torch.Tensor,
                 coords: torch.Tensor, ind_points: torch.Tensor,
                 coords_pred: torch.Tensor, r: torch.Tensor,
                 predict_response: bool, predict_var: bool,
                 predict_cov: bool = False):
    """FITC prediction (``CalcPredFITC_FSA``): cross-covariance
    Q_pn = C_pm C_mm^-1 C_mn, mean = Q_pn Psi^-1 r, covariance
    (Q_pp + diag(sigma1^2 - diag Q_pp)) - Q_pn Psi^-1 Q_np. The JAX package
    forms Q_pn [n_p, n]; here it stays in k-space: with V_p = L_mm^-1 C_mp
    and V = L_mm^-1 C_mn, Q_pn = V_p' V and Q_pn Psi^-1 Q_np = V_p' H V_p
    with H = V Psi^-1 V' = G - G (I + G)^-1 G, G = V Lambda^-1 V' [k, k] —
    no [n_p, n] matrix. Returns (mean, var, cov)."""
    nugget, gp_pars = cov_pars_full[0], cov_pars_full[1:]
    c_nm, l_mm, lam, v = fitc_parts(cov_fn, gp_pars, coords, ind_points,
                                    nugget)
    k = ind_points.shape[-2]
    # in V-space: Psi = V'V + Lambda, M~ = I + V Lambda^-1 V'
    G = (v / lam[..., None, :]) @ v.mT
    l_Mt = cholesky(_eye(k, G) + G)
    vr = v @ (r / lam)
    v_psi_r = vr - G @ torch.cholesky_solve(vr[:, None], l_Mt)[:, 0]
    c_pm = cov_between(cov_fn, gp_pars, coords_pred, ind_points)
    vp = torch.linalg.solve_triangular(l_mm, c_pm.mT, upper=False)  # [k, p]
    mean = vp.mT @ v_psi_r
    var = cov = None
    if predict_var or predict_cov:
        H = G - G @ torch.cholesky_solve(G, l_Mt)
        Hvp = H @ vp
        prior_diag = gp_pars[0] * torch.ones(coords_pred.shape[0],
                                             dtype=mean.dtype,
                                             device=mean.device)
        if predict_cov:
            q_pp = vp.mT @ vp
            cov = q_pp - vp.mT @ Hvp
            cov = cov + torch.diag(prior_diag - torch.diagonal(q_pp))
            if predict_response:
                cov = cov + nugget * _eye(cov.shape[0], cov)
            var = torch.diagonal(cov)
        else:
            var = prior_diag - torch.sum(vp * Hvp, dim=0)
            if predict_response:
                var = var + nugget
    return mean, var, cov


def fsa_psi(cov_fn: CovFunction, taper_range: float, taper_shape: float,
            taper_mu: float, cov_pars_full: torch.Tensor,
            coords: torch.Tensor, ind_points: torch.Tensor) -> torch.Tensor:
    """Full-scale approximation covariance, dense [..., n, n]:
    Psi = Q + T o (Sigma - Q) + nugget I (``CalcCovFactorFITC_FSA``)."""
    nugget, gp_pars = cov_pars_full[0], cov_pars_full[1:]
    n = coords.shape[-2]
    d_nn = distance(coords, coords)
    sigma = (cov_fn.cov_matrix(gp_pars, dist=d_nn) if cov_fn.is_isotropic
             else cov_fn.cov_matrix(gp_pars, coords1=coords, coords2=coords))
    c_nm = cov_between(cov_fn, gp_pars, coords, ind_points)
    Q = c_nm @ torch.linalg.solve(inducing_cov(cov_fn, gp_pars, ind_points),
                                  c_nm.mT)
    T = wendland_correlation(d_nn, taper_range, taper_shape, taper_mu)
    return Q + T * (sigma - Q) + nugget * _eye(n, Q)


def fsa_nll_from_psi(psi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Gaussian NLL of a dense Psi [..., n, n] at r [..., n] by Cholesky."""
    chol = cholesky(psi)
    alpha = torch.linalg.solve_triangular(chol, r[..., None],
                                          upper=False)[..., 0]
    return 0.5 * (torch.sum(alpha * alpha, -1) + 2.0 * _log_diag_sum(chol)
                  + r.shape[-1] * LOG_2PI)


# ---------------------------------------------------------------------------
# the taper-sparse structure of full-scale tapering's iterative route
# ---------------------------------------------------------------------------

# rows of the structure a chunk of the neighbour search holds ([c, n])
TAPER_SEARCH_CHUNK = 1024
# bytes a gathered block [c, k_t, q] of a product may take
TAPER_GATHER_BYTES = 1 << 30


class TaperStructure(NamedTuple):
    """The support of the tapered residual: ``idx`` [n, k_t] (int64, -1
    padded) the other points within the taper range, ``rev`` [n, k_t] the
    position of row i in row idx[i, j] (0 at padding), ``mask`` [n, k_t],
    ``dist`` [n, k_t] their distances and ``taper`` [n, k_t] the taper's
    values there (0 at padding). Built once from the coordinates."""
    idx: torch.Tensor
    rev: torch.Tensor
    mask: torch.Tensor
    dist: torch.Tensor
    taper: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _row_chunk(n: int, per_row_bytes: int, budget: int = TAPER_GATHER_BYTES):
    return max(1, min(n, budget // max(per_row_bytes, 1)))


def taper_neighbors(coords: torch.Tensor, taper_range: float,
                    chunk: int = TAPER_SEARCH_CHUNK) -> torch.Tensor:
    """[n, k_t] int64 indices of the OTHER points within the taper support
    of each point (distance < ``taper_range``, self excluded), nearest
    first, -1 padded; k_t is the largest in-radius count. Chunks of rows
    (distances from coordinate differences, :func:`distance`) and a
    ``topk`` per chunk, after a first pass that counts."""
    n = coords.shape[0]
    r2 = float(taper_range) ** 2

    def d2_chunk(s):
        rows = coords[s:s + chunk]
        d2 = None
        for j in range(coords.shape[1]):
            dj = rows[:, None, j] - coords[None, :, j]
            d2 = dj * dj if d2 is None else d2 + dj * dj
        ids = torch.arange(s, s + rows.shape[0], device=coords.device)
        ok = (d2 < r2) & (ids[:, None] != torch.arange(
            n, device=coords.device)[None, :])
        return d2, ok

    counts = torch.cat([d2_chunk(s)[1].sum(dim=1)
                        for s in range(0, n, chunk)])
    k_t = max(int(counts.max()), 1)
    out = []
    for s in range(0, n, chunk):
        d2, ok = d2_chunk(s)
        neg, ix = torch.topk(torch.where(ok, -d2, -math.inf), k_t, dim=1)
        out.append(torch.where(torch.isfinite(neg), ix, -1))
    return torch.cat(out)


def taper_structure(coords: torch.Tensor, taper_range: float,
                    taper_shape: float, taper_mu: float) -> TaperStructure:
    """:class:`TaperStructure` of ``coords`` [n, d] (the JAX package
    recomputes distances and the taper each evaluation; they are constant,
    so they are kept)."""
    idx = taper_neighbors(coords, taper_range)
    n, k_t = idx.shape
    mask = idx >= 0
    ixs = torch.clamp(idx, min=0)
    rev = torch.zeros_like(idx)
    step = _row_chunk(n, k_t * k_t)
    rows = torch.arange(n, device=idx.device)
    for s in range(0, n, step):
        hit = idx[ixs[s:s + step]] == rows[s:s + step, None, None]
        rev[s:s + step] = torch.argmax(hit.to(torch.int8), dim=2)
    d2 = None
    for j in range(coords.shape[1]):
        dj = coords[:, None, j] - coords[ixs, j]
        d2 = dj * dj if d2 is None else d2 + dj * dj
    pos = mask & (d2 > 0.0)
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    taper = torch.where(mask, wendland_correlation(
        dist, taper_range, taper_shape, taper_mu), 0.0)
    return TaperStructure(idx, torch.where(mask, rev, 0), mask, dist, taper)


def _transposed(g: torch.Tensor, ts: TaperStructure) -> torch.Tensor:
    """g^T on the support: out[i, j] = g[idx[i, j], rev[i, j]] (0 at
    padding) — a gather."""
    return torch.where(ts.mask, g[torch.clamp(ts.idx, min=0), ts.rev], 0.0)


def _pair_gather(W: torch.Tensor, coef: torch.Tensor, ts: TaperStructure
                 ) -> torch.Tensor:
    """out[i] = sum_j coef[i, j] W[idx[i, j]] for W [n, q]: a gather of
    W's rows and a batched [1, k_t] x [k_t, q] product, by chunks of rows
    within ``TAPER_GATHER_BYTES`` (on the CPU one sparse product, as
    ``ops/vecchia.py::apply_B`` there)."""
    n, k_t = ts.idx.shape
    q = W.shape[1]
    ixs = torch.clamp(ts.idx, min=0)
    if W.device.type == "cpu":
        rows = torch.arange(n, device=W.device)[:, None].expand_as(ts.idx)
        A = torch.sparse_coo_tensor(
            torch.stack([rows[ts.mask], ts.idx[ts.mask]]), coef[ts.mask],
            (n, n), check_invariants=False)
        return torch.sparse.mm(A, W)
    step = _row_chunk(n, k_t * q * W.element_size())
    out = []
    for s in range(0, n, step):
        c = coef[s:s + step]
        out.append(torch.bmm(c[:, None, :], W[ixs[s:s + step]])[:, 0])
    return torch.cat(out) if len(out) > 1 else out[0]


class _PairInner(torch.autograd.Function):
    """pq[i, j] = v[:, i] . v[:, idx[i, j]] for v [k, n] (0 at padding).
    Backward: grad v[:, i] = sum_j (G + G^T)[i, j] v[:, idx[i, j]], G^T
    through ``rev`` — gathers only."""

    @staticmethod
    def forward(ctx, v, ts):
        vt = v.T.contiguous()
        n, k_t = ts.idx.shape
        ixs = torch.clamp(ts.idx, min=0)
        step = _row_chunk(n, k_t * vt.shape[1] * vt.element_size())
        parts = []
        for s in range(0, n, step):
            parts.append(torch.bmm(vt[ixs[s:s + step]],
                                   vt[s:s + step, :, None])[:, :, 0])
        out = torch.where(ts.mask, torch.cat(parts), 0.0)
        ctx.save_for_backward(vt)
        ctx.ts = ts
        return out

    @staticmethod
    def backward(ctx, G):
        (vt,) = ctx.saved_tensors
        ts = ctx.ts
        G = torch.where(ts.mask, G, 0.0)
        gsym = G + _transposed(G, ts)
        return _pair_gather(vt, gsym, ts).T, None


class _ResidMatvec(torch.autograd.Function):
    """(R + diag) X with R[i, idx[i, j]] = vals[i, j], R symmetric, X [n]
    or [n, q]. Backward: grad X = (R + diag) G (R symmetric), grad vals =
    rows of G dotted with the gathered rows of X, grad diag = rowsum(G X)
    — gathers only."""

    @staticmethod
    def forward(ctx, vals, diag, X, ts):
        vec = X.dim() == 1
        X2 = X[:, None] if vec else X
        out = diag[:, None] * X2 + _pair_gather(X2, vals, ts)
        ctx.save_for_backward(vals, diag, X2)
        ctx.ts, ctx.vec = ts, vec
        return out[:, 0] if vec else out

    @staticmethod
    def backward(ctx, G):
        vals, diag, X2 = ctx.saved_tensors
        ts = ctx.ts
        G2 = G[:, None] if ctx.vec else G
        g_vals = g_diag = g_x = None
        if ctx.needs_input_grad[0]:
            n, k_t = ts.idx.shape
            ixs = torch.clamp(ts.idx, min=0)
            step = _row_chunk(n, k_t * X2.shape[1] * X2.element_size())
            parts = [torch.bmm(X2[ixs[s:s + step]],
                               G2[s:s + step, :, None])[:, :, 0]
                     for s in range(0, n, step)]
            g_vals = torch.where(ts.mask, torch.cat(parts), 0.0)
        if ctx.needs_input_grad[1]:
            g_diag = torch.sum(G2 * X2, dim=1)
        if ctx.needs_input_grad[2]:
            g_x = diag[:, None] * G2 + _pair_gather(G2, vals, ts)
            if ctx.vec:
                g_x = g_x[:, 0]
        return g_vals, g_diag, g_x, None


def fsa_taper_values(cov_fn: CovFunction, gp_pars: torch.Tensor,
                     v: torch.Tensor, ts: TaperStructure):
    """Tapered-residual entries on the support: vals[i, j] =
    T(d_ij) (k(d_ij) - p_i . p_j) for j = idx[i, :] (0 at padding) and
    diag[i] = sigma1^2 - |p_i|^2 (T(0) = 1), p_i = v[:, i] = L_mm^-1 C_m,i
    (the JAX package's ``fsa_taper_values``; the inner products by
    :class:`_PairInner`, never [n, k_t, k] at once)."""
    k_val = cov_fn.cov_matrix(gp_pars, dist=ts.dist)
    vals = ts.taper * (k_val - _PairInner.apply(v, ts))
    return vals, gp_pars[0] - torch.sum(v * v, dim=0)


def fsa_resid_mv(vals: torch.Tensor, diag: torch.Tensor, X: torch.Tensor,
                 ts: TaperStructure) -> torch.Tensor:
    """(T o (Sigma - Q) + diag(diag)) X on the support, X [n] or [n, q]: a
    gather-only product, forward and backward (the support is
    symmetric)."""
    return _ResidMatvec.apply(vals, diag, X, ts)
