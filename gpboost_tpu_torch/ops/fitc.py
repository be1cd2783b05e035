"""FITC (predictive process) and full-scale tapering (PyTorch port of
``gpboost_tpu/ops/fitc.py``; reference ``CreateREComponentsFITC_FSA``
``re_model_template.h:6919``, ``CalcCovFactorFITC_FSA`` :8770,
``CalcPredFITC_FSA`` :10600):

- FITC (gaussian): Psi = Q + Lambda, Q = C_nm C_mm^-1 C_mn,
  Lambda = diag(sigma1^2 - diag(Q)) + sigma2 I. Every solve goes through the
  Woodbury identity with one [k, k] Cholesky; no [n, n] matrix.
- full-scale tapering: Psi = Q + T o (Sigma - Q) + sigma2 I with a compactly
  supported Wendland taper T, dense (the Cholesky route).

Every function takes coordinates with optional leading batch dimensions
(``[..., n, d]``, inducing points ``[..., k, d]``): the equal-size clusters of
a ``cluster_ids`` model run as one batch. The taper-sparse iterative route of
full-scale tapering (the JAX module's ``taper_neighbors`` /
``fsa_taper_values`` / ``fsa_resid_mv``) is not ported (ROADMAP.md Queue A,
item 12).
"""
from __future__ import annotations

import math

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
