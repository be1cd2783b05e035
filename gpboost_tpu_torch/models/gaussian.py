"""Exact Gaussian likelihood by a dense Cholesky: NLL, profiled NLL, Fisher
information, prediction (PyTorch port of ``gpboost_tpu/models/gaussian.py``).

The Gaussian branches of ``REModelTemplate::EvalNegLogLikelihood``
(``re_model_template.h:2646``), ``CalcCovFactor`` (:8525),
``CalcFisherInformation`` (:9144) and ``CalcPred`` (:10026) for the exact
models (``gp_approx="none"``: a GP, GP random coefficients, grouped effects
beside a GP, ``cluster_ids``). With Psi = sigma2 Psi_tilde,
Psi_tilde = I + Sigma_total / sigma2 (``cov_fcts.h:433-496``):

    nll = r' Psi^-1 r / 2 + logdet(Psi) / 2 + n/2 log(2 pi),

and the profiled NLL puts the nugget at its optimum sigma2_hat =
r' Psi_tilde^-1 r / n (``re_model_template.h:2409``).

The dense work is ``torch.linalg``'s (the JAX package's is XLA's
``cholesky`` / ``solve_triangular``; no Pallas kernel). Value and gradient
go through one autograd Function, ``grouped.logdet_quad`` (logdet and the
quadratic form from one Cholesky, a backward of one ``cholesky_inverse``,
instead of autograd through the Cholesky's ~4 n^3); the Fisher information
takes p products Psi^-1 dPsi_i, one [n, n] derivative at a time, instead of
the [n, n, p] Jacobian. :func:`neg_log_likelihood_twice` keeps autograd
through ``torch.linalg.cholesky`` for the Hessian of Newton's method.
Observation ``weights`` divide the error variance: Psi = Sigma_total +
sigma2 diag(1/w) (JAX ``gaussian.py:40-46, :89-90``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch.models.covariance import split_cov_pars, total_re_cov
from gpboost_tpu_torch.models.grouped import logdet_quad
from gpboost_tpu_torch.models.spec import GroupedRESpec, ModelData, ModelSpec

LOG_2PI = math.log(2.0 * math.pi)


def _error_diag(data: ModelData, sigma2: torch.Tensor,
                n: int) -> torch.Tensor:
    """The error variances [n]: sigma2, or sigma2 / w_i with observation
    ``weights`` (a weight k counts as k replicates; JAX
    ``gaussian.py:40-46``)."""
    if data.weights is None:
        return sigma2.expand(n)
    return sigma2 / data.weights


def build_psi(spec: ModelSpec, data: ModelData,
              cov_pars: torch.Tensor) -> torch.Tensor:
    """Marginal covariance Psi = Sigma_total + sigma2 diag(1/w) [n, n]."""
    sigma2, comp_pars = split_cov_pars(spec, cov_pars)
    sig = total_re_cov(spec, data, comp_pars)
    return sig + torch.diag(_error_diag(data, sigma2, sig.shape[0]))


def neg_log_likelihood(spec: ModelSpec, data: ModelData,
                       cov_pars: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """Exact Gaussian NLL of the residual r = y - F at ``cov_pars``
    (R test fixture: 124.2549533, ``test_GPModel_gaussian_process.R:83``).
    Differentiable in ``cov_pars`` (one ``cholesky_inverse`` backward)."""
    sigma2, comp_pars = split_cov_pars(spec, cov_pars)
    sig = total_re_cov(spec, data, comp_pars)
    logdet, quad = logdet_quad(sig, _error_diag(data, sigma2, sig.shape[0]),
                               r)
    return 0.5 * (quad + logdet + r.shape[0] * LOG_2PI)


def neg_log_likelihood_twice(spec: ModelSpec, data: ModelData,
                             cov_pars: torch.Tensor,
                             r: torch.Tensor) -> torch.Tensor:
    """The same NLL by autograd through ``torch.linalg.cholesky`` and a
    triangular solve: differentiable twice (the Hessian of Newton's
    method)."""
    chol = torch.linalg.cholesky(build_psi(spec, data, cov_pars))
    alpha = torch.linalg.solve_triangular(chol, r[:, None], upper=False)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * (torch.dot(alpha, alpha) + logdet + r.shape[0] * LOG_2PI)


def _sigma_tilde(spec: ModelSpec, data: ModelData,
                 ratio_pars: torch.Tensor) -> torch.Tensor:
    """Sigma_total at ``ratio_pars`` (cov_pars[1:] with each variance
    relative to the nugget, ``TransformCovPars``, ``cov_fcts.h:433``);
    Psi_tilde is this plus I (the JAX package's ``_psi_tilde``; here the I
    goes into ``logdet_quad``'s diagonal)."""
    one = torch.ones(1, dtype=ratio_pars.dtype, device=ratio_pars.device)
    _, comp_pars = split_cov_pars(spec, torch.cat([one, ratio_pars]))
    return total_re_cov(spec, data, comp_pars)


def _one(ref: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=ref.dtype, device=ref.device)


def nll_profiled(spec: ModelSpec, data: ModelData, ratio_pars: torch.Tensor,
                 r: torch.Tensor):
    """Profiled NLL, the nugget at sigma2_hat = r' Psi_tilde^-1 r / n:
    returns (nll, sigma2_hat) (``re_model_template.h:2409,2890``)."""
    sig = _sigma_tilde(spec, data, ratio_pars)
    n = r.shape[0]
    logdet, quad = logdet_quad(sig, _error_diag(data, _one(sig), n), r)
    sigma2_hat = quad / n
    nll = 0.5 * n * (torch.log(sigma2_hat) + LOG_2PI + 1.0) + 0.5 * logdet
    return nll, sigma2_hat


def nll_given_sigma2(spec: ModelSpec, data: ModelData,
                     ratio_pars: torch.Tensor, sigma2: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """NLL at a given nugget in the ratio parametrisation."""
    sig = _sigma_tilde(spec, data, ratio_pars)
    n = r.shape[0]
    logdet, quad = logdet_quad(sig, _error_diag(data, _one(sig), n), r)
    return (quad / (2.0 * sigma2) + 0.5 * logdet
            + 0.5 * n * (torch.log(sigma2) + LOG_2PI))


def psi_cholesky(spec: ModelSpec, data: ModelData,
                 cov_pars: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of Psi."""
    return torch.linalg.cholesky(build_psi(spec, data, cov_pars))


def psi_inv_mul(spec: ModelSpec, data: ModelData, cov_pars: torch.Tensor,
                R: torch.Tensor) -> torch.Tensor:
    """Psi^-1 R for R [n] or [n, k]."""
    L = psi_cholesky(spec, data, cov_pars)
    if R.dim() == 1:
        return torch.cholesky_solve(R[:, None], L)[:, 0]
    return torch.cholesky_solve(R, L)


def wls_coefficients(spec: ModelSpec, data: ModelData,
                     cov_pars: torch.Tensor, y: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """GLS coefficients (X' Psi^-1 X)^-1 X' Psi^-1 y (the reference's 'wls'
    update, ``re_model_template.h:9125``): one Cholesky for both solves."""
    w = psi_inv_mul(spec, data, cov_pars, torch.cat([X, y[:, None]], 1))
    return torch.linalg.solve(X.T @ w[:, :-1], X.T @ w[:, -1])


def fisher_information(spec: ModelSpec, data: ModelData,
                       log_cov_pars: torch.Tensor) -> torch.Tensor:
    """Expected Fisher information of the log-scale covariance parameters,
    FI_jk = 0.5 tr(Psi^-1 dPsi_j Psi^-1 dPsi_k) (``CalcFisherInformation``,
    re_model_template.h:9144). dPsi_j is a forward-mode derivative of the
    covariance build, one parameter at a time, and S_j = Psi^-1 dPsi_j
    replaces it at once; FI_jk = 0.5 sum(S_j o S_k'). p + 2 live [n, n]
    matrices, where the JAX package's Jacobian holds [n, n, p]."""
    lp = log_cov_pars.detach()

    def psi_fn(t):
        return build_psi(spec, data, torch.exp(t))

    with torch.no_grad():
        chol = torch.linalg.cholesky(psi_fn(lp))
    p = lp.shape[0]
    s = []
    for j in range(p):
        tangent = torch.zeros_like(lp)
        tangent[j] = 1.0
        _, dpsi = torch.func.jvp(psi_fn, (lp,), (tangent,))
        s.append(torch.cholesky_solve(dpsi, chol))
        del dpsi
    fi = torch.empty((p, p), dtype=lp.dtype, device=lp.device)
    for j in range(p):
        for k in range(j, p):
            fi[j, k] = fi[k, j] = 0.5 * torch.sum(s[j] * s[k].T)
    return fi


def nll_profiled_value_and_grad(spec: ModelSpec, data: ModelData,
                                log_ratio_pars: torch.Tensor,
                                r: torch.Tensor):
    """(nll, d nll / d log_ratio_pars, sigma2_hat), by autograd."""
    th = log_ratio_pars.detach().requires_grad_(True)
    with torch.enable_grad():
        nll, s2 = nll_profiled(spec, data, torch.exp(th), r.detach())
        (g,) = ag.grad(nll, th)
    return nll.detach(), g, s2.detach()


def gradient_log_scale(spec: ModelSpec, data: ModelData,
                       log_cov_pars: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """d nll / d log(cov_pars), by autograd."""
    return nll_value_and_grad_log_scale(spec, data, log_cov_pars, r)[1]


def nll_value_and_grad_log_scale(spec: ModelSpec, data: ModelData,
                                 log_cov_pars: torch.Tensor,
                                 r: torch.Tensor):
    """(nll, d nll / d log(cov_pars)) in the full parametrisation."""
    th = log_cov_pars.detach().requires_grad_(True)
    with torch.enable_grad():
        v = neg_log_likelihood(spec, data, torch.exp(th), r.detach())
        (g,) = ag.grad(v, th)
    return v.detach(), g


def predict(spec: ModelSpec, data: ModelData, cov_pars: torch.Tensor,
            r: torch.Tensor, data_pred: ModelData,
            cross_dists: Optional[torch.Tensor], predict_var: bool,
            predict_cov_mat: bool, pred_dists: Optional[torch.Tensor] = None,
            predict_response: bool = True):
    """Exact posterior prediction of the random effects
    (``REModelTemplate::CalcPred``, :10026):

      mean = Sigma_po Psi^-1 r,
      cov  = Sigma_pp - Sigma_po Psi^-1 Sigma_op   (+ sigma2 I, response).

    Returns (mean, var or None, cov or None); the caller adds the fixed
    part of the prediction points."""
    sigma2, comp_pars = split_cov_pars(spec, cov_pars)
    chol = psi_cholesky(spec, data, cov_pars)
    cross = total_re_cov(spec, data, comp_pars, data2=data_pred,
                         cross_dists=cross_dists)
    mean = cross @ torch.cholesky_solve(r[:, None], chol)[:, 0]
    var = cov = None
    if predict_var or predict_cov_mat:
        v = torch.linalg.solve_triangular(chol, cross.T, upper=False)
        if predict_cov_mat:
            pred_self = ModelData(
                group_codes=data_pred.group_codes,
                slope_data=data_pred.slope_data, coords=data_pred.coords,
                dists=pred_dists,
                gp_rand_coef_data=data_pred.gp_rand_coef_data,
                cluster_codes=data_pred.cluster_codes)
            cov = total_re_cov(spec, pred_self, comp_pars) - v.T @ v
            if predict_response:
                cov.diagonal().add_(sigma2)
            var = torch.diagonal(cov).clone()
        else:
            var = _prior_var_diag(spec, data_pred, comp_pars) \
                - torch.sum(v * v, dim=0)
            if predict_response:
                var = var + sigma2
    return mean, var, cov


def _prior_var_diag(spec: ModelSpec, data_pred: ModelData,
                    comp_pars) -> torch.Tensor:
    """Diagonal of the prior random-effects covariance at the prediction
    points: a component's variance, for the non-stationary ``linear`` and
    ``hurst`` covariances sigma2 x'x and sigma2 (x'x)^H per point (JAX
    ``models/gaussian.py:255-285``)."""
    ref = comp_pars[0]
    n = (data_pred.coords.shape[0] if data_pred.coords is not None
         else data_pred.group_codes.shape[0])
    total = torch.zeros(n, dtype=ref.dtype, device=ref.device)
    for comp, pars in zip(spec.components, comp_pars):
        contrib = pars[0].expand(n)
        if isinstance(comp, GroupedRESpec):
            if comp.is_slope:
                z = data_pred.slope_data[:, comp.slope_data_idx]
                contrib = contrib * z * z
        else:
            kind = comp.cov_fn.cov_fct_type
            if kind in ("linear", "hurst"):
                sq = torch.sum(data_pred.coords * data_pred.coords, dim=1)
                contrib = pars[0] * (sq if kind == "linear" else torch.pow(
                    torch.clamp(sq, min=1e-300), pars[1]))
            if comp.is_random_coef:
                z = data_pred.gp_rand_coef_data[:, comp.rand_coef_data_idx]
                contrib = contrib * z * z
        total = total + contrib
    return total
