"""Laplace approximation for non-Gaussian likelihoods (PyTorch port of
``gpboost_tpu/models/laplace.py``).

- :func:`newton_mode` and :func:`mode_vjp`: the posterior mode of
  sum log p(y | F + Z b) - 1/2 b' Q b (Newton with step halving, reference
  ``FindModePostRandEffCalcMLL_Stable``, ``likelihoods.h:1843-1935``) and
  its implicit differentiation through the mode equation
  Q b = Z' d1(y, F + Z b) (one adjoint solve with Q + Z'WZ, then the
  vector-Jacobian product of the mode equation), for any solver of
  (Q + Z'WZ) x = r: dense here, CG in ``vecchia_model.py``, in the
  q-dimensional b-space of the grouped models in ``grouped.py`` (Z the
  incidence; the identity elsewhere);
- :func:`find_mode_prec`: that mode for a dense latent precision Q, as a
  ``torch.autograd.Function`` differentiable w.r.t. (Q, F, aux);
- :func:`find_mode`: the mode of an exact model, whose latent covariance
  Sigma [n, n] is dense, in the stable form of Rasmussen & Williams,
  Alg. 3.1 (``FindModePostRandEffCalcMLL_Stable``): each Newton step
  factors B = I + W^1/2 Sigma W^1/2 and tracks a = Sigma^-1 b, so Sigma is
  never inverted (a smooth Matern's Sigma^-1 is ill-conditioned); a
  ``torch.autograd.Function`` with the implicit backward (one solve with
  I + W Sigma);
- the Laplace NLL of a :class:`ModelSpec` (:func:`neg_log_marginal_likelihood`,
  :func:`nll_value_and_grad`), its gradient in the fixed effects F (the
  LaGaBoost gradient, :func:`gradient_wrt_F`), the predictor
  (:func:`predict`) and the predictive NLL by adaptive Gauss-Hermite
  quadrature (:func:`test_nll_adaptive_gh`);
- :func:`_response_moments`: response-scale mean and variance of a latent
  N(mu, var) (``PredictResponse`` / ``RespMeanAdaptiveGHQuadrature``,
  likelihoods.h:7526), closed forms where the reference has them, else
  Gauss-Hermite quadrature.

Observation weights multiply the log-likelihood, or are the trial counts of
the binomial-type families (``likelihoods.weighted_family``; JAX
``models/laplace.py:47-74, :253-290``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models.covariance import split_cov_pars, total_re_cov
from gpboost_tpu_torch.models.spec import ModelData, ModelSpec

MAX_NEWTON_IT = 100
# stop when the objective changes by less than this, relative (the JAX
# package's Newton-CG mode finder's; its dense one, find_mode, stops at
# DENSE_NEWTON_TOL)
NEWTON_TOL = 1e-9
DENSE_NEWTON_TOL = 1e-8
MAX_HALVING = 60

_GH_DEG = 30
_GH_NODES, _GH_WEIGHTS = np.polynomial.hermite_e.hermegauss(_GH_DEG)
_GH_W_NORM = _GH_WEIGHTS / math.sqrt(2.0 * math.pi)
# physicists' Hermite (weight e^{-x^2}) and the adaptive weights
# w_j e^{x_j^2} of test_nll_adaptive_gh
_GH_PHYS_NODES, _GH_PHYS_WEIGHTS = np.polynomial.hermite.hermgauss(_GH_DEG)
_GH_LOG_ADAPT_W = np.log(_GH_PHYS_WEIGHTS) + _GH_PHYS_NODES ** 2


def _aux_arg(aux, like: torch.Tensor) -> torch.Tensor:
    """aux as a tensor (empty for a family without any)."""
    if aux is None:
        return torch.zeros(0, dtype=like.dtype, device=like.device)
    return aux


def _aux_val(aux: torch.Tensor):
    return None if aux.numel() == 0 else aux


def newton_halving(b, psi, delta, objective):
    """One damped Newton step of the mode finders: from ``b`` (objective
    ``psi``, a host float) along ``delta``, halving the step while the
    objective falls below ``psi`` or is NaN, at most ``MAX_HALVING``
    times. Returns (b_new, psi_new as a host float, tries): one host read a
    try."""
    t = 1.0
    val = float(objective(b + delta))
    k = 0
    while (val < psi or math.isnan(val)) and k < MAX_HALVING:
        t *= 0.5
        val = float(objective(b + t * delta))
        k += 1
    return b + t * delta, val, k + 1


def newton_mode(fam, y, F, aux, q_mv, solve, counts=None, z=None, zt=None,
                size=None):
    """Posterior mode of psi(b) = sum log p(y | F + Z b) - 1/2 b' Q b by
    damped Newton: each step solves (Q + Z'WZ) delta = Z' d1 - Q b by
    ``solve(w, rhs)`` (w the [n] weights W), then :func:`newton_halving`;
    it stops when psi changes by less than ``NEWTON_TOL`` relative, or
    after ``MAX_NEWTON_IT`` steps. ``q_mv`` is v -> Q v. Z is the identity
    unless ``z`` (b -> Z b) and ``zt`` (v -> Z' v) are given, with b of
    ``size`` entries (the grouped models' b-space). With ``counts`` (a
    ``Counter``), adds the steps and the loop's host reads (objective
    values) to ``newton_steps`` and ``newton_reads``."""
    z = z or (lambda b: b)
    zt = zt or (lambda v: v)

    def objective(b):
        return torch.sum(fam.log_lik(y, F + z(b), aux)) \
            - 0.5 * torch.dot(b, q_mv(b))

    b = (torch.zeros_like(y) if size is None
         else torch.zeros(size, dtype=y.dtype, device=y.device))
    psi = float(objective(b))
    steps, reads = 0, 1
    for _ in range(MAX_NEWTON_IT):
        loc = F + z(b)
        d1 = fam.d_loc(y, loc, aux)
        w = torch.clamp(-fam.d2_loc(y, loc, aux), min=1e-10)
        delta = solve(w, zt(d1) - q_mv(b))
        b, psi_new, tries = newton_halving(b, psi, delta, objective)
        steps += 1
        reads += tries
        conv = abs(psi_new - psi) < NEWTON_TOL * (abs(psi) + 1e-10)
        psi = psi_new
        if conv:
            break
    if counts is not None:
        counts["newton_steps"] += steps
        counts["newton_reads"] += reads
    return b


def mode_vjp(fam, y, b, v, solve, qb, inputs, needs, z=None, zt=None):
    """Vector-Jacobian product of the mode b, defined by the mode equation
    g = Q(theta) b - Z' d1(y, F + Z b) = 0, by implicit differentiation:
    lam = (Q + Z'WZ)^-1 v by ``solve(w, v)``, then the VJP of g at -lam.
    ``inputs`` = (*theta, F, aux), ``qb(*theta)`` = Q(theta) b, ``needs``
    which inputs want a gradient; Z as in :func:`newton_mode` (``zt``
    differentiable). Returns a gradient (or None) per input."""
    z = z or (lambda x: x)
    zt = zt or (lambda x: x)
    F, aux = inputs[-2], inputs[-1]
    with torch.no_grad():
        lam = solve(-fam.d2_loc(y, F + z(b), _aux_val(aux)), v)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need and x.numel() > 0)
                  for x, need in zip(inputs, needs)]
        g = qb(*leaves[:-2]) - zt(fam.d_loc(y, leaves[-2] + z(b),
                                            _aux_val(leaves[-1])))
        wrt = [x for x in leaves if x.requires_grad]
        grads = iter(ag.grad(g, wrt, grad_outputs=-lam,
                           allow_unused=True) if wrt else ())
    out = []
    for x in leaves:
        gr = next(grads) if x.requires_grad else None
        if gr is None and x.requires_grad:
            gr = torch.zeros_like(x)
        out.append(gr)
    return out


def dense_solve(Q):
    """(w, rhs) -> (Q + diag(w))^-1 rhs, dense."""
    return lambda w, rhs: torch.linalg.solve(Q + torch.diag(w), rhs)


class _FindModePrec(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Q, F, aux, lik_name, y):
        fam = lk.get_family(lik_name)
        b = newton_mode(fam, y, F, _aux_val(aux), lambda v: Q @ v,
                        dense_solve(Q))
        ctx.save_for_backward(Q, F, aux, y, b)
        ctx.lik_name = lik_name
        return b

    @staticmethod
    def backward(ctx, v):
        Q, F, aux, y, b = ctx.saved_tensors
        out = mode_vjp(lk.get_family(ctx.lik_name), y, b, v, dense_solve(Q),
                       lambda Q_: Q_ @ b, (Q, F, aux),
                       ctx.needs_input_grad[:3])
        return out[0], out[1], out[2], None, None


def find_mode_prec(lik_name: str, Q: torch.Tensor, y: torch.Tensor,
                   F: torch.Tensor, aux) -> torch.Tensor:
    """Posterior mode with latent *precision* Q (= Sigma^-1), dense [n, n].
    Differentiable w.r.t. (Q, F, aux) by implicit differentiation."""
    return _FindModePrec.apply(Q, F, _aux_arg(aux, y), lik_name, y)


# ---------------------------------------------------------------------------
# exact models: the mode in the Sigma form, the NLL, its gradients, predict
# ---------------------------------------------------------------------------

def _mode_sigma(fam, sigma, y, F, aux):
    """Newton iterations in the stable parametrisation (R&W Alg. 3.1): the
    state is (b, a = Sigma^-1 b); a step solves with B = I + W^1/2 Sigma
    W^1/2 by its Cholesky, then halves along (db, da) while
    psi(b) = loglik - 1/2 a'b falls (JAX ``laplace.py:77-137``)."""
    n = y.shape[0]

    def objective(x):
        return torch.sum(fam.log_lik(y, F + x[:n], aux)) \
            - 0.5 * torch.dot(x[n:], x[:n])

    x = torch.zeros(2 * n, dtype=sigma.dtype, device=sigma.device)
    psi = float(objective(x))
    for _ in range(MAX_NEWTON_IT):
        b, a = x[:n], x[n:]
        loc = F + b
        d1 = fam.d_loc(y, loc, aux)
        w = torch.clamp(-fam.d2_loc(y, loc, aux), min=1e-10)
        sw = torch.sqrt(w)
        c = w * b + d1
        B = sw[:, None] * sigma * sw[None, :]
        B.diagonal().add_(1.0)
        L = torch.linalg.cholesky(B)
        del B
        t = torch.cholesky_solve((sw * (sigma @ c))[:, None], L)[:, 0]
        a_new = c - sw * t
        delta = torch.cat([sigma @ a_new - b, a_new - a])
        x, psi_new, _ = newton_halving(x, psi, delta, objective)
        conv = abs(psi_new - psi) < DENSE_NEWTON_TOL * (abs(psi) + 1e-10)
        psi = psi_new
        if conv:
            break
    return x[:n]


class _FindMode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sigma, F, aux, lik_name, y):
        fam = lk.get_family(lik_name)
        b = _mode_sigma(fam, sigma, y, F, _aux_val(aux))
        ctx.save_for_backward(sigma, F, aux, y, b)
        ctx.lik_name = lik_name
        return b

    @staticmethod
    def backward(ctx, v):
        """Implicit differentiation of g = b - Sigma d1(y, F + b) = 0:
        lam = (I + W Sigma)^-1 v, then the VJP of g at -lam."""
        sigma, F, aux, y, b = ctx.saved_tensors
        fam = lk.get_family(ctx.lik_name)
        with torch.no_grad():
            w = -fam.d2_loc(y, F + b, _aux_val(aux))
            M = w[:, None] * sigma
            M.diagonal().add_(1.0)
            lam = torch.linalg.solve(M, v)
            del M
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            F_ = F.detach().requires_grad_(needs[1])
            aux_ = aux.detach().requires_grad_(needs[2] and aux.numel() > 0)
            d1 = fam.d_loc(y, F_ + b, _aux_val(aux_))
            wrt = [t for t in (F_, aux_) if t.requires_grad]
            grads = iter(ag.grad(
                d1, wrt, grad_outputs=sigma @ lam) if wrt else ())
        # g's VJP at -lam: d(-lam' (b - Sigma d1)) = lam d1' (Sigma),
        # (Sigma lam)' d d1 (F, aux)
        g_sigma = torch.outer(lam, d1.detach()) if needs[0] else None
        g_F = next(grads) if F_.requires_grad else None
        g_aux = next(grads) if aux_.requires_grad else None
        return g_sigma, g_F, g_aux, None, None


def find_mode(lik_name: str, sigma: torch.Tensor, y: torch.Tensor,
              F: torch.Tensor, aux) -> torch.Tensor:
    """Posterior mode b* of sum log p(y | F + b) - 1/2 b' Sigma^-1 b for a
    dense latent covariance Sigma [n, n]; differentiable w.r.t. (Sigma, F,
    aux) by the implicit function theorem."""
    return _FindMode.apply(sigma, F, _aux_arg(aux, y), lik_name, y)


def _laplace_nll_from_sigma(lik_name, sigma, y, F, aux):
    """-log p(y) ~ -(loglik(b*) - 1/2 b*' Sigma^-1 b* - 1/2 logdet(I + W
    Sigma)); at the mode Sigma^-1 b* = d1, and the determinant is an LU's
    (W may be negative for the t and beta families), as in the JAX
    package."""
    fam = lk.get_family(lik_name)
    b = find_mode(lik_name, sigma, y, F, aux)
    loc = F + b
    d1 = fam.d_loc(y, loc, aux)
    w = -fam.d2_loc(y, loc, aux)
    loglik = torch.sum(fam.log_lik(y, loc, aux))
    M = w[:, None] * sigma
    M.diagonal().add_(1.0)
    _, logdet = torch.linalg.slogdet(M)
    return -(loglik - 0.5 * torch.dot(b, d1) - 0.5 * logdet)


def _latent_cov(spec: ModelSpec, data: ModelData, cov_pars: torch.Tensor):
    _, comp_pars = split_cov_pars(spec, cov_pars)
    return total_re_cov(spec, data, comp_pars)


def neg_log_marginal_likelihood(spec: ModelSpec, data: ModelData,
                                cov_pars: torch.Tensor, aux,
                                y: torch.Tensor,
                                F: Optional[torch.Tensor] = None):
    """Laplace-approximate NLL of an exact model (``EvalNegLogLikelihood``'s
    non-Gaussian branch, re_model_template.h:2646); differentiable in
    (cov_pars, aux, F)."""
    sigma = _latent_cov(spec, data, cov_pars)
    F = torch.zeros_like(y) if F is None else F
    return _laplace_nll_from_sigma(
        lk.weighted_family(spec.likelihood, data.weights), sigma, y, F, aux)


def nll_value_and_grad(spec: ModelSpec, data: ModelData,
                       cov_pars: torch.Tensor, aux, y: torch.Tensor,
                       X: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None,
                       fixed_effects: Optional[torch.Tensor] = None):
    """(nll, (d / d cov_pars, d / d aux or None, d / d beta or None)), by
    autograd; F = X beta + fixed_effects."""
    cp = cov_pars.detach().requires_grad_(True)
    ap = None if aux is None else aux.detach().requires_grad_(True)
    bt = None if beta is None else beta.detach().requires_grad_(True)
    with torch.enable_grad():
        F = fixed_effects
        if bt is not None:
            F = X @ bt if F is None else F + X @ bt
        v = neg_log_marginal_likelihood(spec, data, cp, ap, y, F)
        leaves = [t for t in (cp, ap, bt) if t is not None]
        grads = iter(ag.grad(v, leaves))
    return v.detach(), tuple(None if t is None else next(grads)
                             for t in (cp, ap, bt))


def gradient_wrt_F(spec: ModelSpec, data: ModelData, cov_pars: torch.Tensor,
                   aux, y: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """d NLL / dF at the fixed effects F: the LaGaBoost gradient
    (``CalcGradientF``, re_model_template.h:3021)."""
    Ft = F.detach().requires_grad_(True)
    with torch.enable_grad():
        v = neg_log_marginal_likelihood(spec, data, cov_pars.detach(),
                                        None if aux is None else aux.detach(),
                                        y, Ft)
        (g,) = ag.grad(v, Ft)
    return g


def test_nll_adaptive_gh(lik_name: str, y: torch.Tensor,
                         pred_mean: torch.Tensor, pred_var: torch.Tensor,
                         aux) -> torch.Tensor:
    """Per-point predictive NLL -log p(y_i), p(y) = int p(y | b) N(b; mu_i,
    var_i) db, by adaptive Gauss-Hermite quadrature
    (``TestNegLogLikelihoodAdaptiveGHQuadrature``, likelihoods.h:7931): 100
    Newton steps to the integrand's mode, then 30 nodes recentred there with
    the scale 1 / sqrt(information), in log space."""
    fam = lk.get_family(lik_name)
    sigma2_inv = 1.0 / pred_var
    mode = torch.zeros_like(pred_mean)
    for _ in range(100):
        d1 = fam.d_loc(y, mode, aux)
        info = -fam.d2_loc(y, mode, aux)
        mode = mode - (d1 - sigma2_inv * (mode - pred_mean)) \
            / (-info - sigma2_inv)
    info_m = -fam.d2_loc(y, mode, aux)
    sqrt2_sigma_hat = torch.sqrt(2.0 / (info_m + sigma2_inv))
    nodes = torch.as_tensor(_GH_PHYS_NODES, dtype=pred_mean.dtype,
                            device=pred_mean.device)
    log_w = torch.as_tensor(_GH_LOG_ADAPT_W, dtype=pred_mean.dtype,
                            device=pred_mean.device)
    x = mode[:, None] + sqrt2_sigma_hat[:, None] * nodes[None, :]
    ll = fam.log_lik(y[:, None], x, aux)
    z = torch.sqrt(sigma2_inv)[:, None] * (x - pred_mean[:, None])
    log_gauss = -0.5 * z * z - 0.5 * math.log(2.0 * math.pi)
    log_lik = torch.logsumexp(log_w[None, :] + ll + log_gauss, dim=1)
    log_lik = log_lik + torch.log(sqrt2_sigma_hat) + 0.5 * torch.log(
        sigma2_inv)
    return -log_lik


def predict(spec: ModelSpec, data: ModelData, cov_pars: torch.Tensor, aux,
            y: torch.Tensor, F: Optional[torch.Tensor], data_pred: ModelData,
            cross_dists: Optional[torch.Tensor], predict_var: bool,
            predict_cov_mat: bool, pred_dists: Optional[torch.Tensor] = None,
            F_pred: Optional[torch.Tensor] = None,
            predict_response: bool = True):
    """Laplace-approximate prediction of an exact model
    (``PredictLaplaceApproxStable``, R&W 3.27-3.29): latent mean
    Sigma_po d1(mode) + F_pred, variance Sigma_pp - Sigma_po W (I + Sigma
    W)^-1 Sigma_op; the response scale by :func:`_response_moments`.
    Returns (mean, var or None, cov or None)."""
    from gpboost_tpu_torch.models.gaussian import _prior_var_diag
    fam = lk.weighted_family(spec.likelihood, data.weights)
    _, comp_pars = split_cov_pars(spec, cov_pars)
    sigma = total_re_cov(spec, data, comp_pars)
    F = torch.zeros_like(y) if F is None else F
    b = find_mode(fam, sigma, y, F, aux)
    loc = F + b
    d1 = fam.d_loc(y, loc, aux)
    w = -fam.d2_loc(y, loc, aux)
    cross = total_re_cov(spec, data, comp_pars, data2=data_pred,
                         cross_dists=cross_dists)
    mean = cross @ d1
    if F_pred is not None:
        mean = mean + F_pred
    var = cov = None
    if predict_var or predict_cov_mat or predict_response:
        M = sigma * w[None, :]
        M.diagonal().add_(1.0)
        wz = w[:, None] * torch.linalg.solve(M, cross.T)    # [n, n_p]
        del M
        if predict_cov_mat:
            pred_self = ModelData(
                group_codes=data_pred.group_codes,
                slope_data=data_pred.slope_data, coords=data_pred.coords,
                dists=pred_dists,
                gp_rand_coef_data=data_pred.gp_rand_coef_data,
                cluster_codes=data_pred.cluster_codes)
            cov = total_re_cov(spec, pred_self, comp_pars) - cross @ wz
            var = torch.diagonal(cov).clone()
        else:
            var = _prior_var_diag(spec, data_pred, comp_pars) \
                - torch.sum(cross.T * wz, dim=0)
    if predict_response:
        mean_r, var_r = _response_moments(spec.likelihood, mean,
                                          torch.clamp(var, min=0.0), aux)
        return (mean_r, var_r if (predict_var or predict_cov_mat) else None,
                cov)
    return mean, var, cov


def _response_moments(lik_name, mu, var, aux):
    """E[mean(y) | latent ~ N(mu, var)] and Var via Gauss-Hermite quadrature
    (``PredictResponse`` / ``RespMeanAdaptiveGHQuadrature``,
    likelihoods.h:7526). Probit uses the closed form Phi(mu / sqrt(1 + var));
    t / beta_binomial / zero_inflated_gamma /
    zero_censored_power_transformed_normal follow the reference's
    family-specific formulas (likelihoods.h:7626-7755)."""
    fam = lk.get_family(lik_name)
    var = torch.clamp(var, min=0.0)
    if lik_name in ("bernoulli_probit", "binomial_probit"):
        p = torch.special.ndtr(mu / torch.sqrt(1.0 + var))
        return p, p * (1.0 - p)
    if lik_name in ("t", "t_fix_df"):
        # the t is treated as a robust-regression tool: add scale^2 to the
        # latent variance (likelihoods.h:7626-7633)
        return mu, var + aux[0] * aux[0]
    if lik_name == "beta_binomial":
        # second-order delta method, one trial (likelihoods.h:7689-7710)
        p = torch.sigmoid(mu)
        s = p * (1.0 - p)
        mean = p + 0.5 * s * (1.0 - 2.0 * p) * var
        var_of_mean = s * s * var
        s_dd = s * (1.0 - 6.0 * p + 6.0 * p * p)
        mean_of_var = torch.clamp(s + 0.5 * s_dd * var, 0.0, 0.25)
        return mean, var_of_mean + mean_of_var
    if lik_name == "zero_inflated_gamma":
        # lognormal closed forms (likelihoods.h:7711-7734); aux[1] = p0
        k, p0 = aux[0], aux[1]
        q = 1.0 - p0
        pm = torch.exp(mu + 0.5 * var)
        var_of_mean = (torch.exp(var) - 1.0) * pm * pm
        mean_of_var = ((1.0 + p0 * k) / (q * k)) * torch.exp(
            2.0 * mu + 2.0 * var)
        return pm, var_of_mean + mean_of_var
    nodes = torch.as_tensor(_GH_NODES, dtype=mu.dtype, device=mu.device)
    wts = torch.as_tensor(_GH_W_NORM, dtype=mu.dtype, device=mu.device)
    if lik_name == "zoctn":
        # Z ~ N(mu, var + sigma^2); y(Z) = censored outside (0, 1), else
        # sigmoid(a + b logit(Z)) (likelihoods.h:11517-11547)
        sigma, a, b = aux[0], aux[1], aux[2]
        s = torch.sqrt(var + sigma * sigma)
        z = mu[:, None] + s[:, None] * nodes[None, :]
        zc = torch.clamp(z, 1e-12, 1.0 - 1e-12)
        yv = torch.sigmoid(a + b * (torch.log(zc) - torch.log1p(-zc)))
        yv = torch.where(z <= 0.0, 0.0, torch.where(z >= 1.0, 1.0, yv))
        ey = yv @ wts
        ey2 = (yv * yv) @ wts
        return ey, torch.clamp(ey2 - ey * ey, min=0.0)
    if lik_name == "zero_censored_power_transformed_normal":
        # Y = max(0, X)^lambda, X ~ N(mu, var + sigma^2)
        # (likelihoods.h:7735-7755)
        sigma, lam = aux[0], aux[1]
        s = torch.sqrt(var + sigma * sigma)
        x = mu[:, None] + s[:, None] * nodes[None, :]
        xp = torch.clamp(x, min=0.0)
        ey = torch.pow(xp, lam) @ wts
        ey2 = torch.pow(xp, 2.0 * lam) @ wts
        return ey, torch.clamp(ey2 - ey * ey, min=0.0)
    sd = torch.sqrt(var)
    locs = mu[:, None] + sd[:, None] * nodes[None, :]
    m = fam.response_mean(locs, aux)
    mean = m @ wts
    if fam.response_var is not None:
        v_cond = fam.response_var(locs, aux)
        second = (v_cond + m * m) @ wts
        varr = torch.clamp(second - mean * mean, min=0.0)
    else:
        varr = None
    return mean, varr
