"""Laplace-approximation pieces for non-Gaussian likelihoods (PyTorch port).

What the Vecchia-Laplace path needs of the JAX package's
``gpboost_tpu/models/laplace.py``:

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
- :func:`_response_moments`: response-scale mean and variance of a latent
  N(mu, var) (``PredictResponse`` / ``RespMeanAdaptiveGHQuadrature``,
  likelihoods.h:7526), closed forms where the reference has them, else
  Gauss-Hermite quadrature.

Not ported: the covariance-parametrised ``find_mode`` of the exact GP,
``gradient_wrt_F`` over a model specification (the grouped LaGaBoost
gradient) and ``test_nll_adaptive_gh`` (ROADMAP.md Queue A, items 11 and
16).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpboost_tpu_torch import likelihoods as lk

MAX_NEWTON_IT = 100
# stop when the objective changes by less than this, relative (the JAX
# package's Newton-CG mode finder's; its dense one stops at 1e-8)
NEWTON_TOL = 1e-9
MAX_HALVING = 60

_GH_DEG = 30
_GH_NODES, _GH_WEIGHTS = np.polynomial.hermite_e.hermegauss(_GH_DEG)
_GH_W_NORM = _GH_WEIGHTS / math.sqrt(2.0 * math.pi)


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
        grads = iter(torch.autograd.grad(g, wrt, grad_outputs=-lam,
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
