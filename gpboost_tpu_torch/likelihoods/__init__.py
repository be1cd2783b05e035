"""Likelihood families for non-Gaussian observation models (PyTorch port).

The JAX package's ``gpboost_tpu/likelihoods/__init__.py``, family for
family: the response distributions of the reference's
``include/GPBoost/likelihoods.h`` (parametrizations documented at
``likelihoods.h:10-70``) as elementwise log-densities. First, second and
third derivatives w.r.t. the location parameter — hand-derived in the
reference (``CalcFirstDerivLogLik`` :8975, ``CalcInformationLogLik``
:9477) — come from nested ``torch.autograd.grad(create_graph=True)`` (on the
calling thread, :mod:`gpboost_tpu_torch.utils.autograd`), which yields the
same closed forms.

``location_par`` is always the sum of fixed and random effects; the response
mean is linked via exp() (count/positive families), the logistic function
(bernoulli_logit, beta, beta_binomial), the normal CDF (probit families), or
identity (gaussian, t).

The two zero-one-censored families (``zero_one_censored_transformed_beta``,
``zero_one_censored_shifted_gamma``) take the incomplete beta / gamma
functions with shape derivatives of ``likelihoods/special.py``.
``gaussian_heteroscedastic`` is registered for its name:
its two-set model is ``models/heteroscedastic.py``, and the single-location
functions of its entry raise, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag

LOG_2PI = math.log(2.0 * math.pi)


def _canonical(name: str) -> str:
    aliases = {
        "binary": "bernoulli_probit", "binary_probit": "bernoulli_probit",
        "binary_logit": "bernoulli_logit", "regression": "gaussian",
        # NB: "zoctn" (zero-ONE-censored transformed normal) is its own
        # family, distinct from zero_censored_power_transformed_normal
        "gamma_zero_inflated": "zero_inflated_gamma",
        "betabinomial": "beta_binomial",
        "student_t": "t", "student-t": "t",
    }
    return aliases.get(name, name)


def parse_likelihood_variants(name: str):
    """Strip approximation-type suffixes from a likelihood name
    (``ParseLikelihoodAliasApproximationType``, likelihoods.h:8052):
    returns (canonical base name, approximation_type or None)."""
    approx = None
    for suf, val in (("_fisher_laplace_combined", "laplace"),
                     ("_fisher-laplace", "fisher_laplace"),
                     ("_fisher_laplace", "fisher_laplace"),
                     ("_lls_laplace", "lss_laplace"),
                     ("_quasi-newton", "laplace"),
                     ("_quasi_newton", "laplace")):
        if name.endswith(suf):
            approx = val
            name = name[:-len(suf)]
            break
    return _canonical(name), approx


class _Trigamma(torch.autograd.Function):
    """psi'(x) as the Hurwitz zeta(2, x): PyTorch's own trigamma is off by
    up to ~5e-10 relative (its higher orders, through the zeta function,
    are accurate)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.special.zeta(torch.full_like(x, 2.0), x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.polygamma(2, x)


class _Digamma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.digamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _Trigamma.apply(x)


class _LGamma(torch.autograd.Function):
    """log Gamma(x) whose derivatives of every order are accurate to float64
    rounding (digamma, then the zeta-based trigamma)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _Digamma.apply(x)


def gammaln(x: torch.Tensor) -> torch.Tensor:
    return _LGamma.apply(x)


def _keep_graph(loc: torch.Tensor, aux) -> bool:
    """Whether a derivative must stay differentiable: the caller builds a
    graph through ``loc`` or ``aux``."""
    return torch.is_grad_enabled() and (
        loc.requires_grad
        or (isinstance(aux, torch.Tensor) and aux.requires_grad))


def _derivative(fn: Callable, loc: torch.Tensor, keep: bool) -> torch.Tensor:
    """Elementwise d/dloc of sum(fn(loc)); differentiable again when
    ``keep`` (``create_graph``), detached otherwise."""
    with torch.enable_grad():
        x = loc if (keep and loc.requires_grad) \
            else loc.detach().requires_grad_(True)
        out = torch.sum(fn(x))
        if not out.requires_grad:           # fn constant in loc
            return torch.zeros_like(loc)
        (g,) = ag.grad(out, x, create_graph=keep)
    return g


@dataclass(frozen=True)
class LikelihoodFamily:
    """One response family: elementwise log-density + metadata.

    ``log_lik(y, loc, aux) -> [n]`` where ``aux`` are the additional
    parameters on the ORIGINAL scale (e.g. gamma shape), a tensor (or None
    for a family without any). The reference stores them log-transformed for
    optimization; the transform lives in the fit loop, not here.
    """
    name: str
    num_aux_pars: int
    aux_names: Tuple[str, ...]
    log_lik: Callable
    # mean of the response given the LATENT location parameter (link inverse)
    response_mean: Callable
    # variance of the response given latent location (for response predictions)
    response_var: Optional[Callable] = None
    discrete: bool = False
    default_aux: Tuple[float, ...] = ()
    # clamp negative observed information to zero (censored likelihoods:
    # reference SecondDerivNegLogLik* returns 0 when H < 0,
    # ``information_ll_can_be_exact_zero_``, likelihoods.h:311,319)
    clip_information: bool = False
    # binomial-type families: weights are the NUMBER OF TRIALS, entering
    # the density non-multiplicatively (likelihoods.h:30-56)
    log_lik_weighted: Optional[Callable] = None
    # per-aux-parameter optimization transform: "log" (positive, default),
    # "identity" (real-valued), "logit" (in (0, 1))
    aux_transforms: Optional[Tuple[str, ...]] = None
    # FISHER-Laplace families (reference approximation_type_ =
    # "fisher_laplace", the default for t, likelihoods.h:207): the Laplace
    # machinery uses the EXPECTED information fisher_loc(y, loc, aux)
    # instead of the observed -d2
    fisher_loc: Optional[Callable] = None

    def default_aux_pars(self, additional_param=None):
        if self.num_aux_pars == 0:
            return None
        base = list(self.default_aux)
        if additional_param is not None:
            base[0] = float(additional_param)
        return np.asarray(base, dtype=float)

    # ---- derivatives w.r.t. location via nested autograd ----------------
    def d_loc(self, y, loc, aux):
        """First derivative of sum(log_lik) w.r.t. location (elementwise)."""
        return _derivative(lambda x: self.log_lik(y, x, aux), loc,
                           _keep_graph(loc, aux))

    def d2_loc(self, y, loc, aux):
        """Diagonal second derivative (elementwise; negative = information).

        Fisher-Laplace families return the NEGATIVE expected information so
        every Laplace consumer runs the reference's fisher_laplace
        approximation."""
        if self.fisher_loc is not None:
            return -self.fisher_loc(y, loc, aux)
        d2 = _derivative(lambda x: self.d_loc(y, x, aux), loc,
                         _keep_graph(loc, aux))
        if self.clip_information:
            d2 = torch.clamp(d2, max=0.0)
        return d2

    def d3_loc(self, y, loc, aux):
        return _derivative(lambda x: self.d2_loc(y, x, aux), loc,
                           _keep_graph(loc, aux))


_REGISTRY: dict[str, LikelihoodFamily] = {}


def _register(fam: LikelihoodFamily):
    _REGISTRY[fam.name] = fam
    return fam


def get_family(name) -> LikelihoodFamily:
    """The family of a likelihood name (a family, e.g. one of
    :func:`weighted_family`, is returned as it is)."""
    if isinstance(name, LikelihoodFamily):
        return name
    name = _canonical(name)
    if name not in _REGISTRY:
        raise ValueError(
            f"Likelihood '{name}' is not supported. Available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def weighted_family(lik, weights: Optional[torch.Tensor]
                    ) -> LikelihoodFamily:
    """The family with observation ``weights`` (the reference's
    ``weights``; the JAX package's ``laplace._weighted_fns``): the
    binomial-type families take them as trial counts inside the density
    (``log_lik_weighted``), every other family's log-likelihood (and its
    Fisher information) is multiplied by them. Without weights the family
    itself."""
    fam = get_family(lik)
    if weights is None:
        return fam
    if fam.log_lik_weighted is not None:
        return dataclasses.replace(
            fam, log_lik=lambda y, loc, aux: fam.log_lik_weighted(
                y, loc, aux, weights))
    return dataclasses.replace(
        fam, log_lik=lambda y, loc, aux: weights * fam.log_lik(y, loc, aux),
        fisher_loc=None if fam.fisher_loc is None else (
            lambda y, loc, aux: weights * fam.fisher_loc(y, loc, aux)))


def supported_likelihoods():
    return sorted(_REGISTRY)


# ---- aux-parameter optimization transforms --------------------------------

def aux_transform_kinds(fam: LikelihoodFamily, n_aux: int):
    return (list(fam.aux_transforms) if fam.aux_transforms is not None
            else ["log"] * n_aux)[:n_aux]


def aux_to_optim_scale(fam, a):
    """User scale -> optimizer scale (numpy, host side)."""
    a = np.asarray(a, np.float64)
    out = []
    for v, t in zip(a, aux_transform_kinds(fam, len(a))):
        if t == "log":
            out.append(math.log(max(v, 1e-300)))
        elif t == "logit":
            vc = min(max(v, 1e-12), 1.0 - 1e-12)
            out.append(math.log(vc / (1.0 - vc)))
        else:
            out.append(float(v))
    return np.asarray(out)


def aux_from_optim_scale(fam, t_aux: torch.Tensor) -> torch.Tensor:
    """Optimizer scale -> user scale (tensor, differentiable)."""
    parts = []
    for i, t in enumerate(aux_transform_kinds(fam, t_aux.shape[0])):
        if t == "log":
            parts.append(torch.exp(t_aux[i]))
        elif t == "logit":
            parts.append(torch.sigmoid(t_aux[i]))
        else:
            parts.append(t_aux[i])
    return torch.stack(parts)


def aux_chain_factors(fam, theta_aux):
    """d(user aux)/d(optimizer par), elementwise (numpy)."""
    theta_aux = np.asarray(theta_aux, np.float64)
    out = []
    for i, t in enumerate(aux_transform_kinds(fam, len(theta_aux))):
        if t == "log":
            out.append(np.exp(theta_aux[i]))
        elif t == "logit":
            s = 1.0 / (1.0 + np.exp(-theta_aux[i]))
            out.append(s * (1.0 - s))
        else:
            out.append(1.0)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# families (parametrizations: likelihoods.h:10-70)
# ---------------------------------------------------------------------------

def _softplus(x):
    # log(1 + exp(x)) without overflow: jax.nn.softplus, not the thresholded
    # torch.nn.functional.softplus
    return torch.logaddexp(x, torch.zeros_like(x))


def _norm_logpdf(z):
    return -0.5 * z * z - 0.5 * LOG_2PI


def _ll_gaussian(y, loc, aux):
    # aux[0] = error variance sigma2 (the family exists for generic paths)
    s2 = aux[0]
    return -0.5 * (LOG_2PI + torch.log(s2) + (y - loc) ** 2 / s2)


_register(LikelihoodFamily(
    "gaussian", 1, ("error_variance",), _ll_gaussian,
    response_mean=lambda loc, aux: loc,
    response_var=lambda loc, aux: torch.full_like(loc, float(aux[0])),
    default_aux=(1.0,)))


def _ll_bernoulli_probit(y, loc, aux):
    # y in {0,1}: y log Phi(loc) + (1-y) log Phi(-loc), stable via log_ndtr
    return (y * torch.special.log_ndtr(loc)
            + (1.0 - y) * torch.special.log_ndtr(-loc))


def _probit_var(loc, aux):
    p = torch.special.ndtr(loc)
    return p * (1.0 - p)


_register(LikelihoodFamily(
    "bernoulli_probit", 0, (), _ll_bernoulli_probit,
    response_mean=lambda loc, aux: torch.special.ndtr(loc),
    response_var=_probit_var, discrete=True))


def _ll_bernoulli_logit(y, loc, aux):
    # y log p + (1-y) log(1-p), p = sigmoid(loc) = y*loc - softplus(loc)
    return y * loc - _softplus(loc)


def _logit_var(loc, aux):
    p = torch.sigmoid(loc)
    return p * (1 - p)


_register(LikelihoodFamily(
    "bernoulli_logit", 0, (), _ll_bernoulli_logit,
    response_mean=lambda loc, aux: torch.sigmoid(loc),
    response_var=_logit_var, discrete=True))


def _lchoose(n, k):
    return gammaln(n + 1.0) - gammaln(k + 1.0) \
        - gammaln(n - k + 1.0)


_register(LikelihoodFamily(
    "binomial_logit", 0, (), _ll_bernoulli_logit,
    response_mean=lambda loc, aux: torch.sigmoid(loc),
    response_var=_logit_var, discrete=True,
    # n [y loc - softplus(loc)] + log C(n, n y)
    log_lik_weighted=lambda y, loc, aux, w:
        w * _ll_bernoulli_logit(y, loc, aux) + _lchoose(w, w * y)))

_register(LikelihoodFamily(
    "binomial_probit", 0, (), _ll_bernoulli_probit,
    response_mean=lambda loc, aux: torch.special.ndtr(loc),
    response_var=_probit_var, discrete=True,
    log_lik_weighted=lambda y, loc, aux, w:
        w * _ll_bernoulli_probit(y, loc, aux) + _lchoose(w, w * y)))


def _ll_poisson(y, loc, aux):
    return y * loc - torch.exp(loc) - gammaln(y + 1.0)


_register(LikelihoodFamily(
    "poisson", 0, (), _ll_poisson,
    response_mean=lambda loc, aux: torch.exp(loc),
    response_var=lambda loc, aux: torch.exp(loc),
    discrete=True))


def _ll_gamma(y, loc, aux):
    # shape gamma, rate lambda = gamma/mu, mu = exp(loc)  (likelihoods.h:15-18)
    g = aux[0]
    return (g * torch.log(g) - g * loc + (g - 1.0) * torch.log(y)
            - g * y * torch.exp(-loc) - gammaln(g))


_register(LikelihoodFamily(
    "gamma", 1, ("shape",), _ll_gamma,
    response_mean=lambda loc, aux: torch.exp(loc),
    response_var=lambda loc, aux: torch.exp(2.0 * loc) / aux[0],
    default_aux=(1.0,)))


def _ll_negative_binomial(y, loc, aux):
    # r = aux[0] shape; p = r/(mu+r), mu = exp(loc)  (likelihoods.h:41-44)
    r = aux[0]
    mu = torch.exp(loc)
    log_p = torch.log(r) - torch.log(mu + r)
    log_1mp = loc - torch.log(mu + r)
    return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
            + y * log_1mp + r * log_p)


_register(LikelihoodFamily(
    "negative_binomial", 1, ("shape",), _ll_negative_binomial,
    response_mean=lambda loc, aux: torch.exp(loc),
    response_var=lambda loc, aux: (torch.exp(loc) * (torch.exp(loc) + aux[0])
                                   / aux[0]),
    discrete=True, default_aux=(1.0,)))


def _ll_negative_binomial_1(y, loc, aux):
    # NB1: r = mu/phi, p = 1/(1+phi)  (likelihoods.h:46-49)
    phi = aux[0]
    r = torch.exp(loc) / phi
    log_p = -torch.log1p(phi)
    log_1mp = torch.log(phi) - torch.log1p(phi)
    return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
            + y * log_1mp + r * log_p)


_register(LikelihoodFamily(
    "negative_binomial_1", 1, ("dispersion",), _ll_negative_binomial_1,
    response_mean=lambda loc, aux: torch.exp(loc),
    response_var=lambda loc, aux: torch.exp(loc) * (1.0 + aux[0]),
    discrete=True, default_aux=(0.5,)))


def _ll_beta(y, loc, aux):
    # Ferrari & Cribari-Neto (2004): mu = sigmoid(loc), precision phi
    phi = aux[0]
    mu = torch.sigmoid(loc)
    a = mu * phi
    b = (1.0 - mu) * phi
    return (gammaln(phi) - gammaln(a) - gammaln(b)
            + (a - 1.0) * torch.log(y) + (b - 1.0) * torch.log1p(-y))


_register(LikelihoodFamily(
    "beta", 1, ("precision",), _ll_beta,
    response_mean=lambda loc, aux: torch.sigmoid(loc),
    response_var=lambda loc, aux: _logit_var(loc, aux) / (1.0 + aux[0]),
    default_aux=(1.0,)))


def _ll_t(y, loc, aux):
    # Student t: scale sigma = aux[0], df nu = aux[1]  (likelihoods.h:26-29)
    sigma, nu = aux[0], aux[1]
    z2 = (y - loc) ** 2 / (nu * sigma * sigma)
    return (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
            - 0.5 * torch.log(nu * math.pi) - torch.log(sigma)
            - (nu + 1.0) / 2.0 * torch.log1p(z2))


_register(LikelihoodFamily(
    "t", 2, ("scale", "df"), _ll_t,
    response_mean=lambda loc, aux: loc,
    response_var=lambda loc, aux: torch.zeros_like(loc) + (
        aux[0] ** 2 * aux[1] / torch.clamp(aux[1] - 2.0, min=1e-10)),
    default_aux=(1.0, 2.0),
    # FisherInformationT (likelihoods.h:9947): (nu+1) / ((nu+3) sigma^2)
    fisher_loc=lambda y, loc, aux: torch.zeros_like(loc) + (
        (aux[1] + 1.0) / (aux[1] + 3.0) / (aux[0] * aux[0]))))


def _ll_t_fix_df(y, loc, aux):
    if len(aux) > 1:
        return _ll_t(y, loc, aux[:2])
    return _ll_t(y, loc, torch.stack([aux[0], torch.full_like(aux[0], 2.0)]))


_register(LikelihoodFamily(
    "t_fix_df", 1, ("scale",), _ll_t_fix_df,
    response_mean=lambda loc, aux: loc,
    default_aux=(1.0,)))


def _ll_lognormal(y, loc, aux):
    # mean(log y) = loc - sigma2/2 (mu = E[y] = exp(loc)); likelihoods.h:20-24
    s2 = aux[0]
    ly = torch.log(y)
    return (-ly - 0.5 * torch.log(s2) - 0.5 * LOG_2PI
            - (ly - (loc - 0.5 * s2)) ** 2 / (2.0 * s2))


_register(LikelihoodFamily(
    "lognormal", 1, ("variance_log",), _ll_lognormal,
    response_mean=lambda loc, aux: torch.exp(loc),
    response_var=lambda loc, aux: (torch.exp(aux[0]) - 1.0)
    * torch.exp(2.0 * loc),
    default_aux=(0.5,)))


def _betaln(p, q):
    return gammaln(p) + gammaln(q) - gammaln(p + q)


def _ll_beta_binomial(y, loc, aux, n_trials=1.0):
    # y = successes/trials; mu = sigmoid(loc), precision phi
    # (likelihoods.h:52-56)
    phi = aux[0]
    mu = torch.sigmoid(loc)
    a = mu * phi
    b = (1.0 - mu) * phi
    n = torch.as_tensor(n_trials, dtype=loc.dtype, device=loc.device)
    k = y * n
    return (gammaln(n + 1.0) - gammaln(k + 1.0)
            - gammaln(n - k + 1.0)
            + _betaln(k + a, n - k + b) - _betaln(a, b))


_register(LikelihoodFamily(
    "beta_binomial", 1, ("precision",), _ll_beta_binomial,
    response_mean=lambda loc, aux: torch.sigmoid(loc),
    discrete=True, default_aux=(20.0,),
    # trials enter INSIDE the beta functions — not a multiplicative weight
    log_lik_weighted=lambda y, loc, aux, w:
        _ll_beta_binomial(y, loc, aux, n_trials=w)))


def _ll_zero_inflated_gamma(y, loc, aux):
    # f(y) = p0 1{y=0} + (1-p0) Gamma(shape, rate=(1-p0)*shape/mu) 1{y>0};
    # aux = (shape, p0) on the user scale (logit(p0) is estimated,
    # likelihoods.h:285)
    g = aux[0]
    p0 = aux[1]
    lam = (1.0 - p0) * g / torch.exp(loc)
    pos = y > 0
    y_safe = torch.where(pos, y, torch.ones_like(y))
    log_gamma_pdf = (g * torch.log(lam) + (g - 1.0) * torch.log(y_safe)
                     - lam * y_safe - gammaln(g))
    return torch.where(pos, torch.log1p(-p0) + log_gamma_pdf,
                       torch.log(p0) + torch.zeros_like(loc))


_register(LikelihoodFamily(
    "zero_inflated_gamma", 2, ("shape", "p0"), _ll_zero_inflated_gamma,
    response_mean=lambda loc, aux: torch.exp(loc),
    default_aux=(1.0, 0.5), aux_transforms=("log", "logit")))


def _ll_zctn(y, loc, aux):
    # zero_censored_power_transformed_normal: Y = max(0, X)^lambda,
    # X ~ N(loc, sigma2)  (likelihoods.h:62-67)
    sigma, lam = aux[0], aux[1]
    pos = y > 0
    y_safe = torch.where(pos, y, torch.ones_like(y))
    yl = y_safe ** (1.0 / lam)
    log_pdf = (_norm_logpdf((yl - loc) / sigma) - torch.log(sigma)
               - torch.log(lam) + (1.0 / lam - 1.0) * torch.log(y_safe))
    log_p0 = torch.special.log_ndtr(-loc / sigma)
    return torch.where(pos, log_pdf, log_p0)


_register(LikelihoodFamily(
    "zero_censored_power_transformed_normal", 2, ("sigma", "lambda"),
    _ll_zctn, response_mean=lambda loc, aux: loc, default_aux=(1.0, 1.0)))


def _ll_zoctn(y, loc, aux):
    # zero-one-censored transformed normal (``LogLikZeroOneCensTransfNorm``
    # likelihoods.h:8877-8900): interior y maps to the pseudo-latent
    # x = sigmoid((logit(y) - a)/b), x | eta ~ N(eta, sigma^2), censoring at
    # 0 and 1. aux = (sigma, a (real-valued asymmetry), b (skewness)).
    sigma, a, b = aux[0], aux[1], aux[2]
    y_int = torch.clamp(y, 1e-12, 1.0 - 1e-12)
    logit_y = torch.log(y_int) - torch.log1p(-y_int)
    x = torch.sigmoid((logit_y - a) / b)
    z = (x - loc) / sigma
    ll_int = (-0.5 * z * z - torch.log(sigma) - 0.5 * LOG_2PI
              + torch.log(x) + torch.log1p(-x) - torch.log(b)
              - torch.log(y_int) - torch.log1p(-y_int))
    ll0 = torch.special.log_ndtr(-loc / sigma)
    ll1 = torch.special.log_ndtr((loc - 1.0) / sigma)
    return torch.where(y <= 0.0, ll0, torch.where(y >= 1.0, ll1, ll_int))


_register(LikelihoodFamily(
    "zoctn", 3, ("sigma", "asymmetry", "skewness"), _ll_zoctn,
    response_mean=lambda loc, aux: loc,
    default_aux=(1.0, 1.0, 1.0),
    aux_transforms=("log", "identity", "log"),
    clip_information=True))


def _zocb_shapes(loc, aux):
    """(a, b, t0, t1, u, 1 + 2u) of the zero-one-censored transformed
    beta: t ~ Beta(a, b), a = mu phi, b = (1 - mu) phi, mu = sigmoid(loc),
    y = clip(-u + (1 + 2u) t, 0, 1)."""
    # the upper clamp keeps the incomplete-beta quadrature in its accurate
    # range (the reference caps phi's init at 100; fitted values are O(10));
    # the shape floor 0.05 keeps its higher derivatives (a < 0.02 happens
    # only at saturated |loc| > 7, where the likelihood is flat)
    phi = torch.clamp(aux[0], 1e-12, 1e3)
    u = torch.clamp(aux[1], 1e-12, 10.0)
    onep2u = 1.0 + 2.0 * u
    mu = torch.clamp(torch.sigmoid(loc), 1e-12, 1.0 - 1e-12)
    a = torch.clamp(mu * phi, min=5e-2)
    b = torch.clamp((1.0 - mu) * phi, min=5e-2)
    t0 = torch.clamp(u / onep2u, 1e-15, 1.0 - 1e-15)
    t1 = torch.clamp((1.0 + u) / onep2u, 1e-15, 1.0 - 1e-15)
    return a, b, t0, t1, u, onep2u


def _on_rows(mask, fn, *args):
    """``fn(*args)`` on the entries where ``mask`` holds, 0 elsewhere (the
    arguments broadcast). A censored branch's incomplete beta / gamma costs a
    [rows, 200] quadrature in each of its derivatives, so only the rows that
    select it pay for it (the JAX package evaluates every row and selects:
    the same values)."""
    shape = torch.broadcast_shapes(mask.shape, *(a.shape for a in args))
    idx = torch.nonzero(mask.expand(shape).reshape(-1)).reshape(-1)
    out = torch.zeros(shape, dtype=args[0].dtype,
                      device=args[0].device).reshape(-1)
    if idx.numel():
        out = out.index_put((idx,), fn(*(a.expand(shape).reshape(-1)[idx]
                                        for a in args)))
    return out.reshape(shape)


def _ll_zocb(y, loc, aux):
    # zero_one_censored_transformed_beta (likelihoods.h:306,
    # LogLikZeroOneCensTransfBeta)
    from gpboost_tpu_torch.likelihoods.special import (betaln_ad,
                                                       log1m_betainc_ad,
                                                       log_betainc_ad)
    a, b, t0, t1, u, onep2u = _zocb_shapes(loc, aux)
    t = torch.clamp((y + u) / onep2u, 1e-15, 1.0 - 1e-15)
    ll0 = _on_rows(y <= 0.0, log_betainc_ad, a, b, t0)
    ll1 = _on_rows(y >= 1.0, log1m_betainc_ad, a, b, t1)
    llmid = ((a - 1.0) * torch.log(t) + (b - 1.0) * torch.log1p(-t)
             - betaln_ad(a, b) - torch.log(onep2u))
    return torch.where(y <= 0.0, ll0, torch.where(y >= 1.0, ll1, llmid))


def _zocb_moments(loc, aux):
    """(E[y|loc], E[y^2|loc]) (XB_FirstMoment_ / XB_SecondMoment_,
    likelihoods.h:11549,11580)."""
    from gpboost_tpu_torch.likelihoods.special import betainc_ad
    a, b, t0, t1, u, onep2u = _zocb_shapes(loc, aux)
    F0 = betainc_ad(a, b, t0)
    P1 = betainc_ad(b, a, 1.0 - t1)
    Pmid = (1.0 - P1) - F0
    Ez1 = (a / (a + b)) * (betainc_ad(a + 1.0, b, t1)
                           - betainc_ad(a + 1.0, b, t0))
    m1 = torch.clamp(onep2u * Ez1 - u * Pmid + P1, 0.0, 1.0)
    coeff2 = a * (a + 1.0) / ((a + b) * (a + b + 1.0))
    Ez2 = coeff2 * (betainc_ad(a + 2.0, b, t1) - betainc_ad(a + 2.0, b, t0))
    m2 = torch.clamp(onep2u ** 2 * Ez2 - 2.0 * u * onep2u * Ez1
                     + u * u * Pmid + P1, 0.0, 1.0)
    return m1, m2


def _moment_var(moments):
    def var(loc, aux):
        m1, m2 = moments(loc, aux)
        return m2 - m1 ** 2
    return var


_register(LikelihoodFamily(
    "zero_one_censored_transformed_beta", 2, ("precision", "u"), _ll_zocb,
    response_mean=lambda loc, aux: _zocb_moments(loc, aux)[0],
    response_var=_moment_var(_zocb_moments),
    default_aux=(20.0, 0.01), clip_information=True))


def _ll_zocg(y, loc, aux):
    # zero_one_censored_shifted_gamma (likelihoods.h:314,
    # LogLikZeroOneCensGamma): y = clip(z - xi, 0, 1), z ~ Gamma(k, mu/k)
    from gpboost_tpu_torch.likelihoods.special import (log_gammainc_lower_ad,
                                                       log_gammainc_upper_ad)
    k, xi = aux[0], aux[1]
    th = torch.exp(torch.clamp(loc, -500.0, 500.0)) / k
    ll0 = _on_rows(y <= 0.0, log_gammainc_lower_ad, k, xi / th)
    ll1 = _on_rows(y >= 1.0, log_gammainc_upper_ad, k, (1.0 + xi) / th)
    z = torch.clamp(y + xi, min=1e-300)
    llmid = (-k * torch.log(th) - z / th + (k - 1.0) * torch.log(z)
             - gammaln(k))
    return torch.where(y <= 0.0, ll0, torch.where(y >= 1.0, ll1, llmid))


def _zocg_moments(loc, aux):
    """(E[y|loc], E[y^2|loc]) (ZOCG_MomentsGivenEta_, likelihoods.h:11615)."""
    from gpboost_tpu_torch.likelihoods.special import gammainc_ad
    k, xi = aux[0], aux[1]
    th = torch.exp(loc) / k
    t0, t1 = xi / th, (1.0 + xi) / th
    Gk0, Gk1 = gammainc_ad(k, t0), gammainc_ad(k, t1)
    Pint = Gk1 - Gk0
    p1 = 1.0 - Gk1
    M1 = (k * th) * (gammainc_ad(k + 1.0, t1) - gammainc_ad(k + 1.0, t0))
    Ey = torch.clamp(p1 + M1 - xi * Pint, 0.0, 1.0)
    M2 = (k * (k + 1.0) * th * th) * (gammainc_ad(k + 2.0, t1)
                                      - gammainc_ad(k + 2.0, t0))
    Ey2 = torch.clamp(p1 + M2 - 2.0 * xi * M1 + xi * xi * Pint, 0.0, 1.0)
    return Ey, Ey2


_register(LikelihoodFamily(
    "zero_one_censored_shifted_gamma", 2, ("shape", "xi"), _ll_zocg,
    response_mean=lambda loc, aux: _zocg_moments(loc, aux)[0],
    response_var=_moment_var(_zocg_moments),
    default_aux=(1.0, 0.1), clip_information=True))

def _ll_het_single(y, loc, aux):
    # gaussian_heteroscedastic is a TWO-location family (mean +
    # log-variance); its model is models/heteroscedastic.py, the entry only
    # carries the name for generic code
    raise NotImplementedError(
        "gaussian_heteroscedastic uses the two-set engine "
        "(gpboost_tpu_torch.models.heteroscedastic), not the "
        "single-location API")


_register(LikelihoodFamily(
    "gaussian_heteroscedastic", 0, (), _ll_het_single,
    response_mean=lambda loc, aux: loc))
