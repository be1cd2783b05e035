"""Covariance function library (vectorized, differentiable PyTorch).

Covariance families of the reference's ``include/GPBoost/cov_fcts.h``
(GPBoost v1.6.5) as plain functions mapping pairwise structure (distances or
coordinates) + parameters to dense covariance matrices. Gradients w.r.t. the
parameters come from ``torch.autograd``.

Parametrizations match the reference (``cov_fcts.h:1682-1745``):

- ``matern`` shape 0.5 / ``exponential``:  sigma2 * exp(-d / rho)
- ``matern`` shape 1.5:  sigma2 * (1 + s3) * exp(-s3),        s3 = sqrt(3) d / rho
- ``matern`` shape 2.5:  sigma2 * (1 + s5 + s5^2/3) exp(-s5), s5 = sqrt(5) d / rho
- ``matern`` general nu: sigma2 * 2^(1-nu)/Gamma(nu) * x^nu K_nu(x),
  x = sqrt(2 nu) d / rho (the Bessel K is this module's own series:
  PyTorch has K of orders 0 and 1 only, with no derivative in the order)
- ``matern_estimate_shape`` / ``matern_ard_estimate_shape``: the same with
  nu a parameter, differentiable in it through the series
- ``gaussian`` (sq. exponential): sigma2 * exp(-(d/rho)^2)
- ``powered_exponential``: sigma2 * exp(-(d/rho)^shape)
- ``wendland`` (Bevilacqua et al. 2019 parametrization, taper shapes 0/1/2)
  and the Wendland taper of ``gp_approx="tapering"`` (``apply_tapering``)
- ARD / space-time variants via per-dimension coordinate scaling
  (``cov_fcts.h:249-330``), the Gneiting space-time covariance, and the
  non-stationary ``linear`` (sigma2 x'x) and ``hurst`` (fractional
  Brownian motion) covariances.

Parameter vector layout per component (original scale, as user-facing):
``[sigma2, range]`` for isotropic, ``[sigma2, rho_1..rho_d]`` for ARD,
``[sigma2, rho_time, rho_space]`` for space-time, ``[sigma2]`` for wendland
and linear, ``[sigma2, range, nu]`` / ``[sigma2, rho_1..rho_d, nu]`` for the
estimated shape, ``[sigma2, H]`` for hurst and ``[sigma2, a_t, c_s, alpha,
nu, beta, delta]`` for Gneiting.

Memory. The autograd graph of the traced-order series holds ~1 150 bytes
an entry (float64): ~48 GB for a Vecchia build at n = 1e5, m = 20 (4.2e7
entries; ``tools/bessel_graph_bytes.py``). Above :data:`BESSEL_CHUNK` entries :class:`_Chunked` evaluates the
series in chunks and recomputes each chunk's graph in the backward, so the
peak stays at one chunk's graph.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from gpboost_tpu_torch.utils import autograd as ag

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)

ISOTROPIC_TYPES = frozenset({
    "exponential", "matern", "gaussian", "powered_exponential", "wendland",
})
ARD_TYPES = frozenset({"matern_ard", "gaussian_ard"})
SPACE_TIME_TYPES = frozenset({"matern_space_time", "exponential_space_time"})
SUPPORTED_COV_TYPES = frozenset(
    ISOTROPIC_TYPES | ARD_TYPES | SPACE_TIME_TYPES
    | {"matern_estimate_shape", "matern_ard_estimate_shape", "linear",
       "space_time_gneiting", "hurst"}
)

# entries a general-order Bessel evaluation differentiates at once: above it
# the series run chunk by chunk (:class:`_Chunked`)
BESSEL_CHUNK = 2 ** 21


def parse_cov_alias(cov_fct_type: str, shape: float) -> tuple[str, float]:
    """Resolve covariance-name aliases as the reference does.

    ``exponential`` == matern(0.5); ``sq_exp``/``rbf`` -> gaussian.
    """
    if cov_fct_type == "exponential":
        return "matern", 0.5
    if cov_fct_type == "exponential_space_time":
        return "matern_space_time", 0.5
    if cov_fct_type in ("sq_exp", "rbf", "squared_exponential"):
        return "gaussian", shape
    if cov_fct_type == "linear_no_woodbury":
        return "linear", shape
    return cov_fct_type, shape


class _Chunked(torch.autograd.Function):
    """``fn(x, *params)`` elementwise in x, evaluated over chunks of x's
    flattened entries: the forward without a graph, the backward
    recomputing one chunk's graph at a time (gradients in x and in the
    0-d ``params``). Under ``create_graph`` the backward differentiates the
    whole input at once, so higher derivatives compose."""

    @staticmethod
    def forward(ctx, fn, chunk, x, *params):
        ctx.fn, ctx.chunk = fn, chunk
        ctx.save_for_backward(x, *params)
        flat = x.reshape(-1)
        with torch.no_grad():
            out = torch.cat([fn(flat[i:i + chunk], *params)
                             for i in range(0, flat.numel(), chunk)])
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        fn, chunk = ctx.fn, ctx.chunk
        needs = ctx.needs_input_grad[2:]
        if torch.is_grad_enabled():
            with torch.enable_grad():
                targets = [t for t, nd in zip([x] + params, needs) if nd]
                grads = list(ag.grad(fn(x, *params), targets, g,
                                   create_graph=True))
        else:
            flat, gf = x.detach().reshape(-1), g.reshape(-1)
            ps = [p.detach().requires_grad_(nd)
                  for p, nd in zip(params, needs[1:])]
            gx = torch.empty_like(flat) if needs[0] else None
            gp = [torch.zeros_like(p) for p in ps if p.requires_grad]
            for i in range(0, flat.numel(), chunk):
                xc = flat[i:i + chunk].detach().requires_grad_(needs[0])
                with torch.enable_grad():
                    targets = ([xc] if needs[0] else []) + [
                        p for p in ps if p.requires_grad]
                    parts = list(ag.grad(fn(xc, *ps), targets,
                                       gf[i:i + chunk]))
                if needs[0]:
                    gx[i:i + chunk] = parts.pop(0)
                for acc, part in zip(gp, parts):
                    acc += part
            grads = ([gx.reshape(x.shape)] if needs[0] else []) + gp
        it = iter(grads)
        return (None, None) + tuple(next(it) if nd else None for nd in needs)


def _elementwise(fn, x: torch.Tensor, *params) -> torch.Tensor:
    """fn(x, *params), in chunks (:class:`_Chunked`) when x is large."""
    if x.numel() <= BESSEL_CHUNK:
        return fn(x, *params)
    return _Chunked.apply(fn, BESSEL_CHUNK, x, *params)


def _matern_correlation(scaled_dist: torch.Tensor, shape: float) -> torch.Tensor:
    """Matern correlation given the *transformed* distance x = c(nu) d / rho.

    c(0.5)=1, c(1.5)=sqrt(3), c(2.5)=sqrt(5), else sqrt(2 nu).
    """
    x = scaled_dist
    if abs(shape - 0.5) < 1e-10:
        return torch.exp(-x)
    if abs(shape - 1.5) < 1e-10:
        return (1.0 + x) * torch.exp(-x)
    if abs(shape - 2.5) < 1e-10:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    return _elementwise(lambda v: _matern_general_correlation(v, shape), x)


def _matern_general_correlation(x: torch.Tensor, nu: float) -> torch.Tensor:
    """General-shape Matern correlation 2^(1-nu)/Gamma(nu) x^nu K_nu(x)
    for a fixed order; differentiable w.r.t. ``x``."""
    const = 2.0 ** (1.0 - nu) / math.gamma(nu)
    xs = torch.clamp(x, min=1e-12)
    val = const * torch.pow(xs, nu) * _bessel_kv(nu, xs)
    return torch.where(x <= 1e-12, torch.ones_like(x), val)


def _bessel_kv(nu: float, x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel function of the second kind K_nu(x), x > 0, nu > 0
    fixed. Half-integer orders use the closed-form finite sum; general
    orders the series for small x and the asymptotic expansion for large x
    (~1e-10 relative)."""
    half = nu - math.floor(nu)
    if abs(half - 0.5) < 1e-12:
        # K_{m+1/2}(x) = sqrt(pi/(2x)) e^-x sum_{k=0}^{m} (m+k)!/(k!(m-k)!) (2x)^-k
        m = int(round(nu - 0.5))
        pref = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x)
        s = torch.zeros_like(x)
        for k in range(m + 1):
            c = math.factorial(m + k) / (math.factorial(k) * math.factorial(m - k))
            s = s + c * torch.pow(2.0 * x, -float(k))
        return pref * s
    return _bessel_kv_general(nu, x)


_KV_SERIES_ASYMPT_CUTOFF = 10.0
_KV_TERMS = 30
_KV_ASYMPT_TERMS = 15


def _kv_asymptotic(mu4, x: torch.Tensor) -> torch.Tensor:
    """K(x) ~ sqrt(pi/(2x)) e^-x [1 + sum_k a_k/x^k] over x >= the cutoff;
    ``mu4`` = 4 nu^2 (a float or a 0-d tensor)."""
    xa = torch.clamp(x, min=_KV_SERIES_ASYMPT_CUTOFF)
    a = torch.ones_like(xa)
    term = torch.ones_like(xa)
    for k in range(1, _KV_ASYMPT_TERMS):
        term = term * (mu4 - (2 * k - 1) ** 2) / (8.0 * k * xa)
        a = a + term
    return torch.sqrt(math.pi / (2.0 * xa)) * torch.exp(-xa) * a


def _kv_base(f: float, x: torch.Tensor) -> torch.Tensor:
    """K_f(x) for base order f in [0, 2.5): series (x<10) + asymptotic (x>=10).

    Series: K_f = pi/2 (I_-f - I_f)/sin(f pi); cancellation grows like
    eps*e^(2x), so the crossover sits at x=10 (~1e-8 relative); the
    asymptotic 14-term expansion is ~1e-7 there and improves with x.
    """
    f_eff = f
    if abs(f - round(f)) < 1e-8:
        f_eff = f + 1e-8  # perturb away from the integer pole
    xc = torch.clamp(x, max=_KV_SERIES_ASYMPT_CUTOFF)
    log_xh = torch.log(xc / 2.0)

    def iv_series(order: float) -> torch.Tensor:
        # I_order(x) = sum_k (x/2)^(2k+order) / (k! Gamma(k+order+1));
        # math.gamma keeps the sign of Gamma at negative arguments
        s = torch.zeros_like(xc)
        for k in range(_KV_TERMS):
            coef = 1.0 / (math.factorial(k) * math.gamma(k + order + 1.0))
            s = s + coef * torch.exp((2 * k + order) * log_xh)
        return s

    small = (math.pi / 2.0) * (iv_series(-f_eff) - iv_series(f_eff)) \
        / math.sin(f_eff * math.pi)
    large = _kv_asymptotic(4.0 * f * f, x)
    return torch.where(x < _KV_SERIES_ASYMPT_CUTOFF, small, large)


_EULER_GAMMA = 0.5772156649015328606


def _psi_int(m: int) -> float:
    """Digamma at positive integer m: psi(m) = -gamma + sum_{j<m} 1/j."""
    return -_EULER_GAMMA + sum(1.0 / j for j in range(1, m))


def _kv_int(n: int, x: torch.Tensor) -> torch.Tensor:
    """K_n(x) for integer order via the log series (A&S 9.6.11) + asymptotic."""
    xc = torch.clamp(x, max=_KV_SERIES_ASYMPT_CUTOFF)
    xh = xc / 2.0
    log_xh = torch.log(xh)
    q = xh * xh  # (x/2)^2
    # finite sum: 1/2 (x/2)^-n sum_{k<n} (n-k-1)!/k! (-q)^k
    finite = torch.zeros_like(xc)
    for k in range(n):
        c = math.factorial(n - k - 1) / math.factorial(k) * (-1.0) ** k
        finite = finite + c * q ** k
    finite = (0.5 * finite * torch.exp(-float(n) * log_xh) if n > 0
              else torch.zeros_like(xc))
    # log term: (-1)^(n+1) log(x/2) I_n(x)
    i_n = torch.zeros_like(xc)
    for k in range(_KV_TERMS):
        c = 1.0 / (math.factorial(k) * math.factorial(k + n))
        i_n = i_n + c * torch.exp((2 * k + n) * log_xh)
    log_term = (-1.0) ** (n + 1) * log_xh * i_n
    # psi series: (-1)^n 1/2 (x/2)^n sum_k (psi(k+1)+psi(n+k+1)) q^k/(k!(n+k)!)
    psi_sum = torch.zeros_like(xc)
    for k in range(_KV_TERMS):
        c = (_psi_int(k + 1) + _psi_int(n + k + 1)) / (
            math.factorial(k) * math.factorial(n + k))
        psi_sum = psi_sum + c * q ** k
    psi_term = (-1.0) ** n * 0.5 * torch.exp(float(n) * log_xh) * psi_sum
    small = finite + log_term + psi_term
    large = _kv_asymptotic(4.0 * float(n * n), x)
    return torch.where(x < _KV_SERIES_ASYMPT_CUTOFF, small, large)


def _bessel_kv_general(nu: float, x: torch.Tensor) -> torch.Tensor:
    """K_nu for arbitrary fixed nu > 0.

    Integer orders (within 1e-5) use the exact log series; otherwise reduce
    to base orders f, f+1 with f = frac(nu) and apply the (stable upward)
    recurrence K_{v+1} = K_{v-1} + (2v/x) K_v.
    """
    if abs(nu - round(nu)) < 1e-5 and round(nu) >= 0:
        return _kv_int(int(round(nu)), x)
    m = int(math.floor(nu))
    f = nu - m
    if m == 0:
        return _kv_base(f, x)
    k_lo = _kv_base(f, x)
    k_hi = _kv_base(f + 1.0, x)
    for j in range(1, m):
        k_lo, k_hi = k_hi, k_lo + (2.0 * (f + j) / x) * k_hi
    return k_hi


def _signed_gamma(z: torch.Tensor) -> torch.Tensor:
    """Gamma(z) for a real (possibly negative, non-pole) tensor z: z > 0
    exp(lgamma z); z < 0 the reflection pi / (sin(pi z) Gamma(1 - z))."""
    pos = torch.exp(torch.lgamma(torch.clamp(z, min=1e-10)))
    neg = math.pi / (torch.sin(math.pi * z)
                     * torch.exp(torch.lgamma(torch.clamp(1.0 - z,
                                                          min=1e-10))))
    return torch.where(z > 0, pos, neg)


def bessel_kv_traced(nu, x: torch.Tensor) -> torch.Tensor:
    """K_nu(x) with the order a tensor nu > 0 — differentiable in BOTH nu
    and x (``matern_estimate_shape`` and the Gneiting nu; the reference
    takes finite differences for the shape gradient, ``cov_fcts.h:
    1794-1813``). The same series (x < 10) + asymptotic (x >= 10) as
    :func:`_bessel_kv`, as loops over a fixed number of terms. Orders within
    1e-4 of an integer are nudged off the sin(nu pi) pole (~1e-3 relative
    there)."""
    nu = torch.as_tensor(nu, dtype=x.dtype, device=x.device)
    r = torch.round(nu)
    near = torch.abs(nu - r) < 1e-4
    nu_eff = torch.where(near, r + torch.where(nu >= r, 1e-4, -1e-4), nu)
    xc = torch.clamp(x, max=_KV_SERIES_ASYMPT_CUTOFF)
    log_xh = torch.log(xc / 2.0)

    def iv_series(order):
        s = torch.zeros_like(xc)
        for k in range(_KV_TERMS):
            coef = torch.exp(-torch.lgamma(torch.tensor(
                k + 1.0, dtype=x.dtype, device=x.device))) \
                / _signed_gamma(k + order + 1.0)
            s = s + coef * torch.exp((2.0 * k + order) * log_xh)
        return s

    small = (math.pi / 2.0) * (iv_series(-nu_eff) - iv_series(nu_eff)) \
        / torch.sin(nu_eff * math.pi)
    large = _kv_asymptotic(4.0 * nu_eff * nu_eff, x)
    return torch.where(x < _KV_SERIES_ASYMPT_CUTOFF, small, large)


_KV_UNIFORM_NU_SWITCH = 8.0


def _log_kv_uniform(nu, x: torch.Tensor) -> torch.Tensor:
    """log K_nu(x) via the LARGE-ORDER uniform asymptotic expansion
    (DLMF 10.41.4, four u_k terms) — the small-x series + fixed-order
    asymptotic pair breaks down for nu >~ 9, but estimated-smoothness fits
    walk nu into the hundreds (the Gaussian limit). Log-space keeps
    Gamma(nu)-scale factors finite; ~1e-8 relative at nu = 8."""
    z = x / nu
    s = torch.sqrt(1.0 + z * z)
    eta = s + torch.log(z / (1.0 + s))
    t = 1.0 / s
    t2 = t * t
    u1 = (3.0 * t - 5.0 * t * t2) / 24.0
    u2 = (81.0 * t2 - 462.0 * t2 * t2 + 385.0 * t2 * t2 * t2) / 1152.0
    u3 = (30375.0 * t * t2 - 369603.0 * t * t2 * t2
          + 765765.0 * t * t2 * t2 * t2
          - 425425.0 * t * t2 * t2 * t2 * t2) / 414720.0
    # alternating signs for K (DLMF 10.41.4: (-1)^k u_k(t)/nu^k)
    series = 1.0 - u1 / nu + u2 / (nu * nu) - u3 / (nu * nu * nu)
    return (0.5 * torch.log(math.pi / (2.0 * nu)) - nu * eta
            - 0.25 * torch.log(1.0 + z * z) + torch.log(series))


def _matern_traced(x: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
    xs = torch.clamp(x, min=1e-12)
    log_pref = (1.0 - nu) * math.log(2.0) - torch.lgamma(nu) \
        + nu * torch.log(xs)
    # small-order branch: nu clamped so the series/asymptotic pair never
    # sees a large order (its values are discarded by the where)
    nu_small = torch.clamp(nu, max=_KV_UNIFORM_NU_SWITCH)
    small = torch.exp(log_pref) * bessel_kv_traced(nu_small, xs)
    nu_large = torch.clamp(nu, min=_KV_UNIFORM_NU_SWITCH)
    large = torch.exp(log_pref + _log_kv_uniform(nu_large, xs))
    val = torch.where(nu < _KV_UNIFORM_NU_SWITCH, small, large)
    return torch.where(x <= 1e-12, torch.ones_like(x), val)


def matern_correlation_traced(x: torch.Tensor, nu) -> torch.Tensor:
    """Matern correlation 2^(1-nu)/Gamma(nu) x^nu K_nu(x) with the order a
    (differentiable) tensor. ``x`` is the transformed distance (the caller
    applies the sqrt(2 nu)/rho scaling). nu < 8 uses the series / fixed-
    order asymptotic Bessel; nu >= 8 the whole correlation in log space
    with the large-order uniform expansion."""
    nu = torch.as_tensor(nu, dtype=x.dtype, device=x.device).reshape(())
    return _elementwise(_matern_traced, x, nu)


def wendland_correlation(dist: torch.Tensor, taper_range: float,
                         taper_shape: float, taper_mu: float) -> torch.Tensor:
    """Wendland correlation (compact support), shapes 0, 1 and 2
    (``cov_fcts.h`` ``WendlandCorrelationShape{0,1,2}``, the Bevilacqua et
    al. (2019) parametrisation): the wendland covariance, the taper of
    ``gp_approx="tapering"`` and of ``full_scale_tapering``."""
    r = dist / taper_range
    rc = torch.clamp(r, max=1.0)
    base = torch.clamp(1.0 - rc, min=0.0)
    if abs(taper_shape) < 1e-10:
        corr = torch.pow(base, taper_mu)
    elif abs(taper_shape - 1.0) < 1e-10:
        corr = torch.pow(base, taper_mu + 1.0) * (1.0 + rc * (taper_mu + 1.0))
    elif abs(taper_shape - 2.0) < 1e-10:
        corr = torch.pow(base, taper_mu + 2.0) * (
            1.0 + rc * (taper_mu + 2.0)
            + rc * rc * (taper_mu * taper_mu + 4.0 * taper_mu + 3.0) / 3.0)
    else:
        raise ValueError(
            f"taper_shape {taper_shape} not supported (only 0, 1, 2)")
    return torch.where(r >= 1.0, torch.zeros_like(corr), corr)


def euclidean_distance(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [..., n1, n2] via inner products (the
    same formula as the reference package, so that both agree to rounding);
    leading batch dimensions broadcast."""
    sq1 = torch.sum(c1 * c1, dim=-1)[..., :, None]
    sq2 = torch.sum(c2 * c2, dim=-1)[..., None, :]
    d2 = torch.clamp(sq1 + sq2 - 2.0 * (c1 @ c2.transpose(-1, -2)), min=0.0)
    # double-where: sqrt'(0) = inf would poison gradients when coordinates are
    # parameter-scaled (ARD) and i == j distances are exactly 0
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def difference_distance(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [..., n1, n2] from coordinate
    differences, dimension by dimension (leading batch dimensions
    broadcast): a point's distance to itself is exactly 0 (the
    inner-product form leaves ~1e-8 there, which the hurst covariance
    |x - y|^2H and the Bessel series at small x would carry), as the JAX
    package's compiled covariance builds get it."""
    d2 = None
    for k in range(c1.shape[-1]):
        dk = c1[..., :, None, k] - c2[..., None, :, k]
        d2 = dk * dk if d2 is None else d2 + dk * dk
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def get_taper_mu(cov_fct_type: str, taper_shape: float, dim_coords: int,
                 apply_tapering: bool) -> float:
    """Wendland mu parameter, Bevilacqua et al. (2019) notation: the
    reference sets mu = (1 + d)/2 + taper_shape + 1/2 for wendland and
    tapered models, else 2 (``re_comp.h:842-845,1821``)."""
    if cov_fct_type == "wendland" or apply_tapering:
        return (1.0 + dim_coords) / 2.0 + taper_shape + 0.5
    return 2.0


def _pos_pow(x: torch.Tensor, p) -> torch.Tensor:
    """x^p for x >= 0 with the zeros of x kept at 0 (and a finite gradient
    there): the hurst and Gneiting terms."""
    return torch.pow(torch.clamp(x, min=1e-300), p) * torch.where(
        x > 0, 1.0, 0.0)


@dataclass(frozen=True)
class CovFunction:
    """Static spec of one covariance function (hashable).

    Equivalent of the reference's ``CovFunction<T_mat>`` class
    (``cov_fcts.h:46``): instead of element-loop lambdas it exposes
    whole-matrix functions over distances/coordinates.
    """

    cov_fct_type: str
    shape: float = 0.0
    taper_range: float = 1.0
    taper_shape: float = 1.0
    taper_mu: float = 1.5
    apply_tapering: bool = False
    dim_coords: int = 2

    @staticmethod
    def create(cov_fct_type: str, shape: float = 0.0, taper_range: float = 1.0,
               taper_shape: float = 1.0, taper_mu: Optional[float] = None,
               apply_tapering: bool = False,
               dim_coords: int = 2) -> "CovFunction":
        cov_fct_type, shape = parse_cov_alias(cov_fct_type, shape)
        if cov_fct_type not in SUPPORTED_COV_TYPES:
            raise ValueError(
                f"Covariance of type '{cov_fct_type}' is not supported")
        if cov_fct_type in ("matern", "matern_ard", "matern_space_time") \
                and shape <= 0.0:
            raise ValueError("'shape' must be > 0 for matern covariances")
        if cov_fct_type == "powered_exponential" and not (0.0 < shape <= 2.0):
            raise ValueError("'shape' must be in (0, 2] for powered_exponential")
        if taper_mu is None:
            taper_mu = get_taper_mu(cov_fct_type, taper_shape, dim_coords,
                                    apply_tapering)
        return CovFunction(cov_fct_type, shape, taper_range, taper_shape,
                           taper_mu, apply_tapering, dim_coords)

    # ---- parameter bookkeeping -------------------------------------------
    @property
    def num_cov_par(self) -> int:
        t = self.cov_fct_type
        if t in ("wendland", "linear"):
            return 1
        if t in ARD_TYPES:
            return 1 + self.dim_coords
        if t in SPACE_TIME_TYPES or t == "matern_estimate_shape":
            return 3
        if t == "matern_ard_estimate_shape":
            return 2 + self.dim_coords
        if t == "space_time_gneiting":
            return 7  # [sigma2, a_t, c_s, alpha, nu, beta, delta]
        return 2  # [sigma2, range]; hurst [sigma2, H]

    @property
    def is_isotropic(self) -> bool:
        return self.cov_fct_type in ISOTROPIC_TYPES

    @property
    def has_coord_scaling(self) -> bool:
        """True when the kernel is isotropic in per-dimension SCALED
        coordinates (ARD / space-time): k(s, s') = sigma2 *
        corr(||scale(s) - scale(s')||) with unit transformed range
        (``cov_fcts.h:249`` anisotropic coordinate scaling). This is what
        makes Vecchia neighbor search + batched factor builds work for
        anisotropic kernels."""
        return self.cov_fct_type in ("matern_ard", "gaussian_ard",
                                     "matern_space_time",
                                     "matern_ard_estimate_shape")

    def corr_from_scaled_dist(self, sdist: torch.Tensor,
                              pars: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """Correlation given distances in the SCALED coordinate space.
        ``pars`` is read by ``matern_ard_estimate_shape`` only, whose
        smoothness is its last parameter (the sqrt(2 nu) distance factor is
        folded into :meth:`scale_coords`)."""
        t = self.cov_fct_type
        if t in ("matern_ard", "matern_space_time"):
            return _matern_correlation(sdist, self.shape)
        if t == "gaussian_ard":
            return torch.exp(-sdist * sdist)
        if t == "matern_ard_estimate_shape":
            return matern_correlation_traced(sdist, pars[-1])
        raise ValueError(f"corr_from_scaled_dist: unsupported type {t}")

    # ---- covariance evaluation -------------------------------------------
    def correlation_from_dist(self, dist: torch.Tensor,
                              pars: torch.Tensor) -> torch.Tensor:
        """Correlation matrix for isotropic types given raw distances."""
        t = self.cov_fct_type
        if t == "matern":
            c = _matern_mult_const(self.shape)
            return _matern_correlation(c * dist / pars[1], self.shape)
        if t == "gaussian":
            r = dist / pars[1]
            return torch.exp(-r * r)
        if t == "powered_exponential":
            return torch.exp(-torch.pow(dist / pars[1], self.shape))
        if t == "wendland":
            return wendland_correlation(dist, self.taper_range,
                                        self.taper_shape, self.taper_mu)
        if t == "matern_estimate_shape":
            # pars = [sigma2, range, shape], x = d sqrt(2 nu) / rho
            # (``CovarianceMaternEstimateShape``, cov_fcts.h:1722)
            nu = pars[2]
            return matern_correlation_traced(
                dist * torch.sqrt(2.0 * nu) / pars[1], nu)
        raise ValueError(f"correlation_from_dist: unsupported type {t}")

    def scale_coords(self, coords: torch.Tensor,
                     pars: torch.Tensor) -> torch.Tensor:
        """Per-dimension coordinate scaling for ARD / space-time types.

        After scaling, the covariance is the base function with unit
        (transformed) range on the scaled distance (``cov_fcts.h:249-330``).
        """
        t = self.cov_fct_type
        d = coords.shape[-1]
        if t == "matern_ard":
            c = _matern_mult_const(self.shape)
            return coords * (c / pars[1:1 + d])[None, :]
        if t == "matern_ard_estimate_shape":
            # the smoothness is a parameter: sqrt(2 nu) into the scales
            c = torch.sqrt(2.0 * pars[1 + d])
            return coords * (c / pars[1:1 + d])[None, :]
        if t == "gaussian_ard":
            return coords / pars[1:1 + d][None, :]
        if t == "matern_space_time":
            c = _matern_mult_const(self.shape)
            scale = torch.cat([c / pars[1:2], (c / pars[2]).expand(d - 1)])
            return coords * scale
        raise ValueError(f"scale_coords: unsupported type {t}")

    def cov_between(self, pars: torch.Tensor, coords1: torch.Tensor,
                    coords2: torch.Tensor) -> torch.Tensor:
        """Covariance between two coordinate sets, dispatching distances for
        isotropic kernels and raw coordinates for anisotropic ones."""
        if self.is_isotropic:
            return self.cov_matrix(pars,
                                   dist=euclidean_distance(coords1, coords2))
        return self.cov_matrix(pars, coords1=coords1, coords2=coords2)

    def cov_matrix(self, pars: torch.Tensor,
                   dist: Optional[torch.Tensor] = None,
                   coords1: Optional[torch.Tensor] = None,
                   coords2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Dense covariance matrix.

        For isotropic types (and ``matern_estimate_shape``) pass ``dist``
        (precomputed distances; reference
        ``use_precomputed_dist_for_calc_cov_``) or coordinates; for the
        ARD / space-time / non-stationary types pass coordinates. Returns
        ``[..., n1, n2]`` (leading batch dimensions of the coordinates
        broadcast).
        """
        t = self.cov_fct_type
        c2 = coords1 if coords2 is None else coords2
        if t == "linear":
            return pars[0] * (coords1 @ c2.mT)
        if self.is_isotropic or t == "matern_estimate_shape":
            if dist is None:
                dist = (euclidean_distance(coords1, c2) if self.is_isotropic
                        else difference_distance(coords1, c2))
            corr = self.correlation_from_dist(dist, pars)
            if self.apply_tapering and self.is_isotropic and t != "wendland":
                corr = corr * wendland_correlation(
                    dist, self.taper_range, self.taper_shape, self.taper_mu)
            return pars[0] * corr
        if t == "matern_ard_estimate_shape":
            # pars = [sigma2, rho_1..rho_d, shape]: per-dim scaled distances,
            # x = sqrt(2 nu) d_scaled (``cov_fcts.h:138,189,273``)
            d_comp = coords1.shape[-1]
            rho = pars[1:1 + d_comp]
            sdist = difference_distance(coords1 / rho, c2 / rho)
            nu = pars[1 + d_comp]
            return pars[0] * matern_correlation_traced(
                torch.sqrt(2.0 * nu) * sdist, nu)
        if t == "hurst":
            # fractional Brownian motion (cov_fcts.h HurstCovariance):
            # C(x, y) = sigma2/2 (|x|^2H + |y|^2H - |x-y|^2H); not
            # stationary, the variance is not on the diagonal
            H = pars[1]
            nx = torch.sum(coords1 * coords1, dim=-1)
            ny = torch.sum(c2 * c2, dim=-1)
            dxy = difference_distance(coords1, c2) ** 2
            return (pars[0] / 2.0) * (
                torch.pow(torch.clamp(nx[..., :, None], min=1e-300), H)
                + torch.pow(torch.clamp(ny[..., None, :], min=1e-300), H)
                - _pos_pow(dxy, H))
        if t == "space_time_gneiting":
            # Gneiting (2002) non-separable space-time covariance
            # (cov_fcts.h SpaceTimeGneitingCovariance_vec); coords[:, 0] is
            # time. pars = [sigma2, a_t, c_s, alpha, nu, beta, delta]; the
            # Matern smoothness is the parameter nu (cov_fcts.h:2433-2463)
            dt = torch.abs(coords1[..., :, None, 0] - c2[..., None, :, 0])
            ds = difference_distance(coords1[..., 1:], c2[..., 1:])
            dim_space = coords1.shape[-1] - 1
            a_t, c_s, alpha, nu, beta, delta = (pars[1], pars[2], pars[3],
                                                pars[4], pars[5], pars[6])
            d_aux_time = a_t * _pos_pow(dt, 2.0 * alpha) + 1.0
            d_aux = c_s * ds / torch.pow(d_aux_time, beta / 2.0)
            d_aux2 = pars[0] / torch.pow(d_aux_time,
                                         delta + beta * dim_space / 2.0)
            return d_aux2 * matern_correlation_traced(d_aux, nu)
        # coordinate-based (ARD / space-time)
        cs1 = self.scale_coords(coords1, pars)
        cs2 = (cs1 if coords2 is None or coords2 is coords1
               else self.scale_coords(coords2, pars))
        sdist = euclidean_distance(cs1, cs2)
        return pars[0] * self.corr_from_scaled_dist(sdist, pars)


def _matern_mult_const(shape: float) -> float:
    if abs(shape - 0.5) < 1e-9:
        return 1.0
    if abs(shape - 1.5) < 1e-9:
        return SQRT3
    if abs(shape - 2.5) < 1e-9:
        return SQRT5
    return math.sqrt(2.0 * shape)
