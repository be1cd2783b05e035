"""Differentiable incomplete beta / gamma functions (PyTorch port of
``gpboost_tpu/likelihoods/special.py``).

The censored likelihoods (``zero_one_censored_transformed_beta`` /
``zero_one_censored_shifted_gamma``, reference ``likelihoods.h:306-321``)
need the regularized incomplete beta I_x(a, b) and lower incomplete gamma
P(a, x) with derivatives in the SHAPES, because a = mu(loc) * phi depends on
the latent location, and the Laplace machinery differentiates the
log-likelihood up to three times in the location.

PyTorch has no incomplete beta, and ``torch.special.gammainc`` has no
derivative in the shape. Values: I_x(a, b) by its continued fraction (the
modified Lentz iteration, run until every entry has converged, at most
:data:`CF_MAX_TERMS` terms), P(a, x) by its series below x = a + 1 and
the continued fraction of Q above (``torch.special.gammainc`` misses the
JAX package's values at 1e-10 near x ~ a). Each is
a ``torch.autograd.Function`` whose backward is itself built from
differentiable torch ops (the Function again, ``digamma``, the quadrature
below), so derivatives of any order compose, as the JAX package's
``custom_jvp`` rules do. The shape derivatives follow the JAX package's
integral forms with the singularity-removing substitution t = x s^(1/a) and
fixed 200-node Gauss-Legendre quadrature:

    d/da I_x(a,b) = J_a / B(a,b) - I_x(a,b) (psi(a) - psi(a+b)),
    J_a = int_0^x t^(a-1) (1-t)^(b-1) ln t dt,

and analogously for b (with ln(1-t)) and for the lower incomplete gamma.
"""
from __future__ import annotations

import numpy as np
import torch

from gpboost_tpu_torch.likelihoods import _Digamma, gammaln

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(200)
# map from [-1, 1] to (0, 1)
_GL_S = 0.5 * (_GL_NODES + 1.0)
_GL_W = 0.5 * _GL_WEIGHTS
# the continued fraction's terms: a check every CF_CHECK terms stops once
# every entry's last factor is within CF_TOL of 1 (a few float64 ulps)
CF_MAX_TERMS = 1000
CF_CHECK = 25
CF_TOL = 1e-15


def digamma(x: torch.Tensor) -> torch.Tensor:
    return _Digamma.apply(x)


def betaln_ad(a, b):
    """log B(a, b) via gammaln (derivatives of every order exact)."""
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def _nodes(ref: torch.Tensor):
    return (torch.as_tensor(_GL_S, dtype=ref.dtype, device=ref.device),
            torch.as_tensor(_GL_W, dtype=ref.dtype, device=ref.device))


def _panel_sub(a, gb_log, gfun, c):
    """Quadrature of exp(gb_log(t)) * gfun(t) over [0, c] with the
    substitution t = c s^(1/a); gb_log excludes the t^(a-1) factor, which
    the substitution's jacobian absorbs."""
    s, w = _nodes(c)
    t = c[..., None] * s ** (1.0 / a[..., None])
    log_node = (a[..., None] * torch.log(torch.clamp(c[..., None],
                                                     min=1e-300))
                - torch.log(a)[..., None] + gb_log(t))
    return torch.sum(w * torch.exp(torch.clamp(log_node, max=700.0))
                     * gfun(t), dim=-1)


def _panel_plain(a, gb_log, gfun, lo, hi):
    """Plain Gauss-Legendre of t^(a-1) exp(gb_log(t)) gfun(t) over [lo, hi];
    an empty panel (hi <= lo) contributes exactly 0 (double where: a bare
    max(width, 0) lets derivatives through the tie and gives NaN at second
    order)."""
    s, w = _nodes(lo)
    width_raw = hi - lo
    pos = width_raw > 0.0
    width = torch.where(pos, width_raw, 1.0)
    t = torch.clamp(lo[..., None] + width[..., None] * s, min=1e-300)
    log_node = ((a[..., None] - 1.0) * torch.log(t) + gb_log(t)
                + torch.log(width[..., None]))
    out = torch.sum(w * torch.exp(torch.clamp(log_node, max=700.0))
                    * gfun(t), dim=-1)
    return torch.where(pos, out, 0.0)


def _beta_J(a, b, x, which: str):
    """J = int_0^x t^(a-1)(1-t)^(b-1) g(t) dt, g = ln t or ln(1-t): the
    substituted head [0, c] (the t -> 0 singularity for a < 1), then [c, x]
    plain (the peak near a/(a+b))."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    c = torch.minimum(x, 0.5 * a / (a + b))

    def gb_log(t):
        return (b[..., None] - 1.0) * torch.log1p(
            -torch.clamp(t, max=1.0 - 1e-15))

    if which == "a":
        def gfun(t):
            return torch.log(torch.clamp(t, min=1e-300))
    else:
        def gfun(t):
            return torch.log1p(-torch.clamp(t, max=1.0 - 1e-15))

    return (_panel_sub(a, gb_log, gfun, c)
            + _panel_plain(a, gb_log, gfun, c, x))


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (modified Lentz), for
    x < (a + 1) / (a + b + 2)."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
    h = d.clone()
    for m in range(1, CF_MAX_TERMS + 1):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
            c = 1.0 + aa / c
            c = torch.where(torch.abs(c) < tiny, tiny, c)
            delta = d * c
            h = h * delta
        if _converged(delta - 1.0, m):
            break
    return h


def _betainc_value(a, b, x):
    """I_x(a, b) for a, b > 0, x in [0, 1]."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    xc = torch.clamp(x, 0.0, 1.0)
    swap = xc > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xc, xc)
    inner = (xx > 0.0) & (xx < 1.0)
    xs = torch.where(inner, xx, 0.5)
    log_front = (aa * torch.log(xs) + bb * torch.log1p(-xs)
                 - torch.lgamma(aa) - torch.lgamma(bb)
                 + torch.lgamma(aa + bb))
    val = torch.exp(log_front) * _betacf(aa, bb, xs) / aa
    val = torch.where(inner, val, torch.where(xx <= 0.0, 0.0, 1.0))
    return torch.where(swap, 1.0 - val, val)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a broadcast gradient back to an input's shape."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _BetaInc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        return _betainc_value(a, b, x)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        I = _BetaInc.apply(a, b, x)
        logB = betaln_ad(a, b)
        out = [None, None, None]
        if ctx.needs_input_grad[2]:
            # the pdf, its exponent floored so it never underflows to an
            # exact 0 (0 * inf under higher-order differentiation)
            log_pdf = ((a - 1.0) * torch.log(torch.clamp(x, 1e-300, 1.0))
                       + (b - 1.0) * torch.log1p(-torch.clamp(
                           x, 0.0, 1.0 - 1e-15)) - logB)
            out[2] = _unbroadcast(
                g * torch.exp(torch.clamp(log_pdf, -700.0, 700.0)), x.shape)
        dab = digamma(a + b)
        if ctx.needs_input_grad[0]:
            da = (_beta_J(a, b, x, "a") * torch.exp(-logB)
                  - I * (digamma(a) - dab))
            out[0] = _unbroadcast(g * da, a.shape)
        if ctx.needs_input_grad[1]:
            db = (_beta_J(a, b, x, "b") * torch.exp(-logB)
                  - I * (digamma(b) - dab))
            out[1] = _unbroadcast(g * db, b.shape)
        return tuple(out)


def _as_tensors(*args):
    ref = next((v for v in args if isinstance(v, torch.Tensor)), None)
    kw = ({} if ref is None else dict(dtype=ref.dtype, device=ref.device))
    return tuple(torch.as_tensor(v, **kw) for v in args)


def betainc_ad(a, b, x):
    """Regularized incomplete beta I_x(a, b), differentiable in all args."""
    return _BetaInc.apply(*_as_tensors(a, b, x))


def _gamma_J(a, x):
    """int_0^x t^(a-1) e^(-t) ln t dt — substituted head [0, c] + plain tail
    [c, x_cap]; the tail past a + 40 sqrt(a) + 50 is < 1e-14 of the mass."""
    a, x = torch.broadcast_tensors(a, x)
    x = torch.minimum(x, a + 40.0 * torch.sqrt(a) + 50.0)
    c = torch.clamp(x, max=1.0)

    def gb_log(t):
        return -t

    def gfun(t):
        return torch.log(torch.clamp(t, min=1e-300))

    return (_panel_sub(a, gb_log, gfun, c)
            + _panel_plain(a, gb_log, gfun, c, x))


def _converged(delta: torch.Tensor, m: int) -> bool:
    return m % CF_CHECK == 0 and bool(torch.all(torch.abs(delta) <= CF_TOL))


def _gammainc_value(a, x):
    """P(a, x) for a > 0, x >= 0: the series below x = a + 1, the
    continued fraction of Q (modified Lentz) above (``torch.special.
    gammainc`` misses the JAX package's values at 1e-10 near x ~ a)."""
    a, x = torch.broadcast_tensors(a, x)
    tiny = 1e-300
    use_series = x < a + 1.0
    xs = torch.where(use_series, torch.clamp(x, min=tiny), a + 1.0)
    log_front_s = a * torch.log(xs) - xs - torch.lgamma(a + 1.0)
    term = torch.ones_like(xs)
    total = torch.ones_like(xs)
    for n in range(1, CF_MAX_TERMS + 1):
        term = term * xs / (a + n)
        total = total + term
        if _converged(term / total, n):
            break
    p_series = torch.exp(log_front_s) * total
    xc = torch.where(use_series, a + 1.0, x)
    b = xc + 1.0 - a
    c = torch.full_like(xc, 1.0 / tiny)
    d = 1.0 / b
    h = d.clone()
    for i in range(1, CF_MAX_TERMS + 1):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        delta = d * c
        h = h * delta
        if _converged(delta - 1.0, i):
            break
    q_cf = torch.exp(a * torch.log(xc) - xc - torch.lgamma(a)) * h
    return torch.where(x <= 0.0, 0.0,
                       torch.where(use_series, p_series, 1.0 - q_cf))


class _GammaInc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return _gammainc_value(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        out = [None, None]
        lga = gammaln(a)
        if ctx.needs_input_grad[1]:
            log_pdf = ((a - 1.0) * torch.log(torch.clamp(x, min=1e-300))
                       - x - lga)
            out[1] = _unbroadcast(
                g * torch.exp(torch.clamp(log_pdf, -700.0, 700.0)), x.shape)
        if ctx.needs_input_grad[0]:
            P = _GammaInc.apply(a, x)
            da = _gamma_J(a, x) * torch.exp(-lga) - P * digamma(a)
            out[0] = _unbroadcast(g * da, a.shape)
        return tuple(out)


def gammainc_ad(a, x):
    """Regularized lower incomplete gamma P(a, x), differentiable in both."""
    return _GammaInc.apply(*_as_tensors(a, x))


# ---------------------------------------------------------------------------
# stable log-tail CDFs: below ~1e-8 the quadrature-backed derivative rules
# lose relative accuracy (d log F = dF / F amplifies absolute error), so the
# far tails switch to series / asymptotic expansions with clean closed-form
# derivatives.
# ---------------------------------------------------------------------------

def log_gammainc_lower_ad(a, x):
    """log P(a, x), stable into the x -> 0 tail.

    Series: P = x^a e^-x / Gamma(a+1) * sum_n x^n / ((a+1)...(a+n))."""
    a, x = _as_tensors(a, x)
    P = gammainc_ad(a, x)
    use_series = P < 1e-8
    x_small = torch.minimum(x, torch.clamp(0.9 * a, min=1e-10))
    S = torch.ones_like(x_small)
    term = torch.ones_like(x_small)
    for n in range(1, 9):
        term = term * x_small / (a + n)
        S = S + term
    log_series = (a * torch.log(torch.clamp(x_small, min=1e-300)) - x_small
                  - gammaln(a + 1.0) + torch.log(S))
    log_direct = torch.log(torch.clamp(torch.where(use_series, 1.0, P),
                                       min=1e-300))
    return torch.where(use_series, log_series, log_direct)


def log_gammainc_upper_ad(a, x):
    """log Q(a, x) = log(1 - P(a, x)), stable into the x -> inf tail.

    Asymptotic: Q ~ x^(a-1) e^-x / Gamma(a) * (1 + (a-1)/x + ...)."""
    a, x = _as_tensors(a, x)
    Q = 1.0 - gammainc_ad(a, x)
    use_asym = Q < 1e-8
    x_large = torch.maximum(x, a + 5.0)
    S = torch.ones_like(x_large)
    term = torch.ones_like(x_large)
    for n in range(1, 5):
        term = term * (a - n) / x_large
        S = S + term
    log_asym = ((a - 1.0) * torch.log(x_large) - x_large - gammaln(a)
                + torch.log(torch.clamp(S, min=1e-10)))
    log_direct = torch.log(torch.clamp(torch.where(use_asym, 1.0, Q),
                                       min=1e-300))
    return torch.where(use_asym, log_asym, log_direct)


def log_betainc_ad(a, b, x):
    """log I_x(a, b), stable into the x -> 0 tail.

    Series: I_x = x^a / (a B(a,b)) * 2F1(a, 1-b; a+1; x)
                = x^a / (a B(a,b)) * sum_n [prod_k (k-b)/k] a/(a+n) x^n."""
    a, b, x = _as_tensors(a, b, x)
    I = betainc_ad(a, b, x)
    use_series = I < 1e-8
    x_small = torch.minimum(x, 0.9 * a / (a + b))
    S = torch.ones_like(x_small)
    term = torch.ones_like(x_small)
    for n in range(1, 9):
        term = term * (n - b) / n * x_small
        S = S + term * a / (a + n)
    log_series = (a * torch.log(torch.clamp(x_small, min=1e-300))
                  - torch.log(a) - betaln_ad(a, b)
                  + torch.log(torch.clamp(S, min=1e-10)))
    log_direct = torch.log(torch.clamp(torch.where(use_series, 1.0, I),
                                       min=1e-300))
    return torch.where(use_series, log_series, log_direct)


def log1m_betainc_ad(a, b, x):
    """log(1 - I_x(a, b)) via the symmetry 1 - I_x(a,b) = I_{1-x}(b,a)."""
    a, b, x = _as_tensors(a, b, x)
    return log_betainc_ad(b, a, 1.0 - x)
