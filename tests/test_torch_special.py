"""PyTorch port vs the JAX package: the differentiable incomplete beta /
gamma functions (``likelihoods/special.py``).

The same numpy inputs go through ``gpboost_tpu.likelihoods.special`` and
``gpboost_tpu_torch.likelihoods.special``, with the shapes a, b in
{0.5, 2, 30} and x from 1e-12 to 1 - 1e-6. Values at 1e-10 relative; the
first and second shape derivatives (``jax.grad`` against nested
``torch.autograd.grad``) at 1e-7 relative plus 1e-12 absolute: near x = 1
the shape derivative of I_x(a, b) ~ 1 is the difference of two O(1e-2)
terms (J_a / B and I (psi(a) - psi(a + b))), which both packages' 200-node
quadratures give to ~1e-15 absolute, not relative.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.likelihoods import special as js
from gpboost_tpu_torch.likelihoods import special as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [0.5, 2.0, 30.0]
X_BETA = np.array([1e-12, 1e-6, 1e-3, 0.05, 0.3, 0.5, 0.7, 0.95, 0.999,
                   1 - 1e-6])
X_GAMMA = np.array([1e-8, 1e-3, 0.3, 1.0, 2.0, 10.0, 35.0, 80.0])
# every (a, b, x) of the grid, as one vector each (one evaluation a case)
_AB = np.array(list(itertools.product(SHAPES, SHAPES)))
A_BETA = np.repeat(_AB[:, 0], len(X_BETA))
B_BETA = np.repeat(_AB[:, 1], len(X_BETA))
XB = np.tile(X_BETA, len(_AB))
A_GAMMA = np.repeat(SHAPES, len(X_GAMMA))
XG = np.tile(X_GAMMA, len(SHAPES))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _derivatives_close(tf, jf, args, arg):
    """First and second derivatives of sum f(args) in args[arg]: nested
    ``torch.autograd.grad`` against ``jax.grad``, 1e-7 + 1e-12."""
    jargs = [jnp.asarray(v) for v in args]

    def jsum(*ps):
        return jnp.sum(jf(*ps))

    g1 = jax.grad(jsum, argnums=arg)
    g2 = jax.grad(lambda *ps: jnp.sum(g1(*ps)), argnums=arg)
    p = [torch.tensor(v, requires_grad=(i == arg))
         for i, v in enumerate(args)]
    v = torch.sum(tf(*p))
    (d1,) = torch.autograd.grad(v, p[arg], create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), p[arg])
    _close(d1.detach(), g1(*jargs), 1e-7, 1e-12)
    _close(d2, g2(*jargs), 1e-7, 1e-12)


def test_incomplete_beta_values():
    args = (A_BETA, B_BETA, XB)
    t = [torch.tensor(v) for v in args]
    j = [jnp.asarray(v) for v in args]
    _close(ts.betainc_ad(*t), js.betainc_ad(*j), 1e-10, 1e-300)
    _close(ts.log_betainc_ad(*t), js.log_betainc_ad(*j), 1e-10)
    _close(ts.log1m_betainc_ad(*t), js.log1m_betainc_ad(*j), 1e-10)


@pytest.mark.parametrize("fn", ["log_betainc_ad", "log1m_betainc_ad"])
@pytest.mark.parametrize("arg", [0, 1])
def test_incomplete_beta_shape_derivatives(fn, arg):
    _derivatives_close(getattr(ts, fn), getattr(js, fn),
                       (A_BETA, B_BETA, XB), arg)


def test_incomplete_gamma_values():
    t = (torch.tensor(A_GAMMA), torch.tensor(XG))
    j = (jnp.asarray(A_GAMMA), jnp.asarray(XG))
    _close(ts.gammainc_ad(*t), js.gammainc_ad(*j), 1e-10, 1e-300)
    _close(ts.log_gammainc_lower_ad(*t), js.log_gammainc_lower_ad(*j), 1e-10)
    _close(ts.log_gammainc_upper_ad(*t), js.log_gammainc_upper_ad(*j), 1e-10)


@pytest.mark.parametrize("fn", ["log_gammainc_lower_ad",
                                "log_gammainc_upper_ad"])
@pytest.mark.parametrize("arg", [0, 1])
def test_incomplete_gamma_derivatives(fn, arg):
    _derivatives_close(getattr(ts, fn), getattr(js, fn), (A_GAMMA, XG), arg)


def test_betaln_and_broadcast_shapes():
    """betaln's second derivative (JAX's own betaln loses it; both packages
    compose gammaln), and a scalar x against vector shapes, as the censored
    likelihood calls it, with the gradient summed back to the scalar."""
    a = torch.tensor([0.7, 3.0, 12.0], dtype=torch.float64,
                     requires_grad=True)
    v = torch.sum(ts.betaln_ad(a, torch.tensor(2.5, dtype=torch.float64)))
    (g,) = torch.autograd.grad(v, a, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), a)
    jg = jax.grad(lambda p: jnp.sum(js.betaln_ad(p, 2.5)))
    jh = jax.grad(lambda p: jnp.sum(jg(p)))
    _close(h, jh(jnp.asarray([0.7, 3.0, 12.0])), 1e-10)
    x = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    b = torch.tensor([1.0, 4.0, 9.0], dtype=torch.float64)
    (gx,) = torch.autograd.grad(torch.sum(ts.betainc_ad(a, b, x)), x)
    want = jax.grad(lambda xx: jnp.sum(js.betainc_ad(
        jnp.asarray([0.7, 3.0, 12.0]), jnp.asarray([1.0, 4.0, 9.0]), xx)))(
        0.2)
    assert gx.shape == () and abs(float(gx) - float(want)) < 1e-10 * abs(
        float(want))
