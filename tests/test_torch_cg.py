"""The port's iterative solvers (``ops/cg.py``) vs the JAX package's, float64
on the CPU, inputs from a numpy seed: batched PCG (iterates at 1e-8 relative
and the same iteration count), Lanczos tridiagonalisation (alpha / beta at
1e-8 relative), the log-determinant from the tridiagonal matrices (1e-10),
and the differentiable stochastic log-determinant with the JAX package's
probes handed to both sides (value and gradient at 1e-6 relative), and
the pieces ported from item 12 (``pcg_implicit`` with ``pre_U``, the
variance-reduced log-determinant, the Nystrom and low-rank preconditioners)
against their JAX counterparts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gpboost_tpu.ops import cg as jcg

from gpboost_tpu_torch.ops import cg as tcg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, K = 60, 5


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(3)
    L = rng.standard_normal((N, N)) / np.sqrt(N)
    base = L @ L.T
    diag = 0.5 + rng.uniform(size=N)
    B = rng.standard_normal((N, K))
    return base, diag, B


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                    1e-300))


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("tol", [1e-2, 1e-10])
def test_pcg_matches_jax(spd, precond, tol):
    base, diag, B = spd
    A = base + np.diag(diag)
    pre_j = (lambda r: r / jnp.asarray(diag)[:, None]) if precond else None
    pre_t = (lambda r: r / torch.tensor(diag)[:, None]) if precond else None
    Xj, itj = jcg.pcg(lambda V: jnp.asarray(A) @ V, jnp.asarray(B), pre_j,
                      tol=tol, max_iter=500)
    Xt, itt = tcg.pcg(lambda V: torch.tensor(A) @ V, torch.tensor(B), pre_t,
                      tol=tol, max_iter=500)
    assert itt == int(itj)
    assert _rel(Xt, Xj) < 1e-8
    # one right-hand side as a vector
    xj, _ = jcg.pcg(lambda V: jnp.asarray(A) @ V, jnp.asarray(B[:, 0]),
                    pre_j, tol=tol, max_iter=500)
    xt, _ = tcg.pcg(lambda V: torch.tensor(A) @ V, torch.tensor(B[:, 0]),
                    pre_t, tol=tol, max_iter=500)
    assert xt.shape == (N,) and _rel(xt, xj) < 1e-8


def test_pcg_stops_at_max_iter(spd):
    base, diag, B = spd
    A = torch.tensor(base + np.diag(diag))
    _, it = tcg.pcg(lambda V: A @ V, torch.tensor(B), tol=1e-14, max_iter=3)
    assert it == 3


@pytest.mark.parametrize("precond", [False, True])
def test_lanczos_and_logdet_match_jax(spd, precond):
    base, diag, B = spd
    A = base + np.diag(diag)
    pre_j = (lambda r: r / jnp.asarray(diag)[:, None]) if precond else None
    pre_t = (lambda r: r / torch.tensor(diag)[:, None]) if precond else None
    aj, bj = jcg.lanczos_tridiag(lambda V: jnp.asarray(A) @ V,
                                 jnp.asarray(B), 20, pre_j)
    at, bt = tcg.lanczos_tridiag(lambda V: torch.tensor(A) @ V,
                                 torch.tensor(B), 20, pre_t)
    assert at.shape == (20, K) and bt.shape == (19, K)
    assert _rel(at, aj) < 1e-8 and _rel(bt, bj) < 1e-8
    zn = np.sum(B * B, axis=0)
    vj = jcg._logdet_from_tridiag(aj, bj, jnp.asarray(zn))
    vt = tcg._logdet_from_tridiag(at, bt, torch.tensor(zn))
    assert abs(float(vt) - float(vj)) < 1e-10 * abs(float(vj))


def test_stochastic_logdet_grad_matches_jax_with_its_probes(spd):
    """logdet(A(theta)), A = base + diag(exp(theta)), Jacobi
    preconditioner: value (Lanczos quadrature) and gradient (Hutchinson
    surrogate over Rademacher probes) against the JAX package's with the
    same probes, and the value near the exact log-determinant."""
    base, diag, _ = spd
    theta = np.log(diag)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    pre_d = np.diag(base) + diag
    e = np.asarray(jax.random.normal(k1, (N, 200), jnp.float64))
    Z = np.sqrt(pre_d)[:, None] * e
    Zg = np.asarray(jcg.rademacher_probes(k2, N, 200, jnp.float64))
    pre_logdet = float(np.sum(np.log(pre_d)))

    def jval(th):
        return jcg.stochastic_logdet_grad(
            lambda V: jnp.asarray(base) @ V + jnp.exp(th)[:, None] * V, None,
            jnp.asarray(Z), 30,
            lambda r: r / jnp.asarray(pre_d)[:, None],
            jnp.asarray(pre_logdet), 1e-10, 500, probes_grad=jnp.asarray(Zg))

    vj, gj = jax.value_and_grad(jval)(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    stats = {}
    vt = tcg.stochastic_logdet_grad(
        lambda V: torch.tensor(base) @ V + torch.exp(th)[:, None] * V, None,
        torch.tensor(Z), 30, lambda r: r / torch.tensor(pre_d)[:, None],
        torch.tensor(pre_logdet), 1e-10, 500, probes_grad=torch.tensor(Zg),
        stats=stats)
    (gt,) = torch.autograd.grad(vt, th)
    assert abs(float(vt) - float(vj)) < 1e-6 * abs(float(vj))
    assert _rel(gt, gj) < 1e-6
    assert stats["lanczos_steps"] == 30 and stats["grad_cg_iters"] > 0
    exact = np.linalg.slogdet(base + np.diag(diag))[1]
    assert abs(float(vt) - exact) < 0.05 * abs(exact)


def test_value_alone_skips_the_surrogate_and_keeps_its_bits(spd):
    """Without gradients the estimate is the same bits as with them, and
    the surrogate's CG solve does not run."""
    base, diag, _ = spd
    rng = np.random.default_rng(4)
    Z = torch.tensor(rng.standard_normal((N, 16)))
    th = torch.tensor(np.log(diag), requires_grad=True)

    def mv(V):
        return torch.tensor(base) @ V + torch.exp(th)[:, None] * V

    with_grad, alone = {}, {}
    v1 = tcg.stochastic_logdet_grad(mv, None, Z, 10, cg_tol=1e-8,
                                    stats=with_grad)
    with torch.no_grad():
        v2 = tcg.stochastic_logdet_grad(mv, None, Z, 10, cg_tol=1e-8,
                                        stats=alone)
    assert torch.equal(v1.detach(), v2) and not v2.requires_grad
    assert with_grad["grad_cg_iters"] > 0 and "grad_cg_iters" not in alone
    assert alone["lanczos_steps"] == 10


def test_logdet_of_a_non_finite_tridiagonal_is_nan():
    """A probe whose Lanczos coefficients are not finite (a line search's
    overshoot) makes the estimate NaN, as in the JAX package, instead of
    the exception ``eigh`` raises on the card."""
    alphas = torch.ones(5, 3, dtype=torch.float64)
    betas = torch.full((4, 3), 0.1, dtype=torch.float64)
    alphas[2, 1] = float("nan")
    v = tcg._logdet_from_tridiag(alphas, betas, torch.ones(3))
    assert torch.isnan(v)
    ok = tcg._logdet_from_tridiag(alphas[:, [0, 2]], betas[:, [0, 2]],
                                  torch.ones(2, dtype=torch.float64))
    assert torch.isfinite(ok)


def test_jacobi_preconditioner_and_probes():
    gen = torch.Generator().manual_seed(5)
    z = tcg.rademacher_probes(gen, 1000, 3)
    assert z.dtype == torch.float64 and set(z.unique().tolist()) == {-1.0, 1.0}
    e1 = tcg.normal_probes(torch.Generator().manual_seed(5), 10, 2)
    e2 = tcg.normal_probes(torch.Generator().manual_seed(5), 10, 2)
    assert torch.equal(e1, e2)
    d = torch.tensor([1.0, 4.0, 9.0], dtype=torch.float64)
    pre = tcg.JacobiPreconditioner(d)
    r = torch.ones(3, 2, dtype=torch.float64)
    torch.testing.assert_close(pre.solve(r)[:, 0], 1.0 / d)
    torch.testing.assert_close(pre.solve(r[:, 0]), 1.0 / d)
    assert abs(float(pre.logdet()) - float(np.log(36.0))) < 1e-14
    s = pre.sample_probes(torch.Generator().manual_seed(1), 4)
    assert s.shape == (3, 4)


def _pcg_implicit_pre_u():
    """``pcg_implicit`` with the low-rank preconditioner: X and the
    implicit gradient w.r.t. theta equal the JAX package's (1e-8)."""
    rng = np.random.default_rng(8)
    n = 30
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    base, B, U = L @ L.T, rng.standard_normal((n, 2)), \
        rng.standard_normal((n, 3))
    t0, pre_d = np.zeros(n), np.diag(L @ L.T) + 1.0
    Xj, vjp = jax.vjp(lambda t: jcg.pcg_implicit(
        lambda th, V: jnp.asarray(base) @ V + jnp.exp(th)[:, None] * V, t,
        jnp.asarray(B), jnp.asarray(pre_d), 1e-12, 300,
        pre_U=jnp.asarray(U)), jnp.asarray(t0))
    (gj,) = vjp(jnp.ones_like(Xj))
    t = torch.tensor(t0, requires_grad=True)
    Xt = tcg.pcg_implicit(
        lambda th, V: torch.tensor(base) @ V + torch.exp(th[0])[:, None] * V,
        (t,), torch.tensor(B), torch.tensor(pre_d), 1e-12, 300,
        pre_U=torch.tensor(U))
    (gt,) = torch.autograd.grad(Xt.sum(), t)
    assert _rel(Xt, Xj) < 1e-8 and _rel(gt, gj) < 1e-8


def _logdet_vr():
    """``stochastic_logdet_grad_vr`` on a fixed A (no parameter gradient
    wanted): its value is the preconditioned Lanczos estimate plus
    logdet P, the JAX package's with the same probes (1e-10)."""
    rng = np.random.default_rng(9)
    n = 30
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    A = L @ L.T + np.eye(n)
    d = np.diag(A)
    Z = rng.standard_normal((n, 6))
    vj = jcg.stochastic_logdet_grad_vr(
        lambda th, V: jnp.asarray(A) @ V, lambda th, V: th[0][:, None] * V,
        lambda th: jnp.sum(jnp.log(th[0])), (jnp.asarray(d),),
        jnp.asarray(Z), 20, lambda r: r / jnp.asarray(d)[:, None], 1e-10,
        300)
    vt = tcg.stochastic_logdet_grad_vr(
        lambda th, V: torch.tensor(A) @ V, lambda th, V: th[0][:, None] * V,
        lambda th: torch.sum(torch.log(th[0])), (torch.tensor(d),),
        torch.tensor(Z), 20, lambda r: r / torch.tensor(d)[:, None], 1e-10,
        300)
    assert abs(float(vt) - float(vj)) < 1e-10 * abs(float(vj))


def _nystrom():
    """``nystrom_preconditioner`` from the JAX package's sketch: the same
    P (1e-10)."""
    rng = np.random.default_rng(10)
    L = rng.standard_normal((40, 40))
    A = L @ L.T + np.eye(40)
    key = jax.random.PRNGKey(2)
    pj = jcg.nystrom_preconditioner(lambda V: jnp.asarray(A) @ V, 40, 8, key)
    pt = tcg.nystrom_preconditioner(
        lambda V: torch.tensor(A) @ V, 40, 8, omega=torch.tensor(np.asarray(
            jax.random.normal(key, (40, 8), jnp.float64))))
    Uj, Ut = np.asarray(pj.U), pt.U.numpy()
    assert _rel(Ut @ Ut.T + np.diag(pt.d.numpy()),
                Uj @ Uj.T + np.diag(np.asarray(pj.d))) < 1e-10


def _lowrank_create():
    """``LowRankDiagPreconditioner.create``: solve and logdet equal the JAX
    package's (1e-12)."""
    rng = np.random.default_rng(11)
    U, d = rng.standard_normal((25, 4)), 1.0 + rng.uniform(size=25)
    r = rng.standard_normal((25, 2))
    pj = jcg.LowRankDiagPreconditioner.create(jnp.asarray(U), jnp.asarray(d))
    pt = tcg.LowRankDiagPreconditioner.create(torch.tensor(U),
                                              torch.tensor(d))
    assert _rel(pt.solve(torch.tensor(r)), pj.solve(jnp.asarray(r))) < 1e-12
    assert abs(float(pt.logdet()) - float(pj.logdet())) < 1e-12 * abs(
        float(pj.logdet()))


def _lowrank_probes():
    """``LowRankDiagPreconditioner`` probes from the JAX package's normals
    equal its ``sample_probes`` (1e-12)."""
    rng = np.random.default_rng(12)
    U, d = rng.standard_normal((25, 4)), 1.0 + rng.uniform(size=25)
    pj = jcg.LowRankDiagPreconditioner.create(jnp.asarray(U), jnp.asarray(d))
    pt = tcg.LowRankDiagPreconditioner(*tcg.LowRankDiagPreconditioner.create(
        torch.tensor(U), torch.tensor(d)))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    e_r = np.asarray(jax.random.normal(k1, (4, 5), jnp.float64))
    e_n = np.asarray(jax.random.normal(k2, (25, 5), jnp.float64))
    assert _rel(pt.probes_from(torch.tensor(e_r), torch.tensor(e_n)),
                pj.sample_probes(key, 5)) < 1e-12


@pytest.mark.parametrize("call", [_pcg_implicit_pre_u, _logdet_vr, _nystrom,
                                  _lowrank_create, _lowrank_probes])
def test_unported_pieces_name_their_item(call):
    """The pieces this case pinned as raises (ROADMAP.md Queue A, item 12)
    are ported: each now holds against the JAX package's counterpart."""
    call()
