"""The non-Gaussian (Laplace) full-scale Vecchia approximation in the port
(``models/fsva_model.py``: the dense route, the iterative one with the
Newton-CG mode ``_FindModeCGFSVA``, ``ops/cg.py::pcg_implicit`` and the
split log-determinant) against the JAX package on the CPU, float64 — the
port's counterpart of ``tests/test_fsva_laplace.py`` (its iterative tests
are in ``tests/test_torch_fsva_laplace_iterative.py``).

- the R goldens of that file (``test_GPModel_non_Gaussian_data.R:1640-1795``,
  the VIF block) at its tolerances (TOLERANCE_ITERATIVE = 0.1);
- the dense Laplace NLL and its gradient against the JAX package on one
  structure, 1e-8 and 1e-6 relative (the mode finders of both packages stop
  at a relative change of 1e-9 in the objective, so they agree to that,
  not to rounding);
- ``pcg_implicit``'s backward against a dense solve;
- prediction: the dense route against the JAX package (1e-7), the port's
  matrix-free route (the one it takes above 8 192 points) against its dense
  one (1e-5: the Newton-CG mode's solves stop at 1e-6 relative residual,
  as the JAX package's).
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops import cg as tcg

TOL_ITER = 1e-1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vif():
    """The data of the JAX file's fixture (test_GPModel_non_Gaussian_data.R
    :27-60, the VIF block's response draw)."""
    n = 100
    x = sim_rand_unif(n * 2, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    L = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    b_1 = sim_rand_normal(n, 0.8)
    X = np.column_stack([np.ones(n), np.sin((np.arange(1, n + 1) - n / 2)
                                            ** 2 * 2 * np.pi / n)])
    y = (sim_rand_unif(n, 0.19341) < norm.cdf(L @ b_1)).astype(float)
    return dict(y=y, coords=coords, X=X, n=n, D=D)


def _model(vif, pkg, **kw):
    args = dict(gp_coords=vif["coords"], cov_function="exponential",
                likelihood="bernoulli_probit", gp_approx="full_scale_vecchia",
                vecchia_ordering="none", **kw)
    return gpb.GPModel(**args) if pkg == "jax" else \
        gpt.GPModel(device="cpu", **args)


def test_fsva_laplace_nll_golden(vif):
    m = _model(vif, "torch", num_neighbors=vif["n"] - 1, num_ind_points=20)
    nll = m.neg_log_likelihood(cov_pars=[1.0, 0.2], y=vif["y"])
    assert abs(nll - 67.18342059) < 2 * TOL_ITER


def test_fsva_laplace_fit_and_predict_golden(vif):
    m = _model(vif, "torch", num_neighbors=vif["n"] - 1, num_ind_points=20)
    iu = np.triu_indices(vif["n"], 1)
    m.fit(y=vif["y"], X=vif["X"], params={
        "optimizer_cov": "lbfgs",
        "init_cov_pars": [1.0, np.mean(vif["D"][iu]) / 3]})
    assert np.sum(np.abs(m.get_cov_pars()
                         - [0.92350821208, 0.05944214192])) < TOL_ITER
    assert np.sum(np.abs(m.get_coef() - [0.3983333, -0.2653886])) < TOL_ITER
    ct = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
    Xt = np.column_stack([np.ones(3), [-0.5, 0.2, 1.0]])
    pred = m.predict(y=vif["y"], gp_coords_pred=ct, predict_var=True,
                     predict_response=False, cov_pars=[1.0, 0.2], X_pred=Xt)
    assert np.sum(np.abs(pred["mu"] - [0.3389905, 0.1512445, -0.1039307])) \
        < TOL_ITER
    assert np.sum(np.abs(pred["var"] - [0.6193228722, 0.6159348965,
                                        0.4291674143])) < TOL_ITER


def test_fsva_laplace_less_neighbors_golden(vif):
    m = _model(vif, "torch", num_neighbors=10, num_ind_points=20)
    ct = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
    Xt = np.column_stack([np.ones(3), [-0.5, 0.2, 1.0]])
    iu = np.triu_indices(vif["n"], 1)
    m.fit(y=vif["y"], X=vif["X"], params={
        "optimizer_cov": "lbfgs",
        "init_cov_pars": [1.0, np.mean(vif["D"][iu]) / 3]})
    pred = m.predict(y=vif["y"], gp_coords_pred=ct, predict_var=True,
                     predict_response=False, cov_pars=[1.0, 0.2], X_pred=Xt)
    assert np.sum(np.abs(pred["mu"] - [0.3362000, 0.1499488, -0.1014509])) \
        < TOL_ITER
    assert np.sum(np.abs(pred["var"] - [0.6036511, 0.6025073, 0.4220153])) \
        < TOL_ITER


def test_dense_nll_gradient_and_prediction_match_jax(vif):
    jm = _model(vif, "jax", num_neighbors=15, num_ind_points=20)
    tm = _model(vif, "torch", num_neighbors=15, num_ind_points=20)
    cp = [1.0, 0.2]
    fe = 0.2 * np.cos(5 * vif["coords"][:, 1])
    nll_j = jm.neg_log_likelihood(cp, vif["y"], fixed_effects=fe)
    assert abs(tm.neg_log_likelihood(cp, vif["y"], fixed_effects=fe)
               - nll_j) < 1e-8 * abs(nll_j)
    g_j = jax.grad(lambda c: jm._approx.nll_laplace(
        c, jnp.asarray(vif["y"]), None, jnp.asarray(fe)))(jnp.asarray(cp))
    c = torch.tensor(cp, dtype=torch.float64, requires_grad=True)
    (g_t,) = torch.autograd.grad(tm._approx.nll_laplace(
        c, torch.tensor(vif["y"]), None, torch.tensor(fe)), c)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6)
    ct = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
    for resp in (False, True):
        pj = jm.predict(y=vif["y"], gp_coords_pred=ct, cov_pars=cp,
                        predict_var=True, predict_response=resp)
        pt = tm.predict(y=vif["y"], gp_coords_pred=ct, cov_pars=cp,
                        predict_var=True, predict_response=resp)
        np.testing.assert_allclose(pt["mu"], pj["mu"], atol=1e-7)
        np.testing.assert_allclose(pt["var"], pj["var"], atol=1e-7)
    # the matrix-free prediction against the dense one
    args = (tm._tensor(cp), torch.tensor(vif["y"]), None, tm._tensor(ct),
            torch.tensor(fe), None, False, True)
    md, vd = tm._approx.predict_laplace(*args)
    mi, vi = tm._approx.predict_laplace(*args, iterative=True)
    torch.testing.assert_close(mi, md, rtol=0, atol=1e-5)
    torch.testing.assert_close(vi, vd, rtol=0, atol=1e-5)


def test_pcg_implicit_gradient():
    """``pcg_implicit``'s backward against autograd through a dense solve:
    X = A(theta)^-1 B, A = S + diag(theta), 1e-8."""
    rng = np.random.default_rng(0)
    n, q = 30, 4
    S = rng.standard_normal((n, n))
    S = torch.tensor(S @ S.T / n + np.eye(n))
    B = torch.tensor(rng.standard_normal((n, q)), requires_grad=True)
    th = torch.tensor(rng.uniform(0.5, 1.5, n), requires_grad=True)
    W = torch.tensor(rng.standard_normal((n, q)))

    def mv(theta, V):
        return S @ V + theta[0][:, None] * V

    X = tcg.pcg_implicit(mv, (th,), B, torch.diagonal(S) + th.detach(),
                         1e-12, 500)
    g = torch.autograd.grad(torch.sum(X * W), (B, th))
    X0 = torch.linalg.solve(S + torch.diag(th), B)
    g0 = torch.autograd.grad(torch.sum(X0 * W), (B, th))
    torch.testing.assert_close(X, X0, rtol=1e-9, atol=1e-10)
    for a, b in zip(g, g0):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-9)
