"""The iterative route of the non-Gaussian full-scale Vecchia approximation
in the port (``models/fsva_model.py::nll_laplace_iterative``: the Newton-CG
mode ``_FindModeCGFSVA``, the k-column ``pcg_implicit`` solve of the exact
log-determinant term, stochastic Lanczos for logdet(Q + W)) against the JAX
package on the CPU, float64 — the iterative tests of
``tests/test_fsva_laplace.py``:

- the NLL and its gradients w.r.t. the covariance parameters and F with the
  JAX package's probes rebuilt here (``jax.random.split(PRNGKey(seed))``:
  normal value probes from the first key, Rademacher gradient probes from
  the second) and handed to the port's ``_nll_laplace_iterative``: 1e-5
  relative, as ``tests/test_torch_laplace_iterative.py`` holds the Vecchia
  route;
- the iterative fit against the R goldens within 2 TOLERANCE_ITERATIVE (the
  JAX file's bounds).
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.ops import cg as jcg
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif

import gpboost_tpu_torch as gpt

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


def test_iterative_matches_jax_with_its_probes(vif):
    """The iterative NLL (Newton-CG mode, the k-column implicit CG, the
    split log-determinant) and its gradients w.r.t. the covariance
    parameters and F, with the JAX package's probes: 1e-5 relative."""
    K, STEPS, SEED = 24, 30, 3
    kw = dict(num_neighbors=15, num_ind_points=20,
              matrix_inversion_method="iterative")
    jm, tm = _model(vif, "jax", **kw), _model(vif, "torch", **kw)
    n, y = vif["n"], vif["y"]
    fe = 0.2 * np.cos(5 * vif["coords"][:, 1])
    cp = [1.0, 0.2]

    def jf(c, F):
        return jm._approx.nll_laplace_iterative(
            c, jnp.asarray(y), None, F, num_rand_vec_trace=K,
            lanczos_steps=STEPS, cg_tol=1e-3, cg_max_iter=1000,
            seed_rand_vec_trace=SEED)

    vj, (gcj, gFj) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(cp), jnp.asarray(fe))
    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    e = np.asarray(jax.random.normal(k1, (n, K), jnp.float64))
    zg = np.asarray(jcg.rademacher_probes(k2, n, K, jnp.float64))
    c = torch.tensor(cp, dtype=torch.float64, requires_grad=True)
    F = torch.tensor(fe, requires_grad=True)
    vt = tm._approx._nll_laplace_iterative(
        c, torch.tensor(y), None, F, torch.tensor(e), torch.tensor(zg),
        STEPS, 1e-3, 1000)
    gct, gFt = torch.autograd.grad(vt, (c, F))
    assert abs(vt.item() - float(vj)) < 1e-5 * abs(float(vj))
    np.testing.assert_allclose(gct.numpy(), np.asarray(gcj), rtol=1e-5)
    np.testing.assert_allclose(gFt.numpy(), np.asarray(gFj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gFj)).max())
    # the public route with the port's own probes: the same value on every
    # call, near the dense NLL (the stochastic part is logdet(Q + W) alone)
    a = tm.neg_log_likelihood(cp, y)
    assert a == tm.neg_log_likelihood(cp, y)
    dense = _model(vif, "torch", num_neighbors=15, num_ind_points=20)
    assert abs(a - dense.neg_log_likelihood(cp, y)) < 0.3


def test_iterative_fit_golden(vif):
    """The iterative fit (L-BFGS, at least 200 probes) reaches the R
    goldens within 2 TOLERANCE_ITERATIVE (the JAX file's bounds)."""
    m = _model(vif, "torch", num_neighbors=vif["n"] - 1, num_ind_points=20,
               matrix_inversion_method="iterative")
    iu = np.triu_indices(vif["n"], 1)
    m.fit(y=vif["y"], X=vif["X"], params={
        "optimizer_cov": "lbfgs",
        "init_cov_pars": [1.0, np.mean(vif["D"][iu]) / 3]})
    assert np.sum(np.abs(m.get_cov_pars()
                         - [0.92350821208, 0.05944214192])) < 2 * TOL_ITER
    assert np.sum(np.abs(m.get_coef() - [0.3983333, -0.2653886])) < TOL_ITER
