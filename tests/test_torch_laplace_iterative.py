"""The port's iterative Vecchia-Laplace NLL (``nll_laplace_iterative``:
Newton-CG mode, Jacobi-preconditioned CG and stochastic Lanczos
log-determinant) vs the JAX package's at n = 200, float64 on the CPU, on the
same ordering and neighbours. The probes of the JAX package
(``jax.random.split(PRNGKey(seed), 3)``: normal value probes from the first
key, Rademacher gradient probes from the second) are rebuilt here and handed
to the port's ``_nll_laplace_iterative``, so both sides estimate with the
same vectors: value and gradients w.r.t. the covariance parameters and F at
1e-5 relative (ROADMAP.md: iterative paths are held at ~1e-5).

The port's own probes (a ``torch.Generator`` from the seed) are checked for
what they promise: the same value on every call, the same vectors for a
float32 and a float64 model; and the public iterative route (NLL, fit,
prediction) runs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.ops import cg as jcg

import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, M, K, STEPS, SEED = 200, 8, 24, 20, 3
CP = [1.1, 0.12]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    return dict(coords=coords, y=y, fe=0.3 * rng.standard_normal(N))


def _pair(data, **kw):
    args = dict(gp_coords=data["coords"], cov_function="exponential",
                gp_approx="vecchia", num_neighbors=M,
                likelihood="bernoulli_logit",
                matrix_inversion_method="iterative", **kw)
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    return jm, tm


def test_iterative_nll_and_gradients_match_jax_with_its_probes(data):
    jm, tm = _pair(data)
    y, fe = data["y"], data["fe"]

    def jf(c, F):
        return jm._approx.nll_laplace_iterative(
            c, jnp.asarray(y), None, F, num_rand_vec_trace=K,
            lanczos_steps=STEPS, cg_tol=1e-3, cg_max_iter=1000,
            seed_rand_vec_trace=SEED)

    vj, (gcj, gFj) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(CP), jnp.asarray(fe))
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    e = np.asarray(jax.random.normal(k1, (N, K), jnp.float64))
    zg = np.asarray(jcg.rademacher_probes(k2, N, K, jnp.float64))
    c = torch.tensor(CP, dtype=torch.float64, requires_grad=True)
    F = torch.tensor(fe, requires_grad=True)
    vt = tm._approx._nll_laplace_iterative(
        c, torch.tensor(y), None, F, torch.tensor(e), torch.tensor(zg),
        STEPS, 1e-3, 1000)
    gct, gFt = torch.autograd.grad(vt, (c, F))
    assert abs(float(vt) - float(vj)) < 1e-5 * abs(float(vj))
    for got, want in ((gct, gcj), (gFt, gFj)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) < 1e-5 * np.max(
            np.abs(want))


def test_port_probes_are_reused_and_shared_across_dtypes(data):
    _, tm = _pair(data)
    v1 = tm.neg_log_likelihood(CP, data["y"])
    v2 = tm.neg_log_likelihood(CP, data["y"])
    assert v1 == v2
    # with 1000 probes the estimate is near the exact (dense) Laplace NLL:
    # its Monte-Carlo standard deviation is ~0.5 here (seeds 1, 2 differ
    # from the exact value by 0.26 and 0.67), the bound is 5 of them
    dense = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=M,
                        likelihood="bernoulli_logit", device="cpu")
    dense._approx.load_structure(tm._approx.perm,
                                 tm._approx.neighbors.numpy())
    exact = dense.neg_log_likelihood(CP, data["y"])
    tm.set_optim_params({"num_rand_vec_trace": 1000,
                         "cg_max_num_it_tridiag": 40})
    assert abs(tm.neg_log_likelihood(CP, data["y"]) - exact) < 2.5
    e64, z64 = tm._approx.laplace_probes(K, SEED)
    t32 = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                      gp_approx="vecchia", num_neighbors=M,
                      likelihood="bernoulli_logit", dtype=torch.float32,
                      matrix_inversion_method="iterative", device="cpu")
    e32, z32 = t32._approx.laplace_probes(K, SEED)
    assert e32.dtype == torch.float32
    assert torch.equal(e32, e64.float()) and torch.equal(z32, z64.float())


def test_iterative_fit_and_prediction_run(data):
    _, tm = _pair(data)
    tm.set_optim_params({"num_rand_vec_trace": 20})
    assert tm._iter_kwargs(fit=True)["num_rand_vec_trace"] == 200
    tm.set_optim_params({"cg_max_num_it_tridiag": 15})
    nll0 = tm.neg_log_likelihood(CP, data["y"])
    tm.fit(y=data["y"], params={"init_cov_pars": CP, "maxit": 2})
    res = tm._fit_result
    assert res.num_evals >= 2 and np.all(tm.get_cov_pars() > 0)
    assert np.isfinite(tm.get_current_neg_log_likelihood())
    assert tm.get_current_neg_log_likelihood() < nll0 + 1.0
    tm.set_prediction_data(nsim_var_pred=64)
    out = tm.predict(gp_coords_pred=data["coords"][:10] + 0.01,
                     predict_var=True)
    assert np.all((out["mu"] > 0) & (out["mu"] < 1))
    assert np.all((out["var"] > 0) & (out["var"] <= 0.25))
