"""``likelihood="gaussian_heteroscedastic"`` in the port
(``models/heteroscedastic.py``: the two-set Fisher-Laplace mode with its
implicit backward; ``VecchiaGP.nll_het`` / ``predict_het``) on the CPU,
float64 — the counterpart of ``tests/test_heteroscedastic.py`` with its R
goldens at that file's tolerances, and against the JAX package:

- the NLL with all and with 20 neighbours, and the dense
  ``gp_approx="none"`` form, equal the JAX package's at 1e-10 relative;
  the gradient in the log-parameters and the two fixed parts (the
  ``custom_vjp`` of the JAX package, a ``torch.autograd.Function`` here) at
  1e-8;
- the fit with covariates (two coefficient vectors) meets the goldens and
  the JAX package's optimum (NLL within 1e-6);
- the latent and response predictions equal the JAX package's at 1e-8 and
  meet the goldens;
- n > 1 000 with ``gp_approx="none"`` raises as in the JAX package.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif

import gpboost_tpu_torch as gpt

COV_PARS_EVAL = [1.0, 0.2, 0.1, 0.2]
COEFS_PRED = [0.5, 0.1, 0.5, 0.1]
X_TEST = np.array([[1.0, -0.5], [1.0, 0.2], [1.0, 1.0]])
COORD_TEST = np.array([[0.1, 0.9], [0.11, 0.91], [0.7, 0.55]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def f():
    n, d = 100, 2
    x = sim_rand_unif(n * d, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    L = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    b_1 = sim_rand_normal(n, 0.8)
    b_2 = sim_rand_normal(n, 0.834)
    eps = sim_rand_normal(n, 0.1234)
    y = L @ b_1 + eps * np.exp(0.5 * (L @ b_2))
    X = np.column_stack([np.ones(n), np.sin((np.arange(1, n + 1) - n / 2) ** 2
                                            * 2 * np.pi / n)])
    return dict(n=n, coords=coords, D=D, y=y, X=X)


def _pair(f, nn, approx="vecchia"):
    kw = dict(gp_coords=f["coords"], cov_function="exponential",
              likelihood="gaussian_heteroscedastic", gp_approx=approx)
    if approx == "vecchia":
        kw.update(num_neighbors=nn, vecchia_ordering="none")
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


@pytest.mark.parametrize("nn,approx,golden", [
    (99, "vecchia", 199.6831947), (20, "vecchia", 199.6932499),
    (None, "none", 199.6831947)], ids=["all", "20", "dense"])
def test_nll_golden_and_jax(f, nn, approx, golden):
    jm, tm = _pair(f, nn, approx)
    assert tm.gp_approx_user == approx and tm.num_cov_pars == 4
    nt = tm.neg_log_likelihood(COV_PARS_EVAL, f["y"])
    assert abs(nt - golden) < 1e-4
    nj = jm.neg_log_likelihood(COV_PARS_EVAL, f["y"])
    assert abs(nt - nj) <= 1e-10 * abs(nj)


def test_gradient_matches_jax(f):
    import jax
    import jax.numpy as jnp
    jm, tm = _pair(f, 20)
    rng = np.random.default_rng(1)
    fe = rng.standard_normal(2 * f["n"]) * 0.3
    th = np.log(np.asarray(COV_PARS_EVAL))
    gj = jax.grad(lambda t, F: jm._approx.nll_laplace(
        jnp.exp(t), jnp.asarray(f["y"]), None, F), argnums=(0, 1))(
        jnp.asarray(th), jnp.asarray(fe))
    t_th = torch.as_tensor(th).requires_grad_(True)
    t_fe = torch.as_tensor(fe).requires_grad_(True)
    v = tm._approx.nll_laplace(torch.exp(t_th), tm._y_tensor(f["y"]), None,
                               t_fe)
    g_th, g_fe = torch.autograd.grad(v, (t_th, t_fe))
    np.testing.assert_allclose(g_th.numpy(), np.asarray(gj[0]), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(g_fe.numpy(), np.asarray(gj[1]), rtol=1e-8,
                               atol=1e-10)


def test_fit_golden_and_jax(f):
    iu = np.triu_indices(f["n"], 1)
    mean_dist = float(f["D"][iu].mean())
    params = {"optimizer_cov": "lbfgs", "maxit": 1000,
              "init_cov_pars": [1.0, mean_dist / 3, 0.1, mean_dist / 3]}
    jm, tm = _pair(f, 30)
    tm.fit(y=f["y"], X=f["X"], params=params)
    cov_exp = [0.29257505689, 0.16019690150, 0.20398810623, 0.02123292904]
    assert np.sum(np.abs(tm.get_cov_pars() - cov_exp)) < 1e-1
    assert tm.get_coef().shape == (4,)
    nll = tm.get_current_neg_log_likelihood()
    assert abs(nll - 191.2393688) < 5e-2
    jm.fit(y=f["y"], X=f["X"], params=params)
    assert abs(nll - jm.get_current_neg_log_likelihood()) < 1e-6


def test_predict_golden_and_jax(f):
    import jax.numpy as jnp
    jm, tm = _pair(f, 99)
    # the prediction's coefficients are set (the golden's), not fitted, and
    # the training X given, as after a fit with X
    for m in (jm, tm):
        m.set_optim_params(params={"init_coef": COEFS_PRED})
    tm.X = tm._tensor(f["X"])
    jm.data.X = jnp.asarray(f["X"])
    kw = dict(y=f["y"], gp_coords_pred=COORD_TEST, predict_var=True,
              cov_pars=COV_PARS_EVAL, X_pred=X_TEST)
    expected_mu = [0.06126291, 0.07337373, 0.30807230]
    for resp, var_exp, tol in (
            (False, [0.5994207, 0.6014515, 0.3936357], 1e-2),
            (True, [2.147623, 2.268682, 2.010216], 2e-2)):
        pt = tm.predict(predict_response=resp, **kw)
        pj = jm.predict(predict_response=resp, **kw)
        np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-8)
        assert np.sum(np.abs(pt["mu"] - expected_mu)) < 1e-2
        assert np.sum(np.abs(pt["var"] - var_exp)) < tol


def test_dense_refuses_large_n():
    coords = np.random.default_rng(0).uniform(size=(1001, 2))
    kw = dict(gp_coords=coords, likelihood="gaussian_heteroscedastic",
              gp_approx="none")
    with pytest.raises(ValueError, match="n <= 1000"):
        gpb.GPModel(**kw)
    with pytest.raises(ValueError, match="n <= 1000"):
        gpt.GPModel(device="cpu", **kw)
