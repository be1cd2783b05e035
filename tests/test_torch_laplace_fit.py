"""The port's dense Vecchia-Laplace route vs the JAX package's, float64 on
the CPU, on the same ordering and neighbours (carried over with
``load_structure``), inputs from a numpy seed: the Laplace NLL and its
gradients w.r.t. the covariance parameters, the aux parameters and F (the
LaGaBoost gradient, ``grad_F_laplace``) at 1e-8 for three families (probit: the R golden and the fit); fitted
covariance parameters, aux parameters, coefficients and the coefficients'
std errors vs the JAX package's fit at 1e-3 relative (L-BFGS and gradient
descent).
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.utils.rng import sim_rand_unif

import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, M = 120, 8
CP = [1.2, 0.15]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    counts = rng.poisson(np.exp(0.5 * f)).astype(float)
    pos = rng.gamma(2.0, np.exp(0.3 * f) / 2.0)
    fe = 0.3 * rng.standard_normal(N)
    return dict(coords=coords, y=y, counts=counts, pos=pos, fe=fe)


def _pair(data, likelihood="bernoulli_logit", **kw):
    args = dict(gp_coords=data["coords"], cov_function="exponential",
                gp_approx="vecchia", num_neighbors=M, likelihood=likelihood,
                **kw)
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    return jm, tm


@pytest.mark.parametrize("likelihood,ykey,aux", [
    ("bernoulli_logit", "y", None), ("poisson", "counts", None),
    ("gamma", "pos", [1.7])])
def test_dense_nll_and_gradients_match_jax(data, likelihood, ykey, aux):
    jm, tm = _pair(data, likelihood)
    y, fe = data[ykey], data["fe"]
    jaux = None if aux is None else jnp.asarray(aux)

    def jf(c, a_, F):
        return jm._approx.nll_laplace(c, jnp.asarray(y), a_, F)

    argn = (0, 2) if aux is None else (0, 1, 2)
    want, gj = jax.value_and_grad(jf, argnums=argn)(
        jnp.asarray(CP), jaux, jnp.asarray(fe))
    got = tm.neg_log_likelihood(CP, y, fixed_effects=fe, aux_pars=aux)
    assert abs(got - float(want)) < 1e-8 * abs(float(want))
    # gradients w.r.t. cov_pars, aux and F (the LaGaBoost gradient)
    c = torch.tensor(CP, dtype=torch.float64, requires_grad=True)
    F = torch.tensor(fe, requires_grad=True)
    a_t = None if aux is None else torch.tensor(aux, dtype=torch.float64,
                                                requires_grad=True)
    nll = tm._approx.nll_laplace(c, torch.tensor(y), a_t, F)
    wrt = (c, F) if aux is None else (c, a_t, F)
    gt = torch.autograd.grad(nll, wrt)
    for got_g, want_g in zip(gt, gj):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-8, atol=1e-10)
    gF = tm._approx.grad_F_laplace(
        torch.tensor(CP, dtype=torch.float64), torch.tensor(y),
        None if aux is None else torch.tensor(aux, dtype=torch.float64),
        torch.tensor(fe))
    np.testing.assert_allclose(gF.numpy(), np.asarray(gj[-1]), rtol=1e-8,
                               atol=1e-10)


def test_r_golden_probit_all_neighbours(gp_fixture_data):
    """``TestVecchiaLaplace::test_probit_nll_matches_exact``: Vecchia-Laplace
    with nn = n - 1 equals the exact Laplace NLL 67.18342059 at
    cov (1, 0.2) (R ``test_GPModel_non_Gaussian_data.R:1296-1297``)."""
    vf = gp_fixture_data
    y = (sim_rand_unif(vf["n"], 0.19341) < norm.cdf(vf["eps"])).astype(float)
    m = gpt.GPModel(gp_coords=vf["coords"], cov_function="exponential",
                    likelihood="bernoulli_probit", gp_approx="vecchia",
                    num_neighbors=vf["n"] - 1, vecchia_ordering="none",
                    device="cpu")
    assert abs(m.neg_log_likelihood(cov_pars=[1.0, 0.2], y=y)
               - 67.18342059) < 1e-4


def test_probit_fit_with_covariates_matches_jax(gp_fixture_data):
    """The R test's probit model with covariates (nn = 30), fitted by
    L-BFGS in both packages: cov_pars and coefficients at 1e-3 relative, the
    coefficients' std errors too."""
    vf = gp_fixture_data
    y = (sim_rand_unif(vf["n"], 0.19341) < norm.cdf(vf["eps"])).astype(float)
    kw = dict(gp_coords=vf["coords"], cov_function="exponential",
              likelihood="bernoulli_probit", gp_approx="vecchia",
              num_neighbors=30, vecchia_ordering="none")
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    params = {"optimizer_cov": "lbfgs", "init_cov_pars": [1.0, 0.1]}
    jm.fit(y=y, X=vf["X"], params=params)
    tm.fit(y=y, X=vf["X"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-3)
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-3)
    np.testing.assert_allclose(tm.get_coef(std_err=True)[1],
                               jm.get_coef(std_err=True)[1], rtol=1e-3)
    assert tm.get_aux_pars() is None and tm.optim_cfg.optimizer_cov == "lbfgs"
    with pytest.raises(NotImplementedError, match="item"):
        tm.get_cov_pars(std_err=True)


@pytest.mark.parametrize("optimizer", ["lbfgs", "gradient_descent"])
def test_gamma_fit_estimates_aux_like_jax(data, optimizer):
    jm, tm = _pair(data, "gamma")
    params = {"optimizer_cov": optimizer, "init_cov_pars": [0.5, 0.2],
              "maxit": 30}
    jm.fit(y=data["pos"], params=params)
    tm.fit(y=data["pos"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-3)
    np.testing.assert_allclose(tm.get_aux_pars(), jm.get_aux_pars(),
                               rtol=1e-3)
    assert abs(tm.get_current_neg_log_likelihood()
               - jm.get_current_neg_log_likelihood()) < 1e-6 * abs(
        jm.get_current_neg_log_likelihood())
