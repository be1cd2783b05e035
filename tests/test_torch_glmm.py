"""Grouped random effects with a non-Gaussian likelihood (the Laplace
approximation in b-space), the port against the JAX package and the
reference's goldens (mirrors the poisson golden 140.4554806 of
``tests/test_grouped_woodbury.py:70`` and ``tests/test_non_gaussian_golden.
py``'s ``TestPoissonGrouped`` / ``TestBernoulliProbitGrouped``, the crossed
``bernoulli_logit`` model of ``tests/test_r_depth_goldens.py`` and the
coefficient std errors of ``tests/test_iid_model.py``). CPU, float64, the
R tests' fixture data (n = 100, 10 groups) or numpy-seeded data.

Tolerances: the NLL and its gradient 1e-10 relative of the JAX package's
(both routes of the port: ``index_add_`` and the fixed-order plan a CUDA
model runs); fits at the optimum NLL 1e-8 relative, cov_pars 1e-4;
predictions at the same parameters 1e-10; the goldens at the JAX tests'
own tolerances.
"""
import json
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm
from scipy.stats import poisson as spoisson

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax.numpy as jnp
from gpboost_tpu.models import grouped as jg
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif
from gpboost_tpu_torch.models import grouped as tg

TOL_MEDIUM = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ng():
    """The grouped part of ``tests/test_non_gaussian_golden.py::ng``
    (test_GPModel_non_Gaussian_data.R:27-85; the LCG streams in order)."""
    n, m = 100, 10
    sim_rand_unif(n * 2, init_c=0.1)
    sim_rand_normal(n, 0.8)
    group = np.repeat(np.arange(1, m + 1), n // m)
    Z1b = sim_rand_normal(m, 0.565)[group - 1]
    group2 = np.tile(np.arange(1, n // m + 1), m)
    Z2b = sim_rand_normal(n // m, 0.36)[group2 - 1]
    xcov = np.cos((np.arange(1, n + 1) - n / 2) ** 2 * 5.5 * np.pi / n)
    Z3b = xcov * sim_rand_normal(m, 0.5678)[group - 1]
    X = np.column_stack([np.ones(n), np.sin(
        (np.arange(1, n + 1) - n / 2) ** 2 * 2 * np.pi / n)])
    return dict(n=n, group=group, group2=group2, xcov=xcov, Z1b=Z1b,
                Z2b=Z2b, Z3b=Z3b, X=X,
                y_pois=spoisson.ppf(sim_rand_unif(n, 0.04532), np.exp(Z1b)),
                y_probit=(sim_rand_unif(n, 0.823431)
                          < norm.cdf(Z1b)).astype(float))


@pytest.fixture(scope="module")
def multi(ng):
    """Two crossed intercepts and a slope, poisson (R:2359-2382's model)."""
    mu = np.exp(ng["Z1b"] + ng["Z2b"] + ng["Z3b"])
    y = spoisson.ppf(sim_rand_unif(ng["n"], 0.74532), mu)
    kw = dict(group_data=np.column_stack([ng["group"], ng["group2"]]),
              group_rand_coef_data=ng["xcov"],
              ind_effect_group_rand_coef=[1], likelihood="poisson")
    return kw, y


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_poisson_nll_golden(ng):
    m = gpt.GPModel(group_data=ng["group"], likelihood="poisson",
                    device="cpu")
    assert m._grouped_only
    nll = m.neg_log_likelihood(cov_pars=[0.9], y=ng["y_pois"])
    assert abs(nll - 140.4554806) < TOL_MEDIUM
    jnll = gpb.GPModel(group_data=ng["group"], likelihood="poisson"
                       ).neg_log_likelihood(cov_pars=[0.9], y=ng["y_pois"])
    assert _rel(nll, jnll) < 1e-10


def test_bernoulli_probit_nll_golden(ng):
    """R:534-535: nll(0.9) = 65.8590638."""
    m = gpt.GPModel(group_data=ng["group"], likelihood="bernoulli_probit",
                    device="cpu")
    assert abs(m.neg_log_likelihood(cov_pars=[0.9], y=ng["y_probit"])
               - 65.8590638) < 1e-5


@pytest.mark.parametrize("route", ["index_add", "plan"])
def test_nll_and_gradient_match_jax(ng, multi, route):
    """The Laplace NLL and its gradient in (cov_pars, beta) with two
    crossed intercepts, a slope and a linear predictor."""
    kw, y = multi
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    Z = (tm._Z if route == "index_add"
         else tg.GroupedZ(tm.spec, tm.data, deterministic=True))
    cp = np.array([0.5, 0.3, 0.4])
    beta = np.array([0.1, -0.2])
    jd = jm._with_y(y)
    jd.X = jnp.asarray(ng["X"])
    jv, (jgc, _, jgb) = jg.nll_laplace_value_and_grad(
        jm.spec, jd, jnp.asarray(cp), None, jnp.asarray(beta), None)
    cpt = torch.tensor(cp, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    v = tg.nll_laplace(Z, "poisson", cpt, None, torch.tensor(y),
                       torch.tensor(ng["X"]) @ bt)
    gc, gb = torch.autograd.grad(v, (cpt, bt))
    assert _rel(float(v.detach()), float(jv)) < 1e-10
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-10,
                               atol=1e-10 * np.abs(jgc).max())
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-10,
                               atol=1e-10 * np.abs(jgb).max())
    v2, g2, _ = tg.nll_laplace_value_and_grad(
        Z, "poisson", torch.tensor(cp), None, torch.tensor(y),
        torch.tensor(ng["X"] @ beta))
    assert _rel(float(v2), float(jv)) < 1e-10
    np.testing.assert_allclose(g2.numpy(), np.asarray(jgc), rtol=1e-10,
                               atol=1e-10 * np.abs(jgc).max())


@pytest.mark.parametrize("optimizer", ["lbfgs", "gradient_descent", "adam"])
def test_fits_reach_the_jax_optimum(ng, multi, optimizer):
    kw, y = multi
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    jm.fit(y, X=ng["X"], params={"optimizer_cov": optimizer})
    tm.fit(y, X=ng["X"], params={"optimizer_cov": optimizer})
    assert _rel(tm.get_current_neg_log_likelihood(),
                jm.get_current_neg_log_likelihood()) < 1e-8
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-4)
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-4,
                               atol=1e-6)
    assert tm._fit_result.num_evals >= 1


def test_bernoulli_probit_fits_golden(ng):
    """R:530-532 (lbfgs -> 0.4025750768) and R:438-446 (GD, no
    acceleration, parameter criterion -> 0.40255), the JAX tests'
    tolerances; and the JAX package's L-BFGS optimum."""
    y = ng["y_probit"]
    m = gpt.GPModel(group_data=ng["group"], likelihood="bernoulli_probit",
                    device="cpu")
    m.fit(y=y, params={"optimizer_cov": "lbfgs", "init_cov_pars": [1.0]})
    np.testing.assert_allclose(m.get_cov_pars(), [0.4025750768], rtol=1e-2)
    jm = gpb.GPModel(group_data=ng["group"], likelihood="bernoulli_probit")
    jm.fit(y=y, params={"optimizer_cov": "lbfgs", "init_cov_pars": [1.0]})
    assert _rel(m.get_current_neg_log_likelihood(),
                jm.get_current_neg_log_likelihood()) < 1e-8
    np.testing.assert_allclose(m.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-4)
    m2 = gpt.GPModel(group_data=ng["group"], likelihood="bernoulli_probit",
                     device="cpu")
    m2.fit(y=y, params={
        "optimizer_cov": "gradient_descent", "lr_cov": 0.1,
        "use_nesterov_acc": False,
        "convergence_criterion": "relative_change_in_parameters",
        "init_cov_pars": [1.0]})
    np.testing.assert_allclose(m2.get_cov_pars(), [0.40255], rtol=1e-2)


def test_poisson_fit_and_predict_golden(ng):
    """R:2332-2356: the fitted variance, the latent mean and covariance
    (an unseen group 9999 at its prior) and the response moments, at the
    golden parameter; and the JAX package's predictions."""
    y = ng["y_pois"]
    m = gpt.GPModel(group_data=ng["group"], likelihood="poisson",
                    device="cpu")
    m.fit(y=y, params={"optimizer_cov": "gradient_descent",
                       "use_nesterov_acc": True, "lr_cov": 0.1})
    np.testing.assert_allclose(m.get_cov_pars(), [0.4033406], rtol=1e-2)
    cp = [0.4033406]
    group_test = np.array([1, 3, 3, 9999])
    pred = m.predict(y=y, group_data_pred=group_test, cov_pars=cp,
                     predict_cov_mat=True, predict_response=False)
    expected_mu = np.array([0.07765297, -0.87488533, -0.87488533, 0.0])
    expected_cov = np.array(
        [0.07526284, 0, 0, 0, 0, 0.15041230, 0.15041230, 0, 0, 0.15041230,
         0.15041230, 0, 0, 0, 0, 0.40334058]).reshape(4, 4)
    assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_MEDIUM
    assert np.sum(np.abs(pred["cov"] - expected_cov)) < TOL_MEDIUM
    pred_r = m.predict(y=y, group_data_pred=group_test, cov_pars=cp,
                       predict_var=True, predict_response=True)
    expected_mu_r = np.array([1.1221925, 0.4494731, 0.4494731, 1.2234446])
    expected_var_r = np.array([1.2206301, 0.4822647, 0.4822647, 1.9670879])
    assert np.sum(np.abs(pred_r["mu"] - expected_mu_r)) < TOL_MEDIUM
    assert np.sum(np.abs(pred_r["var"] - expected_var_r)) < 5 * TOL_MEDIUM
    jm = gpb.GPModel(group_data=ng["group"], likelihood="poisson")
    for resp, kw in ((False, dict(predict_cov_mat=True)),
                     (True, dict(predict_var=True))):
        pj = jm.predict(y=y, group_data_pred=group_test, cov_pars=cp,
                        predict_response=resp, **kw)
        pt = m.predict(y=y, group_data_pred=group_test, cov_pars=cp,
                       predict_response=resp, **kw)
        for key in ("mu", "var", "cov"):
            if pj[key] is None:
                assert pt[key] is None
                continue
            np.testing.assert_allclose(pt[key], pj[key], rtol=0, atol=1e-10,
                                       err_msg=key)


def test_crossed_logit_prediction_cov_matrix_golden():
    """Crossed grouped REs, bernoulli_logit (``tests/test_r_depth_goldens.
    py::test_crossed_grouped_ng_prediction_cov_matrix``): fitted variances,
    NLL, the latent predictive mean and covariance with an unseen pair."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "r_depth_goldens.json")
    with open(path) as f:
        g = json.load(f)["crossed_ng"]
    rng = np.random.default_rng(77)
    n = 400
    g1 = rng.integers(0, 20, n)
    g2 = rng.integers(0, 15, n)
    b1 = 0.8 * rng.standard_normal(20)
    b2 = 0.5 * rng.standard_normal(15)
    yb = rng.binomial(1, 1 / (1 + np.exp(-(b1[g1] + b2[g2])))).astype(
        np.float64)
    m = gpt.GPModel(group_data=np.column_stack([g1, g2]),
                    likelihood="bernoulli_logit", device="cpu")
    m.fit(y=yb, params={"optimizer_cov": "lbfgs", "maxit": 100})
    np.testing.assert_allclose(m.get_cov_pars(), np.asarray(g["cov_pars"]),
                               rtol=1e-3)
    assert m.get_current_neg_log_likelihood() == pytest.approx(
        g["nll"], abs=1e-4)
    gp_pred = np.column_stack([[0, 1, 2, 25], [0, 3, 3, 20]])
    pr = m.predict(group_data_pred=gp_pred, predict_cov_mat=True,
                   predict_response=False, cov_pars=np.asarray(g["cov_pars"]))
    np.testing.assert_allclose(pr["mu"], np.asarray(g["pred_mu"]),
                               atol=1e-5)
    np.testing.assert_allclose(pr["cov"].ravel(), np.asarray(g["pred_cov"]),
                               atol=1e-5)


def test_coefficient_std_errors(ng):
    """R:1906-1914 (bernoulli_probit, one grouped RE and X: coefficients
    and their std errors, the JAX test's tolerance) and the JAX package's
    std errors at the same parameters, within 1e-5: both packages take
    central differences (step eps^(1/3) ~ 6e-6) of the NLL's gradient, which
    multiply the gradients' difference (the last bits that the mode
    finder's stop rule leaves) by ~1e5."""
    y = (sim_rand_unif(ng["n"], init_c=0.542)
         < norm.cdf(ng["Z1b"] + ng["X"] @ np.array([0.1, 2.0]))).astype(
             float)
    kw = dict(group_data=ng["group"], likelihood="bernoulli_probit")
    m = gpt.GPModel(device="cpu", **kw)
    m.fit(y=y, X=ng["X"], params={"init_cov_pars": [1.0]})
    coef = m.get_coef(std_err=True)
    np.testing.assert_allclose(coef[0], [-0.1116235586, 1.5161515464],
                               atol=5e-3)
    np.testing.assert_allclose(coef[1], [0.2568338470, 0.2637361920],
                               atol=5e-3)
    jm = gpb.GPModel(**kw)
    jm.fit(y=y, X=ng["X"], params={"init_cov_pars": [1.0]})
    jm.cov_pars_, jm.coefs_ = m.cov_pars_.copy(), m.coefs_.copy()
    jm.std_dev_coefs_ = None
    np.testing.assert_allclose(coef[1], np.asarray(jm.get_coef(
        std_err=True))[1], rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item"):
        m.get_cov_pars(std_err=True)


def test_iid_binary_logit_golden():
    """``tests/test_iid_model.py::test_iid_binary_logit_golden``: the iid
    GLM (the dummy variance collapses; here to 3.7e-6, as in the JAX
    package, above the 1e-6 under which it is pinned at 1e-20)."""
    n = 100
    X = np.column_stack([np.ones(n), np.sin(
        (np.arange(1, n + 1) - n / 2) ** 2 * 2 * np.pi / n)])
    y = (sim_rand_unif(n, init_c=0.468)
         < 1.0 / (1.0 + np.exp(-X @ np.array([0.1, 2.0])))).astype(float)
    m = gpt.GPModel(likelihood="binary_logit", num_data=n, device="cpu")
    m.fit(y=y, X=X, params={"std_dev": True})
    assert m.get_cov_pars()[0] < 1e-5
    coef = m.get_coef(std_err=True)
    np.testing.assert_allclose(coef[0], [0.08910433727, 1.57411916970],
                               atol=5e-4)
    np.testing.assert_allclose(coef[1], [0.22947935529, 0.35649689071],
                               atol=5e-4)
    assert abs(m.get_current_neg_log_likelihood() - 56.6742427) < 1e-4
    X_test = np.column_stack([np.ones(3), [-0.5, 0.2, 1.0]])
    pr = m.predict(X_pred=X_test, predict_var=True, predict_response=True)
    expected = np.array([0.3322656738, 0.5996311078, 0.8406703427])
    np.testing.assert_allclose(pr["mu"], expected, atol=1e-4)
    np.testing.assert_allclose(pr["var"], expected * (1 - expected),
                               atol=1e-3)
