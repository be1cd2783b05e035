"""Fits of grouped Gaussian models, the port against the JAX package and the
reference's goldens (mirrors ``tests/test_iid_model.py``'s Gaussian golden
and ``tests/test_r_depth_goldens.py::
test_nested_grouped_prediction_and_std_errors``). CPU, float64; the same
numpy-seeded inputs go through both packages.

Tolerances: at the optimum, the NLL within 1e-8 relative and the covariance
parameters within 1e-4 relative of the JAX package's (trajectories are not
compared: CLAUDE.md "Testing"); the q-space std errors within 1e-8
relative of the JAX package's dense Fisher information at the same
parameters; predictions at the same parameters within 1e-10; the goldens
at the JAX tests' own tolerances.
"""
import json
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.utils.rng import sim_rand_unif

N_IID = 100
OPTIMIZERS = ["gradient_descent", "lbfgs", "nelder_mead", "adam"]


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
def iid_data():
    """``tests/test_iid_model.py::iid_data``."""
    n = N_IID
    X = np.column_stack([np.ones(n),
                         np.sin((np.arange(1, n + 1) - n / 2) ** 2
                                * 2 * np.pi / n)])
    y = X @ np.array([0.1, 2.0]) + norm.ppf(
        sim_rand_unif(n, init_c=0.91468)) * 0.1
    return dict(X=X, y=y, X_test=np.column_stack([np.ones(3),
                                                  [-0.5, 0.2, 1.0]]))


@pytest.fixture(scope="module")
def crossed():
    rng = np.random.default_rng(11)
    n = 300
    g1 = rng.integers(0, 15, n)
    g2 = rng.integers(0, 6, n)
    xs = rng.uniform(-1, 1, n)
    X = np.column_stack([np.ones(n), rng.uniform(size=n)])
    y = (X @ np.array([0.5, 1.5]) + 0.8 * rng.standard_normal(15)[g1]
         + 0.5 * rng.standard_normal(6)[g2]
         + xs * 0.6 * rng.standard_normal(15)[g1]
         + 0.4 * rng.standard_normal(n))
    return dict(kw=dict(group_data=np.column_stack([g1, g2]),
                        group_rand_coef_data=xs,
                        ind_effect_group_rand_coef=[1]), X=X, y=y)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_iid_gaussian_golden(iid_data):
    """R:5691 (the iid model: error variance, collapsed dummy variance
    pinned at 1e-20, GLS coefficients and their std errors, NLL,
    prediction) — the JAX test's values and tolerances, and the JAX
    package's results."""
    f = iid_data
    jm = gpb.GPModel(likelihood="gaussian", num_data=N_IID)
    tm = gpt.GPModel(likelihood="gaussian", num_data=N_IID, device="cpu")
    jm.fit(y=f["y"], X=f["X"], params={"std_dev": True})
    tm.fit(y=f["y"], X=f["X"], params={"std_dev": True})
    assert tm._iid_model and tm._grouped_only
    cp = tm.get_cov_pars(std_err=False)
    assert abs(cp[0] - 7.654507e-03) < 1e-6
    assert cp[1] == 1e-20
    coef = tm.get_coef(std_err=True)
    np.testing.assert_allclose(coef[0], [0.094720436, 1.987728662],
                               atol=1e-6)
    np.testing.assert_allclose(coef[1], [0.008837829, 0.012498577],
                               atol=1e-6)
    assert abs(tm.get_current_neg_log_likelihood() - (-101.7291793)) < 1e-5
    assert _rel(tm.get_current_neg_log_likelihood(),
                jm.get_current_neg_log_likelihood()) < 1e-8
    np.testing.assert_allclose(coef, jm.get_coef(std_err=True), rtol=1e-6)
    pred = tm.predict(X_pred=f["X_test"], predict_var=True,
                      predict_response=False)
    np.testing.assert_allclose(
        pred["mu"], [-0.8991438945, 0.4922661688, 2.0824490983], atol=1e-6)
    assert np.all(pred["var"] < 1e-6)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_fits_reach_the_jax_optimum(crossed, optimizer):
    """Every optimizer of the profiled route, with GLS coefficients, on two
    crossed intercepts and a slope."""
    jm = gpb.GPModel(**crossed["kw"])
    tm = gpt.GPModel(device="cpu", **crossed["kw"])
    params = {"optimizer_cov": optimizer}
    jm.fit(y=crossed["y"], X=crossed["X"], params=dict(params))
    tm.fit(y=crossed["y"], X=crossed["X"], params=dict(params))
    assert _rel(tm.get_current_neg_log_likelihood(),
                jm.get_current_neg_log_likelihood()) < 1e-8
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-4)
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-4)
    assert tm._fit_result.num_evals >= tm.get_num_optim_iter() >= 1
    # the fitted NLL is the NLL at the fitted parameters
    fe = crossed["X"] @ tm.get_coef()
    assert tm.neg_log_likelihood(tm.get_cov_pars(), crossed["y"],
                                 fixed_effects=fe) == pytest.approx(
        tm.get_current_neg_log_likelihood(), rel=1e-12)


def test_std_errors_match_jax_dense_fisher(crossed):
    """The q-space Fisher information and the GLS coefficient covariance
    against the JAX package's dense [n, n] route at the same parameters."""
    jm = gpb.GPModel(**crossed["kw"])
    tm = gpt.GPModel(device="cpu", **crossed["kw"])
    tm.fit(y=crossed["y"], X=crossed["X"], params={"optimizer_cov": "lbfgs"})
    jm.fit(y=crossed["y"], X=crossed["X"], params={"optimizer_cov": "lbfgs"})
    jm.cov_pars_ = tm.cov_pars_.copy()
    jm.coefs_ = tm.coefs_.copy()
    jm.std_dev_cov_pars_ = None
    jm.std_dev_coefs_ = None
    got = tm.get_cov_pars(std_err=True)
    want = np.asarray(jm.get_cov_pars(std_err=True))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(tm.get_coef(std_err=True),
                               np.asarray(jm.get_coef(std_err=True)),
                               rtol=1e-8)
    assert np.all(got[1] > 0)


@pytest.fixture(scope="module")
def depth():
    """``tests/test_r_depth_goldens.py``'s goldens and data (the nested
    grouped model's part of its ``sim`` fixture)."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "r_depth_goldens.json")
    with open(path) as f:
        G = json.load(f)
    rng = np.random.default_rng(77)
    n = 400
    g1 = rng.integers(0, 20, n)
    g2 = rng.integers(0, 15, n)
    b1 = 0.8 * rng.standard_normal(20)
    b2 = 0.5 * rng.standard_normal(15)
    rng.binomial(1, 1 / (1 + np.exp(-(b1[g1] + b2[g2]))))
    outer = rng.integers(0, 10, n)
    nested = outer * 10 + rng.integers(0, 4, n)
    bo = 0.9 * rng.standard_normal(10)
    bi = 0.4 * rng.standard_normal(100)
    X = np.column_stack([np.ones(n), rng.uniform(size=n)])
    y = X @ np.array([1.0, 2.0]) + bo[outer] + bi[nested] \
        + 0.3 * rng.standard_normal(n)
    return G["nested_gauss"], dict(outer=outer, nested=nested, X=X, y=y)


def test_nested_grouped_prediction_and_std_errors(depth):
    """Nested grouped REs, gaussian, linear predictor: the reference's
    cov_pars and coefficients with std errors, NLL and response predictive
    covariance (the JAX test's tolerances), and the JAX package's results
    at the same parameters."""
    g, sim = depth
    gr = np.column_stack([sim["outer"], sim["nested"]])
    m = gpt.GPModel(group_data=gr, device="cpu")
    m.fit(y=sim["y"], X=sim["X"],
          params={"optimizer_cov": "lbfgs", "maxit": 200})
    cp_std = np.asarray(m.get_cov_pars(std_err=True))
    ref = np.asarray(g["cov_pars_std"]).reshape(2, -1)
    np.testing.assert_allclose(cp_std[0], ref[0], rtol=1e-3)
    np.testing.assert_allclose(cp_std[1], ref[1], rtol=1e-2)
    coef_std = np.asarray(m.get_coef(std_err=True))
    cref = np.asarray(g["coef_std"]).reshape(2, -1)
    np.testing.assert_allclose(coef_std[0], cref[0], rtol=1e-3)
    np.testing.assert_allclose(coef_std[1], cref[1], rtol=1e-2)
    assert m.get_current_neg_log_likelihood() == pytest.approx(
        g["nll"], abs=1e-3)
    gp2 = np.column_stack([[0, 1, 2], [0, 17, 23]])
    X_pred2 = np.column_stack([np.ones(3), [0.2, 0.5, 0.8]])
    pr = m.predict(group_data_pred=gp2, X_pred=X_pred2,
                   predict_cov_mat=True, predict_response=True)
    np.testing.assert_allclose(np.asarray(pr["mu"]),
                               np.asarray(g["pred_mu"]), atol=1e-3)
    np.testing.assert_allclose(np.asarray(pr["cov"]).ravel(),
                               np.asarray(g["pred_cov"]), atol=1e-3)
    jm = gpb.GPModel(group_data=gr)
    jm.fit(y=sim["y"], X=sim["X"],
           params={"optimizer_cov": "lbfgs", "maxit": 200})
    assert _rel(m.get_current_neg_log_likelihood(),
                jm.get_current_neg_log_likelihood()) < 1e-8
    jm.cov_pars_, jm.coefs_ = m.cov_pars_.copy(), m.coefs_.copy()
    pj = jm.predict(group_data_pred=gp2, X_pred=X_pred2,
                    predict_cov_mat=True, predict_response=True)
    for key in ("mu", "var", "cov"):
        np.testing.assert_allclose(pr[key], pj[key], rtol=0, atol=1e-10,
                                   err_msg=key)


def test_training_data_random_effects_match_jax(crossed):
    jm = gpb.GPModel(**crossed["kw"])
    tm = gpt.GPModel(device="cpu", **crossed["kw"])
    tm.fit(y=crossed["y"], X=crossed["X"], params={"optimizer_cov": "lbfgs"})
    jm.fit(y=crossed["y"], X=crossed["X"], params={"optimizer_cov": "lbfgs"})
    jm.cov_pars_, jm.coefs_ = tm.cov_pars_.copy(), tm.coefs_.copy()
    for var in (False, True):
        got = tm.predict_training_data_random_effects(predict_var=var)
        want = jm.predict_training_data_random_effects(predict_var=var)
        assert got.shape == want.shape == (300, 6 if var else 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_model_dicts_round_trip_both_ways(crossed, iid_data):
    tm = gpt.GPModel(device="cpu", **crossed["kw"])
    tm.fit(y=crossed["y"], X=crossed["X"], params={"optimizer_cov": "lbfgs"})
    gp = np.column_stack([[0, 3, 99], [1, 1, 2]])
    xs = np.array([0.2, -0.4, 0.9])
    Xp = np.column_stack([np.ones(3), [0.1, 0.5, 0.9]])
    want = tm.predict(group_data_pred=gp, group_rand_coef_data_pred=xs,
                      X_pred=Xp, predict_var=True)
    back = gpt.GPModel.from_dict(json.loads(json.dumps(tm.model_to_dict())),
                                 device="cpu")
    jback = gpb.GPModel.from_dict(tm.model_to_dict())
    for other in (back, jback):
        got = other.predict(group_data_pred=gp, group_rand_coef_data_pred=xs,
                            X_pred=Xp, predict_var=True)
        for key in ("mu", "var"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-10, err_msg=key)
    # the JAX package's dict of an iid model
    jm = gpb.GPModel(likelihood="gaussian", num_data=N_IID)
    jm.fit(y=iid_data["y"], X=iid_data["X"])
    tm2 = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    assert tm2._iid_model
    pj = jm.predict(X_pred=iid_data["X_test"], predict_var=True)
    pt = tm2.predict(X_pred=iid_data["X_test"], predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-10)


def test_summary_names_the_parameters(crossed, capsys):
    tm = gpt.GPModel(device="cpu", **crossed["kw"])
    tm.fit(y=crossed["y"], params={"optimizer_cov": "lbfgs"})
    tm.get_cov_pars(std_err=True)
    tm.summary()
    out = capsys.readouterr().out
    for name in ("Error_term", "Group_1", "Group_2", "Group_3_rand_coef",
                 "std dev"):
        assert name in out
