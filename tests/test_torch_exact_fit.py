"""The exact GP's fits, std errors and predictions through ``GPModel``, the
port against the R goldens and the JAX package (mirrors
``tests/test_gaussian_gp_golden.py``'s ``TestExactGPFit``, ``TestNewton``,
``TestEstimateCovParIndex``, ``TestPrediction`` and
``tests/test_gp_rand_coef_golden.py``). CPU, float64, the R fixture
(n = 100).

Tolerances: the R goldens at the JAX tests' own (GD / L-BFGS / Nelder-Mead
rtol 2e-1 + atol 1e-2 around the optimum; Fisher scoring 5e-2 / 5e-3;
Newton 1e-4 absolute and 7 iterations; held parameters 1e-4 on the NLL,
1e-3 on cov_pars; predictions 1e-5 summed; std errors 1e-1); against the
JAX package, the same algorithm on the same data: 1e-6 relative on fitted
parameters and NLLs, 1e-8 on std errors, 1e-10 on predictions and the
training-data effects (1e-8 where the port predicts by the cluster blocks
and the JAX package densely).
"""
import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COORD_TEST = np.array([[0.1, 0.9], [0.2, 0.4], [0.7, 0.55]])


@pytest.fixture(scope="module")
def f(gp_fixture_data):
    f = dict(gp_fixture_data)
    f["y"] = f["eps"] + f["xi"]
    iu = np.triu_indices(f["n"], 1)
    v = np.var(f["y"], ddof=1)
    f["init"] = [v / 2, v / 2, np.mean(f["D"][iu]) / 3]
    return f


def _pair(f, **kw):
    kw = dict(gp_coords=f["coords"], cov_function="exponential", **kw)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


def _fit_both(f, params, X=None, **kw):
    jm, tm = _pair(f, **kw)
    jm.fit(y=f["y"], X=X, params=dict(params))
    tm.fit(y=f["y"], X=X, params=dict(params))
    return jm, tm


@pytest.mark.parametrize("optimizer,want,rtol,atol", [
    ("gradient_descent", [0.03283, 1.07612, 0.11354], 2e-1, 1e-2),
    ("lbfgs", [0.03283, 1.07612, 0.11354], 2e-1, 1e-2),
    ("nelder_mead", [0.03283, 1.07612, 0.11354], 2e-1, 1e-2),
    ("fisher_scoring", [0.03294841, 1.07591929, 0.11355958], 5e-2, 5e-3)])
def test_fits_match_r_and_jax(f, optimizer, want, rtol, atol):
    """``TestExactGPFit`` (R:118-175): each optimizer from the R inits
    reaches the reference's optimum (NLL below 122.7772 for the gradient
    routes); the port's cov_pars and NLL are the JAX package's within 1e-6
    relative."""
    params = {"optimizer_cov": optimizer, "init_cov_pars": f["init"],
              "delta_rel_conv": 1e-8 if optimizer == "nelder_mead"
              else 1e-6}
    jm, tm = _fit_both(f, params)
    np.testing.assert_allclose(tm.get_cov_pars(), want, rtol=rtol,
                               atol=atol)
    if optimizer != "nelder_mead":
        assert tm.get_current_neg_log_likelihood() < 122.7772
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(tm.get_current_neg_log_likelihood() - nll_j) \
        < 1e-6 * abs(nll_j)
    assert tm.get_num_optim_iter() == jm.num_it_


def test_readme_first_example_matches_jax(f):
    """The README's first example, ``GPModel(gp_coords=coords,
    cov_function="matern", cov_fct_shape=1.5)`` with ``gp_approx`` at its
    default: the default fit with X (gradient descent + GLS), then
    ``predict(..., X_pred=..., predict_var=True)``; cov_pars, coefficients,
    NLL, mean and variance the JAX package's within 1e-6 relative."""
    kw = dict(gp_coords=f["coords"], cov_function="matern",
              cov_fct_shape=1.5)
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    assert tm.gp_approx == "none" and tm._exact
    for m in (jm, tm):
        m.fit(y=f["y"], X=f["X"])
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-6)
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(tm.get_current_neg_log_likelihood() - nll_j) \
        < 1e-6 * abs(nll_j)
    kw = dict(gp_coords_pred=COORD_TEST, X_pred=f["X"][:3], predict_var=True)
    pj, pt = jm.predict(**kw), tm.predict(**kw)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-6)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-6)


def test_newton_matches_reference(f):
    """``TestNewton`` (R:224-230): Newton's method (the Hessian of the NLL
    by autograd) -> (0.03282998, 1.07612393, 0.11353614) in 7
    iterations, 1e-4 absolute, and the JAX package's parameters 1e-6."""
    params = {"optimizer_cov": "newton", "lr_cov": 1.0,
              "use_nesterov_acc": False, "init_cov_pars": f["init"]}
    jm, tm = _fit_both(f, params)
    np.testing.assert_allclose(tm.get_cov_pars(),
                               [0.03282998, 1.07612393, 0.11353614],
                               atol=1e-4)
    assert tm.num_it_ == 7
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)


@pytest.mark.parametrize("mask,nll,cov", [
    ([1, 1, 0], 123.4853915, [0.10273152, 1.23337073, None]),
    ([0, 0, 0], 128.132446, [None, None, None]),
    ([0, 1, 0], 127.9879294, [None, 0.60888001, None])])
def test_held_parameters(f, mask, nll, cov):
    """``TestEstimateCovParIndex`` (R:233-258): L-BFGS on the free
    parameters, the others at their inits; the R NLL 1e-4, cov_pars 1e-3
    (held ones exactly), the JAX package's NLL 1e-6 relative."""
    params = {"optimizer_cov": "lbfgs", "init_cov_pars": f["init"],
              "estimate_cov_par_index": mask}
    jm, tm = _fit_both(f, params)
    assert abs(tm.get_current_neg_log_likelihood() - nll) < 1e-4
    want = [f["init"][i] if c is None else c for i, c in enumerate(cov)]
    np.testing.assert_allclose(tm.get_cov_pars(), want, rtol=1e-3)
    for i, held in enumerate(mask):
        if not held:
            assert tm.get_cov_pars()[i] == pytest.approx(f["init"][i],
                                                         rel=1e-12)
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(tm.get_current_neg_log_likelihood() - nll_j) \
        < 1e-6 * abs(nll_j)


def test_std_errors_and_coefficients(f):
    """``TestExactGPFit.test_std_dev``: the std errors (0.07943467,
    0.25351519, 0.03840236) to 1e-1; with X, the GLS coefficients and
    their std errors and the cov_pars' std errors are the JAX package's
    (1e-6 on the fitted values, 1e-8 relative on the std errors at the
    same parameters)."""
    params = {"optimizer_cov": "gradient_descent", "init_cov_pars": f["init"],
              "std_dev": True}
    jm, tm = _fit_both(f, params)
    np.testing.assert_allclose(tm.get_cov_pars(std_err=True)[1],
                               [0.07943467, 0.25351519, 0.03840236],
                               rtol=1e-1)
    jm, tm = _fit_both(f, {"optimizer_cov": "lbfgs",
                           "init_cov_pars": f["init"], "std_dev": True},
                       X=f["X"])
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-6)
    tm.cov_pars_ = np.asarray(jm.get_cov_pars())
    tm.coefs_ = np.asarray(jm.get_coef())
    tm.std_dev_cov_pars_ = tm.std_dev_coefs_ = None
    np.testing.assert_allclose(tm.get_cov_pars(std_err=True)[1],
                               jm.std_dev_cov_pars_, rtol=1e-8)
    np.testing.assert_allclose(tm.get_coef(std_err=True)[1],
                               jm.get_coef(std_err=True)[1], rtol=1e-8)


def test_predictions_match_r_goldens(f):
    """``TestPrediction`` (R:294-312, R:267-283): at (0.02, 1.2, 0.9) the
    mean, the covariance, the variances and the latent covariance to 1e-5
    summed; after a Fisher-scoring fit (parameter criterion) the mean and
    the covariance's diagonal to 1e-3."""
    _, tm = _pair(f)
    cp = [0.02, 1.2, 0.9]
    pred = tm.predict(y=f["y"], gp_coords_pred=COORD_TEST, cov_pars=cp,
                      predict_cov_mat=True)
    want_mu = np.array([0.08704577, 1.63875604, 0.48513581])
    want_cov = np.array([[1.189093e-01, 1.171632e-05, -4.172444e-07],
                         [1.171632e-05, 7.427727e-02, 1.492859e-06],
                         [-4.172444e-07, 1.492859e-06, 8.107455e-02]])
    assert np.sum(np.abs(pred["mu"] - want_mu)) < 1e-5
    assert np.sum(np.abs(pred["cov"] - want_cov)) < 1e-5
    pv = tm.predict(y=f["y"], gp_coords_pred=COORD_TEST, cov_pars=cp,
                    predict_var=True)
    assert np.sum(np.abs(pv["var"] - np.diag(want_cov))) < 1e-5
    pl = tm.predict(y=f["y"], gp_coords_pred=COORD_TEST, cov_pars=cp,
                    predict_cov_mat=True, predict_response=False)
    assert np.sum(np.abs(pl["cov"] - (want_cov - 0.02 * np.eye(3)))) < 1e-5
    tm.fit(y=f["y"], params={
        "optimizer_cov": "fisher_scoring", "delta_rel_conv": 1e-6,
        "use_nesterov_acc": False, "maxit": 100,
        "convergence_criterion": "relative_change_in_parameters",
        "init_cov_pars": f["init"]})
    pred = tm.predict(y=f["y"], gp_coords_pred=COORD_TEST,
                      predict_cov_mat=True)
    assert np.sum(np.abs(pred["mu"] - [0.06960478, 1.61299381,
                                       0.44053480])) < 1e-3
    assert np.sum(np.abs(np.diag(pred["cov"]) - [6.218737e-01, 3.535390e-01,
                                                 4.202154e-01])) < 1e-3


def test_gp_rand_coef_goldens(f):
    """``test_gp_rand_coef_golden.py``: the SVC NLL 149.4422184 (1e-5), the
    prediction with two random coefficients (1e-5 summed), an L-BFGS fit at
    least as good as the R trajectory's estimates, and the training-data
    random effects against prediction differences (1e-4 summed) and
    against the JAX package at the same parameters (1e-10)."""
    y = f["eps_svc"] + f["xi"]
    kw = dict(gp_coords=f["coords"], cov_function="exponential",
              gp_rand_coef_data=f["Z_SVC"])
    tm = gpt.GPModel(device="cpu", **kw)
    cp = [0.1, 1.0, 0.1, 0.8, 0.15, 1.1, 0.08]
    assert abs(tm.neg_log_likelihood(cp, y) - 149.4422184) < 1e-5
    coord_test = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
    z_test = np.column_stack([[0.1, 0.3, 0.7], [0.5, 0.2, 0.4]])
    pred = tm.predict(y=y, gp_coords_pred=coord_test,
                      gp_rand_coef_data_pred=z_test, cov_pars=cp,
                      predict_cov_mat=True)
    want_mu = np.array([-0.1669209, 1.6166381, 0.2861320])
    want_cov = np.array([9.643323e-01, 3.536846e-04, -1.783557e-04,
                         3.536846e-04, 5.155009e-01, 4.554321e-07,
                         -1.783557e-04, 4.554321e-07,
                         7.701614e-01]).reshape(3, 3)
    assert np.sum(np.abs(pred["mu"] - want_mu)) < 1e-5
    assert np.sum(np.abs(pred["cov"] - want_cov)) < 1e-5
    tm.fit(y=y, params={"optimizer_cov": "lbfgs", "maxit": 30})
    expected = [0.25740068, 0.83503539, 0.15039055, 1.61010233, 0.09015444,
                0.25064640, 0.08720822]
    assert tm.get_current_neg_log_likelihood() \
        <= tm.neg_log_likelihood(expected, y) + 1e-6
    tre = tm.predict_training_data_random_effects()
    n = f["n"]
    base = tm.predict(y=y, gp_coords_pred=f["coords"],
                      gp_rand_coef_data_pred=np.zeros((n, 2)),
                      predict_response=False)["mu"]
    for j in range(2):
        z = np.zeros((n, 2))
        z[:, j] = 1.0
        pj = tm.predict(y=y, gp_coords_pred=f["coords"],
                        gp_rand_coef_data_pred=z,
                        predict_response=False)["mu"]
        assert np.sum(np.abs(tre[:, j + 1] - (pj - base))) < 1e-4
    assert np.sum(np.abs(tre[:, 0] - base)) < 1e-4
    jm = gpb.GPModel(**kw)
    jm.fit(y=y, params={"optimizer_cov": "lbfgs", "maxit": 1})
    jm.cov_pars_ = tm.get_cov_pars()
    np.testing.assert_allclose(
        tm.predict_training_data_random_effects(predict_var=True),
        jm.predict_training_data_random_effects(predict_var=True),
        rtol=1e-10, atol=1e-12)


def test_dict_round_trip_and_summary(f, capsys):
    """``model_to_dict`` / ``from_dict`` of an exact model with X and
    cluster_ids predict the same (bits); the JAX package's dict of the same
    model loads into the port; ``summary`` names the parameters as the
    JAX package does."""
    cid = f["cluster_ids"]
    jm, tm = _pair(f, cluster_ids=cid)
    for m in (jm, tm):
        m.fit(y=f["y"], X=f["X"], params={"optimizer_cov": "lbfgs",
                                          "init_cov_pars": f["init"]})
    kw = dict(gp_coords_pred=COORD_TEST, cluster_ids_pred=[1, 3, 2],
              X_pred=f["X"][:3], predict_var=True)
    want = tm.predict(**kw)
    back = gpt.GPModel.from_dict(json.loads(json.dumps(tm.model_to_dict())),
                                 device="cpu")
    got = back.predict(**kw)
    np.testing.assert_array_equal(got["mu"], want["mu"])
    np.testing.assert_array_equal(got["var"], want["var"])
    from_jax = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    pj = jm.predict(**kw)
    # the JAX package saves cluster codes, not ids: predict at codes; the
    # port predicts by the cluster blocks, the JAX package densely
    # (distances by differences vs by inner products): 1e-8
    pt = from_jax.predict(**dict(kw, cluster_ids_pred=[0, 2, 1]))
    pj = jm.predict(**dict(kw, cluster_ids_pred=[1, 3, 2]))
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-8)
    assert tm._cov_par_names() == jm._cov_par_names()
    tm.summary()
    assert "GP_range" in capsys.readouterr().out
