"""The wendland covariance, ``gp_approx="tapering"`` and the non-stationary
``linear`` / ``hurst`` covariances of the PyTorch port: the R goldens of
``tests/test_taper_wendland_golden.py`` and ``tests/test_linear_cov_golden.py``
at their tolerances (1e-5 strict, 1e-3 medium, 1e-2 loose), and parity with
the JAX package on the same inputs (NLL 1e-10 relative, fits 1e-5 relative,
predictions 1e-8).
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.utils.rng import sim_rand_unif

TOL_STRICT = 1e-5
TOL_MEDIUM = 1e-3
TOL_LOOSE = 1e-2
COORD_TEST = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(coords, **kw):
    return gpt.GPModel(gp_coords=coords, device="cpu", **kw), \
        gpb.GPModel(gp_coords=coords, **kw)


# ---------------------------------------------------------------------------
# wendland
# ---------------------------------------------------------------------------

def test_wendland_nll(gp_fixture_data):
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    tm, jm = _pair(f["coords"], cov_function="wendland",
                   cov_fct_taper_shape=0, cov_fct_taper_range=0.1)
    assert tm.num_cov_pars == jm.num_cov_pars == 2
    nll = tm.neg_log_likelihood([0.02, 1.2], y)
    assert abs(nll - 136.9508962) < TOL_STRICT
    nll_j = jm.neg_log_likelihood(cov_pars=[0.02, 1.2], y=y)
    assert abs(nll - nll_j) < 1e-10 * abs(nll_j)


@pytest.mark.parametrize("shape,rng_,mu,cov", [
    (1, 2.0, [-0.008405567, 1.493836307, 0.720565199],
     [2.933992e-02, 2.223241e-06, 1.352544e-05, 2.223241e-06, 2.496193e-02,
      1.130906e-05, 1.352544e-05, 1.130906e-05, 2.405649e-02]),
    (1, 0.15, [-0.007404038, 1.487424320, 0.200022114],
     [1.113020e+00, 0.0, 0.0, 0.0, 3.522739e-01, 9.018454e-10, 0.0,
      9.018454e-10, 6.092985e-01]),
    (2, 0.08, [-2.314198e-05, 8.967992e-01, 2.430054e-02],
     list(np.diag([1.22, 0.9024792, 1.1887157]).ravel()))])
def test_wendland_predict(gp_fixture_data, shape, rng_, mu, cov):
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="wendland",
                    cov_fct_taper_shape=shape, cov_fct_taper_range=rng_,
                    device="cpu")
    pred = m.predict(y=y, gp_coords_pred=COORD_TEST, cov_pars=[0.02, 1.2],
                     predict_cov_mat=True, predict_response=True)
    assert np.sum(np.abs(pred["mu"] - mu)) < TOL_STRICT
    assert np.sum(np.abs(pred["cov"] - np.reshape(cov, (3, 3)))) < TOL_STRICT
    pv = m.predict(y=y, gp_coords_pred=COORD_TEST, cov_pars=[0.02, 1.2],
                   predict_var=True, predict_response=True)
    assert np.sum(np.abs(pv["var"] - np.diag(np.reshape(cov, (3, 3))))) \
        < TOL_STRICT


def test_wendland_fisher_scoring(gp_fixture_data):
    """R's Fisher-scoring trajectory stops early at (4.9e-9, 1.302), NLL
    137.4235; the JAX package (and the port) go on to the optimum near
    (0, 1.216): at least the reference's likelihood, std errors finite."""
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="wendland",
                    cov_fct_taper_shape=0, cov_fct_taper_range=0.1,
                    device="cpu")
    m.fit(y, params={"optimizer_cov": "fisher_scoring",
                     "use_nesterov_acc": False, "delta_rel_conv": 1e-6})
    got = m.get_cov_pars(std_err=True)
    assert got[0, 0] < 1e-6 and 1.1 < got[0, 1] < 1.45
    assert np.all(np.isfinite(got[1]) & (got[1] > 0))
    nll_ref_stop = m.neg_log_likelihood([4.941224e-09, 1.302468], y)
    assert abs(nll_ref_stop - 137.4234801) < TOL_MEDIUM
    assert m.get_current_neg_log_likelihood() <= nll_ref_stop + 1e-6


# ---------------------------------------------------------------------------
# gp_approx="tapering"
# ---------------------------------------------------------------------------

def test_large_taper_range_equals_no_taper(gp_fixture_data):
    f = gp_fixture_data
    y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
    exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        device="cpu")
    tap = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                      gp_approx="tapering", cov_fct_taper_shape=0,
                      cov_fct_taper_range=1e6, device="cpu")
    cp = [0.1, 1.6, 0.2]
    assert abs(exact.neg_log_likelihood(cp, y)
               - tap.neg_log_likelihood(cp, y)) < TOL_MEDIUM


def test_matern_tapering_nll_and_predict(gp_fixture_data):
    """R:1520-1560: matern 1.5 with a taper of range 1e6 is the exact model
    (NLL 121.8046544 at the R optimum, predictions within 1e-3); the JAX
    package's NLL and prediction at a finite range (0.3), 1e-10."""
    f = gp_fixture_data
    y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
    fe = f["X"] @ np.array([2.34174699, 1.88055706])
    cp = [0.17383685, 0.84111654, 0.08839064]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="matern",
                    cov_fct_shape=1.5, gp_approx="tapering",
                    cov_fct_taper_shape=1, cov_fct_taper_range=1e6,
                    device="cpu")
    assert abs(m.neg_log_likelihood(cp, y, fixed_effects=fe)
               - 121.8046544) < TOL_MEDIUM
    exact = gpt.GPModel(gp_coords=f["coords"], cov_function="matern",
                        cov_fct_shape=1.5, device="cpu")
    p_t = m.predict(y=y - fe, gp_coords_pred=COORD_TEST, cov_pars=cp,
                    predict_cov_mat=True, predict_response=False)
    p_e = exact.predict(y=y - fe, gp_coords_pred=COORD_TEST, cov_pars=cp,
                        predict_cov_mat=True, predict_response=False)
    assert np.sum(np.abs(p_t["mu"] - p_e["mu"])) < TOL_MEDIUM
    assert np.sum(np.abs(p_t["cov"] - p_e["cov"])) < TOL_MEDIUM
    tm, jm = _pair(f["coords"], cov_function="matern", cov_fct_shape=1.5,
                   gp_approx="tapering", cov_fct_taper_shape=1,
                   cov_fct_taper_range=0.3)
    nll_j = jm.neg_log_likelihood(cov_pars=cp, y=y, fixed_effects=fe)
    assert abs(tm.neg_log_likelihood(cp, y, fixed_effects=fe) - nll_j) \
        < 1e-10 * abs(nll_j)
    pt = tm.predict(y=y - fe, gp_coords_pred=COORD_TEST, cov_pars=cp,
                    predict_var=True)
    pj = jm.predict(y=y - fe, gp_coords_pred=COORD_TEST, cov_pars=cp,
                    predict_var=True)
    np.testing.assert_allclose(pt["mu"], np.asarray(pj["mu"]), atol=1e-8)
    np.testing.assert_allclose(pt["var"], np.asarray(pj["var"]), atol=1e-8)


def test_matern_general_shape_tapering_nll(gp_fixture_data):
    """shape = 1.5 + 1e-4 takes the general Bessel-K Matern (R:1571-1577)."""
    f = gp_fixture_data
    y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="matern",
                    cov_fct_shape=1.5 + 1e-4, gp_approx="tapering",
                    cov_fct_taper_shape=1, cov_fct_taper_range=1e6,
                    device="cpu")
    fe = f["X"] @ np.array([2.34174699, 1.88055706])
    nll = m.neg_log_likelihood([0.17383685, 0.84111654, 0.08839064], y,
                               fixed_effects=fe)
    assert abs(nll - 121.8046544) < TOL_LOOSE


def test_exponential_tapering_fit(gp_fixture_data):
    """R taper range 0.5 (:1506-1514): cov_pars (0.0259, 0.9944, 0.1771) and
    coefs (2.324, 1.895) at R's loose fit tolerances; L-BFGS of the port
    against the JAX package's at 1e-5 relative."""
    f = gp_fixture_data
    y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
    kw = dict(cov_function="exponential", gp_approx="tapering",
              cov_fct_taper_shape=0, cov_fct_taper_range=0.5)
    tm, jm = _pair(f["coords"], **kw)
    params = {"optimizer_cov": "lbfgs"}
    tm.fit(y, X=f["X"], params=params)
    jm.fit(y=y, X=f["X"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), [0.02593993, 0.99435221,
                                                   0.17712808],
                               rtol=2e-1, atol=2e-2)
    np.testing.assert_allclose(tm.get_coef(), [2.32410488, 1.89498931],
                               rtol=5e-2)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)


def test_taper_keywords_need_a_taper(gp_fixture_data):
    """The taper keywords are read by tapering, the wendland covariance and
    the full-scale approximations; elsewhere they raise."""
    with pytest.raises(NotImplementedError, match="taper"):
        gpt.GPModel(gp_coords=gp_fixture_data["coords"],
                    cov_function="exponential", cov_fct_taper_range=0.3,
                    device="cpu")


# ---------------------------------------------------------------------------
# linear and hurst
# ---------------------------------------------------------------------------

N, D_LIN = 100, 50


@pytest.fixture(scope="module")
def lin_data():
    x = sim_rand_unif(N * D_LIN, init_c=0.1156)
    coords_lin = x.reshape(D_LIN, N).T
    beta_lin = norm.ppf(sim_rand_unif(D_LIN, init_c=0.1234))
    X = np.column_stack([np.ones(N),
                         np.sin((np.arange(1, N + 1) - N / 2) ** 2
                                * 2 * np.pi / N)])
    y = (coords_lin @ beta_lin + X @ np.array([0.1, 2.0])
         + norm.ppf(sim_rand_unif(N, init_c=0.2224)) * 0.1)
    coord_test = sim_rand_unif(3 * D_LIN, init_c=0.19156).reshape(D_LIN, 3).T
    X_test = np.column_stack([np.ones(3), [-0.5, 0.2, 0.4]])
    return dict(coords=coords_lin, X=X, y=y, coord_test=coord_test,
                X_test=X_test)


@pytest.mark.parametrize("approx", ["none", "vecchia"])
def test_linear_nll(lin_data, approx):
    """R:4409-4490: the dense NLL, and Vecchia at nn = n - 1 equal to it."""
    kw = {} if approx == "none" else dict(
        gp_approx="vecchia", num_neighbors=N - 1, vecchia_ordering="none")
    m = gpt.GPModel(gp_coords=lin_data["coords"], cov_function="linear",
                    device="cpu", **kw)
    assert abs(m.neg_log_likelihood([0.5, 0.9], lin_data["y"])
               - 268.6641569) < 1e-5


def test_linear_fit_and_predict(lin_data):
    f = lin_data
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="linear",
                    device="cpu")
    m.fit(f["y"], X=f["X"], params={"optimizer_cov": "lbfgs"})
    np.testing.assert_allclose(m.get_cov_pars(),
                               [0.01428942126, 0.92806146725], atol=1e-4)
    np.testing.assert_allclose(m.get_coef(), [0.08076221412, 1.97947766605],
                               atol=1e-4)
    assert abs(m.get_current_neg_log_likelihood() - 81.26251299) < 1e-3
    pred = m.predict(y=f["y"], gp_coords_pred=f["coord_test"],
                     X_pred=f["X_test"], predict_var=True,
                     predict_response=False)
    np.testing.assert_allclose(pred["mu"], [4.671312214, 3.029084877,
                                            7.400864491], atol=1e-3)
    np.testing.assert_allclose(pred["var"], [0.01524446, 0.01621295,
                                             0.01564379], atol=1e-3)


@pytest.fixture(scope="module")
def hurst_data():
    from scipy.linalg import cholesky as chol_upper
    n = 100
    x = sim_rand_unif(n * 2, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    r = np.sum(coords ** 2, axis=1)
    D2 = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    K = 0.5 * (r[:, None] ** 0.5 + r[None, :] ** 0.5 - D2 ** 0.5)
    U = chol_upper(K + 1e-8 * np.eye(n))
    b = U @ (norm.ppf(sim_rand_unif(n, init_c=0.1346)) * 0.1)
    X = np.column_stack([np.ones(n),
                         np.sin((np.arange(1, n + 1) - n / 2) ** 2
                                * 2 * np.pi / n)])
    y = X @ np.array([0.1, 2.0]) + b \
        + norm.ppf(sim_rand_unif(n, init_c=0.1354)) * 0.1
    coord_test = sim_rand_unif(3 * 2, init_c=0.19156).reshape(2, 3).T
    return dict(coords=coords, X=X, y=y, coord_test=coord_test,
                X_test=np.column_stack([np.ones(3), [-0.5, 0.2, 0.4]]))


@pytest.mark.parametrize("approx", ["none", "vecchia"])
def test_hurst_nll(hurst_data, approx):
    """R:4754-4830 (1e-4), and the JAX package's NLL: 1e-10 relative under
    Vecchia; the dense one 1e-8, where the JAX package lies 1.6e-5 from a
    numpy float64 Cholesky of the same Psi (the two packages' Psi agree to
    2e-16), which the port meets at 1e-12 relative."""
    kw = {} if approx == "none" else dict(
        gp_approx="vecchia", num_neighbors=N - 1, vecchia_ordering="none")
    tm, jm = _pair(hurst_data["coords"], cov_function="hurst", **kw)
    cp = [0.01, 1.0, 0.5]
    y = hurst_data["y"]
    nll = tm.neg_log_likelihood(cp, y)
    assert abs(nll - 2508.161111) < 1e-4
    nll_j = jm.neg_log_likelihood(cov_pars=cp, y=y)
    if approx == "vecchia":
        assert abs(nll - nll_j) < 1e-10 * abs(nll_j)
        return
    assert abs(nll - nll_j) < 1e-8 * abs(nll_j)
    c = hurst_data["coords"]
    sq = np.sum(c * c, axis=1)
    d2 = np.sum((c[:, None] - c[None]) ** 2, axis=-1)
    psi = 0.5 * (np.sqrt(sq)[:, None] + np.sqrt(sq)[None, :]
                 - np.sqrt(d2)) + 0.01 * np.eye(N)
    L = np.linalg.cholesky(psi)
    a = np.linalg.solve(L, y)
    ref = 0.5 * (a @ a + 2 * np.sum(np.log(np.diag(L)))
                 + N * np.log(2 * np.pi))
    assert abs(nll - ref) < 1e-12 * abs(ref)


def test_hurst_fit_and_predict(hurst_data):
    f = hurst_data
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="hurst",
                    device="cpu")
    m.fit(f["y"], X=f["X"], params={"optimizer_cov": "lbfgs"})
    cp = m.get_cov_pars()
    np.testing.assert_allclose(cp[0], 2.430011710e-02, atol=1e-4)
    assert cp[1] < 1e-4
    np.testing.assert_allclose(m.get_coef(), [0.06807413795, 2.01626778203],
                               atol=1e-3)
    assert abs(m.get_current_neg_log_likelihood() - (-43.96963741)) < 1e-2
    pred = m.predict(y=f["y"], gp_coords_pred=f["coord_test"],
                     X_pred=f["X_test"], predict_var=True,
                     predict_response=False)
    np.testing.assert_allclose(pred["mu"], [-0.9400622610, 0.4713289372,
                                            0.8745803091], atol=1e-3)


@pytest.mark.parametrize("cov", ["linear", "hurst"])
def test_nonstationary_vecchia_factors_match_jax(hurst_data, cov):
    """The non-stationary factor branch of the Vecchia build (m = 6) and the
    Vecchia prediction's variances against the JAX package (1e-10)."""
    f = hurst_data
    kw = dict(cov_function=cov, gp_approx="vecchia", num_neighbors=6)
    tm, jm = _pair(f["coords"], **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    cp = [0.02, 1.0] if cov == "linear" else [0.02, 1.0, 0.4]
    nll_j = jm.neg_log_likelihood(cov_pars=cp, y=f["y"])
    assert abs(tm.neg_log_likelihood(cp, f["y"]) - nll_j) < 1e-10 * abs(nll_j)
    pt = tm.predict(y=f["y"], gp_coords_pred=f["coord_test"], cov_pars=cp,
                    predict_var=True)
    pj = jm.predict(y=f["y"], gp_coords_pred=f["coord_test"], cov_pars=cp,
                    predict_var=True)
    np.testing.assert_allclose(pt["mu"], np.asarray(pj["mu"]), atol=1e-10)
    np.testing.assert_allclose(pt["var"], np.asarray(pj["var"]), atol=1e-10)
