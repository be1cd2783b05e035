"""The space-time GP of the PyTorch port: ``matern_space_time`` on the exact
route and under Vecchia with the time orderings, and the Gneiting
covariance — the R goldens of ``tests/test_space_time_golden.py`` (the
reference suite's block "Space-time Gaussian process model with linear
regression term", at its tolerances: 1e-5 strict, 1e-2 for the orderings,
whose within-time ties are the implementation's), plus parity with the JAX
package on the same model (1e-10 relative).
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif

TOL_STRICT = 1e-5
TOL_LOOSE = 1e-2
X_TEST = np.column_stack([np.ones(3), np.zeros(3)])
COV_PARS_PRED = [1.0, 1.0, 2.0, 0.1]
COEF_FIT = np.array([1.9593121521, 2.1693074509])
EXPECTED_MU = np.array([1.959312152, 1.940440108, 2.566912825])
EXPECTED_COV = np.array(
    [2.0, 0.0, 0.0,
     0.0, 1.5919472301920, 0.0001229642924,
     0.0, 0.0001229642924, 1.5650143857452]).reshape(3, 3)
NLL_PARS = [0.1, 1.6, 1.0, 0.2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def st(gp_fixture_data):
    f = gp_fixture_data
    n = f["n"]
    time = np.arange(1, n + 1, dtype=float)
    us = sim_rand_unif(n, 0.6418)
    nt = 20
    for i in range(1, nt + 1):
        time[(us < i / nt) & (us >= (i - 1) / nt)] = i
    scaled = np.column_stack([time / 2.0, f["coords"] / 0.1])
    D_ST = np.sqrt(((scaled[:, None] - scaled[None]) ** 2).sum(-1))
    Sigma = np.exp(-D_ST) + 1e-20 * np.eye(n)
    eps_ST = np.linalg.cholesky(Sigma) @ sim_rand_normal(n, 0.688)
    y = eps_ST + f["X"] @ f["beta"] + f["xi"]
    coords_st = np.column_stack([time, f["coords"]])
    coord_test = np.vstack([[10000.0, 0.2, 0.9], coords_st[0],
                            coords_st[9]])
    coord_test[1:, 1:] += 0.01
    return dict(y=y, f=f, coords_st=coords_st, coord_test=coord_test)


def _st_model(pkg, st, **kw):
    extra = {} if pkg is gpb else {"device": "cpu"}
    return pkg.GPModel(gp_coords=st["coords_st"],
                       cov_function="matern_space_time", cov_fct_shape=0.5,
                       **kw, **extra)


def test_dense_predict(st):
    m = _st_model(gpt, st)
    r = st["y"] - st["f"]["X"] @ COEF_FIT
    pred = m.predict(y=r, gp_coords_pred=st["coord_test"],
                     cov_pars=COV_PARS_PRED, predict_cov_mat=True,
                     predict_response=True)
    assert np.sum(np.abs(pred["mu"] + X_TEST @ COEF_FIT - EXPECTED_MU)) \
        < TOL_STRICT
    assert np.sum(np.abs(pred["cov"] - EXPECTED_COV)) < TOL_STRICT


@pytest.mark.parametrize("nn,golden", [(99, 272.1497719),
                                       (50, 272.1376522)])
def test_vecchia_nll(st, nn, golden):
    m = _st_model(gpt, st, gp_approx="vecchia", num_neighbors=nn,
                  vecchia_ordering="none")
    assert abs(m.neg_log_likelihood(NLL_PARS, st["y"]) - golden) < TOL_STRICT


@pytest.mark.parametrize("ordering,golden", [
    ("time", 272.1498125), ("time_random_space", 272.1498202)])
def test_time_orderings(st, ordering, golden):
    """R: the NLL at nn = 50 with the time orderings (LOOSE); the port's
    ordering and neighbours are the JAX package's, and so is its NLL
    (1e-10 relative)."""
    tm = _st_model(gpt, st, gp_approx="vecchia", num_neighbors=50,
                   vecchia_ordering=ordering)
    jm = _st_model(gpb, st, gp_approx="vecchia", num_neighbors=50,
                   vecchia_ordering=ordering)
    np.testing.assert_array_equal(tm._approx.perm, np.asarray(jm._approx.perm))
    nll = tm.neg_log_likelihood(NLL_PARS, st["y"])
    assert abs(nll - golden) < TOL_LOOSE
    nll_j = jm.neg_log_likelihood(cov_pars=NLL_PARS, y=st["y"])
    assert abs(nll - nll_j) < 1e-10 * abs(nll_j)


def test_time_ordering_requires_space_time_kernel(st):
    for pkg in (gpt, gpb):
        extra = {} if pkg is gpb else {"device": "cpu"}
        with pytest.raises(ValueError, match="space-time"):
            pkg.GPModel(gp_coords=st["f"]["coords"],
                        cov_function="exponential", gp_approx="vecchia",
                        num_neighbors=30, vecchia_ordering="time", **extra)


@pytest.mark.parametrize("kind", ["order_obs_first_cond_all",
                                  "order_obs_first_cond_obs_only"])
def test_vecchia_predict(st, kind):
    """R:2404-2424: both prediction types at nn = n - 1 meet the exact
    model's values (STRICT)."""
    n = st["f"]["n"]
    m = _st_model(gpt, st, gp_approx="vecchia", num_neighbors=n - 1,
                  vecchia_ordering="none")
    full = kind.endswith("cond_all")
    m.set_prediction_data(vecchia_pred_type=kind,
                          num_neighbors_pred=n + 2 if full else n)
    r = st["y"] - st["f"]["X"] @ COEF_FIT
    pred = m.predict(y=r, gp_coords_pred=st["coord_test"],
                     cov_pars=COV_PARS_PRED, predict_cov_mat=full,
                     predict_var=not full, predict_response=True)
    assert np.sum(np.abs(pred["mu"] + X_TEST @ COEF_FIT - EXPECTED_MU)) \
        < TOL_STRICT
    got = pred["cov"] if full else pred["var"]
    want = EXPECTED_COV if full else np.diag(EXPECTED_COV)
    assert np.sum(np.abs(got - want)) < TOL_STRICT


def test_duplicate_locations(st):
    """R:2466-2500: the first 5 rows replaced by the last 5."""
    coords_dup = st["coords_st"].copy()
    coords_dup[:5] = coords_dup[-5:]
    for kw in ({}, dict(gp_approx="vecchia", num_neighbors=99,
                        vecchia_ordering="none")):
        m = gpt.GPModel(gp_coords=coords_dup,
                        cov_function="matern_space_time", cov_fct_shape=0.5,
                        device="cpu", **kw)
        assert abs(m.neg_log_likelihood(NLL_PARS, st["y"])
                   - 276.47191976324) < TOL_STRICT


def test_gneiting_nll(st):
    """R:2503-2511 and the JAX package's value (1e-10 relative)."""
    pars = [0.1, 1.0, 0.2, 2.0, 0.5, 1.5, 0.5, 2.0]
    m = _st_model(gpt, st)
    mg = gpt.GPModel(gp_coords=st["coords_st"],
                     cov_function="space_time_gneiting", cov_fct_shape=0.5,
                     device="cpu")
    jg = gpb.GPModel(gp_coords=st["coords_st"],
                     cov_function="space_time_gneiting", cov_fct_shape=0.5)
    assert m.num_cov_pars == 4 and mg.num_cov_pars == 8
    nll = mg.neg_log_likelihood(pars, st["y"])
    assert abs(nll - 604.779654987741) < TOL_STRICT
    nll_j = jg.neg_log_likelihood(cov_pars=pars, y=st["y"])
    assert abs(nll - nll_j) < 1e-10 * abs(nll_j)


def test_fitted_space_time_vecchia_matches_jax(st):
    """An L-BFGS fit of the space-time Vecchia GP (time ordering, m = 8):
    the neighbours in the scaled coordinates are redetermined as the
    ranges move, as in the JAX package; cov_pars within 1e-5 relative."""
    kw = dict(gp_approx="vecchia", num_neighbors=8,
              vecchia_ordering="time_random_space")
    params = {"optimizer_cov": "lbfgs", "maxit": 30}
    tm = _st_model(gpt, st, **kw).fit(st["y"], params=params)
    jm = _st_model(gpb, st, **kw)
    jm.fit(y=st["y"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)
