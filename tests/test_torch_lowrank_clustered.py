"""``cluster_ids`` under fitc / full_scale_tapering / full_scale_vecchia in
the port (``models/clustered_approx.py``) on the CPU, float64 — the port's
counterpart of ``tests/test_cluster_fitc_golden.py``, with its R goldens
(``tests/data/cluster_fitc_goldens.json``, reference package v1.6.5) at
that file's own tolerances, and against the JAX package:

- NLL and prediction (mean, variance) of the batched clusters equal the
  JAX package's (1e-10 relative NLL; predictions 1e-7: the JAX package's
  inner-product distances) and the loop over the sub-models (1e-12);
- an unseen prediction cluster gets the prior exactly;
- the Laplace approximation with clusters (the loop) against the JAX
  package (1e-8: the mode finders' stop rule);
- fits run and lower the NLL.
"""
import json
import os

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                   "cluster_fitc_goldens.json")))
CP = np.array([0.07, 1.1, 0.22])
CID_P = np.array([1] * 6 + [2] * 6)
CASES = [("fitc", 1e-6, 1e-5, 1e-4), ("fsva", 5e-2, 5e-2, 5e-2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = 240
    cid = np.repeat([1, 2], n // 2)
    coords = rng.uniform(size=(n, 2))
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    K = 1.2 * np.exp(-D / 0.25)
    K[:n // 2, n // 2:] = 0.0
    K[n // 2:, :n // 2] = 0.0
    L = np.linalg.cholesky(K + 0.05 * np.eye(n))
    y = L @ rng.standard_normal(n)
    cpp = rng.uniform(size=(12, 2))
    return coords, cid, y, cpp


def make(approx, coords, cid, k, pkg="torch", **kw):
    kw.update(gp_coords=coords, cov_function="exponential", gp_approx=approx,
              num_ind_points=k, cluster_ids=cid)
    if approx == "full_scale_tapering":
        kw["cov_fct_taper_range"] = 0.5
    if approx == "full_scale_vecchia":
        kw["num_neighbors"] = 10
        kw["vecchia_ordering"] = "none"
    return gpb.GPModel(**kw) if pkg == "jax" else gpt.GPModel(device="cpu",
                                                              **kw)


@pytest.mark.parametrize("name,nll_tol,mu_tol,var_tol", CASES)
def test_clustered_approx_nll_and_predict(name, nll_tol, mu_tol, var_tol,
                                          data):
    coords, cid, y, cpp = data
    g = GOLD[name]
    m = make(g["approx"], coords, cid, g["num_ind_points"])
    assert m._approx.stacked is not None
    nll = m.neg_log_likelihood(cov_pars=CP, y=y)
    assert abs(nll - g["nll"]) < nll_tol * abs(g["nll"])
    pr = m.predict(y=y, gp_coords_pred=cpp, cluster_ids_pred=CID_P,
                   cov_pars=CP, predict_var=True)
    np.testing.assert_allclose(pr["mu"], g["mu"], atol=mu_tol)
    np.testing.assert_allclose(pr["var"], g["var"], atol=var_tol)


@pytest.mark.parametrize("approx", ["fitc", "full_scale_tapering",
                                    "full_scale_vecchia"])
def test_batched_clusters_match_jax_and_the_loop(data, approx):
    coords, cid, y, cpp = data
    jm = make(approx, coords, cid, 40, pkg="jax")
    tm = make(approx, coords, cid, 40)
    nll_j = jm.neg_log_likelihood(CP, y)
    nll_t = tm.neg_log_likelihood(CP, y)
    assert abs(nll_t - nll_j) < 1e-10 * abs(nll_j)
    th = torch.log(tm._tensor(CP))
    yt = tm._tensor(y)
    v_b, g_b = tm._approx._vg_gaussian(th, yt, None)
    r_b = tm._psi_solve(CP, y)
    stacked, tm._approx.stacked = tm._approx.stacked, None
    v_l, g_l = tm._approx._vg_gaussian(th, yt, None)
    r_l = tm._psi_solve(CP, y)
    tm._approx.stacked = stacked
    assert abs(v_b.item() - v_l.item()) < 1e-12 * abs(v_l.item())
    torch.testing.assert_close(g_b, g_l, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r_b, r_l, rtol=1e-12, atol=1e-12)
    pj = jm.predict(y=y, gp_coords_pred=cpp, cluster_ids_pred=CID_P,
                    cov_pars=CP, predict_var=True)
    pt = tm.predict(y=y, gp_coords_pred=cpp, cluster_ids_pred=CID_P,
                    cov_pars=CP, predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], atol=1e-7)
    np.testing.assert_allclose(pt["var"], pj["var"], atol=1e-7)


def test_clustered_nll_matches_sum_of_reference_single_models(data):
    coords, cid, y, _ = data
    for name, approx in (("fitc40_sum_ref_single", "fitc"),
                         ("fsa40_sum_ref_single", "full_scale_tapering")):
        nll = float(make(approx, coords, cid, 40).neg_log_likelihood(
            cov_pars=CP, y=y))
        assert abs(nll - GOLD[name]) < 1e-2 * abs(GOLD[name]), (name, nll)


def test_clustered_matches_per_cluster_sum(data):
    coords, cid, y, _ = data
    total = make("fitc", coords, cid, 40).neg_log_likelihood(cov_pars=CP,
                                                             y=y)
    parts = 0.0
    for c in (1, 2):
        sel = cid == c
        parts += gpt.GPModel(gp_coords=coords[sel],
                             cov_function="exponential", gp_approx="fitc",
                             num_ind_points=40, device="cpu"
                             ).neg_log_likelihood(cov_pars=CP, y=y[sel])
    assert abs(total - parts) < 1e-8


def test_clustered_fitc_unseen_cluster_prior(data):
    coords, cid, y, cpp = data
    m = make("fitc", coords, cid, 40)
    pr = m.predict(y=y, gp_coords_pred=cpp,
                   cluster_ids_pred=np.array([1] * 6 + [9] * 6),
                   cov_pars=CP, predict_var=True)
    assert np.all(pr["mu"][6:] == 0.0)
    assert np.all(pr["var"][6:] == CP[1] + CP[0])
    with pytest.raises(ValueError, match="cluster_ids_pred"):
        m.predict(y=y, gp_coords_pred=cpp, cov_pars=CP)


def test_clustered_fits_run(data):
    coords, cid, y, _ = data
    for approx in ("fitc", "full_scale_vecchia"):
        m = make(approx, coords, cid, 40)
        m.fit(y=y, params={"maxit": 8, "trace": False})
        assert np.all(np.isfinite(m.cov_pars_))
        assert m.current_nll_ < m.neg_log_likelihood(
            cov_pars=np.array([1.0, 1.0, 0.5]), y=y)


def test_unequal_clusters_take_the_loop(data):
    coords, _, y, cpp = data
    cid = np.repeat([1, 2], [100, 140])
    m = make("fitc", coords, cid, 30)
    assert m._approx.stacked is None
    jm = make("fitc", coords, cid, 30, pkg="jax")
    nll_j = jm.neg_log_likelihood(CP, y)
    assert abs(m.neg_log_likelihood(CP, y) - nll_j) < 1e-10 * abs(nll_j)


def test_clustered_laplace_matches_jax(data):
    coords, cid, y, cpp = data
    yb = (y > 0).astype(float)
    kw = dict(likelihood="bernoulli_logit")
    jm = make("fitc", coords, cid, 30, pkg="jax", **kw)
    tm = make("fitc", coords, cid, 30, **kw)
    cp = [1.1, 0.22]
    nll_j = jm.neg_log_likelihood(cp, yb)
    assert abs(tm.neg_log_likelihood(cp, yb) - nll_j) < 1e-8 * abs(nll_j)
    cid_p = np.array([1] * 5 + [2] * 5 + [7] * 2)
    pj = jm.predict(y=yb, gp_coords_pred=cpp, cluster_ids_pred=cid_p,
                    cov_pars=cp, predict_var=True)
    pt = tm.predict(y=yb, gp_coords_pred=cpp, cluster_ids_pred=cid_p,
                    cov_pars=cp, predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], atol=1e-7)
    np.testing.assert_allclose(pt["var"], pj["var"], atol=1e-7)
