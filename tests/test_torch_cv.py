"""``cv`` with GP-aware folds, ``fit_GP_cov_pars_OOS`` and
``grid_search_tune_parameters`` of the port against the JAX package on the
CPU, float64, on numpy-seeded data (n = 300):

- mirrors ``tests/test_boosting_basic.py::test_cv`` (the same folds, the
  curves within 1e-2 relative: see ``test_cv``) and
  ``::test_cv_gpboost_oos`` (grouped random
  effects: the curves within 1e-9, the out-of-sample covariance parameters
  within 1e-6 relative);
- the grid search at the size of the README's GPBoost example (n = 1 000 /
  25 groups there; n = 300 / 20 groups here, a 2 x 2 grid, ``nfold=4``):
  the same best parameters and best iteration, the best score within 1e-9;
- the folds' GPModels keep only the likelihood, the covariance function and
  the approximation of the parent (as the JAX package's), on its device.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting import engine as jengine

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import engine as tengine

TOL = 1e-10
GP_TOL = 1e-9
OOS_RTOL = 1e-6
PKGS = ((gpb, {}), (gpt, {"device": "cpu"}))


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
    rng = np.random.default_rng(42)
    n, F = 300, 4
    X = rng.uniform(size=(n, F))
    y = (2 * X[:, 0] + np.sin(5 * X[:, 1]) + (X[:, 2] > 0.6) * 1.5
         + 0.1 * rng.standard_normal(n))
    groups = rng.integers(0, 20, size=n)
    y2 = y + 0.6 * rng.standard_normal(20)[groups]
    return dict(X=X, y=y, groups=groups, y2=y2,
                coords=rng.uniform(size=(n, 2)))


def _same(rt, rj, tol, rtol=0.0):
    assert set(rt) == set(rj)
    for key in rj:
        np.testing.assert_allclose(rt[key], rj[key], rtol=rtol, atol=tol,
                                   err_msg=key)


def test_cv(data):
    out = []
    for pkg, kw in PKGS:
        out.append(pkg.cv({"objective": "regression", "verbose": -1},
                          pkg.Dataset(data["X"], label=data["y"], **kw),
                          num_boost_round=10, nfold=3, seed=1))
    rj, rt = out
    assert "l2-mean" in rt and len(rt["l2-mean"]) == 10
    assert rt["l2-mean"][-1] < rt["l2-mean"][0]
    # the first rounds agree to rounding; the leaf totals are summed in
    # another order than XLA's (leaf values ~1e-17 apart), and in round 8
    # of fold 0 a split then takes the other of two cut points that no
    # training row lies between (equal gains, a tie that those last bits
    # break), which moves held-out rows between them
    _same({k: v[:7] for k, v in rt.items()},
          {k: v[:7] for k, v in rj.items()}, TOL)
    _same(rt, rj, 0.0, rtol=1e-2)


def test_make_folds_matches_jax():
    for n, nfold, seed in ((300, 3, 1), (101, 4, 7)):
        ft = tengine._make_folds(n, nfold, True, None, seed)
        fj = jengine._make_folds(n, nfold, True, None, seed)
        for a, b in zip(ft, fj):
            np.testing.assert_array_equal(a, b)


def test_cv_gpboost_oos(data):
    out = []
    for pkg, kw in PKGS:
        gp = pkg.GPModel(group_data=data["groups"], **kw)
        res = pkg.cv({"objective": "regression", "verbose": -1},
                     pkg.Dataset(data["X"], label=data["y2"], **kw),
                     num_boost_round=10, nfold=3, gp_model=gp,
                     fit_GP_cov_pars_OOS=True, seed=2,
                     early_stopping_rounds=3, return_cvbooster=True)
        out.append((res, np.asarray(gp.get_cov_pars())))
    (rj, pj), (rt, pt) = out
    cvb = rt.pop("cvbooster")
    rj.pop("cvbooster")
    assert len(cvb.boosters) == 3
    _same(rt, rj, GP_TOL)
    assert np.all(np.isfinite(pt)) and 0.1 < pt[1] < 1.0   # truth 0.36
    np.testing.assert_allclose(pt, pj, rtol=OOS_RTOL)


def test_fold_models_keep_the_structure(data):
    parent = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                         gp_approx="vecchia", num_neighbors=5,
                         dtype=torch.float32, device="cpu")
    mask = np.arange(300) % 3 != 0
    fold = tengine._subset_gp_model(parent, mask)
    assert fold.gp_approx == "vecchia" and fold.device == parent.device
    assert fold.cov_function_name == "exponential"
    assert fold.num_data == int(mask.sum())
    # as in the JAX package: the defaults for what the fold does not take
    assert fold.dtype == torch.float64 and fold.num_neighbors is None
    pred = tengine._subset_gp_pred_kwargs(parent, ~mask)
    np.testing.assert_array_equal(pred["gp_coords_pred"],
                                  data["coords"][~mask])
    grouped = gpt.GPModel(group_data=np.column_stack(
        [data["groups"], data["groups"] % 3]), device="cpu")
    jgrouped = gpb.GPModel(group_data=np.column_stack(
        [data["groups"], data["groups"] % 3]))
    pt = tengine._subset_gp_pred_kwargs(grouped, mask)
    pj = jengine._subset_gp_pred_kwargs(jgrouped, mask)
    np.testing.assert_array_equal(pt["group_data_pred"],
                                  np.asarray(pj["group_data_pred"]))


def test_grid_search_matches_jax(data):
    grid = {"learning_rate": [0.1, 0.5], "max_depth": [2, 5]}
    out = []
    for pkg, kw in PKGS:
        gp = pkg.GPModel(group_data=data["groups"], **kw)
        out.append(pkg.grid_search_tune_parameters(
            grid, pkg.Dataset(data["X"], label=data["y2"], **kw),
            params={"verbose": -1}, nfold=4, gp_model=gp,
            num_boost_round=10, early_stopping_rounds=3, seed=1,
            verbose_eval=0))
    bj, bt = out
    assert bt["best_params"] == bj["best_params"]
    assert bt["best_iter"] == bj["best_iter"]
    assert abs(bt["best_score"] - bj["best_score"]) <= GP_TOL
