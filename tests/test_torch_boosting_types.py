"""DART, GOSS, random forests, Nesterov acceleration and the GPBoost leaf
steps (the Newton leaf re-solve and the step-length line search) of the port
against the JAX package's host loop (CPU, float64; n = 150 / 300, 4 / 15
leaves, at most 8 rounds; GOSS at learning rate 0.25, so that it samples
from round 4 on).

Tolerances. Without a GP: training and prediction scores 1e-12 absolute
(the same trees from the same draws; sums in another order only in
Nesterov's momentum and the line search's gradients). With a GP (Vecchia,
exact, grouped; the default refit, gradient descent): training scores 1e-9
absolute — the ``Psi^-1`` solves and the refits' sums run in another order.
(With L-BFGS and its memory carried from refit to refit, a random forest's
refits, alternating between the constant initial score and the updated
one, move the last digits of the parameters a few 1e-5 apart within five
rounds.) ``GPModel._psi_solve`` on [n, k] columns: 1e-10 relative to the JAX
package's.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once (see tests/test_torch_boosting.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.25,
        "min_data_in_leaf": 10, "verbose": -1}
GP_BASE = dict(BASE, num_leaves=4)
VARIANTS = {
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.3},
    "dart_uniform_xgboost": {"boosting": "dart", "uniform_drop": True,
                             "xgboost_dart_mode": True, "skip_drop": 0.0,
                             "drop_seed": 7},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "rf": {"boosting": "rf", "feature_fraction": 0.8},
    "nesterov": {"use_nesterov_acc": True},
    "nesterov_constant": {"use_nesterov_acc": True, "nesterov_acc_rate": 0.3,
                          "momentum_schedule_version": 0,
                          "momentum_offset": 2},
    "line_search": {"line_search_step_length": True},
}
GP_VARIANTS = ("dart", "goss", "rf", "nesterov", "newton", "line_search")


def _regression(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 5))
    y = (2 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
         + 0.3 * rng.standard_normal(n))
    return X, y, rng.uniform(size=(50, 5))


@pytest.fixture(scope="module")
def reg():
    return _regression(300)


@pytest.fixture(scope="module")
def gp_data():
    rng = np.random.default_rng(3)
    n = 150
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    grp = rng.integers(0, 12, size=n)
    y = (2 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.5 * rng.standard_normal(12)[grp] + 0.3 * rng.standard_normal(n))
    return dict(X=X, y=y, coords=coords, grp=grp)


def _gp_models(d, kind, likelihood="gaussian"):
    if kind == "vecchia":
        kw = dict(gp_coords=d["coords"], cov_function="exponential",
                  gp_approx="vecchia", num_neighbors=8)
    elif kind == "exact":
        kw = dict(gp_coords=d["coords"], cov_function="exponential")
    else:
        kw = dict(group_data=d["grp"])
    jm = gpb.GPModel(likelihood=likelihood, **kw)
    tm = gpt.GPModel(likelihood=likelihood, device="cpu", **kw)
    if kind == "vecchia":
        # identical conditioning sets whatever the top-k tie-breaking
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
    return jm, tm


def _train_both(params, X, y, rounds, jm=None, tm=None):
    jb = gpb.train(dict(params), gpb.Dataset(X, label=y), gp_model=jm,
                   num_boost_round=rounds)
    tb = gpt.train(dict(params), gpt.Dataset(X, label=y, device="cpu"),
                   gp_model=tm, num_boost_round=rounds)
    return jb, tb


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variants_without_gp(reg, name):
    X, y, Xp = reg
    jb, tb = _train_both(dict(BASE, **VARIANTS[name]), X, y, 8)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tb.predict(Xp), jb.predict(Xp), rtol=0,
                               atol=1e-12)
    shrink = [t.shrinkage for t in tb.trees]
    np.testing.assert_allclose(shrink, [t.shrinkage for t in jb.trees],
                               rtol=1e-12)
    if name.startswith("dart"):
        # DART renormalised some trees (test_boosting_variants.py::test_dart)
        assert len({round(s, 6) for s in shrink}) > 1
    if name == "goss":
        # the rounds from 1 / learning_rate on grew on a sample
        assert tb.current_iteration() > int(1 / BASE["learning_rate"])
    if name == "rf":
        # the average of unshrunk trees, bagged (rf.hpp)
        assert all(s == 1.0 for s in shrink) and tb.bagging_freq == 1
        assert abs(np.mean(tb.predict(X)) - np.mean(y)) < 0.2


@pytest.mark.parametrize("kind", ["vecchia", "exact", "grouped"])
@pytest.mark.parametrize("name", GP_VARIANTS)
def test_variants_with_gp(gp_data, kind, name):
    extra = ({"leaves_newton_update": True} if name == "newton"
             else VARIANTS[name])
    jm, tm = _gp_models(gp_data, kind)
    jb, tb = _train_both(dict(GP_BASE, **extra), gp_data["X"], gp_data["y"],
                         5, jm, tm)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-9)
    assert len(tb.trees) == len(jb.trees) == 5


def test_line_search_with_a_non_gaussian_gp(gp_data):
    """The golden-section search on the Laplace NLL (a grouped
    ``bernoulli_logit`` model): the same step lengths (1e-9) and scores."""
    yb = (gp_data["y"] > np.median(gp_data["y"])).astype(float)
    jm, tm = _gp_models(gp_data, "grouped", likelihood="bernoulli_logit")
    params = dict(GP_BASE, objective="binary", line_search_step_length=True)
    jb, tb = _train_both(params, gp_data["X"], yb, 2, jm, tm)
    np.testing.assert_allclose([t.shrinkage for t in tb.trees],
                               [t.shrinkage for t in jb.trees], rtol=1e-9)
    assert len({round(t.shrinkage, 6) for t in tb.trees}) > 1
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("kind", ["vecchia", "exact", "grouped"])
def test_psi_solve_takes_columns(gp_data, kind):
    """``_psi_solve`` of H [n, k] (the Newton leaf re-solve's one-hot leaf
    columns) is the JAX package's Psi^-1 H: the Vecchia model raveled H into
    one vector of n k entries before this was fixed."""
    jm, tm = _gp_models(gp_data, kind)
    n = len(gp_data["y"])
    cov_pars = (np.array([0.3, 1.0, 0.2]) if kind != "grouped"
                else np.array([0.3, 0.5]))
    leaf = np.random.default_rng(1).integers(0, 6, size=n)
    H = (leaf[:, None] == np.arange(6)[None, :]).astype(np.float64)
    want = np.asarray(jm._psi_solve(cov_pars, H))
    got = tm._psi_solve(cov_pars, H)
    assert tuple(got.shape) == (n, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    # a device tensor in, the same columns out
    np.testing.assert_array_equal(
        tm._psi_solve(cov_pars, torch.as_tensor(H)).numpy(), got.numpy())
    # and each column alone
    np.testing.assert_allclose(tm._psi_solve(cov_pars, H[:, 2]).numpy(),
                               got[:, 2].numpy(), rtol=1e-12, atol=1e-14)
