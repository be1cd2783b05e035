"""The grower's options of the port vs the JAX package's host grower (CPU,
float64; inputs from a numpy seed handed to both sides): monotone
constraints (basic, intermediate, advanced, the monotone penalty),
interaction constraints, extra trees, path smoothing,
``feature_fraction_bynode``, ``max_delta_step``, ``feature_contri``, forced
splits and forced bins, ``max_bin_by_feature``, the missing-value switches
and CEGB. Mirrors ``tests/test_boosting_config_tail.py``'s tests of these,
``tests/test_boosting_variants.py::test_monotone_constraints``,
``tests/test_config_tail_r4.py``'s ``max_delta_step``, ``feature_contri``,
``max_bin_by_feature``, missing-value and forced-bins tests,
``tests/test_boosting_basic.py::TestForcedSplitsAndOVA::test_forced_splits``
and ``tests/test_cegb.py`` whole: each behaviour is asserted on the port,
and each training grows the JAX package's trees (the same split features,
bins and leaf flags; leaf values and predictions within 1e-10).

Two splits whose gains tie exactly (two cut points with no training row
between them; gains that are 0 in exact arithmetic, as when
``max_delta_step`` caps both children) are broken by rounding, which the
two packages do in other orders (the leaf totals, ~1e-17): the trees are
held up to the first such tie, checked to be one, and the predictions of
the iterations before it (``_same_trees``). Where every output is capped
only the cap is asserted.
"""
import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import tree as tt

TOL = 1e-10
BASE = {"objective": "regression", "num_leaves": 8, "verbose": -1,
        "min_data_in_leaf": 5, "learning_rate": 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other (a GD fit here took
    ~580 s with six processes at once, 4.5 s with one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(params, X, y, rounds, dparams=None):
    """The same training in both packages: (port booster, JAX booster),
    their trees compared by :func:`_same_trees`."""
    jb = gpb.train(dict(params), gpb.Dataset(X, label=y, params=dparams),
                   num_boost_round=rounds)
    tb = gpt.train(dict(params), gpt.Dataset(X, label=y, params=dparams,
                                             device="cpu"),
                   num_boost_round=rounds)
    _same_trees(tb, jb, X)
    return tb, jb


def _same_trees(tb, jb, X):
    """The same split features, bins and leaf flags, leaf values within
    TOL, predictions within TOL; up to the first split where the two
    differ, which must be an exact tie of two gains (within 1e-12 of the
    tree's root gain): two cut points with no training row between them,
    broken by the ~1e-17 the leaf totals differ by (they sum ``[F, B]`` in
    another order than XLA's). From there the trainings are two valid runs;
    the predictions of the iterations before the tie are held."""
    assert len(tb.trees) == len(jb.trees)
    for k, (t, j) in enumerate(zip(tb.trees, jb.trees)):
        same = all(np.array_equal(getattr(t, name), getattr(j, name))
                   for name in ("split_feature", "threshold_bin", "left",
                                "right", "is_leaf", "default_left"))
        if not same:
            node = np.flatnonzero(
                (t.split_feature != j.split_feature)
                | (t.threshold_bin != j.threshold_bin)
                | (t.is_leaf != j.is_leaf))[0]
            gt, gj = float(t.split_gain[node]), float(j.split_gain[node])
            assert abs(gt - gj) <= 1e-12 * abs(float(j.split_gain[0])), (
                k, node, gt, gj)
            np.testing.assert_allclose(
                tb.predict(X, num_iteration=k, raw_score=True) if k else
                tb.init_score, jb.predict(X, num_iteration=k, raw_score=True)
                if k else jb.init_score, rtol=0, atol=TOL)
            return k
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=TOL)
    return None


def simdata(n=500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, F))
    y = 2 * X[:, 0] - X[:, 1] + 0.5 * np.sin(6 * X[:, 2]) \
        + 0.2 * rng.standard_normal(n)
    return X, y


def leaf_paths(tree):
    """(leaf_id, set of split features on the path) pairs."""
    out = []

    def walk(node, feats):
        if tree.is_leaf[node]:
            out.append((node, feats))
            return
        f = int(tree.split_feature[node])
        walk(int(tree.left[node]), feats | {f})
        walk(int(tree.right[node]), feats | {f})

    walk(0, frozenset())
    return out


def test_extra_trees_randomizes_thresholds():
    X, y = simdata()
    b0, _ = _both(BASE, X, y, 3)
    be, _ = _both(dict(BASE, extra_trees=True), X, y, 3)
    _both(dict(BASE, extra_trees=True, extra_seed=11,
               feature_fraction_bynode=0.5), X, y, 3)
    t0 = [int(t.threshold_bin[n]) for t in b0.trees
          for n in t.internal_nodes()]
    te = [int(t.threshold_bin[n]) for t in be.trees
          for n in t.internal_nodes()]
    assert t0 != te  # random single-candidate bins change the thresholds
    assert float(np.mean((y - be.predict(X)) ** 2)) < float(np.var(y))


def test_feature_fraction_bynode_varies_candidates_within_tree():
    X, y = simdata()
    b, _ = _both(dict(BASE, feature_fraction_bynode=0.34, num_leaves=16), X,
                 y, 4)
    # per-NODE sampling: a single tree still reaches several features
    feats_per_tree = [len({int(t.split_feature[n])
                           for n in t.internal_nodes()}) for t in b.trees]
    assert max(feats_per_tree) > 2


def test_path_smooth_shrinks_leaves_toward_parent():
    X, y = simdata()
    b0, _ = _both(BASE, X, y, 1)
    bs, _ = _both(dict(BASE, path_smooth=100.0), X, y, 1)
    v0 = np.abs(b0.trees[0].leaf_value[b0.trees[0].is_leaf])
    vs = np.abs(bs.trees[0].leaf_value[bs.trees[0].is_leaf])
    assert np.mean(vs[vs > 0]) < np.mean(v0[v0 > 0])


def test_interaction_constraints_respected_on_every_path():
    X, y = simdata(n=800)
    groups = [[0, 1], [2, 3, 4, 5]]
    b, _ = _both(dict(BASE, interaction_constraints=groups, num_leaves=16),
                 X, y, 5)
    # the reference's string form reads the same
    _both(dict(BASE, interaction_constraints=str(groups), num_leaves=16), X,
          y, 2)
    gsets = [frozenset(g) for g in groups]
    for t in b.trees:
        for _, feats in leaf_paths(t):
            assert any(feats <= g for g in gsets), feats


def _monotone_check(params, sign):
    rng = np.random.default_rng(9)
    n = 800
    X = rng.uniform(size=(n, 3))
    y = 1.5 * X[:, 0] ** 2 - X[:, 1] + 0.1 * rng.standard_normal(n)
    p = dict(BASE, monotone_constraints=[sign, 0, 0], num_leaves=16, **params)
    b, _ = _both(p, X, y, 10, dparams=p)
    grid = np.linspace(0.01, 0.99, 40)
    probe = np.column_stack([grid, np.full(40, 0.5), np.full(40, 0.5)])
    d = np.diff(b.predict(probe)) * sign
    assert np.all(d >= -1e-10)


def test_monotone_intermediate_enforces_monotonicity():
    _monotone_check({"monotone_constraints_method": "intermediate"}, 1)
    _monotone_check({"monotone_constraints_method": "intermediate"}, -1)


def test_monotone_advanced_accepted_and_monotone():
    _monotone_check({"monotone_constraints_method": "advanced"}, 1)


def test_monotone_penalty_discourages_root_monotone_split():
    rng = np.random.default_rng(10)
    n = 800
    X = rng.uniform(size=(n, 2))
    # feature 0 slightly stronger: without penalty it wins the root split
    y = 1.2 * X[:, 0] + X[:, 1] + 0.05 * rng.standard_normal(n)
    p0 = dict(BASE, monotone_constraints=[1, 0], num_leaves=4)
    b0, _ = _both(p0, X, y, 1, dparams=p0)
    assert int(b0.trees[0].split_feature[0]) == 0
    p1 = dict(p0, monotone_penalty=1.0)
    b1, _ = _both(p1, X, y, 1, dparams=p1)
    assert int(b1.trees[0].split_feature[0]) == 1


def test_monotone_constraints():
    rng = np.random.default_rng(11)
    n = 3000
    x = rng.uniform(size=(n, 2))
    y = 2 * x[:, 0] + 0.3 * np.sin(8 * x[:, 0]) + x[:, 1] \
        + 0.05 * rng.standard_normal(n)
    bst, _ = _both({"objective": "regression", "verbose": -1,
                    "monotone_constraints": "(1, 0)", "num_leaves": 31}, x,
                   y, 20)
    grid = np.linspace(0.01, 0.99, 60)
    for x1 in (0.2, 0.8):
        pred = bst.predict(np.column_stack([grid, np.full_like(grid, x1)]))
        assert np.all(np.diff(pred) >= -1e-10), "monotonicity violated"
    assert np.mean((bst.predict(x) - y) ** 2) < 0.15 * np.var(y)


def _r4_data(n=500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    return X, y


def test_max_delta_step_caps_leaves():
    X, y = _r4_data()
    mds = 0.05
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "max_delta_step": mds, "boost_from_average": False}
    # every output capped (labels x 100): the gains are 0 in exact
    # arithmetic, so only the cap is asserted
    bst = gpt.train(params, gpt.Dataset(X, label=100.0 * y, device="cpu"),
                    num_boost_round=3)
    for t in bst.trees:
        lv = t.leaf_value[np.asarray(t.is_leaf)]
        # leaf values are shrunk by the learning rate after capping
        assert np.max(np.abs(lv)) <= mds * 0.1 + 1e-12
    tb, _ = _both(dict(params, max_delta_step=0.3), X, y, 3)   # some capped
    assert np.max(np.abs(np.concatenate(
        [t.leaf_value for t in tb.trees]))) <= 0.03 + 1e-12


def test_feature_contri_steers_splits():
    rng = np.random.default_rng(0)
    n = 600
    X = rng.normal(size=(n, 2))
    y = X[:, 0] + X[:, 1] + 0.01 * rng.normal(size=n)
    bst, _ = _both({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, "feature_contri": [1e-8, 1.0]}, X, y, 3)
    imp = bst.feature_importance(importance_type="split")
    assert imp[1] > 0 and imp[0] == 0


def test_max_bin_by_feature():
    X, y = _r4_data()
    p = {"max_bin_by_feature": [5, 0, 9, 0]}
    ds = gpt.Dataset(X, label=y, params=p, device="cpu")
    np.testing.assert_array_equal(ds.num_bins,
                                  gpb.Dataset(X, label=y, params=p).num_bins)
    assert ds.num_bins[0] <= 5 and ds.num_bins[2] <= 9
    assert ds.num_bins[1] > 9 and ds.num_bins[3] > 9
    _both({"objective": "regression", "num_leaves": 7, "verbose": -1,
           **p}, X, y, 3, dparams=p)


def test_zero_as_missing_and_use_missing():
    rng = np.random.default_rng(3)
    n = 300
    X = rng.normal(size=(n, 2))
    X[:150, 0] = 0.0
    y = np.where(X[:, 0] == 0.0, 5.0, 0.0) + 0.01 * rng.normal(size=n)
    p = {"zero_as_missing": True}
    ds = gpt.Dataset(X, label=y, params=p, device="cpu")
    assert ds.has_nan[0]
    bst, _ = _both({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, "learning_rate": 0.5, **p}, X, y, 30,
                   dparams=p)
    pred = bst.predict(X)
    assert float(np.mean((pred - y) ** 2)) < 0.05 * float(np.var(y))
    # use_missing=False: NaN behaves like 0.0, in training and prediction
    Xn = X.copy()
    Xn[:150, 0] = np.nan
    p2 = {"use_missing": False}
    assert not gpt.Dataset(Xn, label=y, params=p2, device="cpu").has_nan[0]
    b2, j2 = _both({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, **p2}, Xn, y, 3, dparams=p2)
    np.testing.assert_allclose(b2.predict(Xn), j2.predict(Xn), rtol=0,
                               atol=TOL)


def test_forcedbins_filename(tmp_path):
    X, y = _r4_data()
    fb = tmp_path / "forced.json"
    fb.write_text(json.dumps(
        [{"feature": 0, "bin_upper_bound": [-0.5, 0.0, 0.5]}]))
    p = {"forcedbins_filename": str(fb)}
    ds = gpt.Dataset(X, label=y, max_bin=8, params=p, device="cpu")
    for edge in (-0.5, 0.0, 0.5):
        assert edge in ds.bin_upper_bounds[0]
    assert len(ds.bin_upper_bounds[0]) <= 8
    jd = gpb.Dataset(X, label=y, max_bin=8, params=p)
    np.testing.assert_array_equal(ds.bin_upper_bounds[0],
                                  jd.bin_upper_bounds[0])
    np.testing.assert_array_equal(ds.binned.numpy(), np.asarray(jd.binned))


def test_forced_splits(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 2] > 0.3) * 2.0 + 0.1 * rng.normal(size=500)
    fs = {"feature": 1, "threshold": 0.0,
          "left": {"feature": 0, "threshold": 0.5}}
    fpath = tmp_path / "forced.json"
    fpath.write_text(json.dumps(fs))
    params = {"objective": "regression", "verbose": -1,
              "min_data_in_leaf": 5}
    bst, _ = _both(dict(params, forcedsplits_filename=str(fpath)), X, y, 30)
    bd, _ = _both(dict(params, forced_splits=fs), X, y, 3)
    # every tree's root splits on feature 1, its left child on feature 0
    for b in (bst, bd):
        for k in range(3):
            t = b.trees[k]
            assert t.split_feature[0] == 1 and not t.is_leaf[0]
            lid = t.left[0]
            assert t.split_feature[lid] == 0 and not t.is_leaf[lid]
    assert np.sqrt(np.mean((bst.predict(X) - y) ** 2)) < 0.5


def _cegb_train(X, y, extra, rounds=10):
    params = {"objective": "regression", "verbose": -1, "learning_rate": 0.1,
              "min_data_in_leaf": 5, **extra}
    return _both(params, X, y, rounds)[0]


def _used_features(bst):
    return {int(t.split_feature[n]) for t in bst.trees
            for n in t.internal_nodes()}


def _model_string(bst):
    d = json.loads(bst.model_to_string())
    d.pop("params", None)  # penalties live in params; compare structure only
    return json.dumps(d, sort_keys=True)


@pytest.fixture(scope="module")
def cegb_data():
    rng = np.random.default_rng(42)
    X = rng.random((100, 5))
    X[:, [1, 3]] = 0
    y = rng.random(100)
    return X, y


def test_cegb_affects_behavior(cegb_data):
    X, y = cegb_data
    base_txt = _model_string(_cegb_train(X, y, {}))
    for case in ({"cegb_penalty_feature_coupled": [50, 100, 10, 25, 30]},
                 {"cegb_penalty_feature_lazy": [1, 2, 3, 4, 5]},
                 {"cegb_penalty_split": 1}):
        assert _model_string(_cegb_train(X, y, case)) != base_txt, case


def test_cegb_scaling_equalities(cegb_data):
    X, y = cegb_data
    pairs = [({"cegb_penalty_feature_coupled": [1, 2, 1, 2, 1]},
              {"cegb_penalty_feature_coupled": [0.5, 1, 0.5, 1, 0.5],
               "cegb_tradeoff": 2}),
             ({"cegb_penalty_feature_lazy": [0.01, 0.02, 0.03, 0.04, 0.05]},
              {"cegb_penalty_feature_lazy": [0.005, 0.01, 0.015, 0.02,
                                             0.025], "cegb_tradeoff": 2}),
             ({"cegb_penalty_split": 1},
              {"cegb_penalty_split": 2, "cegb_tradeoff": 0.5})]
    for p1, p2 in pairs:
        assert (_model_string(_cegb_train(X, y, p1))
                == _model_string(_cegb_train(X, y, p2))), (p1, p2)


def test_cegb_coupled_penalty_prefers_reused_feature():
    """With a huge coupled penalty on feature 1 the model sticks to feature
    0, though feature 1 is the (slightly) better raw split; the re-scoring
    of the cached leaves reads the host once a leaf it scans again."""
    rng = np.random.default_rng(0)
    n = 400
    x0 = rng.random(n)
    x1 = x0 + 0.01 * rng.standard_normal(n)
    X = np.column_stack([x0, x1])
    y = (x1 > 0.5).astype(float) + 0.05 * rng.standard_normal(n)
    bst = _cegb_train(X, y, {"cegb_penalty_feature_coupled": [0.0, 1e6]},
                      rounds=5)
    assert 1 not in _used_features(bst)
    assert 1 in _used_features(_cegb_train(X, y, {}, rounds=5))
    # re-scoring: a coupled feature's first use scans the other leaves again
    X2 = rng.random((n, 2))
    y2 = X2[:, 0] + 2 * X2[:, 1] + 0.05 * rng.standard_normal(n)
    reads = tt.grow_tree.host_reads
    b2 = _cegb_train(X2, y2, {"cegb_penalty_feature_coupled": [0.5, 0.5]},
                     rounds=1)
    assert _used_features(b2) == {0, 1}
    assert tt.grow_tree.host_reads - reads > 2 * b2.trees[0].num_leaves - 1


def test_cegb_split_penalty_limits_tree_size(cegb_data):
    X, y = cegb_data
    big = _cegb_train(X, y, {"cegb_penalty_split": 10.0}, rounds=3)
    small = _cegb_train(X, y, {}, rounds=3)
    assert (sum(t.num_leaves - 1 for t in big.trees)
            < sum(t.num_leaves - 1 for t in small.trees))
