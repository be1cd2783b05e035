"""Categorical features of the port vs the JAX package's host grower (CPU,
float64; inputs from a numpy seed handed to both sides).

Tolerances: the binned matrices and the category bins of prediction data
are EQUAL; trained trees have the same split features, bins, categorical
left sets and leaf flags, leaf values and predictions within 1e-10. The
behaviour the JAX package's own tests check (``test_boosting_variants.py::
test_categorical_splits``, ``test_boosting_config_tail.py::
test_max_cat_to_onehot_*``, ``::test_min_data_per_group_*``,
``::test_cat_smooth_*``) is asserted on the port's trees too. The JAX
package's categorical scan runs eagerly (seconds a tree), so the trainings
here are a tree or two.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.boosting import tree as jt
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


def _same_trees(tb, jb, X):
    assert len(tb.trees) == len(jb.trees)
    for t, j in zip(tb.trees, jb.trees):
        for name in ("split_feature", "threshold_bin", "left", "right",
                     "is_leaf", "is_categorical", "cat_mask",
                     "default_left"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                          err_msg=name)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=TOL)


def _train_both(params, X, y, rounds=1, **dkw):
    jb = gpb.train(dict(params), gpb.Dataset(X, label=y, params=params,
                                             **dkw), num_boost_round=rounds)
    tb = gpt.train(dict(params), gpt.Dataset(X, label=y, params=params,
                                             device="cpu", **dkw),
                   num_boost_round=rounds)
    return tb, jb


def test_categorical_splits():
    rng = np.random.default_rng(3)
    n = 3000
    cat = rng.integers(0, 12, size=n).astype(float)
    cat_effect = np.array([2.0, -1.5, 0.5, 3.0, -2.0, 0.0, 1.0, -0.5, 2.5,
                           -3.0, 0.7, -1.0])
    y = cat_effect[cat.astype(int)] + 0.05 * rng.standard_normal(n)
    X = cat[:, None]
    params = {"objective": "regression", "num_leaves": 4,
              "min_data_in_leaf": 5, "learning_rate": 1.0, "verbose": -1}
    plain = gpt.train(params, gpt.Dataset(X, label=y, device="cpu"),
                      num_boost_round=1)
    mse_plain = np.mean((plain.predict(X) - y) ** 2)
    tb, jb = _train_both(params, X, y, categorical_feature=[0])
    _same_trees(tb, jb, X)
    # subset splits beat contiguous thresholds
    assert np.mean((tb.predict(X) - y) ** 2) < 0.5 * mse_plain
    assert any(t.has_categorical() for t in tb.trees)
    # save / load round trip with categorical splits, and the JAX model
    back = gpt.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_array_equal(back.predict(X), tb.predict(X))
    jmodel = gpt.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(jmodel.predict(X), jb.predict(X), rtol=0,
                               atol=TOL)


def test_max_cat_to_onehot_gives_single_category_splits():
    rng = np.random.default_rng(4)
    n = 600
    cat = rng.integers(0, 3, size=n).astype(np.float64)  # 3 categories
    X = np.column_stack([cat, rng.uniform(size=n)])
    y = np.where(cat == 1, 2.0, 0.0) + 0.1 * rng.standard_normal(n)
    params = dict(BASE, max_cat_to_onehot=4, min_data_per_group=1,
                  cat_smooth=1, num_leaves=4)
    tb, jb = _train_both(params, X, y, categorical_feature=[0])
    _same_trees(tb, jb, X)
    t = tb.trees[0]
    cat_nodes = [nd for nd in t.internal_nodes() if t.is_categorical[nd]]
    assert cat_nodes
    # one-hot: the left set of the first categorical split is ONE category
    assert int(np.sum(t.cat_mask[cat_nodes[0]])) == 1


def test_min_data_per_group_blocks_small_category_splits():
    rng = np.random.default_rng(5)
    n = 400
    cat = rng.integers(0, 8, size=n).astype(np.float64)
    X = np.column_stack([cat, rng.uniform(size=n)])
    y = np.where(cat == 2, 1.5, 0.0) + 0.1 * rng.standard_normal(n)
    loose = dict(BASE, min_data_per_group=1, cat_smooth=1,
                 max_cat_to_onehot=1, num_leaves=4)
    tight = dict(loose, min_data_per_group=399)
    reads = tt.grow_tree.host_reads
    bl, jl = _train_both(loose, X, y, categorical_feature=[0])
    # a read a leaf scanned: the group scan reads nothing (its kernel on
    # the card, its plain version here)
    leaves = bl.trees[0].num_leaves
    assert tt.grow_tree.host_reads - reads == 2 * leaves - 1
    bt, jt_ = _train_both(tight, X, y, categorical_feature=[0])
    _same_trees(bl, jl, X)
    _same_trees(bt, jt_, X)

    def ncat(b):
        return sum(bool(b.trees[0].is_categorical[nd])
                   for nd in b.trees[0].internal_nodes())

    assert ncat(bl) > 0
    assert ncat(bt) == 0  # no group can reach 399 of 400 on both sides


def test_cat_smooth_excludes_sparse_categories():
    rng = np.random.default_rng(6)
    n = 300
    cat = np.concatenate([np.zeros(140), np.ones(140),
                          np.full(20, 2.0)])  # category 2 has 20 rows
    rng.shuffle(cat)
    X = np.column_stack([cat, rng.uniform(size=n)])
    y = np.where(cat == 0, 1.0, -1.0) + 0.1 * rng.standard_normal(n)
    params = dict(BASE, cat_smooth=50, min_data_per_group=1,
                  max_cat_to_onehot=1, num_leaves=4)
    tb, jb = _train_both(params, X, y, categorical_feature=[0])
    _same_trees(tb, jb, X)
    t = tb.trees[0]
    for nd in t.internal_nodes():
        if t.is_categorical[nd]:
            # category 2 (count 20 < cat_smooth 50) is ineligible for the
            # left set: it always falls right
            assert not t.cat_mask[nd][2]


@pytest.mark.parametrize("case", [
    dict(), dict(penalty=True), dict(min_data_per_group=30.0),
    dict(max_cat_to_onehot=16), dict(lambda_l1=0.5, cat_l2=2.0,
                                     max_cat_threshold=3)],
    ids=["default", "cegb_penalty", "group_scan", "onehot", "l1_threshold"])
def test_find_best_split_categorical_matches_jax(case):
    rng = np.random.default_rng(7)
    F, B = 4, 16
    hc = rng.integers(0, 60, size=(F, B)).astype(float)
    hg = rng.standard_normal((F, B)) * hc
    hh = hc * rng.uniform(0.5, 1.5, size=(F, B))
    nb = np.array([16, 12, 9, 14])
    mask = np.array([True, False, True, True])
    pen = rng.uniform(0, 5, size=F) if case.get("penalty") else None
    kw = dict(penalty=pen, cat_l2=case.get("cat_l2", 10.0), cat_smooth=10.0,
              min_data_per_group=case.get("min_data_per_group", 0.0),
              max_cat_to_onehot=case.get("max_cat_to_onehot", 4))
    args = (case.get("lambda_l1", 0.0), 1.0, 5.0, 1e-3, 0.0,
            case.get("max_cat_threshold", 32))
    f, k, gain, ok, left, gl, hl, cl = tt.find_best_split_categorical(
        *(torch.as_tensor(a) for a in (hg, hh, hc, nb)), mask, *args,
        **dict(kw, penalty=None if pen is None else torch.as_tensor(pen)))
    want = jt.find_best_split_categorical(
        *(jnp.asarray(a) for a in (hg, hh, hc, nb)), jnp.asarray(mask),
        *args, **dict(kw, penalty=None if pen is None else jnp.asarray(pen)))
    assert (f, k, ok) == (int(want[0]), int(want[1]), bool(want[3]))
    assert ok
    np.testing.assert_array_equal(left, np.asarray(want[4])[f, :k + 1])
    for a, w in ((gain, want[2]), (gl, want[5]), (hl, want[6]),
                 (cl, want[7])):
        assert abs(a - float(w)) < TOL * max(1.0, abs(float(w)))


def test_category_bins_match_jax():
    rng = np.random.default_rng(8)
    n = 3000
    small = rng.integers(0, 30, size=n).astype(float)
    # 400 levels: ids past max_bin - 1 share the last bin
    big = rng.zipf(1.1, size=n) % 400 + 0.5
    X = np.column_stack([rng.uniform(size=n), small, big])
    X[rng.random(n) < 0.05, 1] = np.nan
    td = gpt.Dataset(X, categorical_feature=[1, 2], device="cpu")
    jd = gpb.Dataset(X, categorical_feature=[1, 2])
    np.testing.assert_array_equal(td.binned.numpy(), np.asarray(jd.binned))
    np.testing.assert_array_equal(td.num_bins, jd.num_bins)
    assert int(td.binned[:, 2].max()) <= 254 and td.num_bins[2] == 255
    assert td.cat_maps.keys() == jd.cat_maps.keys()
    # NaN (and an unseen value) go to bin 0
    assert bool((td.binned[np.isnan(X[:, 1]), 1] == 0).all())
    # prediction data: unseen levels, NaN, inf, through both mappings
    Xp = X[:200].copy()
    Xp[:20, 1] = 99.0
    Xp[20:30, 2] = np.nan
    Xp[30:35, 2] = np.inf
    bst = gpt.train(dict(BASE, num_leaves=4), gpt.Dataset(
        X, label=rng.standard_normal(n), categorical_feature=[1, 2],
        device="cpu"), num_boost_round=1)
    jbst = gpb.Booster(model_str=bst.model_to_string())
    _, bins = bst._device_inputs(Xp)
    np.testing.assert_array_equal(bins.numpy(), jbst._cat_bins_matrix(Xp))
    # the params form of categorical_feature, names too
    for p in ({"categorical_feature": "1,2"},
              {"categorical_feature": "name:a,b"}):
        tp = gpt.Dataset(X, feature_name=["x", "a", "b"], params=p,
                         device="cpu")
        assert tp.categorical_feature == [1, 2]
        np.testing.assert_array_equal(tp.binned.numpy(), td.binned.numpy())
    # set_categorical_feature bins again
    t2 = gpt.Dataset(X, device="cpu").set_categorical_feature([1, 2])
    np.testing.assert_array_equal(t2.binned.numpy(), td.binned.numpy())
