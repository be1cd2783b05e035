"""The serial tree learner of the port vs the JAX package's host grower
(CPU, float64; inputs from a numpy seed handed to both sides).

Tolerances: ``find_best_split`` picks the same (feature, bin, default
direction) and its gain and left sums agree to 1e-10; ``grow_tree`` gives
IDENTICAL structure (split feature, threshold bin, children, leaf flags,
default directions) with leaf values, node counts and gains at 1e-10;
tree predictions 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.boosting import tree as jt
from gpboost_tpu_torch.boosting import tree as tt


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

ATOL = 1e-10


def _data(n=2500, seed=0, with_nan=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 5))
    X[:, 3] = rng.integers(0, 6, size=n)
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
         + 0.5 * (X[:, 3] > 2) + 0.3 * rng.standard_normal(n))
    if with_nan:
        miss = rng.random(n) < 0.15
        y = y + 1.5 * miss          # missingness carries signal
        X[miss, 0] = np.nan
        X[rng.random(n) < 0.05, 1] = np.nan
    grad = (y.mean() - y)
    hess = np.ones(n)
    return X, y, grad, hess


def _hists(X, grad, hess, mask, max_bin=63):
    td = gpt.Dataset(X, max_bin=max_bin, device="cpu")
    hist = tt.build_histogram(td.binned, torch.as_tensor(grad),
                              torch.as_tensor(hess), torch.as_tensor(mask),
                              td.max_num_bins)
    return td, hist


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("l1,l2,min_data,min_hess", [
    (0.0, 0.0, 20.0, 1e-3), (0.5, 1.0, 5.0, 1e-3), (0.0, 10.0, 200.0, 50.0)])
def test_find_best_split_matches_jax(with_nan, l1, l2, min_data, min_hess):
    X, _, grad, hess = _data(with_nan=with_nan)
    mask = np.random.default_rng(1).random(len(grad)) < 0.7
    td, (hg, hh, hc) = _hists(X, grad, hess, mask)
    nan_mask = td.has_nan if with_nan else None
    got = tt.find_best_split(
        hg, hh, hc, torch.as_tensor(td.num_bins), l1, l2, min_data, min_hess,
        0.0, nan_mask=None if nan_mask is None else torch.as_tensor(nan_mask))
    want = jt.find_best_split(
        jnp.asarray(hg.numpy()), jnp.asarray(hh.numpy()),
        jnp.asarray(hc.numpy()), jnp.asarray(td.num_bins), l1, l2, min_data,
        min_hess, 0.0,
        nan_mask=None if nan_mask is None else jnp.asarray(nan_mask))
    f, b, gain, ok, gl, hl, cl, dl = got
    assert (int(f), int(b), bool(ok), bool(dl)) == (
        int(want[0]), int(want[1]), bool(want[3]), bool(want[7]))
    assert bool(ok)
    for a, w in ((gain, want[2]), (gl, want[4]), (hl, want[5]),
                 (cl, want[6])):
        assert abs(float(a) - float(w)) < ATOL * max(1.0, abs(float(w)))


def test_find_best_split_without_a_valid_bin_is_not_ok():
    X, _, grad, hess = _data(300)
    td, (hg, hh, hc) = _hists(X, grad, hess, np.ones(300, bool))
    nb = torch.as_tensor(td.num_bins)
    out = tt.find_best_split(hg, hh, hc, nb, 0.0, 0.0, 200.0, 1e-3, 0.0)
    assert not bool(out[3]) and float(out[2]) == -np.inf
    # a feature with 0 bins never wins; ties go to the FIRST maximum
    hg2 = torch.stack([hg[0], hg[0], hg[0]])
    hh2 = torch.stack([hh[0], hh[0], hh[0]])
    hc2 = torch.stack([hc[0], hc[0], hc[0]])
    nb2 = torch.tensor([0, int(nb[0]), int(nb[0])])
    out = tt.find_best_split(hg2, hh2, hc2, nb2, 0.0, 0.0, 20.0, 1e-3, 0.0)
    want = jt.find_best_split(jnp.asarray(hg2.numpy()),
                              jnp.asarray(hh2.numpy()),
                              jnp.asarray(hc2.numpy()),
                              jnp.asarray(nb2.numpy()), 0.0, 0.0, 20.0, 1e-3,
                              0.0)
    assert int(out[0]) == int(want[0]) == 1 and int(out[1]) == int(want[1])


def test_partition_rows_matches_jax():
    rng = np.random.default_rng(2)
    binned = rng.integers(0, 9, size=(400, 3)).astype(np.int32)
    row_leaf = rng.integers(0, 3, size=400).astype(np.int32)
    for miss_right in (False, True):
        got = tt.partition_rows(torch.as_tensor(binned),
                                torch.as_tensor(row_leaf), 1, 2, 4, 5, 6,
                                miss_right=miss_right)
        want = jt.partition_rows(jnp.asarray(binned), jnp.asarray(row_leaf),
                                 1, 2, 4, 5, 6, miss_right=miss_right)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the transposed view of the features-major panel serves as well
    panel = torch.as_tensor(np.ascontiguousarray(binned.T.astype(np.uint8)))
    got = tt.partition_rows(panel.t(), torch.as_tensor(row_leaf), 1, 2, 4, 5,
                            6)
    want = jt.partition_rows(jnp.asarray(binned), jnp.asarray(row_leaf), 1,
                             2, 4, 5, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grow_both(X, grad, hess, params, max_bin=63, row_mask=None,
               use_panel=True):
    td = gpt.Dataset(X, max_bin=max_bin, device="cpu")
    jd = gpb.Dataset(X, max_bin=max_bin)
    nan_mask = td.has_nan if td.has_nan.any() else None
    reads = tt.grow_tree.host_reads
    t_tree, t_rows = tt.grow_tree(
        td.binned, torch.as_tensor(td.num_bins), torch.as_tensor(grad),
        torch.as_tensor(hess), td.max_num_bins, tt.GrowerParams(**params),
        row_mask=None if row_mask is None else torch.as_tensor(row_mask),
        nan_mask=nan_mask, binned_t=td.binned_t if use_panel else None)
    reads = tt.grow_tree.host_reads - reads
    j_tree, j_rows = jt.grow_tree(
        jd.binned, jnp.asarray(jd.num_bins), jnp.asarray(grad),
        jnp.asarray(hess), jd.max_num_bins, jt.GrowerParams(**params),
        row_mask=None if row_mask is None else jnp.asarray(row_mask),
        nan_mask=nan_mask)
    return td, t_tree, t_rows, j_tree, j_rows, reads


def _same_tree(t_tree, j_tree):
    for name in ("split_feature", "threshold_bin", "left", "right",
                 "is_leaf", "default_left", "is_categorical"):
        np.testing.assert_array_equal(getattr(t_tree, name),
                                      getattr(j_tree, name), err_msg=name)
    for name in ("leaf_value", "node_count", "split_gain"):
        np.testing.assert_allclose(getattr(t_tree, name),
                                   getattr(j_tree, name), rtol=0, atol=ATOL,
                                   err_msg=name)
    assert t_tree.num_leaves == j_tree.num_leaves
    assert t_tree.max_depth_used == j_tree.max_depth_used


@pytest.mark.parametrize("case", [
    dict(params=dict(num_leaves=31, min_data_in_leaf=20)),
    dict(params=dict(num_leaves=15, min_data_in_leaf=5, lambda_l1=0.3,
                     lambda_l2=2.0, min_gain_to_split=0.5)),
    dict(params=dict(num_leaves=31, max_depth=3)),
    dict(params=dict(num_leaves=31, min_data_in_leaf=20), with_nan=True),
    dict(params=dict(num_leaves=8, min_data_in_leaf=10), with_nan=True,
         bagged=True, use_panel=False),
    dict(params=dict(num_leaves=31, min_data_in_leaf=600)),   # stops early
], ids=["default", "regularised", "max_depth", "nan", "nan_bagged_no_panel",
        "stops_early"])
def test_grow_tree_matches_jax(case):
    X, _, grad, hess = _data(with_nan=case.get("with_nan", False))
    row_mask = (np.random.default_rng(3).random(len(grad)) < 0.8
                if case.get("bagged") else None)
    td, t_tree, t_rows, j_tree, j_rows, reads = _grow_both(
        X, grad, hess, case["params"], row_mask=row_mask,
        use_panel=case.get("use_panel", True))
    _same_tree(t_tree, j_tree)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    # one host read per leaf that was scored: the root and two per split
    assert reads == 2 * t_tree.num_leaves - 1
    if case.get("with_nan"):
        assert not t_tree.default_left[t_tree.internal_nodes()].all()
    # the dict of either package's tree loads into the other's Tree
    back = tt.Tree.from_dict(j_tree.to_dict())
    _same_tree(back, j_tree)
    assert t_tree.to_dict().keys() == j_tree.to_dict().keys()
    _same_tree(jt.Tree.from_dict(t_tree.to_dict()), t_tree)


@pytest.mark.parametrize("with_nan", [False, True])
def test_predict_tree_binned_and_raw_match_jax(with_nan):
    X, _, grad, hess = _data(with_nan=with_nan)
    td, t_tree, t_rows, j_tree, _, _ = _grow_both(
        X, grad, hess, dict(num_leaves=31, min_data_in_leaf=20))
    for node in t_tree.internal_nodes():
        t_tree.threshold[node] = td.threshold_value(
            int(t_tree.split_feature[node]), int(t_tree.threshold_bin[node]))

    def T(a):
        return torch.as_tensor(a)

    depth = int(t_tree.max_depth_used)
    vals, nodes = tt.predict_tree_binned(
        td.binned, T(t_tree.split_feature), T(t_tree.threshold_bin),
        T(t_tree.left), T(t_tree.right), depth, T(t_tree.leaf_value),
        default_left=T(t_tree.default_left))
    # on the training data the traversal ends where the grower put the rows
    np.testing.assert_array_equal(nodes.numpy(), t_rows.numpy())
    jv, jn = jt.predict_tree_binned(
        jnp.asarray(td.binned.numpy()), jnp.asarray(t_tree.split_feature),
        jnp.asarray(t_tree.threshold_bin), jnp.asarray(t_tree.left),
        jnp.asarray(t_tree.right), 32, jnp.asarray(t_tree.leaf_value),
        default_left=jnp.asarray(t_tree.default_left))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(jn))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-12)

    X2, _, _, _ = _data(700, seed=9, with_nan=True)   # NaN also if unseen
    rv, rn = tt.predict_tree_raw(
        T(X2), T(t_tree.split_feature), T(t_tree.threshold), T(t_tree.left),
        T(t_tree.right), T(t_tree.leaf_value), depth,
        default_left=T(t_tree.default_left))
    jrv, jrn = jt.predict_tree_raw(
        jnp.asarray(X2), jnp.asarray(t_tree.split_feature),
        jnp.asarray(t_tree.threshold), jnp.asarray(t_tree.left),
        jnp.asarray(t_tree.right), jnp.asarray(t_tree.leaf_value), 32,
        default_left=jnp.asarray(t_tree.default_left))
    np.testing.assert_array_equal(rn.numpy(), np.asarray(jrn))
    np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), atol=1e-12)
    # raw values of the training data land in the leaves of their bins
    _, rn_train = tt.predict_tree_raw(
        T(X), T(t_tree.split_feature), T(t_tree.threshold), T(t_tree.left),
        T(t_tree.right), T(t_tree.leaf_value), depth,
        default_left=T(t_tree.default_left))
    np.testing.assert_array_equal(rn_train.numpy(), t_rows.numpy())


def test_float32_histograms_grow_the_float64_root_split():
    # the GPU path works on float32 gradients: same first split on
    # well-separated data, leaf values close
    X, _, grad, hess = _data()
    td = gpt.Dataset(X, max_bin=63, device="cpu")
    trees = []
    for dt in (torch.float64, torch.float32):
        tree, _ = tt.grow_tree(
            td.binned, torch.as_tensor(td.num_bins),
            torch.as_tensor(grad, dtype=dt), torch.as_tensor(hess, dtype=dt),
            td.max_num_bins, tt.GrowerParams(num_leaves=4),
            binned_t=td.binned_t)
        trees.append(tree)
    assert trees[0].split_feature[0] == trees[1].split_feature[0]
    assert trees[0].threshold_bin[0] == trees[1].threshold_bin[0]
    np.testing.assert_allclose(trees[1].leaf_value, trees[0].leaf_value,
                               atol=1e-4)
