"""Exclusive Feature Bundling of the port (CPU, float64) against the JAX
package and against itself without bundling; mirrors ``tests/test_efb.py``.

Tolerances: the bundle layout (bundle matrix, bins a bundle, source maps) is
EQUAL to the JAX package's; the per-feature histograms rebuilt from the
bundle histograms equal the direct ones within 1e-10; training with and
without bundling predicts within 1e-12 and grows the JAX package's trees
(same splits, leaf values 1e-10). The binary file round trip keeps the bins
and the layout, across the two packages too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.boosting import tree as jt
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.boosting.dataset import build_efb

PARAMS = {"objective": "regression", "num_leaves": 16, "verbose": -1,
          "min_data_in_leaf": 5}


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


def _onehot_data(n=800, seed=0):
    rng = np.random.default_rng(seed)
    Xd = rng.uniform(size=(n, 3))
    lv = rng.integers(0, 12, size=n)
    Xoh = np.zeros((n, 12))
    Xoh[np.arange(n), lv] = rng.uniform(1, 2, size=n)
    X = np.hstack([Xd, Xoh])
    y = 2 * Xd[:, 0] + 0.7 * (lv % 3) + 0.1 * rng.normal(size=n)
    return X, y


def test_efb_engages_on_sparse_and_not_on_dense():
    X, y = _onehot_data()
    ds = gpt.Dataset(X, label=y, device="cpu")
    jd = gpb.Dataset(X, label=y)
    assert ds.efb is not None and ds.efb.n_multi_bundles >= 1
    assert ds.efb.binned_hist.shape[1] < X.shape[1]
    # the JAX package's layout, and the uint8 panel of the kernel
    np.testing.assert_array_equal(ds.efb.binned_hist.numpy(),
                                  np.asarray(jd.efb.binned_hist))
    np.testing.assert_array_equal(ds.efb.num_bins_hist,
                                  jd.efb.num_bins_hist)
    for name in ("src_col", "src_bin", "default_bin", "fix_mask"):
        np.testing.assert_array_equal(getattr(ds.efb, name).numpy(),
                                      np.asarray(getattr(jd.efb, name)))
    assert ds.efb.max_bins_hist <= 256
    np.testing.assert_array_equal(ds.efb.binned_hist_t.numpy().T,
                                  ds.efb.binned_hist.numpy())
    rng = np.random.default_rng(1)
    dense = gpt.Dataset(rng.uniform(size=(500, 6)),
                        label=rng.standard_normal(500), device="cpu")
    assert dense.efb is None  # dense features conflict: no saving
    off = gpt.Dataset(X, label=y, params={"enable_bundle": False},
                      device="cpu")
    assert off.efb is None


def test_histogram_reconstruction_is_exact():
    X, y = _onehot_data()
    ds = gpt.Dataset(X, label=y, device="cpu")
    jd = gpb.Dataset(X, label=y)
    efb = ds.efb
    rng = np.random.default_rng(2)
    grad = rng.standard_normal(ds.num_data)
    hess = rng.uniform(0.5, 1.5, size=ds.num_data)
    mask = rng.random(ds.num_data) < 0.7
    g, h, m = (torch.as_tensor(a) for a in (grad, hess, mask))
    ref = torch.stack(tt.build_histogram(ds.binned, g, h, m,
                                         ds.max_num_bins))
    bh = torch.stack(tt.build_histogram(efb.binned_hist, g, h, m,
                                        efb.max_bins_hist,
                                        binned_t=efb.binned_hist_t))
    got = tt.expand_bundle_hist(bh, efb.src_col, efb.src_bin,
                                efb.default_bin, efb.fix_mask)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10)
    # the JAX package's reconstruction from the same bundle histograms
    want = jt.expand_bundle_hist(*(jnp.asarray(x.numpy()) for x in bh),
                                 jd.efb.src_col, jd.efb.src_bin,
                                 jd.efb.default_bin, jd.efb.fix_mask)
    for k in range(3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-12)


def test_training_identical_with_and_without_bundling():
    X, y = _onehot_data()
    b_off = gpt.train(dict(PARAMS, enable_bundle=False),
                      gpt.Dataset(X, label=y, device="cpu",
                                  params={"enable_bundle": False}),
                      num_boost_round=10)
    reads = tt.grow_tree.host_reads
    b_on = gpt.train(PARAMS, gpt.Dataset(X, label=y, device="cpu"),
                     num_boost_round=10)
    leaves = sum(t.num_leaves for t in b_on.trees)
    # one read a leaf scanned, as without bundling
    assert tt.grow_tree.host_reads - reads == 2 * leaves - 10
    np.testing.assert_allclose(b_on.predict(X), b_off.predict(X), rtol=0,
                               atol=1e-12)
    jb = gpb.train(PARAMS, gpb.Dataset(X, label=y), num_boost_round=10)
    for t, j in zip(b_on.trees, jb.trees):
        for name in ("split_feature", "threshold_bin", "left", "right",
                     "is_leaf"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=1e-10)


def test_bundler_rejects_conflicting_features():
    # two features active on overlapping rows must not bundle
    rng = np.random.default_rng(3)
    n = 400
    a = np.zeros(n)
    b = np.zeros(n)
    idx = rng.choice(n, 100, replace=False)
    a[idx] = rng.uniform(1, 2, 100)
    b[idx[:50]] = rng.uniform(1, 2, 50)   # 50 conflicting rows
    X = np.column_stack([a, b, np.where(np.arange(n) % 7 == 0, 1.0, 0.0)])
    ds = gpt.Dataset(X, label=rng.standard_normal(n), device="cpu")
    binned = ds.binned.numpy()
    efb = build_efb(binned, ds.num_bins, [], ds.max_bin, "cpu",
                    min_saving=0.0)
    assert efb is not None
    # the conflicting pair lies in different columns
    assert int(efb.src_col[0]) != int(efb.src_col[1])
    # no row of a bundle has two members away from their default bins
    for g in range(efb.binned_hist.shape[1]):
        members = np.flatnonzero(efb.src_col.numpy() == g)
        active = binned[:, members] != efb.default_bin.numpy()[members]
        assert int(active.sum(axis=1).max()) <= 1 or len(members) == 1


def test_efb_survives_binary_roundtrip(tmp_path):
    X, y = _onehot_data()
    ds = gpt.Dataset(X, label=y, device="cpu")
    f = str(tmp_path / "ds.bin")
    ds.save_binary(f)
    ds2 = gpt.Dataset(f, device="cpu")
    assert ds2.efb is not None
    assert ds2.efb.binned_hist.shape == ds.efb.binned_hist.shape
    np.testing.assert_array_equal(ds2.binned.numpy(), ds.binned.numpy())
    np.testing.assert_array_equal(ds2.label, ds.label)
    # the JAX package's file, and the port's file in the JAX package
    jf = str(tmp_path / "jd.bin")
    gpb.Dataset(X, label=y).save_binary(jf)
    np.testing.assert_array_equal(gpt.Dataset(jf, device="cpu")
                                  .binned.numpy(), ds.binned.numpy())
    np.testing.assert_array_equal(np.asarray(gpb.Dataset(f).binned),
                                  ds.binned.numpy())
    # a text file is the native reader's (ROADMAP item 19)
    with pytest.raises(NotImplementedError, match="item 19"):
        gpt.Dataset(str(tmp_path / "data.csv"), device="cpu")
