"""``Dataset`` of the port vs the JAX package (CPU): bin edges, ``num_bins``,
``has_nan`` and the binned matrix must be EQUAL, not close — binning is host
numpy copied line for line. Inputs from a numpy seed handed to both sides.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt


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


def _data(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([
        rng.uniform(size=n),                         # continuous
        rng.standard_normal(n),                      # continuous, NaNs below
        rng.integers(0, 7, size=n).astype(float),    # few distinct values
        np.round(rng.exponential(size=n), 1),        # ties, skewed
        np.where(rng.random(n) < 0.97, 0.0, rng.uniform(size=n)),  # sparse
        np.full(n, 3.5),                             # constant
    ])
    X[rng.random(n) < 0.1, 1] = np.nan
    X[rng.random(n) < 0.02, 2] = np.inf              # non-finite = missing
    y = rng.standard_normal(n)
    return X, y


def _same_bins(td, jd):
    np.testing.assert_array_equal(td.num_bins, np.asarray(jd.num_bins))
    np.testing.assert_array_equal(td.has_nan, np.asarray(jd.has_nan))
    assert len(td.bin_upper_bounds) == len(jd.bin_upper_bounds)
    for a, b in zip(td.bin_upper_bounds, jd.bin_upper_bounds):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(td.binned.numpy(), np.asarray(jd.binned))
    assert td.max_num_bins == jd.max_num_bins


@pytest.mark.parametrize("max_bin,min_data_in_bin", [(255, 3), (16, 3),
                                                     (63, 1), (255, 40)])
def test_bins_equal_the_jax_package(max_bin, min_data_in_bin):
    X, y = _data()
    params = {"min_data_in_bin": min_data_in_bin}
    td = gpt.Dataset(X, label=y, max_bin=max_bin, params=params,
                     device="cpu")
    jd = gpb.Dataset(X, label=y, max_bin=max_bin, params=params)
    _same_bins(td, jd)
    assert td.has_nan.tolist() == [False, True, True, False, False, False]
    # the features-major uint8 panel is the transposed binned matrix
    assert td.binned_t.dtype == torch.uint8 and td.binned_t.is_contiguous()
    np.testing.assert_array_equal(td.binned_t.numpy(),
                                  td.binned.numpy().T.astype(np.uint8))


def test_reference_dataset_adopts_the_bin_mapping():
    X, y = _data()
    X2, _ = _data(400, seed=1)
    X2[:5, 0] = np.nan      # NaN in a feature without a training-time NA bin
    X2[5:9, 3] = 1e9        # beyond the last training edge
    td = gpt.Dataset(X, label=y, device="cpu")
    jd = gpb.Dataset(X, label=y)
    tv = gpt.Dataset(X2, reference=td, device="cpu")
    jv = gpb.Dataset(X2, reference=jd)
    _same_bins(tv, jv)
    tv2 = td.create_valid(X2)
    np.testing.assert_array_equal(tv2.binned.numpy(), tv.binned.numpy())


def test_thresholds_and_bins_for_thresholds_equal():
    X, y = _data()
    td = gpt.Dataset(X, label=y, max_bin=32, device="cpu")
    jd = gpb.Dataset(X, label=y, max_bin=32)
    for f in range(X.shape[1]):
        for b in range(int(td.num_bins[f])):
            assert td.threshold_value(f, b) == jd.threshold_value(f, b)
        for v in (-1.0, 0.0, 0.31, 2.0, 1e9):
            assert td.bin_for_threshold(f, v) == jd.bin_for_threshold(f, v)


def test_256_bins_with_an_na_bin_fit_the_uint8_panel():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4000)
    x[:40] = np.nan
    td = gpt.Dataset(x[:, None], max_bin=256, device="cpu",
                     params={"min_data_in_bin": 1})
    jd = gpb.Dataset(x[:, None], max_bin=256, params={"min_data_in_bin": 1})
    _same_bins(td, jd)
    assert td.max_num_bins == 256 and td.binned_t is not None
    assert int(td.binned_t.max()) == 255
    wide = gpt.Dataset(x[:, None], max_bin=400, device="cpu",
                       params={"min_data_in_bin": 1})
    assert wide.max_num_bins > 256 and wide.binned_t is None


def test_fields_and_device_rule():
    X, y = _data(200)
    td = gpt.Dataset(X, label=y, weight=np.ones(200), device="cpu")
    assert td.num_data_rows() == 200 and td.num_feature() == 6
    np.testing.assert_array_equal(td.get_label(), y)
    td.set_label(2 * y).set_weight(None).set_init_score(np.zeros(200))
    np.testing.assert_array_equal(td.get_field("label"), 2 * y)
    assert td.get_weight() is None and td.get_init_score().shape == (200,)
    # group, the ranking field, is a field as in the JAX package
    jd = gpb.Dataset(X, label=y)
    for d in (td, jd):
        d.set_field("group", [120, 80])
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    with pytest.raises(ValueError, match="unknown dataset field"):
        td.set_field("query", [1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gpt.Dataset(X, label=y)          # the default device is the GPU


@pytest.mark.parametrize("kwargs", [
    dict(categorical_feature=[0]), dict(group=[100, 100]),
    dict(params={"categorical_feature": "0,1"}),
    dict(params={"max_bin_by_feature": [10] * 6}),
    dict(params={"zero_as_missing": True}),
])
def test_unported_dataset_features_raise(kwargs):
    """Every case is ported and bins as the JAX package does (categorical
    features, ranking's group, the params form, per-feature bins, zero as
    missing)."""
    X, y = _data(200)
    td = gpt.Dataset(X, label=y, device="cpu", **kwargs)
    jd = gpb.Dataset(X, label=y, **kwargs)
    np.testing.assert_array_equal(td.binned.numpy(), np.asarray(jd.binned))
    np.testing.assert_array_equal(td.num_bins, jd.num_bins)
    np.testing.assert_array_equal(td.has_nan, jd.has_nan)
    assert td.categorical_feature == list(jd.categorical_feature)
    if "group" in kwargs:
        np.testing.assert_array_equal(td.group, np.asarray(jd.group))
