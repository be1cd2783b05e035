"""The tree learner's tail on the card (ROADMAP item 18b, part 1): what the
full-size run of ``chip_smoke.py`` does not hold case by case. Needs an
NVIDIA GPU; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_tree_tail.py --noconftest -q

- the histogram kernel against its float64 plain version on an EFB bundle
  panel and on a Dataset with categorical columns (one past the 255-bin
  cap): counts exact, sums within 1e-5 x the sum of |v| over the bin;
- float32 trainings with categorical columns, EFB, the CEGB lazy penalty
  and linear leaves launch the kernel once a leaf (never the plain
  version) and give the same bits twice;
- the same trainings in float64 (``gpu_use_dp``) card vs CPU: the same
  trees, categorical left sets and linear features, and raw scores within
  1e-9, up to the first exact tie of two split gains (a categorical left
  set and its mirror image tie too), checked to be one.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.ops.kernels import histogram as hk

pytestmark = pytest.mark.gpu

HIST_SUM_TOL = 1e-5
CPU_RTOL = 1e-9
PARAMS = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 20,
          "verbose": -1}
ROUNDS = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(15)
    n = 4000
    X = rng.uniform(size=(n, 5))
    c1 = rng.integers(0, 20, n).astype(float)
    c2 = ((rng.zipf(1.1, n) - 1) % 400).astype(float)
    lv = rng.integers(0, 40, n)
    oh = np.zeros((n, 40))
    oh[np.arange(n), lv] = 1.0
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
         + rng.standard_normal(20)[c1.astype(int)]
         + rng.standard_normal(40)[lv] + 0.3 * rng.standard_normal(n))
    return dict(cat=np.column_stack([X, c1, c2]), onehot=np.hstack([X, oh]),
                y=y)


CASES = {
    "categorical": ("cat", {"categorical_feature": [5, 6]}, {}),
    "efb": ("onehot", {}, {}),
    "cegb_lazy": ("cat", {}, {"cegb_penalty_feature_lazy":
                              [0.0, 0.01, 0.01, 0.1, 0.1, 0.0, 0.0]}),
    "linear": ("cat", {}, {"linear_tree": True, "linear_lambda": 0.1}),
}


def _train(data, case, device, **extra):
    key, dkw, params = CASES[case]
    ds = gpt.Dataset(data[key], label=data["y"], device=device, **dkw)
    return gpt.train(dict(PARAMS, **params, **extra), ds,
                     num_boost_round=ROUNDS), ds


def _compare(binned, panel, B, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    n = binned.shape[0]
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) + 0.5
    for mask in (torch.ones(n, dtype=torch.bool, device=dev),
                 torch.rand(n, generator=gen, device=dev) < 0.03):
        before = hk.histogram.launches
        got = hk.histogram(binned, g, h, mask, B, binned_t=panel,
                           scales=hk.fixed_point_scales(g, h))
        assert hk.histogram.launches == before + 1
        want = hk.histogram_plain(binned, g.double(), h.double(), mask, B)
        scale = hk.histogram_plain(binned, g.double().abs(),
                                   h.double().abs(), mask, B)
        assert torch.equal(got[2].double(), want[2])
        for k in (0, 1):
            err = (got[k].double() - want[k]).abs()
            assert bool((err <= HIST_SUM_TOL * scale[k] + 1e-30).all())


def test_histogram_on_bundle_panel_and_categorical_bins(dev, data):
    ds = gpt.Dataset(data["onehot"], label=data["y"], device=dev)
    efb = ds.efb
    assert efb is not None and efb.binned_hist_t is not None
    assert efb.binned_hist.shape[1] < ds.num_features
    _compare(efb.binned_hist, efb.binned_hist_t, efb.max_bins_hist, dev)
    dc = gpt.Dataset(data["cat"], label=data["y"], categorical_feature=[5, 6],
                     device=dev)
    assert dc.num_bins[6] == 255 and dc.binned_t is not None
    _compare(dc.binned, dc.binned_t, dc.max_num_bins, dev)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_once_a_leaf_and_the_same_bits(dev, data, case):
    before = hk.histogram.launches
    b1, _ = _train(data, case, dev)
    # the fixed-shape grower where it covers the case's options
    assert hk.histogram.launches - before == tt.histogram_launches(
        b1.trees, PARAMS["num_leaves"])
    b2, _ = _train(data, case, dev)
    assert np.array_equal(b1._score, b2._score)
    if case == "categorical":
        assert any(t.has_categorical() for t in b1.trees)
    if case == "linear":
        assert any(t.lin_features is not None for t in b1.trees)


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_vs_cpu(dev, data, case):
    bc, _ = _train(data, case, dev, gpu_use_dp=True)
    bh, _ = _train(data, case, torch.device("cpu"))
    X = data[CASES[case][0]]
    first_diff = None
    for k, (a, b) in enumerate(zip(bc.trees, bh.trees)):
        if not (np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)
                and np.array_equal(a.is_leaf, b.is_leaf)):
            node = np.flatnonzero((a.split_feature != b.split_feature)
                                  | (a.threshold_bin != b.threshold_bin)
                                  | (a.is_leaf != b.is_leaf))[0]
            ga, gb = float(a.split_gain[node]), float(b.split_gain[node])
            assert abs(ga - gb) <= 1e-9 * abs(float(b.split_gain[0]))
            first_diff = k
            break
        cat_diff = np.flatnonzero((a.cat_mask != b.cat_mask).any(axis=1))
        if len(cat_diff):
            # a left set and its mirror image: their gains tie exactly
            node = cat_diff[0]
            ga, gb = float(a.split_gain[node]), float(b.split_gain[node])
            assert abs(ga - gb) <= 1e-9 * abs(float(b.split_gain[0]))
            first_diff = k
            break
        if a.lin_features is not None:
            assert np.array_equal(a.lin_features, b.lin_features)
    it = ROUNDS if first_diff is None else first_diff
    if it:
        p1 = bc.predict(X, num_iteration=it, raw_score=True)
        p2 = bh.predict(X, num_iteration=it, raw_score=True)
        err = float(np.max(np.abs(p1 - p2)))
        assert err <= CPU_RTOL * max(1.0, float(np.max(np.abs(p2))))
