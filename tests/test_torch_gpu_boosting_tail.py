"""The boosting tail on the card (ROADMAP item 18a): what the full-size run
of ``chip_smoke.py`` does not hold case by case. Needs an NVIDIA GPU;
skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_boosting_tail.py --noconftest -q

- the histogram kernel under a bagging mask (the booster's own bag of
  a bagged training) against its float64 plain version: counts exact, sums
  within 1e-5 x the sum of |v| over the bin;
- one bagged training round per objective launches the kernel once a leaf
  (``num_models`` trees a round for the multiclass objectives);
- one validation round with ``use_gp_model_for_validation`` (a float64
  Vecchia GP, ``gpu_use_dp``) card vs CPU: the same trees, training scores
  and metric values within 1e-9 relative.
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
          "verbose": -1, "bagging_fraction": 0.7, "bagging_freq": 1,
          "feature_fraction": 0.8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = 4000
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.3 * rng.standard_normal(n))
    return dict(X=X, y=y, coords=coords)


def test_bagged_histogram_matches_plain(dev, data):
    ds = gpt.Dataset(data["X"], label=data["y"], device=dev)
    bst = gpt.train(PARAMS, ds, num_boost_round=2)
    bag = bst._bag_mask_t
    assert bag.is_cuda and 0 < int(bag.sum()) < ds.num_data
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(ds.num_data, generator=gen, device=dev)
    h = torch.rand(ds.num_data, generator=gen, device=dev) + 0.5
    B = ds.max_num_bins
    before = hk.histogram.launches
    got = hk.histogram(ds.binned, g, h, bag, B, binned_t=ds.binned_t,
                       scales=hk.fixed_point_scales(g, h))
    assert hk.histogram.launches == before + 1
    want = hk.histogram_plain(ds.binned, g.double(), h.double(), bag, B)
    scale = hk.histogram_plain(ds.binned, g.double().abs(), h.double().abs(),
                               bag, B)
    assert torch.equal(got[2].double(), want[2])
    for k in (0, 1):
        err = (got[k].double() - want[k]).abs()
        assert bool((err <= HIST_SUM_TOL * scale[k] + 1e-30).all())
    # the rows outside the bag count nowhere
    assert int(got[2][0].sum()) == int(bag.sum())


@pytest.mark.parametrize("name,extra", [
    ("regression", {}), ("quantile", {"alpha": 0.3}),
    ("multiclass", {"num_class": 3}), ("mean_scale_regression", {})])
def test_bagged_round_launches_once_a_leaf(dev, data, name, extra):
    y = data["y"]
    if name == "multiclass":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    ds = gpt.Dataset(data["X"], label=y, device=dev)
    hk.histogram.launches = 0
    bst = gpt.train(dict(PARAMS, objective=name,
                         feature_fraction_bynode=0.8, **extra), ds,
                    num_boost_round=2)
    assert len(bst.trees) == 2 * bst.num_models
    # feature_fraction_bynode keeps the host grower: one launch a leaf
    assert hk.histogram.launches == tt.histogram_launches(
        bst.trees, PARAMS["num_leaves"])
    assert np.all(np.isfinite(bst._score))


def test_validation_round_card_vs_cpu(data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, nv = 3000, 1000
    out = []
    for device in ("cuda", "cpu"):
        gp = gpt.GPModel(gp_coords=data["coords"][:n],
                         cov_function="exponential", gp_approx="vecchia",
                         num_neighbors=10, device=device)
        gp.set_optim_params({"optimizer_cov": "lbfgs",
                             "init_cov_pars": [0.25, 1.0, 0.1]})
        gp.set_prediction_data(gp_coords_pred=data["coords"][n:n + nv])
        ds = gpt.Dataset(data["X"][:n], label=data["y"][:n], device=device)
        dv = ds.create_valid(data["X"][n:n + nv], label=data["y"][n:n + nv])
        ev = {}
        params = dict(PARAMS, metric=["l2", "test_neg_log_likelihood",
                                      "crps_gaussian"],
                      gpu_use_dp=True)
        bst = gpt.train(params, ds, gp_model=gp, num_boost_round=1,
                        valid_sets=[dv], evals_result=ev, verbose_eval=False)
        out.append((bst, ev))
    (bc, ec), (bh, eh) = out
    tc, th = bc.trees[0], bh.trees[0]
    ic, ih = tc.internal_nodes(), th.internal_nodes()
    np.testing.assert_array_equal(tc.split_feature[ic], th.split_feature[ih])
    np.testing.assert_array_equal(tc.threshold_bin[ic], th.threshold_bin[ih])
    np.testing.assert_allclose(bc._score, bh._score, rtol=CPU_RTOL)
    for metric, vals in eh["valid_0"].items():
        np.testing.assert_allclose(ec["valid_0"][metric], vals,
                                   rtol=CPU_RTOL, err_msg=metric)
