"""The device-resident GPBoost loop and its fixed-shape grower on the card
(ROADMAP Queue A, item 10). Needs an NVIDIA GPU; skipped elsewhere. Run on
the GPU machine with

    python -m pytest tests/test_torch_gpu_device_loop.py --noconftest -q

- the histogram kernel's two entries (scales by value, scales read from
  device memory) give the same bits;
- the fixed-shape grower's graph replay and its eager run give the same
  bits, and neither reads the host (CUDA's sync debug mode set to error);
- ``grow_tree_fast`` and ``grow_tree`` give the same tree to the last bit
  on the card (numeric, missing values, a row mask, path smoothing with
  ``max_delta_step``, ``feature_contri`` with ``max_depth``, a tree that
  stops early; categorical features, the three monotone methods with the
  penalty, interaction constraints, forced splits, and these together);
- the categorical scan's group-scan kernel gives its plain version's bits
  (float32 and float64 counts, inside a CUDA graph too), and a categorical
  tree's replay its eager run's, with no host read;
- two device-loop trainings on a float32 Vecchia GP give the same bits,
  the first capturing the grower's graph and the second replaying it; the
  host reads are the refits' evaluations and one fetch;
- a gradient that is not finite raises ``ValueError`` (the host route's)
  from ``grow_tree_fast``, ``Booster.update`` and the device loop;
- ``device_resident_boosting="auto"`` engages the loop for a Gaussian GP on
  the card and leaves the LaGaBoost branch to ``"true"``.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import device_loop
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
from gpboost_tpu_torch.ops.kernels import histogram as hk
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

pytestmark = pytest.mark.gpu

N, F, B = 20_000, 6, 64
BASE = dict(num_leaves=31, min_data_in_leaf=20, lambda_l2=0.1)
CAT = np.array([False, False, False, False, True, True])
MONO = np.array([1, 0, -1, 0, 0, 0])
FORCED = {"feature": 1, "threshold_bin": 30,
          "left": {"feature": 0, "threshold_bin": 20}}
CASES = {
    "base": (BASE, {}),
    "smooth_plus_mds": (dict(BASE, path_smooth=3.0, max_delta_step=0.05), {}),
    "contri_depth": (dict(BASE, max_depth=4,
                          feature_contri=np.linspace(0.5, 1.5, F)), {}),
    "nan": (BASE, {"nan": True}),
    "row_mask": (BASE, {"row_mask": True}),
    # at most 8 leaves of 2 500 rows: the remaining steps do not split
    "early_stop": (dict(BASE, min_data_in_leaf=2_500), {}),
    # the options of ROADMAP item 10b, part 1 (features 4 and 5
    # categorical: 64 levels each)
    "categorical": (dict(BASE, cat_smooth=5.0, min_data_per_group=50),
                    {"grow": dict(categorical_mask=CAT)}),
    "mono_basic_penalty": (dict(BASE, monotone_penalty=1.0),
                           {"grow": dict(monotone_constraints=MONO)}),
    "mono_intermediate": (dict(BASE,
                               monotone_constraints_method="intermediate",
                               monotone_penalty=1.0),
                          {"grow": dict(monotone_constraints=MONO)}),
    "mono_advanced_mds": (dict(BASE, monotone_constraints_method="advanced",
                               max_delta_step=0.05),
                          {"grow": dict(monotone_constraints=MONO)}),
    "interaction": (BASE, {"grow": dict(
        interaction_constraints=[[0, 1, 4], [2, 3, 5]])}),
    "forced": (BASE, {"nan": True, "grow": dict(forced_splits=FORCED)}),
    "cat_interaction_forced": (BASE, {"nan": True, "grow": dict(
        categorical_mask=CAT, interaction_constraints=[[0, 1, 4], [2, 3, 5]],
        monotone_constraints=MONO, forced_splits=FORCED)}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(case, dev, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(N, F))
    opts = CASES[case][1]
    kw = dict(opts.get("grow", {}))
    if opts.get("nan"):
        binned[:, 0] = np.where(rng.uniform(size=N) < 0.1, 0,
                                binned[:, 0] % (B - 1) + 1)
        kw["nan_mask"] = np.eye(F, dtype=bool)[0]
    if opts.get("row_mask"):
        kw["row_mask"] = torch.as_tensor(rng.uniform(size=N) < 0.6,
                                         device=dev)
    bt = torch.as_tensor(binned, device=dev)
    kw["binned_t"] = bt.t().contiguous().to(torch.uint8)
    g = torch.as_tensor(rng.standard_normal(N) * (1 + binned[:, 1] / B)
                        - 0.02 * binned[:, 0] + 0.5 * (binned[:, 4] % 3),
                        dtype=torch.float32, device=dev)
    h = torch.ones(N, dtype=torch.float32, device=dev)
    nb = torch.full((F,), B, device=dev)
    return bt, nb, g, h, tt.GrowerParams(**CASES[case][0]), kw


def test_histogram_entries_same_bits(dev):
    rng = np.random.default_rng(1)
    binned = torch.as_tensor(rng.integers(0, B, size=(N, F)), device=dev)
    panel = binned.t().contiguous().to(torch.uint8)
    g = torch.as_tensor(rng.standard_normal(N), dtype=torch.float32,
                        device=dev)
    h = torch.as_tensor(rng.uniform(0.5, 2, N), dtype=torch.float32,
                        device=dev)
    mask = torch.as_tensor(rng.uniform(size=N) < 0.5, device=dev)
    host = hk.histogram(binned, g, h, mask, B, binned_t=panel,
                        scales=hk.fixed_point_scales(g, h))
    before = hk.histogram.launches
    on_dev = hk.histogram(binned, g, h, mask, B, binned_t=panel,
                          scales=hk.fixed_point_scales_device(g, h))
    assert hk.histogram.launches == before + 1
    for a, b in zip(host, on_dev):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_and_host_grower_same_tree(dev, case):
    bt, nb, g, h, params, kw = _inputs(case, dev)
    tf, rlf = tt.grow_tree_fast(bt, nb, g, h, B, params, **kw)
    th, rlh = tt.grow_tree(bt, nb, g, h, B, params, **kw)
    for name in ("split_feature", "threshold_bin", "left", "right",
                 "is_leaf", "leaf_value", "node_count", "split_gain",
                 "default_left", "is_categorical", "cat_mask"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(th, name),
                                      err_msg=name)
    assert tf.num_leaves == th.num_leaves
    assert torch.equal(rlf, rlh)
    if "categorical_mask" in kw:
        assert tf.has_categorical()
    if "forced_splits" in kw:
        assert tf.split_feature[0] == 1 and tf.split_gain[0] == 0.0
    if case == "early_stop":
        assert 1 < tf.num_leaves < params.num_leaves


def test_replay_and_eager_same_bits_and_no_host_read(dev):
    bt, nb, g, h, params, kw = _inputs("nan", dev)
    grower = tt.FixedGrower(bt, B, params, torch.float32,
                            nan_mask=kw["nan_mask"], binned_t=kw["binned_t"])
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    before = hk.histogram.launches
    eager = {k: v.clone() for k, v in grower.grow(g, h, ones, nb).items()}
    assert grower.captures == 1
    assert hk.histogram.launches == before + params.num_leaves
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay = {k: v.clone() for k, v in grower.grow(g, h, ones,
                                                       nb).items()}
        other = {k: v.clone() for k, v in grower.grow(
            g * 3 - 1, h, ones, nb).items()}
        direct = tt._grow_tree_fixed(g * 3 - 1, h, ones, nb, grower)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hk.histogram.launches == before + 3 * params.num_leaves \
        + params.num_leaves
    for k in eager:
        assert torch.equal(eager[k], replay[k]), k
        assert torch.equal(other[k], direct[k]), k
    assert not torch.equal(eager["leaf_value"], other["leaf_value"])


def _gpboost_data(n=5000):
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.3 * rng.standard_normal(n))
    return X, coords, y


def _vecchia_gp(coords, dev, **kw):
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=10,
                     dtype=torch.float32, device=dev, **kw)
    gp.set_optim_params({"optimizer_cov": "lbfgs",
                         "init_cov_pars": [0.25, 1.0, 0.1]})
    return gp


def test_device_loop_trainings_same_bits(dev):
    X, coords, y = _gpboost_data()
    rounds = 4
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "device_resident_boosting": "true"}
    ds = gpt.Dataset(X, label=y, device=dev)
    runs = []
    for _ in range(2):
        gp = _vecchia_gp(coords, dev)
        hk.histogram.launches = 0
        vk.reset_launch_counts()
        bst = gpt.train(params, ds, gp_model=gp, num_boost_round=rounds)
        info = bst.device_training_info_
        assert hk.histogram.launches == rounds * params["num_leaves"]
        # the refits' evaluations and the trailing refit's, on the kernel
        assert vk.launch_counts()["vecchia_nll_grad"] >= int(
            info["refit_evaluations"].sum())
        assert info["host_reads"] == int(info["refit_evaluations"].sum()) + 1
        runs.append((bst, gp.get_cov_pars(), info["includes_compile"]))
    (b1, c1, cap1), (b2, c2, cap2) = runs
    assert cap1 and not cap2
    assert np.array_equal(b1._score, b2._score)
    assert np.array_equal(c1, c2)
    for t1, t2 in zip(b1.trees, b2.trees):
        assert np.array_equal(t1.leaf_value, t2.leaf_value)
        assert np.array_equal(t1.split_feature, t2.split_feature)


def test_gradient_that_is_not_finite_raises(dev, monkeypatch):
    bt, nb, g, h, params, kw = _inputs("base", dev)
    g = g.clone()
    g[17] = float("nan")
    with pytest.raises(ValueError, match="grow_tree_fast: a leaf value is "
                       "not finite"):
        tt.grow_tree_fast(bt, nb, g, h, B, params, **kw)
    X, coords, y = _gpboost_data(2000)
    ds = gpt.Dataset(X, label=y, device=dev)

    def nan_objective(preds, data):
        return np.full(len(preds), np.nan), np.ones(len(preds))

    with pytest.raises(ValueError, match="not finite"):
        gpt.train({"objective": "regression", "num_leaves": 15,
                   "verbose": -1}, ds, num_boost_round=1, fobj=nan_objective)
    orig = device_loop._fns_for

    def nan_fns(b):
        vg, final, kdt = orig(b)
        return vg, (lambda *a: final(*a) * float("nan")), kdt

    monkeypatch.setattr(device_loop, "_fns_for", nan_fns)
    with pytest.raises(ValueError, match="device loop: a leaf value is not "
                       "finite"):
        gpt.train({"objective": "regression", "num_leaves": 15,
                   "verbose": -1, "device_resident_boosting": "true"}, ds,
                  gp_model=_vecchia_gp(coords, dev), num_boost_round=2)


def test_auto_engages_the_gaussian_branch_alone(dev):
    X, coords, y = _gpboost_data(2000)
    ds = gpt.Dataset(X, label=y, device=dev)
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    bst = gpt.train(params, ds, gp_model=_vecchia_gp(coords, dev),
                    num_boost_round=2)
    assert "device_training_info_" in bst.__dict__
    yb = (y > np.median(y)).astype(float)
    for mode, want in (("auto", False), ("true", True)):
        gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                         gp_approx="vecchia", num_neighbors=10,
                         likelihood="bernoulli_logit",
                         matrix_inversion_method="iterative",
                         dtype=torch.float32, device=dev)
        gp.set_optim_params({"optimizer_cov": "lbfgs",
                             "init_cov_pars": [1.0, 0.1]})
        b = gpt.Booster(params={"objective": "binary", "num_leaves": 15,
                                "verbose": -1,
                                "device_resident_boosting": mode},
                        train_set=gpt.Dataset(X, label=yb, device=dev),
                        gp_model=gp)
        assert device_loop.eligible(b) is want, mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_scan_kernel_is_its_plain_version(dev, dtype):
    """The group-scan kernel against its plain version on random integer
    counts (the shapes of 1 and 40 categorical features, 255 bins; every
    min_data_per_group from 1 to past the row totals), eagerly and inside a
    CUDA graph: the same booleans."""
    rng = np.random.default_rng(11)
    for D in (2, 80):
        counts = torch.as_tensor(rng.integers(0, 50, size=(D, 255)),
                                 dtype=dtype, device=dev)
        ok = torch.as_tensor(rng.uniform(size=(D, 255)) < 0.7, device=dev)
        for mdpg in (1.0, 20.0, 100.0, 1e6):
            before = gk.group_boundaries.launches
            got = gk.group_boundaries(counts, ok, mdpg)
            assert gk.group_boundaries.launches == before + 1
            want = gk.group_boundaries_plain(counts, ok, mdpg)
            assert torch.equal(got, want), (D, mdpg)
        static = counts.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gk.group_boundaries(static, ok, 20.0)
        static.copy_(counts.flip(1))
        graph.replay()
        assert torch.equal(out, gk.group_boundaries_plain(counts.flip(1), ok,
                                                          20.0))
    with pytest.raises(ValueError, match="dtype"):
        gk.group_boundaries(counts.to(torch.int32), ok, 1.0)


def test_categorical_replay_and_eager_same_bits_and_no_host_read(dev):
    """A categorical, forced, interaction-constrained and monotone tree:
    the replay, a direct eager call and the first (eager) call the same
    bits, no host read (sync debug mode "error"), and per tree
    ``num_leaves + len(ops)`` histogram launches and ``2 num_leaves - 1``
    group-scan launches."""
    bt, nb, g, h, params, kw = _inputs("cat_interaction_forced", dev)
    opts = {k: kw[k] for k in ("categorical_mask", "interaction_constraints",
                               "monotone_constraints", "forced_splits")}
    grower = tt.FixedGrower(bt, B, params, torch.float32,
                            nan_mask=kw["nan_mask"], binned_t=kw["binned_t"],
                            **opts)
    L, n_ops = params.num_leaves, len(grower.forced_ops)
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    h0, s0 = hk.histogram.launches, gk.group_boundaries.launches
    eager = {k: v.clone() for k, v in grower.grow(g, h, ones, nb).items()}
    assert (hk.histogram.launches - h0, gk.group_boundaries.launches - s0) \
        == (L + n_ops, 2 * L - 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay = {k: v.clone() for k, v in grower.grow(g, h, ones,
                                                       nb).items()}
        direct = tt._grow_tree_fixed(g, h, ones, nb, grower)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (hk.histogram.launches - h0, gk.group_boundaries.launches - s0) \
        == (3 * (L + n_ops), 3 * (2 * L - 1))
    for k in eager:
        assert torch.equal(eager[k], replay[k]), k
        assert torch.equal(direct[k], replay[k]), k
    assert bool(eager["iscat"].any())

