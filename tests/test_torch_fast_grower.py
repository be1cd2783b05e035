"""The fixed-shape grower of the port (``tree.grow_tree_fast`` /
``_grow_tree_fixed``) on the CPU, float64, against the JAX package's
``grow_tree_fast`` and against the port's host grower ``grow_tree``;
mirrors ``tests/test_boosting_basic.py::test_fast_grower_matches_host_grower``
(n 3 000, F 8, B 32), ``tests/test_fast_grower_features.py`` (its numeric,
categorical and interaction cases and
``test_fast_grower_nan_with_categoricals``) and
``tests/test_fast_grower_mono_cegb_forced.py`` (``MONO_CASES``, the forced
splits alone and with monotone constraints, ``flatten_forced_splits``).

Tolerances: against the JAX package (its host grower with an EFB panel,
where its fixed-shape grower does not trace) the same number of leaves, split
features, bins and ``row_leaf`` (on the rows inside a row mask: the JAX
package's fixed-shape grower leaves the rows outside it where they were,
the port's moves them as its host grower does), leaf values within 1e-10;
with categorical features the same number of leaves and every row's leaf
value within 1e-12 (a categorical left set and its mirror image tie, as in
the JAX package's own test); against the port's host grower every array of
the tree and ``row_leaf`` EQUAL (the same bits). The options the grower does
not cover (CEGB, extra trees, ``feature_fraction_bynode``) raise, naming
ROADMAP.md Queue A, item 10b. The grower runs with every way of reading a
tensor into Python patched to raise: it never reads the host inside a tree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.boosting import tree as jt
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
from gpboost_tpu_torch.ops.kernels import histogram as hk

N, F, B = 3000, 8, 32
BASE = dict(num_leaves=15, max_depth=5, min_data_in_leaf=20,
            min_sum_hessian_in_leaf=1e-3, lambda_l2=0.1)
LEAF_TOL = 1e-10
PRED_TOL = 1e-12
CAT_MASK = np.zeros(F, bool)
CAT_MASK[[1, 4]] = True
IC = [[0, 1, 2], [2, 3, 4, 5], [6, 7]]
MONO = np.array([1, 0, -1, 0, 0, 1, 0, 0])
FORCED = {"feature": 3, "threshold_bin": 15,
          "left": {"feature": 6, "threshold_bin": 10},
          "right": {"feature": 1, "threshold_bin": 20}}
CAT = {"grow": dict(categorical_mask=CAT_MASK)}
# the monotone cases' data (the JAX test's: gradients that follow features
# 0 and 2, so that the constraints bind)
MONO_DATA = {"data": 1, "grow": dict(monotone_constraints=MONO)}

CASES = {
    "base": (BASE, {}),
    "path_smooth": (dict(BASE, path_smooth=5.0), {}),
    "max_delta_step": (dict(BASE, max_delta_step=0.05), {}),
    "smooth_plus_mds": (dict(BASE, max_delta_step=0.05, path_smooth=3.0), {}),
    "l1_no_depth_cap": (dict(BASE, max_depth=-1, lambda_l1=1.0), {}),
    "feature_contri": (dict(BASE, max_depth=-1,
                            feature_contri=np.linspace(0.5, 1.5, F)), {}),
    # stops early: no leaf has an admissible gain after a few splits
    "early_stop": (dict(BASE, num_leaves=31, max_depth=-1,
                        min_gain_to_split=5.0), {}),
    # more leaves than min_data_in_leaf lets the rows make
    "more_leaves_than_data": (dict(BASE, num_leaves=63, max_depth=-1,
                                   min_data_in_leaf=200), {}),
    "nan": (BASE, {"nan": True}),
    "row_mask": (dict(BASE, path_smooth=2.0), {"row_mask": True}),
    "efb": (dict(BASE, min_data_in_leaf=5), {"efb": True}),
    # categorical features and interaction constraints
    "categorical": (BASE, CAT),
    "categorical_onehot": (dict(BASE, max_cat_to_onehot=40), CAT),
    "categorical_smooth": (dict(BASE, path_smooth=2.0), CAT),
    "interaction": (BASE, {"grow": dict(interaction_constraints=IC)}),
    "interaction_cat": (BASE, {"grow": dict(interaction_constraints=IC,
                                            categorical_mask=CAT_MASK)}),
    "nan_with_categoricals": (BASE, dict(CAT, nan=True)),
    "categorical_row_mask": (BASE, dict(CAT, row_mask=True)),
    # the monotone methods
    "mono_basic": (dict(BASE, monotone_constraints_method="basic"),
                   MONO_DATA),
    "mono_intermediate": (dict(BASE,
                               monotone_constraints_method="intermediate"),
                          MONO_DATA),
    "mono_advanced": (dict(BASE, monotone_constraints_method="advanced"),
                      MONO_DATA),
    "mono_basic_penalty": (dict(BASE, monotone_constraints_method="basic",
                                monotone_penalty=1.5), MONO_DATA),
    "mono_intermediate_mds": (dict(
        BASE, monotone_constraints_method="intermediate",
        max_delta_step=0.08), MONO_DATA),
    "mono_basic_smooth": (dict(BASE, monotone_constraints_method="basic",
                               path_smooth=3.0), MONO_DATA),
    # forced splits, alone and with intermediate monotone constraints
    "forced": (BASE, {"data": 1, "grow": dict(forced_splits=FORCED)}),
    "forced_monotone": (dict(BASE, monotone_constraints_method="intermediate"),
                        {"data": 1, "grow": dict(monotone_constraints=MONO,
                                                 forced_splits=FORCED)}),
    # everything at once: a forced prefix inside one interaction group on
    # a feature without a monotone constraint (on a monotone one the JAX
    # package's fixed-shape grower tightens the children's bounds, its host
    # grower and the port's do not: ROADMAP.md, Not faults), categorical
    # features in the group, monotone constraints beside
    "cat_forced_interaction": (dict(
        BASE, monotone_constraints_method="intermediate"),
        {"data": 1, "grow": dict(
            categorical_mask=CAT_MASK, interaction_constraints=IC,
            monotone_constraints=MONO,
            forced_splits={"feature": 3, "threshold_bin": 15,
                           "left": {"feature": 3, "threshold_bin": 8}})}),
}


def _has_cat(case):
    return "categorical_mask" in CASES[case][1].get("grow", {})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _onehot(n=800, seed=0):
    rng = np.random.default_rng(seed)
    Xd = rng.uniform(size=(n, 3))
    lv = rng.integers(0, 12, size=n)
    Xoh = np.zeros((n, 12))
    Xoh[np.arange(n), lv] = rng.uniform(1, 2, size=n)
    return np.hstack([Xd, Xoh]), 2 * Xd[:, 0] + 0.7 * (lv % 3)


def _inputs(case):
    """(port kwargs, JAX kwargs) of a case: the same bins, gradients,
    hessians and masks for both packages."""
    opts = CASES[case][1]
    rng = np.random.default_rng(opts.get("data", 0))
    binned = rng.integers(0, B, size=(N, F))
    grad = rng.standard_normal(N)
    if opts.get("data") == 1:
        grad = -0.1 * binned[:, 0] + 0.08 * binned[:, 2] + grad
    hess = np.ones(N)
    nb = np.full(F, B)
    port, jax_kw = dict(opts.get("grow", {})), dict(opts.get("grow", {}))
    if opts.get("nan"):
        # feature 0 gets an exclusive NA bin (bin 0) on ~10 % of the rows
        binned[:, 0] = np.where(rng.uniform(size=N) < 0.1, 0,
                                binned[:, 0] % (B - 1) + 1)
        mask = np.zeros(F, bool)
        mask[0] = True
        port["nan_mask"] = jax_kw["nan_mask"] = mask
    if opts.get("row_mask"):
        rm = rng.uniform(size=N) < 0.7
        port["row_mask"] = torch.as_tensor(rm)
        jax_kw["row_mask"] = jnp.asarray(rm)
    if opts.get("efb"):
        X, y = _onehot()
        ds = gpt.Dataset(X, label=y, device="cpu")
        jd = gpb.Dataset(X, label=y)
        assert ds.efb is not None
        n = X.shape[0]
        grad = rng.standard_normal(n)
        hess = np.ones(n)
        port.update(binned_t=ds.binned_t, efb=ds.efb)
        jax_kw["efb"] = jd.efb
        return (dict(port, binned=ds.binned, nb=torch.as_tensor(ds.num_bins),
                     grad=grad, hess=hess, B=ds.max_num_bins),
                dict(jax_kw, binned=jnp.asarray(jd.binned),
                     nb=jnp.asarray(jd.num_bins), B=jd.max_num_bins))
    return (dict(port, binned=torch.as_tensor(binned), nb=torch.as_tensor(nb),
                 grad=grad, hess=hess, B=B),
            dict(jax_kw, binned=jnp.asarray(binned, jnp.int32),
                 nb=jnp.asarray(nb, jnp.int32), B=B))


GROW_KEYS = ("nan_mask", "row_mask", "efb", "categorical_mask",
             "interaction_constraints", "monotone_constraints",
             "forced_splits")


def _port_grow(fn, case):
    p, _ = _inputs(case)
    kw = {k: p[k] for k in GROW_KEYS + ("binned_t",) if k in p}
    return fn(p["binned"], p["nb"], torch.as_tensor(p["grad"]),
              torch.as_tensor(p["hess"]), p["B"],
              tt.GrowerParams(**CASES[case][0]), **kw)


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's fixed-shape grower on every case, computed once."""
    out = {}
    for case in CASES:
        p, j = _inputs(case)
        kw = {k: j[k] for k in GROW_KEYS if k in j}
        # the JAX package's fixed-shape grower does not trace with an EFB
        # panel (its hist_B reaches the jit by keyword, not as a static
        # argument; ROADMAP.md, Not faults): its host grower there
        grow = jt.grow_tree if "efb" in kw else jt.grow_tree_fast
        tree, rl = grow(
            j["binned"], j["nb"], jnp.asarray(p["grad"]),
            jnp.asarray(p["hess"]), j["B"], jt.GrowerParams(**CASES[case][0]),
            **kw)
        out[case] = (tree, np.asarray(rl))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_grower_matches_jax_and_host_grower(jax_trees, case):
    tf, rlf = _port_grow(tt.grow_tree_fast, case)
    th, rlh = _port_grow(tt.grow_tree, case)
    tj, rlj = jax_trees[case]
    # the JAX package's fixed-shape grower
    assert tf.num_leaves == tj.num_leaves
    inside = (_inputs(case)[0]["row_mask"].numpy()
              if CASES[case][1].get("row_mask") else np.ones(len(rlj), bool))
    if _has_cat(case):
        # a categorical left set and its mirror image tie: every row's leaf
        # value
        np.testing.assert_allclose(
            tf.leaf_value[rlf.numpy()][inside],
            np.asarray(tj.leaf_value)[rlj][inside], rtol=0, atol=PRED_TOL)
        assert tf.has_categorical() == bool(np.any(tj.is_categorical))
    else:
        np.testing.assert_array_equal(tf.split_feature, np.asarray(
            tj.split_feature))
        np.testing.assert_array_equal(tf.threshold_bin, np.asarray(
            tj.threshold_bin))
        np.testing.assert_array_equal(tf.default_left, np.asarray(
            tj.default_left))
        np.testing.assert_allclose(tf.leaf_value, np.asarray(tj.leaf_value),
                                   rtol=0, atol=LEAF_TOL)
        np.testing.assert_array_equal(rlf.numpy()[inside], rlj[inside])
    # the port's host grower: the same bits
    for name in ("split_feature", "threshold_bin", "left", "right",
                 "is_leaf", "leaf_value", "node_count", "split_gain",
                 "default_left", "is_categorical", "cat_mask"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(th, name),
                                      err_msg=name)
    assert (tf.num_leaves, tf.max_depth_used) == (th.num_leaves,
                                                  th.max_depth_used)
    assert torch.equal(rlf, rlh)
    np.testing.assert_array_equal(tf.row_leaf_host, rlh.numpy())


def test_early_stop_leaves_the_carry_as_it_was():
    """Steps with no admissible split change nothing: a tree that stops
    after k splits has the node arrays of k splits (unused slots at their
    initial values), however many masked steps follow."""
    tf, _ = _port_grow(tt.grow_tree_fast, "early_stop")
    L = CASES["early_stop"][0]["num_leaves"]
    assert 1 < tf.num_leaves < L
    used = 2 * tf.num_leaves - 1
    M = 2 * L - 1
    idx = np.arange(M)
    np.testing.assert_array_equal(tf.left[used:], idx[used:])
    np.testing.assert_array_equal(tf.right[used:], idx[used:])
    assert not tf.is_leaf[used:].any()
    assert (tf.node_count[used:] == 0).all()
    assert (tf.leaf_value[used:] == 0).all()
    assert tf.default_left[used:].all()


GAPS = [
    ("categorical", dict(categorical_mask=np.eye(F, dtype=bool)[1])),
    ("monotone", dict(monotone_constraints=np.eye(F, dtype=int)[0])),
    ("interaction", dict(interaction_constraints=[[0, 1], [2, 3]])),
    ("forced", dict(forced_splits={"feature": 0, "threshold_bin": 5})),
    ("cegb", dict(cegb=tt.CEGBState(F, N, penalty_split=0.1))),
    ("extra_trees", dict(params=dict(extra_trees=True))),
    ("feature_fraction_bynode",
     dict(params=dict(feature_fraction_bynode=0.5))),
]
# the options the fixed-shape grower took over from the host grower
PORTED = ("categorical", "monotone", "interaction", "forced")


@pytest.mark.parametrize("name,kw", GAPS, ids=[g[0] for g in GAPS])
def test_uncovered_options_raise_naming_item_10b(name, kw):
    """CEGB, extra trees and ``feature_fraction_bynode`` raise, naming
    item 10b; the four options ported from it (``PORTED``) grow the host
    grower's tree to the bit instead."""
    p, _ = _inputs("base")
    kw = dict(kw)
    params = tt.GrowerParams(**dict(BASE, **kw.pop("params", {})))
    args = (p["binned"], p["nb"], torch.as_tensor(p["grad"]),
            torch.as_tensor(p["hess"]), B, params)
    if name in PORTED:
        assert not tt.fixed_grower_gaps(params, kw.get("cegb"))
        tf, rlf = tt.grow_tree_fast(*args, **kw)
        th, rlh = tt.grow_tree(*args, **kw)
        for field in ("split_feature", "threshold_bin", "left", "right",
                      "leaf_value", "split_gain", "is_categorical",
                      "cat_mask"):
            np.testing.assert_array_equal(getattr(tf, field),
                                          getattr(th, field), err_msg=field)
        assert torch.equal(rlf, rlh)
        return
    assert tt.fixed_grower_gaps(params, kw.get("cegb"))
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md Queue A, item 10b"):
        tt.grow_tree_fast(*args, **kw)


def test_forced_prefix_is_in_the_tree_and_flattens_to_leaf_ids():
    """The forced splits come first (the JAX package's
    ``test_forced_splits_parity`` and
    ``test_flatten_forced_splits_leaf_ids``); a forced tree launches the
    histogram ``num_leaves + len(ops)`` times on the fixed-shape grower."""
    tf, _ = _port_grow(tt.grow_tree_fast, "forced")
    assert tf.split_feature[0] == 3 and tf.threshold_bin[0] == 15
    assert tf.split_feature[1] == 6 and tf.split_feature[2] == 1
    assert tf.split_gain[0] == 0.0 and tf.default_left[:3].all()
    ops = tt.flatten_forced_splits(FORCED, 15)
    assert ops == ((0, 3, 15), (1, 6, 10), (2, 1, 20))
    assert ops == jt.flatten_forced_splits(FORCED, 15)
    assert tt.flatten_forced_splits(None, 15) == ()
    # the num_leaves budget truncates the prefix
    assert len(tt.flatten_forced_splits(FORCED, 2)) == 1
    assert tt.histogram_launches([tf], 15, len(ops)) == 18


def _raise(*args, **kwargs):
    raise AssertionError("the fixed-shape grower read a tensor into Python")


@pytest.mark.parametrize("case", ["nan", "row_mask", "efb",
                                  "smooth_plus_mds", "feature_contri",
                                  "cat_forced_interaction",
                                  "mono_intermediate"])
def test_grower_never_reads_a_tensor_into_python(case, monkeypatch):
    p, _ = _inputs(case)
    params = tt.GrowerParams(**CASES[case][0])
    opts = {k: p[k] for k in ("categorical_mask", "interaction_constraints",
                              "monotone_constraints", "forced_splits")
            if k in p}
    g = tt.FixedGrower(p["binned"], p["B"], params, torch.float64,
                       nan_mask=p.get("nan_mask"),
                       binned_t=p.get("binned_t"), efb=p.get("efb"), **opts)
    n = p["binned"].shape[0]
    rm = p.get("row_mask", torch.ones(n, dtype=torch.bool))
    grad, hess = torch.as_tensor(p["grad"]), torch.as_tensor(p["hess"])
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    out = g.grow(grad, hess, rm, p["nb"])
    monkeypatch.undo()
    tf, rlf = _port_grow(tt.grow_tree_fast, case)
    assert torch.equal(out["row_leaf"], rlf)
    np.testing.assert_array_equal(out["leaf_value"].numpy(), tf.leaf_value)


@pytest.mark.parametrize("top", [0.0, 1e-30, 3.0, 2.0 ** -120, 1e30, 1e38])
def test_device_scales_are_the_host_scales(top):
    """The histogram kernel's fixed-point scales computed on the device
    (``fixed_point_scales_device``, the fixed-shape grower's) equal the
    host route's, exactly."""
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.uniform(-1, 1, 500) * top, dtype=torch.float32)
    h = torch.as_tensor(rng.uniform(0, 1, 500) * top, dtype=torch.float32)
    assert tuple(hk.fixed_point_scales_device(g, h).tolist()) == \
        hk.fixed_point_scales(g, h)


def test_grower_cache_is_a_bounded_lru():
    p, _ = _inputs("base")
    tt._FIXED_GROWERS.clear()
    first = tt.fixed_grower(p["binned"], B, tt.GrowerParams(**BASE),
                            torch.float64)
    assert tt.fixed_grower(p["binned"], B, tt.GrowerParams(**BASE),
                           torch.float64) is first
    for k in range(tt._FIXED_GROWERS_MAX):
        tt.fixed_grower(p["binned"], B, tt.GrowerParams(
            **dict(BASE, num_leaves=3 + k)), torch.float64)
    assert len(tt._FIXED_GROWERS) == tt._FIXED_GROWERS_MAX
    assert tt.fixed_grower(p["binned"], B, tt.GrowerParams(**BASE),
                           torch.float64) is not first
    tt._FIXED_GROWERS.clear()


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_gradient_that_is_not_finite_raises(bad):
    """A gradient that is not finite gives NaN leaves on the fixed-shape
    grower's device route (NaN fixed-point scales): ``grow_tree_fast``
    raises the host route's ``ValueError`` after its fetch instead of
    returning a NaN tree; on the CPU too."""
    p, _ = _inputs("base")
    grad = p["grad"].copy()
    grad[17] = bad
    with pytest.raises(ValueError, match="grow_tree_fast: a leaf value is "
                       "not finite"):
        tt.grow_tree_fast(p["binned"], p["nb"], torch.as_tensor(grad),
                          torch.as_tensor(p["hess"]), B,
                          tt.GrowerParams(**BASE))
    with pytest.raises(ValueError, match="not finite"):
        tt.check_finite_leaves(np.array([0.5, bad, 0.0]),
                               np.array([1, 1, 0]), "test")
    tt.check_finite_leaves(np.array([0.5, 1.0, bad]), np.array([1, 1, 0]),
                           "test")


def _numpy_group_scan(c_s, ok, min_data_per_group):
    """The host numpy group scan that ``_cat_scan`` ran before the kernel
    (float64 carry, sequential over the bins)."""
    carry = np.zeros(c_s.shape[0], np.float64)
    out = np.zeros(c_s.shape, bool)
    for b in range(c_s.shape[1]):
        cur = carry + c_s[:, b]
        out[:, b] = ok[:, b] & (cur >= min_data_per_group)
        carry = np.where(out[:, b], 0.0, cur)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mdpg", [1.0, 37.0, 100.0])
def test_group_boundaries_plain_matches_numpy_scan(dtype, mdpg):
    """``group_boundaries_plain`` (the CPU route of ``group_boundaries``,
    the kernel's plain version) gives the old host numpy scan's bits on
    random counts, integers as the histograms hold them."""
    rng = np.random.default_rng(int(mdpg))
    counts = rng.integers(0, 60, size=(6, 255)).astype(np.float64)
    counts[:, rng.uniform(size=255) < 0.2] = 0.0
    ok = rng.uniform(size=(6, 255)) < 0.8
    got = gk.group_boundaries(torch.as_tensor(counts, dtype=dtype),
                              torch.as_tensor(ok), mdpg)
    assert got.dtype == torch.bool and gk.group_boundaries.launches == 0
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_group_scan(counts, ok, mdpg))
    assert got.any() and not got.all()

