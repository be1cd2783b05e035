"""The port's model formats and prediction options against the JAX package
(CPU, float64): the reference's text model format (``model_text.py``) both
ways between the packages, the C export (``convert.py``, compiled with the
host's ``gcc``), leaf indices, SHAP contributions (``shap.py``), the
prediction early stop, and JSON models of DART, random forests and Nesterov
acceleration. Mirrors the JAX package's ``tests/test_convert_model.py``,
``test_pred_early_stop.py``, ``test_model_text_interop.py::
test_text_roundtrip_without_reference``, ``test_ranking_tail.py::
test_xentlambda_reference_model_conversion_and_metric_exact`` and
``test_boosting_basic.py::test_pred_leaf``.

Tolerances: predictions after a text or JSON round trip 1e-10 (the text
format adds the initial score to the first tree's leaves); the C source's
predictions 1e-10 relative (1e-9 for linear leaves and softmax); SHAP
contributions 1e-12 of the JAX package's and rows summing to the raw score
within 1e-9; leaf indices and the early-stopped scores exact against their
emulation (1e-12).
"""
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting.convert import booster_to_c as jax_booster_to_c

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import metrics as tmet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once (see tests/test_torch_boosting.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compile_and_load(src: str, tmp_path, tag: str):
    cfile = tmp_path / f"model_{tag}.c"
    sofile = tmp_path / f"model_{tag}.so"
    cfile.write_text(src)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(sofile),
                    str(cfile), "-lm"], check=True)
    lib = ctypes.CDLL(str(sofile))
    for fn in (lib.predict_raw, lib.predict):
        fn.argtypes = [ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double)]
        fn.restype = None
    return lib


def _c_predict(lib, X, num_outputs, raw=False):
    out = np.zeros((X.shape[0], num_outputs))
    row = (ctypes.c_double * X.shape[1])()
    res = (ctypes.c_double * num_outputs)()
    fn = lib.predict_raw if raw else lib.predict
    for i in range(X.shape[0]):
        row[:] = [float(v) for v in X[i]]
        fn(row, res)
        out[i] = list(res)
    return out


_NUM = re.compile(r"-?\d+\.\d*(?:e[-+]?\d+)?|-?\d+e[-+]?\d+")


def _same_up_to_rounding(a: str, b: str, rtol=1e-12):
    """Two model texts or C sources with the same structure and numbers
    within ``rtol`` (the packages' leaf sums differ in their last bits)."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b)
    x = np.array([float(v) for v in _NUM.findall(a)])
    y = np.array([float(v) for v in _NUM.findall(b)])
    np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-300)


def _train(params, X, y, rounds, **dkw):
    tb = gpt.train(dict(params), gpt.Dataset(X, label=y, device="cpu",
                                              **dkw), num_boost_round=rounds)
    jb = gpb.train(dict(params), gpb.Dataset(X, label=y, **dkw),
                   num_boost_round=rounds)
    return tb, jb


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((300, 6))
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.1 * rng.standard_normal(300)
    return X, y


@pytest.fixture(scope="module")
def reg_model(reg_data):
    X, y = reg_data
    return _train({"objective": "regression", "num_leaves": 15,
                   "verbose": -1}, X, y, 8)


def test_text_roundtrip_without_reference():
    """Self round trip through the text format, categorical splits too."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(400, 4))
    X[:, 3] = rng.integers(0, 6, size=400)
    y = (X[:, 0] + 0.5 * np.sin(3 * X[:, 1])
         + np.where(X[:, 3] >= 3, 1.5, -0.5) + 0.05 * rng.normal(size=400))
    ours = gpt.train({"objective": "regression", "num_leaves": 9,
                      "min_data_in_leaf": 5, "verbose": -1,
                      "min_data_per_group": 5},
                     gpt.Dataset(X, label=y, categorical_feature=[3],
                                 device="cpu"), num_boost_round=10)
    s = ours.model_to_string(format="text")
    again = gpt.Booster(model_str=s, device="cpu")
    np.testing.assert_allclose(again.predict(X), ours.predict(X),
                               rtol=1e-10, atol=1e-10)
    assert any(t.has_categorical() for t in again.trees)


def test_text_models_between_the_packages(reg_data, reg_model, tmp_path):
    """The text model the port writes is the JAX package's text for the
    same trees (its numbers within 1e-12), each package loads the other's,
    and a ``.txt`` file round-trips through ``save_model`` /
    ``Booster(model_file=)``."""
    X, _ = reg_data
    tb, jb = reg_model
    _same_up_to_rounding(tb.model_to_string(format="text"),
                         jb.model_to_string(format="text"))
    from_jax = gpt.Booster(model_str=jb.model_to_string(format="text"),
                           device="cpu")
    np.testing.assert_allclose(from_jax.predict(X), jb.predict(X),
                               rtol=1e-10, atol=1e-10)
    tb.save_model(str(tmp_path / "m.txt"))
    jax_reads = gpb.Booster(model_file=str(tmp_path / "m.txt"))
    np.testing.assert_allclose(jax_reads.predict(X), tb.predict(X),
                               rtol=1e-10, atol=1e-10)
    back = gpt.Booster(model_file=str(tmp_path / "m.txt"), device="cpu")
    np.testing.assert_allclose(back.predict(X, num_iteration=3),
                               tb.predict(X, num_iteration=3), rtol=1e-10,
                               atol=1e-10)
    # the python dict of the JSON model, and a model from a string
    assert tb.dump_model()["trees"] == json.loads(tb.model_to_string())[
        "trees"]
    again = gpt.Booster.model_from_string(tb.model_to_string(),
                                          device="cpu")
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))


def test_reference_text_model_conversion_and_metric_exact():
    """The reference GPBoost's xentlambda text model (the JAX package's
    goldens): predictions within 1e-10 of the reference's and its metric
    value."""
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "ranking_goldens.json")) as f:
        G = json.load(f)
    rng = np.random.default_rng(42)
    n = 300
    X = rng.normal(0, 1, (n, 4))
    p = 1 / (1 + np.exp(-(X[:, 0] - 0.5 * X[:, 1])))
    y = rng.binomial(1, p).astype(float)
    w = rng.uniform(0.5, 2.0, n)
    bst = gpt.Booster(model_str=G["xentlambda_model_txt"], device="cpu")
    pred = bst.predict(X)
    np.testing.assert_allclose(pred[:10], np.array(G["xentlambda_pred_head"]),
                               rtol=1e-10)
    val = tmet.cross_entropy_lambda(y, pred, w)
    assert val == pytest.approx(G["xentlambda_curve"][-1], abs=1e-10)


@pytest.mark.parametrize("case", ["regression", "nan", "binary",
                                  "multiclass", "categorical", "linear"])
def test_convert_model(reg_data, reg_model, case, tmp_path):
    """The generated C reproduces ``predict`` (and the raw score); for the
    regression models its source is the JAX package's (numbers within
    1e-12)."""
    X, y = reg_data
    rng = np.random.default_rng(5)
    K, Xq = 1, X[:50]
    if case in ("regression", "nan"):
        tb, jb = reg_model
        if case == "nan":
            Xq = X[:20].copy()
            Xq[::2, 0] = np.nan
    elif case == "binary":
        tb, jb = _train({"objective": "binary", "verbose": -1}, X,
                        (y > np.median(y)).astype(float), 8)
    elif case == "multiclass":
        K = 3
        Xm = rng.standard_normal((300, 4))
        ym = ((Xm[:, 0] + 0.3 * rng.standard_normal(300) > 0).astype(int)
              + (Xm[:, 1] > 0.8).astype(int))
        tb, jb = _train({"objective": "multiclass", "num_class": 3,
                         "verbose": -1}, Xm, ym, 6)
        Xq = Xm[:40]
    elif case == "categorical":
        cat = rng.integers(0, 6, size=400).astype(float)
        x1 = rng.standard_normal(400)
        Xq = np.column_stack([cat, x1])
        yc = (np.where(np.isin(cat, [1, 4]), 2.0, -1.0) + 0.5 * x1
              + 0.05 * rng.standard_normal(400))
        # the JAX package's categorical scan is eager (~1 s a leaf here)
        tb, jb = _train({"objective": "regression", "verbose": -1,
                         "min_data_in_leaf": 5, "num_leaves": 4}, Xq, yc, 2,
                        categorical_feature=[0])
        Xq = Xq[:60]
    else:
        tb, jb = _train({"objective": "regression", "verbose": -1,
                         "linear_tree": True}, X, y, 5)
    src = tb.model_to_c()
    # the same trees as the JAX package's where no exact gain tie can
    # break otherwise (binary and multiclass gradients take few values at
    # first; a categorical left set ties with its mirror image)
    if case in ("regression", "nan", "linear"):
        _same_up_to_rounding(src, jax_booster_to_c(jb).replace(
            "gpboost_tpu convert_model", "gpboost_tpu_torch convert_model"))
    lib = _compile_and_load(src, tmp_path, case)
    rtol = 1e-9 if case in ("multiclass", "linear") else 1e-10
    want = np.asarray(tb.predict(Xq)).reshape(K, -1).T
    np.testing.assert_allclose(_c_predict(lib, Xq, K), want, rtol=rtol,
                               atol=1e-12)
    raw = np.asarray(tb.predict(Xq, raw_score=True)).reshape(K, -1).T
    np.testing.assert_allclose(_c_predict(lib, Xq, K, raw=True), raw,
                               rtol=rtol, atol=1e-12)
    tb.save_model_to_c(str(tmp_path / "saved.c"))
    assert (tmp_path / "saved.c").read_text() == src


def test_pred_leaf(reg_data, reg_model):
    X, _ = reg_data
    tb, jb = reg_model
    leaves = tb.predict(X[:50], pred_leaf=True)
    assert leaves.shape == (50, 8) and leaves.max() < 15
    np.testing.assert_array_equal(leaves, jb.predict(X[:50], pred_leaf=True))
    np.testing.assert_array_equal(tb.predict(X[:50], pred_leaf=True,
                                             num_iteration=3), leaves[:, :3])
    # each leaf index names the leaf whose value the tree gives the row
    vals = np.stack([t.leaf_value[t.leaf_index_order()[leaves[:, k]]]
                     for k, t in enumerate(tb.trees)], axis=1)
    np.testing.assert_allclose(vals.sum(1) + tb.init_score[0],
                               tb.predict(X[:50], raw_score=True), rtol=0,
                               atol=1e-12)


def test_shap_sums_to_prediction():
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(600, 8))
    y = (2 * X[:, 0] + np.sin(5 * X[:, 1]) + (X[:, 2] > 0.5)
         + 0.1 * rng.standard_normal(600))
    tb, jb = _train({"objective": "regression", "num_leaves": 7,
                     "verbose": -1}, X, y, 5)
    sub = X[:20]
    contrib = tb.predict(sub, pred_contrib=True)
    assert contrib.shape == (20, X.shape[1] + 1)
    np.testing.assert_allclose(contrib, jb.predict(sub, pred_contrib=True),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(contrib.sum(axis=1),
                               tb.predict(sub, raw_score=True), atol=1e-9)
    # the informative features get most of the attribution
    imp = np.abs(contrib[:, :-1]).mean(axis=0)
    assert set(np.argsort(imp)[-3:]) == {0, 1, 2}


def _emulate(bst, X, n_iter, num_models, kind, freq, margin):
    """The reference's prediction early stop from per-iteration raw
    predictions (the JAX package's test_pred_early_stop.py)."""
    n = X.shape[0]
    base = np.broadcast_to(np.asarray(bst.init_score)[:, None],
                           (num_models, n)).copy()
    raws = [base] + [
        np.asarray(bst.predict(X, raw_score=True, num_iteration=i)
                   ).reshape(num_models, n)
        for i in range(1, n_iter + 1)]
    smat = base.copy()
    active = np.ones(n, dtype=bool)
    for i in range(1, n_iter + 1):
        delta = raws[i] - raws[i - 1]
        smat[:, active] += delta[:, active]
        if i % freq == 0:
            if kind == "binary":
                m = 2.0 * np.abs(smat[0])
            else:
                top2 = np.sort(smat, axis=0)[-2:]
                m = top2[1] - top2[0]
            active &= m <= margin
    return smat


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_early_stop(kind):
    rng = np.random.default_rng(9 if kind == "binary" else 11)
    if kind == "binary":
        X = rng.standard_normal((400, 5))
        y = (X[:, 0] + 0.2 * rng.standard_normal(400) > 0).astype(float)
        params, rounds, K, margin = {"objective": "binary"}, 40, 1, 1.0
    else:
        X = rng.standard_normal((300, 4))
        y = np.clip((X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5), 0, 2)
        params = {"objective": "multiclass", "num_class": 3}
        rounds, K, margin = 25, 3, 0.5
    tb, jb = _train(dict(params, verbose=-1), X, y, rounds)
    full = tb.predict(X, raw_score=True)
    stop = dict(pred_early_stop=True, pred_early_stop_freq=5,
                pred_early_stop_margin=margin)
    for b in (tb, jb):
        b.params.update(stop)
    es = tb.predict(X, raw_score=True)
    assert not np.allclose(full, es)        # confident rows stopped early
    if kind == "binary":
        # the same trees as the JAX package's here (multiclass meets an
        # exact gain tie that breaks otherwise)
        np.testing.assert_allclose(es, jb.predict(X, raw_score=True),
                                   rtol=0, atol=1e-12)
    tb.params["pred_early_stop"] = False
    want = _emulate(tb, X, rounds, K, kind, 5, margin).reshape(-1)
    np.testing.assert_allclose(es, want, rtol=1e-12)
    # a huge margin: the full prediction
    tb.params.update(pred_early_stop=True, pred_early_stop_margin=1e300)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), full)


@pytest.mark.parametrize("extra", [
    {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.3},
    {"boosting": "rf", "feature_fraction": 0.8},
    {"use_nesterov_acc": True, "nesterov_acc_rate": 0.3,
     "momentum_schedule_version": 0, "momentum_offset": 2}],
    ids=["dart", "rf", "nesterov"])
def test_saved_models_predict_alike(reg_data, extra):
    """A DART, random-forest or Nesterov model saved by the JAX package
    predicts the same in the port (its averaging and momentum replay come
    from the saved parameters), and back."""
    X, y = reg_data
    params = dict({"objective": "regression", "num_leaves": 15,
                   "learning_rate": 0.25, "verbose": -1}, **extra)
    tb, jb = _train(params, X, y, 8)
    from_jax = gpt.Booster(model_str=jb.model_to_string(), device="cpu")
    assert from_jax.boosting_type == tb.boosting_type
    np.testing.assert_allclose(from_jax.predict(X), jb.predict(X), rtol=0,
                               atol=1e-12)
    from_port = gpb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(from_port.predict(X), tb.predict(X), rtol=0,
                               atol=1e-12)
