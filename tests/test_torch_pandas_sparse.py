"""pandas DataFrame / scipy.sparse input of the port (CPU), against the JAX
package on the same input; mirrors ``tests/test_pandas_sparse.py`` but its
``test_sklearn_dataframe`` (the scikit-learn wrappers are ROADMAP item 19).

Tolerances: feature names, categorical columns, levels and labels EQUAL;
predictions of the same training within 1e-10 of the JAX package's, and a
frame against its codes array within 1e-12 (the reference's own test).
The last test imports the port and trains from arrays with pandas made
unimportable: the card's machine has no pandas.
"""
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt

TOL = 1e-10
PARAMS = {"objective": "regression", "num_leaves": 7, "verbose": -1,
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


def _make_df(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=n)
    x1 = rng.uniform(size=n)
    cat = pd.Categorical(rng.choice(["a", "b", "c"], size=n),
                         categories=["a", "b", "c"])
    df = pd.DataFrame({"x0": x0, "x1": x1, "kind": cat})
    y = (x0 + np.where(np.asarray(cat) == "b", 2.0, 0.0)
         + 0.1 * rng.normal(size=n))
    return df, y


def test_dataframe_categorical_train_predict():
    df, y = _make_df()
    ds = gpt.Dataset(df, label=y, device="cpu")
    # column names become feature names; the category column is found
    assert ds.feature_name == ["x0", "x1", "kind"]
    assert ds.categorical_feature == [2]
    assert ds.pandas_categorical == [["a", "b", "c"]]
    params = dict(PARAMS, learning_rate=0.5)
    bst = gpt.train(params, ds, num_boost_round=3)
    jb = gpb.train(params, gpb.Dataset(df, label=y), num_boost_round=3)
    pred_df = bst.predict(df)
    np.testing.assert_allclose(pred_df, jb.predict(df), rtol=0, atol=TOL)
    # the same data as a plain codes array predicts the same
    arr = df.copy()
    arr["kind"] = df["kind"].cat.codes.astype(float)
    np.testing.assert_allclose(bst.predict(arr.to_numpy()), pred_df,
                               rtol=1e-12)
    # the categorical split was useful
    assert float(np.mean((y - pred_df) ** 2)) < 0.2 * float(np.var(y))


def test_dataframe_predict_reordered_levels():
    """A prediction frame whose Categorical declares the levels in another
    order maps through the TRAINING levels (pandas_categorical)."""
    df, y = _make_df()
    bst = gpt.train(PARAMS, gpt.Dataset(df, label=y, device="cpu"),
                    num_boost_round=3)
    base = bst.predict(df)
    df2 = df.copy()
    df2["kind"] = pd.Categorical(np.asarray(df["kind"]),
                                 categories=["c", "a", "b"])
    np.testing.assert_allclose(bst.predict(df2), base, rtol=1e-12)


def test_dataframe_bad_dtype_raises():
    df = pd.DataFrame({"x": [1.0, 2.0], "s": ["u", "v"]})
    with pytest.raises(ValueError, match="DataFrame.dtypes"):
        gpt.Dataset(df, label=[0.0, 1.0], device="cpu")


def test_dataframe_label_series():
    df, y = _make_df(n=120)
    ds = gpt.Dataset(df, label=pd.Series(y), device="cpu")
    np.testing.assert_allclose(ds.label, y)
    # an all-numeric frame trains as its array does
    num = df[["x0", "x1"]]
    b1 = gpt.train(PARAMS, gpt.Dataset(num, label=y, device="cpu"),
                   num_boost_round=3)
    b2 = gpt.train(PARAMS, gpt.Dataset(num.to_numpy(), label=y,
                                       device="cpu"), num_boost_round=3)
    np.testing.assert_array_equal(b1.predict(num), b2.predict(num))


def test_sparse_csr_train_predict():
    rng = np.random.default_rng(1)
    n, F = 500, 8
    dense = rng.normal(size=(n, F)) * (rng.uniform(size=(n, F)) < 0.3)
    y = dense[:, 0] + 2.0 * dense[:, 3] + 0.05 * rng.normal(size=n)
    params = dict(PARAMS, num_leaves=15)
    for maker in (sp.csr_matrix, sp.csc_matrix):
        ds = gpt.Dataset(maker(dense), label=y, device="cpu")
        assert ds.num_features == F
        bst = gpt.train(params, ds, num_boost_round=10)
        jb = gpb.train(params, gpb.Dataset(maker(dense), label=y),
                       num_boost_round=10)
        pred_sp = bst.predict(sp.csr_matrix(dense))
        pred_d = bst.predict(dense)
        np.testing.assert_allclose(pred_sp, pred_d, rtol=1e-12)
        np.testing.assert_allclose(pred_d, jb.predict(dense), rtol=0,
                                   atol=TOL)
        assert float(np.mean((y - pred_d) ** 2)) < 0.3 * float(np.var(y))


def test_dataframe_valid_set_shares_levels():
    df, y = _make_df(n=300, seed=2)
    dfv, yv = _make_df(n=100, seed=3)
    ds = gpt.Dataset(df, label=y, device="cpu")
    dv = gpt.Dataset(dfv, label=yv, reference=ds, device="cpu")
    assert dv.pandas_categorical == ds.pandas_categorical
    res = {}
    bst = gpt.train(PARAMS, ds, num_boost_round=2, valid_sets=[dv],
                    valid_names=["v"], callbacks=[gpt.record_evaluation(res)])
    # the validation score is the prediction of the frame through the
    # training levels
    np.testing.assert_allclose(res["v"]["l2"][-1],
                               np.mean((bst.predict(dfv) - yv) ** 2),
                               rtol=1e-12)


def test_model_roundtrip_keeps_pandas_categorical():
    df, y = _make_df(n=200, seed=4)
    bst = gpt.train(PARAMS, gpt.Dataset(df, label=y, device="cpu"),
                    num_boost_round=5)
    base = bst.predict(df)
    bst2 = gpt.Booster(model_str=bst.model_to_string(), device="cpu")
    np.testing.assert_allclose(bst2.predict(df), base, rtol=1e-12)
    # the JAX package reads the port's model, levels and all
    jb = gpb.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(jb.predict(df), base, rtol=0, atol=TOL)


def test_port_imports_and_trains_without_pandas():
    """The card's machine has no pandas: with ``sys.modules["pandas"] =
    None`` (an import of it raises) the port imports and trains from
    arrays, categorical features and sparse input included."""
    code = """
import sys
sys.modules["pandas"] = None
import numpy as np
import gpboost_tpu_torch as gpt
rng = np.random.default_rng(0)
X = np.column_stack([rng.uniform(size=300), rng.integers(0, 5, 300)])
y = X[:, 0] + X[:, 1]
b = gpt.train({"objective": "regression", "verbose": -1}, gpt.Dataset(
    X, label=y, categorical_feature=[1], device="cpu"), num_boost_round=2)
assert np.isfinite(b.predict(X)).all()
assert "pandas" not in {m.split(".")[0] for m in sys.modules
                        if sys.modules[m] is not None}
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
