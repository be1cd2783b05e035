"""Linear leaves (``linear_tree``) of the port vs the JAX package (CPU,
float64); mirrors ``tests/test_boosting_variants.py::test_linear_tree``.

Tolerances: the same tree structure, linear features and constants;
coefficients within 1e-8 (each leaf's ridge system is solved by LAPACK on
both sides, its sums taken in other orders); predictions within 1e-8. A
leaf whose system is singular keeps its constant, as in the JAX package.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.boosting import tree as jt
from gpboost_tpu_torch.boosting import tree as tt

COEF_TOL = 1e-8


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


def _same_linear(tb, jb, X):
    for t, j in zip(tb.trees, jb.trees):
        for name in ("split_feature", "threshold_bin", "is_leaf",
                     "lin_features"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                          err_msg=name)
        np.testing.assert_allclose(t.lin_coefs, j.lin_coefs, rtol=0,
                                   atol=COEF_TOL)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=COEF_TOL)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=COEF_TOL)


def test_linear_tree():
    """Linear leaf models (reference LinearTreeLearner) beat constant leaves
    on piecewise-linear targets; the model round trip keeps them."""
    rng = np.random.default_rng(0)
    n = 1000
    X = rng.uniform(size=(n, 4))
    y = np.where(X[:, 0] > 0.5, 3 * X[:, 1] + 1, -2 * X[:, 1]) \
        + 0.05 * rng.standard_normal(n)
    common = {"objective": "regression", "num_leaves": 7,
              "learning_rate": 0.5, "verbose": -1}
    b_plain = gpt.train(common, gpt.Dataset(X, label=y, device="cpu"),
                        num_boost_round=10)
    lin = {**common, "linear_tree": True, "linear_lambda": 0.1}
    b_lin = gpt.train(lin, gpt.Dataset(X, label=y, device="cpu"),
                      num_boost_round=10)
    j_lin = gpb.train(lin, gpb.Dataset(X, label=y), num_boost_round=10)
    _same_linear(b_lin, j_lin, X)
    mse_p = np.mean((b_plain.predict(X) - y) ** 2)
    mse_l = np.mean((b_lin.predict(X) - y) ** 2)
    assert mse_l < 0.6 * mse_p
    # the training score is the linear prediction
    np.testing.assert_allclose(b_lin._score, b_lin.predict(X), rtol=0,
                               atol=1e-12)
    # round trip with linear leaves, and either package's model
    b2 = gpt.Booster(model_str=b_lin.model_to_string(), device="cpu")
    np.testing.assert_array_equal(b2.predict(X), b_lin.predict(X))
    j2 = gpt.Booster(model_str=j_lin.model_to_string(), device="cpu")
    np.testing.assert_allclose(j2.predict(X), j_lin.predict(X), rtol=0,
                               atol=1e-12)


def test_linear_tree_with_categorical_split():
    rng = np.random.default_rng(1)
    n = 600
    X = np.column_stack([rng.uniform(size=n),
                         rng.integers(0, 6, n).astype(float)])
    eff = np.array([0.0, 1.0, -1.0, 2.0, 0.5, -2.0])
    y = 3 * X[:, 0] + eff[X[:, 1].astype(int)] \
        + 0.05 * rng.standard_normal(n)
    params = {"objective": "regression", "num_leaves": 4, "verbose": -1,
              "min_data_in_leaf": 5, "linear_tree": True}
    tb = gpt.train(params, gpt.Dataset(X, label=y, categorical_feature=[1],
                                       device="cpu"), num_boost_round=1)
    jb = gpb.train(params, gpb.Dataset(X, label=y, categorical_feature=[1]),
                   num_boost_round=1)
    _same_linear(tb, jb, X)
    assert any(t.has_categorical() for t in tb.trees)
    # a categorical split is no linear feature
    for t in tb.trees:
        assert not set(t.lin_features[t.lin_features >= 0].tolist()) - {0}


def test_singular_leaf_keeps_its_constant():
    """A leaf whose ridge system is singular (a zero first column: hessians
    summing to -1e-6 with a centred feature) keeps its constant; its
    sibling gets its linear model; the same as the JAX package."""
    X = np.array([[0.5], [0.0], [1.0], [2.0], [3.0], [4.0], [5.0]])
    grad = np.array([1.0, 0.0, 0.0, -1.0, -2.0, 0.5, -0.5])
    hess = np.array([-1e-6, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0])
    row_leaf = np.array([1, 1, 1, 2, 2, 2, 2], np.int32)

    def tree(pkg):
        return pkg.Tree(
            split_feature=np.zeros(3, np.int32), threshold=np.array(
                [1.5, 0.0, 0.0]), threshold_bin=np.zeros(3, np.int32),
            left=np.array([1, 1, 2], np.int32),
            right=np.array([2, 1, 2], np.int32),
            leaf_value=np.array([0.0, 0.25, -0.5]),
            is_leaf=np.array([False, True, True]),
            is_categorical=np.zeros(3, bool))

    t = tt.fit_linear_leaves(tree(tt), torch.as_tensor(X),
                             torch.as_tensor(row_leaf), torch.as_tensor(grad),
                             torch.as_tensor(hess))
    j = jt.fit_linear_leaves(tree(jt), X, row_leaf, grad, hess)
    np.testing.assert_array_equal(t.lin_features, j.lin_features)
    assert t.lin_features[1, 0] == -1 and t.leaf_value[1] == 0.25
    assert t.lin_features[2, 0] == 0
    np.testing.assert_allclose(t.lin_coefs, j.lin_coefs, rtol=0,
                               atol=COEF_TOL)
    np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                               atol=COEF_TOL)
