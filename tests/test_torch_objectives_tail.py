"""The boosting objectives without a GP (``regression_l1``, ``huber``,
``fair``, ``poisson``, ``gamma``, ``tweedie``, ``quantile``, ``mape``,
``tobit``, ``cross_entropy``, ``cross_entropy_lambda``,
``mean_scale_regression``, ``multiclass``, ``multiclassova``, and
``regression`` with ``reg_sqrt``) against the JAX package on the CPU, float64,
on numpy-seeded data (n = 300, 5 features, a label of each objective's
kind):

- initial scores and gradients / hessians at a random score: 1e-12;
- 5 rounds of ``train`` with bagging, feature fraction by tree and by node
  and a validation set: every tree splits on the same features at the same
  bins (the random draws come from numpy generators seeded and drawn as in
  the JAX package), leaf values within 1e-10, validation curves within
  1e-10, converted predictions within 1e-10 (``mean_scale_regression``: its
  ``pred_mean`` / ``pred_var`` dict).

Both packages break exact ties of split gains alike because the port's CPU
prefix sums follow XLA's order (``tree.prefix_sum``): a quantile gradient
takes two values, so its gains tie often.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting import objectives as jobj

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import objectives as tobj

N, NV = 300, 100
GRAD_TOL = 1e-12
LEAF_TOL = 1e-10
SAMPLING = {"bagging_fraction": 0.7, "bagging_freq": 2,
            "feature_fraction": 0.8, "feature_fraction_bynode": 0.8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = N + NV
    X = rng.uniform(size=(n, 5))
    f = 2 * X[:, 0] + np.sin(5 * X[:, 1])
    y = f + 0.3 * rng.standard_normal(n)
    mu = np.exp(f - 1)
    labels = {
        "regression": y, "regression_l1": y, "huber": y, "fair": y,
        "quantile": y, "mape": y, "mean_scale_regression": y,
        "poisson": rng.poisson(mu).astype(float),
        "gamma": mu * rng.gamma(2.0, 0.5, n),
        "tweedie": rng.poisson(mu) * rng.gamma(2.0, 0.5, n),
        "tobit": np.clip(f / 4 + 0.1 * rng.standard_normal(n), 0, 1),
        "cross_entropy": 1 / (1 + np.exp(-(f - 1.5))),
        "cross_entropy_lambda": 1 / (1 + np.exp(-(f - 1.5))),
        "multiclass": np.digitize(f, [1.0, 2.0]).astype(float),
        "multiclassova": np.digitize(f, [1.0, 2.0]).astype(float),
    }
    return dict(X=X, labels=labels, w=rng.uniform(0.5, 2.0, n),
                score=rng.standard_normal(3 * n))


OBJECTIVES = [
    ("regression_l1", {}), ("huber", {"alpha": 0.7}), ("fair", {"fair_c": 0.5}),
    ("poisson", {"poisson_max_delta_step": 0.5}), ("gamma", {}),
    ("tweedie", {"tweedie_variance_power": 1.3}), ("quantile", {"alpha": 0.3}),
    ("mape", {}), ("tobit", {"sigma": 0.2, "yl": 0.0, "yu": 1.0}),
    ("cross_entropy", {}), ("cross_entropy_lambda", {}),
    ("mean_scale_regression", {}), ("multiclass", {"num_class": 3}),
    ("multiclassova", {"num_class": 3}), ("regression", {"reg_sqrt": True}),
]
IDS = [o if not p else f"{o}-{next(iter(p))}" for o, p in OBJECTIVES]


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name,extra", OBJECTIVES, ids=IDS)
def test_init_scores_and_gradients_match_jax(data, name, extra, weighted):
    label = data["labels"][name][:N]
    w = data["w"][:N] if weighted else None
    oj = jobj.create_objective(name, dict(extra))
    ot = tobj.create_objective(name, dict(extra))
    oj.init(label, w)
    ot.init(label, w)
    assert ot.num_model_per_iteration == oj.num_model_per_iteration
    np.testing.assert_allclose(ot.init_scores(), oj.init_scores(), rtol=0,
                               atol=GRAD_TOL)
    K = oj.num_model_per_iteration
    score = data["score"][:K * N]
    gj, hj = oj.get_gradients(score)
    gt, ht = ot.get_gradients(score)
    np.testing.assert_allclose(gt, gj, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(ht, hj, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(ot.convert_output(score),
                               oj.convert_output(score), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def _same_trees(tb, jb):
    assert len(tb.trees) == len(jb.trees)
    for t, j in zip(tb.trees, jb.trees):
        it, ij = t.internal_nodes(), j.internal_nodes()
        np.testing.assert_array_equal(t.split_feature[it],
                                      j.split_feature[ij])
        np.testing.assert_array_equal(t.threshold_bin[it],
                                      j.threshold_bin[ij])
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=LEAF_TOL)


@pytest.mark.parametrize("name,extra", OBJECTIVES, ids=IDS)
def test_five_rounds_match_jax(data, name, extra):
    X, label = data["X"], data["labels"][name]
    params = dict({"objective": name, "num_leaves": 7,
                   "min_data_in_leaf": 10, "verbose": -1}, **SAMPLING,
                  **extra)
    out = []
    for pkg, kw in ((gpb, {}), (gpt, {"device": "cpu"})):
        ds = pkg.Dataset(X[:N], label=label[:N], **kw)
        dv = ds.create_valid(X[N:], label=label[N:])
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=5, valid_sets=[dv],
                        evals_result=ev, verbose_eval=False)
        out.append((bst, ev))
    (jb, ej), (tb, et) = out
    _same_trees(tb, jb)
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration()
    assert tb.current_iteration() == jb.current_iteration() == 5
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=LEAF_TOL)
    assert list(et["valid_0"]) == list(ej["valid_0"])
    for metric, curve in ej["valid_0"].items():
        np.testing.assert_allclose(et["valid_0"][metric], curve, rtol=0,
                                   atol=LEAF_TOL)
    pj, pt = jb.predict(X[N:]), tb.predict(X[N:])
    if name == "mean_scale_regression":
        assert set(pt) == set(pj) == {"pred_mean", "pred_var"}
        for key in pj:
            np.testing.assert_allclose(pt[key], pj[key], rtol=LEAF_TOL,
                                       atol=LEAF_TOL)
    else:
        np.testing.assert_allclose(pt, pj, rtol=LEAF_TOL, atol=LEAF_TOL)
    np.testing.assert_allclose(
        tb.predict(X[N:], raw_score=True, num_iteration=2),
        jb.predict(X[N:], raw_score=True, num_iteration=2), rtol=0,
        atol=LEAF_TOL)


@pytest.mark.parametrize("name", ["multiclass", "multiclassova"])
def test_multiclass_save_and_load(data, name, tmp_path):
    X, label = data["X"], data["labels"][name]
    ds = gpt.Dataset(X[:N], label=label[:N], device="cpu")
    bst = gpt.train({"objective": name, "num_class": 3, "num_leaves": 7,
                     "verbose": -1}, ds, num_boost_round=3)
    assert len(bst.trees) == 9 and bst.num_trees_per_iter == 3
    path = tmp_path / "model.json"
    bst.save_model(str(path))
    back = gpt.Booster(model_file=str(path), device="cpu")
    np.testing.assert_array_equal(back.predict(X[N:]), bst.predict(X[N:]))
    # the JAX package reads the port's file and predicts the same
    jback = gpb.Booster(model_file=str(path))
    np.testing.assert_allclose(jback.predict(X[N:]), bst.predict(X[N:]),
                               rtol=0, atol=1e-12)
    p = bst.predict(X[N:]).reshape(3, -1)
    if name == "multiclass":
        np.testing.assert_allclose(p.sum(0), 1.0, atol=1e-12)


@pytest.mark.parametrize("name,label,err", [
    ("tobit", -1.0, "yl, yu"), ("cross_entropy", 2.0, "lie in"),
    ("cross_entropy_lambda", 2.0, "lie in")])
def test_label_checks_match_jax(name, label, err):
    y = np.full(10, label)
    for mod in (jobj, tobj):
        obj = mod.create_objective(name, {})
        with pytest.raises(ValueError, match=err.replace(", ", ".*")
                           if name == "tobit" else err):
            obj.init(y, None)


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg", "xendcg"])
def test_ranking_objectives_raise(name):
    """Ported: the ranking objectives' gradients and hessians are the JAX
    package's — ``rank_xendcg``'s the same bits (the same host loop and
    draws, two rounds), ``lambdarank``'s within 1e-12 relative (the pairs'
    sums in another order)."""
    rng = np.random.default_rng(8)
    group = np.array([9, 1, 14, 6, 11])
    y = rng.integers(0, 4, group.sum()).astype(float)
    score = np.round(rng.normal(size=group.sum()), 1)   # tied scores too
    jo = jobj.create_objective(name, {})
    to = tobj.create_objective(name, {})
    jo.init(y, None, group=group)
    to.init(y, None, group=group)
    for _ in range(2):
        (gj, hj), (gt, ht) = jo.get_gradients(score), to.get_gradients(score)
        if name == "lambdarank":
            np.testing.assert_allclose(gt, gj, rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(ht, hj, rtol=1e-12)
        else:
            np.testing.assert_array_equal(gt, gj)
            np.testing.assert_array_equal(ht, hj)
