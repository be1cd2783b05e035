"""Validation sets, metrics, callbacks, early stopping, bagging and feature
sampling, ``fobj`` / ``feval`` and the GP-aware validation
(``use_gp_model_for_validation`` with ``set_prediction_data``, the four GP
metrics) of the port against the JAX package on the CPU, float64, on
numpy-seeded data (n <= 500, at most 10 rounds where no early stopping cuts
them).

Mirrors ``tests/test_boosting_basic.py::test_early_stopping_and_eval`` and
``::test_bagging_feature_fraction``, ``tests/test_boosting_fixes.py::
test_bagging_freq_reuses_bag``, ``::test_no_bagging_when_freq_zero`` and the
four ``test_gp_metric_*`` tests (a grouped GP, and a Vecchia GP beside
them), each with the JAX package's result as the reference:

- trees: the same split features and bins; training scores and leaf values
  within 1e-10 without a GP, within 1e-9 with one (the covariance refits
  stop on the optimizers' own criteria);
- validation curves within 1e-10 (1e-9 with a GP), ``best_iteration``
  equal, the bags equal mask by mask; with a Poisson GP (LaGaBoost, whose
  Laplace gradients agree to ~1e-11) the curves of the trees' validation
  score within 1e-2 relative (``test_gp_metric_test_nll_non_gaussian``
  says why).
"""
import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting.booster import Booster as JBooster

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import callback as tcb

TOL = 1e-10
GP_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = ((gpb, {}), (gpt, {"device": "cpu"}))


@pytest.fixture(scope="module")
def reg_data():
    """``tests/test_boosting_basic.py``'s recipe at n = 500."""
    rng = np.random.default_rng(42)
    n, F = 500, 10
    X = rng.uniform(size=(n, F))
    y = (2 * X[:, 0] + np.sin(5 * X[:, 1]) + (X[:, 2] > 0.6) * 1.5
         + 0.1 * rng.standard_normal(n))
    return X, y


def _make_reg(n=300, F=4, seed=0):
    """``tests/test_boosting_fixes.py``'s ``_make_reg``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    y = 2.0 * X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=n)
    return X, y


def _grouped_boost_data(seed=0, n=240, n_groups=24):
    """``tests/test_boosting_fixes.py``'s ``_grouped_boost_data``."""
    rng = np.random.default_rng(seed)
    group = np.arange(n) % n_groups
    b_re = 0.8 * rng.normal(size=n_groups)
    X = rng.uniform(size=(n, 2))
    f = 2.0 * np.sin(4.0 * X[:, 0])
    y = f + b_re[group] + 0.3 * rng.normal(size=n)
    return X, y, group


def _same_trees(tb, jb, tol=TOL):
    assert len(tb.trees) == len(jb.trees)
    for t, j in zip(tb.trees, jb.trees):
        it, ij = t.internal_nodes(), j.internal_nodes()
        np.testing.assert_array_equal(t.split_feature[it],
                                      j.split_feature[ij])
        np.testing.assert_array_equal(t.threshold_bin[it],
                                      j.threshold_bin[ij])
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=tol)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=tol)


def _same_curves(et, ej, tol=TOL):
    assert list(et) == list(ej)
    for name in ej:
        assert list(et[name]) == list(ej[name])
        for metric, curve in ej[name].items():
            np.testing.assert_allclose(et[name][metric], curve, rtol=0,
                                       atol=tol, err_msg=f"{name} {metric}")


def _train_both(params, X, y, split, rounds, gp=None, pred=None, **kw):
    """Train the JAX package and the port on the same data; ``gp`` builds a
    GPModel from (package, its keyword arguments), ``pred`` gives its
    ``set_prediction_data`` keywords."""
    out = []
    for pkg, dkw in PKGS:
        ds = pkg.Dataset(X[:split], label=y[:split], **dkw)
        dv = ds.create_valid(X[split:], label=y[split:])
        model = None
        if gp is not None:
            model = gp(pkg, dkw)
            if pred is not None:
                model.set_prediction_data(**pred)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=rounds, gp_model=model,
                        valid_sets=[dv], evals_result=ev, verbose_eval=False,
                        **kw)
        out.append((bst, ev, model))
    return out


def test_early_stopping_and_eval(reg_data):
    X, y = reg_data
    (jb, ej, _), (tb, et, _) = _train_both(
        {"objective": "regression", "learning_rate": 0.8, "verbose": -1},
        X, y, 400, 100, early_stopping_rounds=3)
    assert tb.best_iteration == jb.best_iteration > 0
    assert len(et["valid_0"]["l2"]) < 100
    _same_curves(et, ej)
    _same_trees(tb, jb)
    # the trees after the best iteration stay; predict takes the best
    assert tb.current_iteration() == len(et["valid_0"]["l2"])
    np.testing.assert_allclose(tb.predict(X[400:]), jb.predict(X[400:]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tb.predict(X[400:]),
        tb.predict(X[400:], num_iteration=tb.best_iteration), rtol=0, atol=0)
    # eval / eval_train / eval_valid
    dv = tb.valid_sets[0]
    assert tb.eval(dv, "valid_0") == tb.eval_valid()
    assert tb.eval_valid()[0][:2] == ("valid_0", "l2")
    np.testing.assert_allclose(tb.eval_train()[0][2],
                               jb.eval_train()[0][2], rtol=0, atol=TOL)


@pytest.mark.parametrize("form", ["keyword", "params"])
def test_early_stopping_forms_and_first_metric_only(reg_data, form):
    X, y = reg_data
    params = {"objective": "regression", "learning_rate": 0.8,
              "metric": ["l1", "l2"], "first_metric_only": True,
              "verbose": -1}
    kw = {"early_stopping_rounds": 2}
    if form == "params":
        params["early_stopping_round"] = 2
        kw = {}
    (jb, ej, _), (tb, et, _) = _train_both(params, X, y, 400, 60, **kw)
    assert tb.best_iteration == jb.best_iteration > 0
    _same_curves(et, ej)


def test_bagging_feature_fraction(reg_data):
    X, y = reg_data
    params = {"objective": "regression", "bagging_fraction": 0.7,
              "bagging_freq": 1, "feature_fraction": 0.7, "verbose": -1}
    out = []
    for pkg, kw in PKGS:
        bst = pkg.train(params, pkg.Dataset(X, label=y, **kw),
                        num_boost_round=10)
        out.append(bst)
    jb, tb = out
    _same_trees(tb, jb)
    mse = np.mean((tb.predict(X) - y) ** 2)
    assert mse < 0.5 * np.var(y)


@pytest.mark.parametrize("seeds", [{}, {"bagging_seed": 5},
                                   {"feature_fraction_seed": 7, "seed": 3}],
                         ids=["one_stream", "bagging_seed", "ff_seed"])
def test_sampling_streams_match_jax(seeds):
    X, y = _make_reg(n=300, F=6)
    params = dict({"objective": "regression", "bagging_fraction": 0.6,
                   "bagging_freq": 2, "feature_fraction": 0.7,
                   "feature_fraction_bynode": 0.6, "min_data_in_leaf": 5,
                   "num_leaves": 7, "verbose": -1}, **seeds)
    out = []
    for pkg, kw in PKGS:
        out.append(pkg.train(params, pkg.Dataset(X, label=y, **kw),
                             num_boost_round=6))
    _same_trees(out[1], out[0])


@pytest.mark.parametrize("labels", ["balanced"])
def test_balanced_bagging_matches_jax(labels):
    """The class-wise bags equal mask by mask, and the trees. At the
    default ``min_data_in_leaf``: with 5 a leaf of this data becomes pure,
    every split of it has a gain that is 0 in exact arithmetic, and whether
    its rounding (~1e-14) lands above 0 depends on the last bit of XLA's
    fused gain arithmetic, which the port does not copy."""
    X, y = _make_reg()
    yb = (y > 0).astype(float)
    params = {"objective": "binary", "pos_bagging_fraction": 0.5,
              "neg_bagging_fraction": 0.9, "bagging_freq": 1,
              "verbose": -1}
    out = []
    for pkg, kw in PKGS:
        b = (JBooster if pkg is gpb else gpt.Booster)(
            params=params, train_set=pkg.Dataset(X, label=yb, **kw))
        masks = []
        for _ in range(3):
            b.update()
            masks.append(np.asarray(b._bag_mask))
        out.append((b, masks))
    (jb, mj), (tb, mt) = out
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    _same_trees(tb, jb)


def test_bagging_freq_reuses_bag():
    X, y = _make_reg()
    masks = {}
    for pkg, kw in PKGS:
        b = (JBooster if pkg is gpb else gpt.Booster)(
            params={"bagging_fraction": 0.5, "bagging_freq": 2,
                    "min_data_in_leaf": 5},
            train_set=pkg.Dataset(X, label=y, **kw))
        masks[pkg] = []
        for _ in range(4):
            b.update()
            masks[pkg].append(np.asarray(b._bag_mask))
    m = masks[gpt]
    # redraw at it 0 and 2; reuse at 1 and 3
    assert np.array_equal(m[0], m[1])
    assert not np.array_equal(m[1], m[2])
    assert np.array_equal(m[2], m[3])
    for a, b in zip(m, masks[gpb]):
        np.testing.assert_array_equal(a, b)


def test_no_bagging_when_freq_zero():
    X, y = _make_reg()
    for pkg, kw in PKGS:
        b = (JBooster if pkg is gpb else gpt.Booster)(
            params={"bagging_fraction": 0.5, "bagging_freq": 0,
                    "min_data_in_leaf": 5},
            train_set=pkg.Dataset(X, label=y, **kw))
        b.update()
        assert b._bag_mask is None


def test_crps_and_test_nll_without_a_gp(reg_data):
    """``crps_gaussian`` / ``test_neg_log_likelihood`` without a gp_model:
    the training residual variance as the predictive variance."""
    X, y = reg_data
    (jb, ej, _), (tb, et, _) = _train_both(
        {"objective": "regression", "verbose": -1,
         "metric": ["crps_gaussian", "test_neg_log_likelihood"]},
        X, y, 400, 8)
    _same_curves(et, ej)
    assert et["valid_0"]["crps_gaussian"][-1] < \
        et["valid_0"]["crps_gaussian"][0]


def test_mean_scale_crps(reg_data):
    X, y = reg_data
    (jb, ej, _), (tb, et, _) = _train_both(
        {"objective": "mean_scale_regression", "verbose": -1,
         "metric": "crps_gaussian"}, X, y, 400, 5)
    _same_curves(et, ej)
    with pytest.raises(ValueError, match="mean_scale_regression"):
        tb.metric_names = ["test_neg_log_likelihood"]
        tb.eval_valid()


def _grouped_gp(group):
    return lambda pkg, kw: pkg.GPModel(group_data=group,
                                       likelihood="gaussian", **kw)


def test_gp_metric_neg_log_likelihood_train():
    X, y, group = _grouped_boost_data()
    out = []
    for pkg, kw in PKGS:
        gp = pkg.GPModel(group_data=group, likelihood="gaussian", **kw)
        b = pkg.train({"objective": "regression", "verbose": -1,
                       "min_data_in_leaf": 10},
                      pkg.Dataset(X, label=y, **kw), gp_model=gp,
                      num_boost_round=3)
        b.metric_names = ["neg_log_likelihood"]
        res = b.eval_train()
        assert res[0][1] == "neg_log_likelihood"
        expected = float(gp.neg_log_likelihood(
            cov_pars=gp.cov_pars_, y=y - np.asarray(b._score[:len(y)])))
        assert abs(res[0][2] - expected) < 1e-8
        with pytest.raises(ValueError):
            b.metric_names = ["test_neg_log_likelihood"]
            b.eval_train()
        out.append(res[0][2])
    assert abs(out[1] - out[0]) <= GP_TOL * abs(out[0])


def test_gp_metric_approx_nll_non_gaussian_train():
    """``approx_neg_marginal_log_likelihood`` on the training data of a
    Poisson GP (the Laplace NLL at the current parameters and the trees'
    score); validation data refuse it, as in the JAX package."""
    rng = np.random.default_rng(2)
    n, n_groups = 200, 20
    group = np.arange(n) % n_groups
    X = rng.uniform(size=(n, 2))
    y = rng.poisson(np.exp(np.sin(3 * X[:, 0]) - 0.3
                           + 0.5 * rng.normal(size=n_groups)[group]))
    out = []
    for pkg, kw in PKGS:
        gp = pkg.GPModel(group_data=group, likelihood="poisson", **kw)
        ds = pkg.Dataset(X, label=y.astype(float), **kw)
        b = pkg.train({"objective": "poisson", "verbose": -1,
                       "min_data_in_leaf": 10}, ds, gp_model=gp,
                      num_boost_round=2)
        b.metric_names = ["approx_neg_marginal_log_likelihood"]
        out.append(b.eval_train()[0][2])
        b.add_valid(ds.create_valid(X[:20], label=y[:20].astype(float)),
                    "v")
        with pytest.raises(ValueError, match="only for training data"):
            b.eval_valid()
    # the Laplace mode finders stop on their own criteria: 1e-8 relative
    assert abs(out[1] - out[0]) <= 1e-8 * abs(out[0])


def test_gp_metric_test_nll_early_stopping():
    X, y, group = _grouped_boost_data()
    tr = np.arange(len(y)) % 4 != 0
    order = np.r_[np.flatnonzero(tr), np.flatnonzero(~tr)]
    X, y, group = X[order], y[order], group[order]
    split = int(tr.sum())
    (jb, ej, jg), (tb, et, tg) = _train_both(
        {"objective": "regression", "metric": "test_neg_log_likelihood",
         "min_data_in_leaf": 10, "learning_rate": 0.2, "verbose": -1},
        X, y, split, 50, gp=_grouped_gp(group[:split]),
        pred={"group_data_pred": group[split:]}, early_stopping_rounds=5)
    curve = et["valid_0"]["test_neg_log_likelihood"]
    assert len(curve) >= 6
    assert min(curve) < curve[0]
    assert tb.best_iteration == int(np.argmin(curve)) + 1 == jb.best_iteration
    _same_curves(et, ej, GP_TOL)
    _same_trees(tb, jb, GP_TOL)
    np.testing.assert_allclose(tg.get_cov_pars(),
                               np.asarray(jg.get_cov_pars()), rtol=GP_TOL)


def test_gp_metric_crps_gaussian():
    X, y, group = _grouped_boost_data(seed=3)
    tr = np.arange(len(y)) % 4 != 0
    order = np.r_[np.flatnonzero(tr), np.flatnonzero(~tr)]
    X, y, group = X[order], y[order], group[order]
    split = int(tr.sum())
    (jb, ej, _), (tb, et, _) = _train_both(
        {"objective": "regression", "metric": "crps_gaussian",
         "min_data_in_leaf": 10, "verbose": -1,
         "bagging_fraction": 0.8, "bagging_freq": 1},
        X, y, split, 10, gp=_grouped_gp(group[:split]),
        pred={"group_data_pred": group[split:]})
    curve = et["valid_0"]["crps_gaussian"]
    assert len(curve) == 10 and np.all(np.isfinite(curve))
    assert curve[-1] < curve[0]
    _same_curves(et, ej, GP_TOL)
    _same_trees(tb, jb, GP_TOL)


def test_gp_metric_test_nll_non_gaussian():
    rng = np.random.default_rng(5)
    n, n_groups = 300, 30
    group = np.arange(n) % n_groups
    b_re = 0.6 * rng.normal(size=n_groups)
    X = rng.uniform(size=(n, 2))
    f = 1.2 * np.sin(4.0 * X[:, 0]) - 0.5
    y = rng.poisson(np.exp(f + b_re[group])).astype(float)
    tr = np.arange(n) % 4 != 0
    order = np.r_[np.flatnonzero(tr), np.flatnonzero(~tr)]
    X, y, group = X[order], y[order], group[order]
    split = int(tr.sum())
    gp = (lambda pkg, kw: pkg.GPModel(group_data=group[:split],
                                      likelihood="poisson", **kw))
    (jb, ej, _), (tb, et, _) = _train_both(
        {"objective": "poisson", "min_data_in_leaf": 10, "verbose": -1,
         "metric": ["test_neg_log_likelihood", "crps_gaussian", "poisson"]},
        X, y, split, 8, gp=gp, pred={"group_data_pred": group[split:]})
    curve = et["valid_0"]["test_neg_log_likelihood"]
    assert len(curve) == 8 and np.all(np.isfinite(curve))
    assert curve[-1] < curve[0]
    # the Laplace gradients agree to ~1e-11, so the training scores do to
    # 1e-9; a split may still take another of two cut points that no
    # training row lies between (equal gains, a tie that the gradients'
    # last bits break), which moves the validation rows between them: the
    # curves that read the trees' validation score hold 1e-2 relative, the
    # Poisson deviance (the GP's response mean alone, as in the JAX
    # package) 1e-8
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=GP_TOL)
    for metric, c in ej["valid_0"].items():
        np.testing.assert_allclose(et["valid_0"][metric], c,
                                   rtol=1e-8 if metric == "poisson" else 1e-2,
                                   err_msg=metric)


def test_gp_validation_vecchia():
    """``use_gp_model_for_validation`` with a Vecchia GP: the validation
    score adds the GP's prediction at ``gp_coords_pred``; the metric
    without the GP reads the trees' score alone."""
    rng = np.random.default_rng(1)
    n = 300
    coords = rng.uniform(size=(n, 2))
    X = rng.uniform(size=(n, 3))
    y = (np.sin(4 * X[:, 0]) + np.sin(6 * coords[:, 0])
         + 0.3 * rng.normal(size=n))
    split = 240

    def gp(pkg, kw):
        return pkg.GPModel(gp_coords=coords[:split],
                           cov_function="exponential", gp_approx="vecchia",
                           num_neighbors=8, **kw)

    metrics = ["l2", "test_neg_log_likelihood", "crps_gaussian"]
    (jb, ej, jg), (tb, et, tg) = _train_both(
        {"objective": "regression", "metric": metrics,
         "min_data_in_leaf": 10, "verbose": -1}, X, y, split, 4, gp=gp,
        pred={"gp_coords_pred": coords[split:]})
    _same_curves(et, ej, GP_TOL)
    _same_trees(tb, jb, GP_TOL)
    assert tg._valid_pred_data.keys() == jg._valid_pred_data.keys()
    (jb2, ej2, _), (tb2, et2, _) = _train_both(
        {"objective": "regression", "metric": "l2", "verbose": -1,
         "min_data_in_leaf": 10}, X, y, split, 4, gp=gp,
        pred={"gp_coords_pred": coords[split:]},
        use_gp_model_for_validation=False)
    _same_curves(et2, ej2, GP_TOL)
    assert et2["valid_0"]["l2"][-1] > et["valid_0"]["l2"][-1]


def test_callbacks_fobj_feval_learning_rates(reg_data, tmp_path):
    X, y = reg_data

    def fobj(score, ds):
        return score - ds.label, np.ones_like(score)

    def feval(score, ds):
        return [("max_abs", float(np.max(np.abs(score - ds.label))), False),
                ("mean", float(np.mean(score)), True)]

    seen = {}
    out = []
    for pkg, kw in PKGS:
        calls = []
        ds = pkg.Dataset(X[:400], label=y[:400], **kw)
        dv = ds.create_valid(X[400:], label=y[400:])
        ev = {}
        bst = pkg.train(
            {"objective": "regression", "verbose": -1, "metric_freq": 2,
             "is_provide_training_metric": True}, ds, num_boost_round=6,
            valid_sets=[ds, dv], valid_names=["train", "val"], fobj=fobj,
            feval=feval, evals_result=ev, verbose_eval=False,
            learning_rates=lambda it: 0.3 * 0.9 ** it,
            callbacks=[lambda env: calls.append(
                (env.iteration, [r[:2] for r in
                                 env.evaluation_result_list]))])
        seen[pkg] = calls
        out.append((bst, ev))
    (jb, ej), (tb, et) = out
    assert seen[gpt] == seen[gpb]
    assert [t.shrinkage for t in tb.trees] == [t.shrinkage for t in jb.trees]
    _same_trees(tb, jb)
    _same_curves(et, ej)
    assert set(et) == {"training", "val"}
    assert list(et["val"]) == ["l2", "max_abs", "mean"]


def test_callback_module_matches_jax():
    from gpboost_tpu.boosting import callback as jcb
    for name in ("early_stopping", "record_evaluation", "print_evaluation",
                 "reset_parameter"):
        args = ({"learning_rate": [0.1]} if name == "reset_parameter" else
                ({} if name == "record_evaluation" else None))
        if name == "early_stopping":
            t, j = getattr(tcb, name)(3), getattr(jcb, name)(3)
        elif name == "record_evaluation":
            t, j = getattr(tcb, name)({}), getattr(jcb, name)({})
        elif name == "print_evaluation":
            t, j = getattr(tcb, name)(), getattr(jcb, name)()
        else:
            t, j = getattr(tcb, name)(**args), getattr(jcb, name)(**args)
        assert t.order == j.order
    assert tcb.CallbackEnv._fields == jcb.CallbackEnv._fields
    assert tcb.log_evaluation is tcb.print_evaluation
    with pytest.raises(ValueError, match="validation set"):
        tcb.early_stopping(2)(tcb.CallbackEnv(None, {}, 0, 0, 1, []))


def test_snapshots_and_dataset_helpers(reg_data, tmp_path):
    X, y = reg_data
    ds = gpt.Dataset(X, label=y, weight=np.ones(len(y)), device="cpu")
    dv = ds.create_valid(X[:50], label=y[:50], weight=np.full(50, 2.0),
                         init_score=np.zeros(50))
    assert dv.bin_upper_bounds is ds.bin_upper_bounds
    np.testing.assert_array_equal(dv.binned.numpy(), ds.binned.numpy()[:50])
    assert dv.weight[0] == 2.0 and dv.init_score.shape == (50,)
    sub = ds.subset(np.arange(10, 60))
    np.testing.assert_array_equal(sub.binned.numpy(),
                                  ds.binned.numpy()[10:60])
    np.testing.assert_array_equal(sub.label, y[10:60])
    stem = str(tmp_path / "m.json")
    gpt.train({"objective": "regression", "verbose": -1, "snapshot_freq": 2,
               "output_model": stem}, ds, num_boost_round=4)
    snap = json.loads(open(f"{stem}.snapshot_iter_4").read())
    assert len(snap["trees"]) == 4
    assert (tmp_path / "m.json.snapshot_iter_2").exists()
