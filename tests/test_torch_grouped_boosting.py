"""The GPBoost algorithm with grouped random effects, the port against the
JAX package's host loop (mirrors ``tests/test_gpboost_algorithm.py::
TestCombinedGroupedRE`` and ``tests/test_gpboost_reuse_lr.py:70-100``). CPU,
float64, at most 5 rounds; the same numpy-seeded inputs go through both
packages.

Tolerances, those of ``tests/test_torch_boosting.py``: with fixed
covariance parameters (``train_gp_model_cov_pars=False``) the training
scores after every round 1e-6; with the covariance refits by gradient
descent (learning-rate reuse on and off, the JAX package's reuse-trajectory
data) the covariance parameters after every round 1e-6 relative and the
scores 1e-6; by L-BFGS (curvature memory carried) the covariance
parameters rtol 1e-3 and the scores 1e-5; ``Booster.predict`` with
``group_data_pred`` (unseen levels included) at the same tolerance as the
scores.
"""
import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt

PARAMS = {"objective": "regression", "num_leaves": 4, "learning_rate": 0.1,
          "min_data_in_leaf": 5, "verbose": -1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    """The data of ``tests/test_gpboost_reuse_lr.py`` (n = 200, 20
    groups), with prediction rows of which two are in a new group."""
    rng = np.random.default_rng(0)
    n = 200
    X = rng.uniform(size=(n, 3))
    f = 2.0 * np.sin(5.0 * X[:, 0]) + X[:, 1] ** 2
    group = rng.integers(0, 20, size=n)
    b = 0.6 * rng.standard_normal(20)
    y = f + b[group] + 0.3 * rng.standard_normal(n)
    Xp = rng.uniform(size=(8, 3))
    gp = np.r_[group[:6], 99999, 99999]
    return dict(X=X, y=y, group=group, Xp=Xp, gp=gp)


def _pair(data, params, optim=None, cov_pars=None):
    jm = gpb.GPModel(group_data=data["group"])
    tm = gpt.GPModel(group_data=data["group"], device="cpu")
    if optim:
        jm.set_optim_params(dict(optim))
        tm.set_optim_params(dict(optim))
    if cov_pars is not None:
        jm.cov_pars_ = np.asarray(cov_pars, np.float64)
        tm.cov_pars_ = np.asarray(cov_pars, np.float64)
    jb = gpb.Booster(params=dict(params),
                     train_set=gpb.Dataset(data["X"], label=data["y"]),
                     gp_model=jm)
    tb = gpt.Booster(params=dict(params),
                     train_set=gpt.Dataset(data["X"], label=data["y"],
                                           device="cpu"), gp_model=tm)
    return jb, tb


def _same_predictions(tb, jb, data, atol):
    for latent in (True, False):
        want = jb.predict(data["Xp"], group_data_pred=data["gp"],
                          predict_var=True, pred_latent=latent)
        got = tb.predict(data["Xp"], group_data_pred=data["gp"],
                         predict_var=True, pred_latent=latent)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=0, atol=atol, err_msg=key)
    return got


@pytest.mark.parametrize("reuse", [True, False])
def test_default_optimizer_gd_reuse_matches_jax(data, reuse):
    """The default optimizer (gradient descent, lr 0.1, Nesterov) as the
    JAX package's ``test_grouped_gd_reuse_trajectory`` /
    ``..._noreuse_...``: the refits from the second on start at the first
    refit's learning rate after its first iteration when reuse is on."""
    optim = {"optimizer_cov": "gradient_descent", "lr_cov": 0.1,
             "use_nesterov_acc": True, "maxit": 1000}
    jb, tb = _pair(data, dict(PARAMS, reuse_learning_rates_gp_model=reuse),
                   optim)
    for _ in range(5):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb.gp_model.get_cov_pars(),
                                   jb.gp_model.get_cov_pars(), rtol=1e-6)
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-6)
    fits = tb.objective.fits
    assert len(fits) == 6 and fits[0]["lr_start"] is None
    if reuse:
        lr1 = fits[0]["lr_after_first"]
        assert lr1 == pytest.approx(jb.objective._lr_after_first, rel=1e-10)
        assert all(f["lr_start"] == lr1 for f in fits[1:])
    else:
        assert all(f["lr_start"] is None for f in fits)
    _same_predictions(tb, jb, data, 1e-6)


def test_lbfgs_memory_reuse_matches_jax(data):
    """L-BFGS refits with the curvature memory carried from the second on
    (``test_grouped_lbfgs_memory_reuse_trajectory``)."""
    jb, tb = _pair(data, PARAMS, {"optimizer_cov": "lbfgs", "maxit": 1000})
    for _ in range(5):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb.gp_model.get_cov_pars(),
                                   jb.gp_model.get_cov_pars(), rtol=1e-3)
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-5)
    assert tb.gp_model.optim_cfg.lbfgs_reuse_mem is True
    assert tb.objective.num_fits == 6
    _same_predictions(tb, jb, data, 1e-5)


def test_no_cov_par_training_matches_jax(data):
    """``train_gp_model_cov_pars=False`` keeps the covariance parameters
    (``TestCombinedGroupedRE::test_no_cov_par_training``): the gradients
    are Psi^-1 (y - F) at them, by Woodbury."""
    cp = [0.1, 0.4]
    jb, tb = _pair(data, dict(PARAMS, train_gp_model_cov_pars=False),
                   cov_pars=cp)
    for _ in range(5):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-6)
    assert tb.objective.num_fits == 0
    np.testing.assert_array_equal(tb.gp_model.get_cov_pars(), cp)
    got = _same_predictions(tb, jb, data, 1e-6)
    # the new group: no random-effect mean, its prior variance
    np.testing.assert_allclose(got["random_effect_mean"][-2:], 0.0,
                               atol=1e-12)


def test_train_and_saved_model(data, tmp_path):
    """``train(..., gp_model=GPModel(group_data=...))`` and a saved booster
    (this package's JSON and the JAX package's) predict the same."""
    jm = gpb.GPModel(group_data=data["group"])
    tm = gpt.GPModel(group_data=data["group"], device="cpu")
    for m in (jm, tm):
        m.set_optim_params({"optimizer_cov": "lbfgs"})
    jb = gpb.train(dict(PARAMS), gpb.Dataset(data["X"], label=data["y"]),
                   gp_model=jm, num_boost_round=3)
    tb = gpt.train(dict(PARAMS), gpt.Dataset(data["X"], label=data["y"],
                                             device="cpu"),
                   gp_model=tm, num_boost_round=3)
    assert tb.num_trees() == 3 and tb.objective.num_fits == 4
    want = tb.predict(data["Xp"], group_data_pred=data["gp"],
                      predict_var=True)
    path = tmp_path / "model.json"
    tb.save_model(str(path))
    back = gpt.Booster(model_file=str(path), device="cpu")
    from_jax = gpt.Booster(model_str=json.dumps(jb._to_dict()), device="cpu")
    from_jax_want = jb.predict(data["Xp"], group_data_pred=data["gp"],
                               predict_var=True)
    for other, ref in ((back, want), (from_jax, from_jax_want)):
        got = other.predict(data["Xp"], group_data_pred=data["gp"],
                            predict_var=True)
        for key in ("response_mean", "response_var", "fixed_effect",
                    "random_effect_mean", "random_effect_cov"):
            np.testing.assert_allclose(got[key], np.asarray(ref[key]),
                                       rtol=0, atol=1e-10, err_msg=key)
    # cluster_ids_pred is ported (exact GPs); a model trained without
    # cluster_ids refuses it
    with pytest.raises(ValueError, match="cluster_ids"):
        tb.predict(data["Xp"], group_data_pred=data["gp"],
                   cluster_ids_pred=np.zeros(8))


@pytest.mark.parametrize("alias", ["group", "group_id", "query_column",
                                   "query", "query_id"])
def test_group_column_aliases_resolve_like_jax(alias):
    """The JAX registry's aliases of ``group_column`` (the ranking
    objectives' query column, not grouped random effects) resolve the same
    way in the port, a column given too (both packages take the key and
    read it nowhere: the Python API takes ``Dataset(group=)``)."""
    from gpboost_tpu import config as jcfg
    from gpboost_tpu_torch import config as tcfg
    assert jcfg.ALIAS_TABLE[alias] == tcfg.ALIAS_TABLE[alias] == \
        "group_column"
    assert tcfg.resolve_params({alias: ""}) == {"group_column": ""}
    assert tcfg.resolve_params({alias: "0"}) == \
        jcfg.resolve_params({alias: "0"}) == {"group_column": "0"}
