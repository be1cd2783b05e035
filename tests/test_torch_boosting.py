"""The boosting slice as a whole vs the JAX package's host loop (CPU,
float64; n = 1500, m = 8, at most 5 rounds; inputs from a numpy seed handed
to both sides).

Tolerances: L2 boosting, per-round training scores 1e-10 (identical trees,
leaf values from the same sums). GPBoost with fixed covariance parameters,
per-round scores 1e-6 (the ``Psi^-1 r`` solves differ in the order of their
sums). GPBoost with covariance training by L-BFGS (``delta_rel_conv`` =
1e-10; both packages run scipy's L-BFGS-B, then ``lbfgs_host`` with carried
memory): covariance parameters rtol 1e-3 and scores 1e-5 absolute, kept
from when the port ran another optimiser. With the default optimizer
(gradient descent, learning-rate reuse; the JAX package's reuse-trajectory
data, n = 200): covariance parameters after every round 1e-6 relative.
"""
import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch import config as tcfg
from gpboost_tpu_torch.utils import same_device


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

N, M = 1500, 8
PARAMS = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    X = rng.uniform(size=(N, 5))
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    chol = np.linalg.cholesky(np.exp(-D / 0.15) + 1e-10 * np.eye(N))
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    y = f + chol @ rng.standard_normal(N) + 0.4 * rng.standard_normal(N)
    return dict(X=X, y=y, coords=coords, Xp=rng.uniform(size=(200, 5)),
                cp=rng.uniform(size=(200, 2)))


def _gp_models(data, **optim):
    jm = gpb.GPModel(gp_coords=data["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M)
    tm = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M, device="cpu")
    # identical conditioning sets whatever the top-k tie-breaking
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    if optim:
        jm.set_optim_params(dict(optim))
        tm.set_optim_params(dict(optim))
    return jm, tm


def _boosters(data, params, jm=None, tm=None):
    jb = gpb.Booster(params=dict(params),
                     train_set=gpb.Dataset(data["X"], label=data["y"]),
                     gp_model=jm)
    tb = gpt.Booster(params=dict(params),
                     train_set=gpt.Dataset(data["X"], label=data["y"],
                                           device="cpu"), gp_model=tm)
    return jb, tb


def _same_structure(tb, jb):
    assert len(tb.trees) == len(jb.trees)
    for t, j in zip(tb.trees, jb.trees):
        for name in ("split_feature", "threshold_bin", "left", "right",
                     "is_leaf"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(t.threshold, j.threshold)


def test_l2_boosting_scores_match_jax_every_round(data):
    jb, tb = _boosters(data, PARAMS)
    assert tb.init_score[0] == jb.init_score[0] == data["y"].mean()
    for _ in range(5):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-10)
    _same_structure(tb, jb)
    assert tb.num_trees() == tb.current_iteration() == 5
    for kind in ("split", "gain"):
        np.testing.assert_allclose(tb.feature_importance(kind),
                                   jb.feature_importance(kind), rtol=1e-10)
    np.testing.assert_allclose(tb.predict(data["Xp"]), jb.predict(data["Xp"]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        tb.predict(data["Xp"], num_iteration=2, raw_score=True),
        jb.predict(data["Xp"], num_iteration=2, raw_score=True), atol=1e-10)
    np.testing.assert_allclose(
        tb.predict(data["Xp"], start_iteration=3),
        jb.predict(data["Xp"], start_iteration=3), atol=1e-10)


def test_train_resolves_aliases_like_jax(data):
    params = {"objective": "l2", "num_leaf": 7, "eta": 0.3, "min_data": 40,
              "reg_lambda": 1.5, "reg_alpha": 0.1, "n_estimators": 3,
              "verbosity": -1, "boost_from_average": False}
    jb = gpb.train(dict(params), gpb.Dataset(data["X"], label=data["y"]))
    tb = gpt.train(dict(params), gpt.Dataset(data["X"], label=data["y"],
                                             device="cpu"))
    assert tb.num_trees() == 3 and tb.grower.num_leaves == 7
    assert tb.init_score[0] == 0.0
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-10)
    _same_structure(tb, jb)


def test_gpboost_fixed_cov_pars_scores_match_jax_every_round(data):
    jm, tm = _gp_models(data)
    jm.cov_pars_ = tm.cov_pars_ = np.array([0.2, 1.1, 0.12])
    params = dict(PARAMS, train_gp_model_cov_pars=False)
    jb, tb = _boosters(data, params, jm, tm)
    for _ in range(4):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-6)
    _same_structure(tb, jb)
    assert tb.objective.num_fits == 0
    np.testing.assert_array_equal(tm.get_cov_pars(), [0.2, 1.1, 0.12])
    want = jb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True)
    got = tb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def trained_with_cov_pars(data):
    optim = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.25, 1.0, 0.1],
             "delta_rel_conv": 1e-10}
    jm, tm = _gp_models(data, **optim)
    jb = gpb.train(dict(PARAMS), gpb.Dataset(data["X"], label=data["y"]),
                   gp_model=jm, num_boost_round=3)
    tb = gpt.train(dict(PARAMS), gpt.Dataset(data["X"], label=data["y"],
                                             device="cpu"),
                   gp_model=tm, num_boost_round=3)
    return jb, tb


def test_gpboost_with_cov_par_training_reaches_the_jax_result(
        trained_with_cov_pars, data):
    jb, tb = trained_with_cov_pars
    np.testing.assert_allclose(tb.gp_model.get_cov_pars(),
                               jb.gp_model.get_cov_pars(), rtol=1e-3)
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-5)
    # one refit before the first tree, one after every round; the refit at
    # the end of a round is reused by the next round (the gradient cache)
    assert tb.objective.num_fits == 3 + 1
    assert tb.gp_model.optim_cfg.lbfgs_reuse_mem is True
    assert np.all(tb.gp_model.get_cov_pars() > 0)
    got = tb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True)
    want = jb.predict(data["Xp"], gp_coords_pred=data["cp"],
                      predict_var=True)
    np.testing.assert_allclose(got["response_mean"], want["response_mean"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["response_var"], want["response_var"],
                               rtol=1e-3)
    assert np.all(got["response_var"] > 0)


@pytest.mark.parametrize("with_gp", [False, True])
def test_jax_model_dict_loaded_by_the_port_predicts_the_same(
        trained_with_cov_pars, data, with_gp):
    if with_gp:
        jb = trained_with_cov_pars[0]
    else:
        jb = gpb.train(dict(PARAMS), gpb.Dataset(data["X"], label=data["y"]),
                       num_boost_round=3)
    content = json.dumps(jb._to_dict())
    tb = gpt.Booster(model_str=content, device="cpu")
    assert tb.num_trees() == 3 and tb.train_set is None
    np.testing.assert_allclose(tb.predict(data["Xp"]), jb.predict(data["Xp"]),
                               rtol=0, atol=1e-12)
    if with_gp:
        want = jb.predict(data["Xp"], gp_coords_pred=data["cp"],
                          predict_var=True)
        got = tb.predict(data["Xp"], gp_coords_pred=data["cp"],
                         predict_var=True)
        for key in ("response_mean", "response_var", "fixed_effect",
                    "random_effect_mean", "random_effect_cov"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=0, atol=1e-8, err_msg=key)
    # and back: the JAX package reads what the port writes
    jb2 = gpb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(jb2.predict(data["Xp"]),
                               jb.predict(data["Xp"]), rtol=0, atol=1e-12)


def test_save_and_load_model_file(trained_with_cov_pars, data, tmp_path):
    tb = trained_with_cov_pars[1]
    path = tmp_path / "model.json"
    tb.save_model(str(path))
    back = gpt.Booster(model_file=str(path), device="cpu")
    want = tb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True)
    got = back.predict(data["Xp"], gp_coords_pred=data["cp"],
                       predict_var=True)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-10)
    # a .txt name writes the reference's text format: the trees alone
    # (the boost-from-average score in the first tree's leaves)
    tb.save_model(str(tmp_path / "model.txt"))
    trees = gpt.Booster(model_file=str(tmp_path / "model.txt"),
                        device="cpu")
    np.testing.assert_allclose(trees.predict(data["Xp"]),
                               want["fixed_effect"], rtol=0, atol=1e-12)


def _reuse_data(n=200):
    """The data of the JAX package's ``tests/test_gpboost_reuse_lr.py``."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, 3))
    f = 2.0 * np.sin(5.0 * X[:, 0]) + X[:, 1] ** 2
    # the grouped effects' draws, not used here: the stream stays aligned
    _ = rng.integers(0, 20, size=n), rng.standard_normal(20)
    coords = rng.uniform(size=(n, 2))
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    L = np.linalg.cholesky(0.8 * np.exp(-D / 0.2) + 1e-10 * np.eye(n))
    y = f + L @ rng.standard_normal(n) + 0.3 * rng.standard_normal(n)
    return X, y, coords


@pytest.mark.parametrize("reuse", [True, False])
def test_default_optimizer_gd_reuse_matches_jax(reuse):
    """GPBoost with the default optimizer (gradient descent, lr 0.1,
    Nesterov), as the JAX package's ``test_vecchia_gd_reuse_trajectory``:
    the covariance parameters after every round within 1e-6 relative of
    the JAX package's; with reuse, the refits from the second on start at
    the first refit's learning rate after its first iteration."""
    X, y, coords = _reuse_data()
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=10, vecchia_ordering="none")
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    optim = {"optimizer_cov": "gradient_descent", "lr_cov": 0.1,
             "use_nesterov_acc": True, "maxit": 1000}
    jm.set_optim_params(dict(optim))
    tm.set_optim_params(dict(optim))
    params = {"objective": "regression", "num_leaves": 4,
              "learning_rate": 0.1, "min_data_in_leaf": 5, "verbose": -1,
              "reuse_learning_rates_gp_model": reuse}
    jb = gpb.Booster(params=dict(params), train_set=gpb.Dataset(X, label=y),
                     gp_model=jm)
    tb = gpt.Booster(params=dict(params),
                     train_set=gpt.Dataset(X, label=y, device="cpu"),
                     gp_model=tm)
    for _ in range(3):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                                   rtol=1e-6)
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-6)
    fits = tb.objective.fits
    assert len(fits) == 4 and fits[0]["lr_start"] is None
    if reuse:
        lr1 = fits[0]["lr_after_first"]
        assert tb.objective.lr_after_first == lr1
        assert lr1 == pytest.approx(jb.objective._lr_after_first, rel=1e-10)
        assert all(f["lr_start"] == lr1 for f in fits[1:])
    else:
        assert all(f["lr_start"] is None for f in fits)


def test_devices(data):
    assert same_device("cuda", "cuda:0") and not same_device("cpu", "cuda")
    assert same_device(torch.device("cpu"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gpt.Booster(model_str="{}")      # the default device is the GPU


UNPORTED = [
    {"categorical_feature": [0]}, {"cat_feature": "0,1"},
    {"monotone_constraints": [1, 0, 0, 0, 0]}, {"boosting": "dart"},
    {"boosting_type": "goss"}, {"boosting": "rf"},
    {"bagging_fraction": 0.5}, {"subsample": 0.5}, {"bagging_freq": 1},
    {"pos_bagging_fraction": 0.5}, {"neg_bagging_fraction": 0.5},
    {"feature_fraction": 0.8}, {"colsample_bytree": 0.8},
    {"feature_fraction_bynode": 0.5}, {"linear_tree": True},
    {"forced_splits": {"feature": 0, "threshold": 0.5}},
    {"forcedsplits_filename": "splits.json"},
    {"cegb_tradeoff": 0.5}, {"cegb_penalty_split": 0.1},
    {"cegb_penalty_feature_lazy": [1.0] * 5},
    {"cegb_penalty_feature_coupled": [1.0] * 5},
    {"extra_trees": True}, {"path_smooth": 1.0}, {"max_delta_step": 0.5},
    {"max_leaf_output": 0.5}, {"interaction_constraints": [[0, 1], [2]]},
    {"use_nesterov_acc": True}, {"leaves_newton_update": True},
    {"line_search_step_length": True},
    {"device_resident_boosting": "true"}, {"tree_learner": "voting"},
    {"tree_learner": "feature"}, {"num_class": 3},
    {"objective": "poisson"}, {"objective": "regression_l1"},
    {"early_stopping_round": 5}, {"some_unknown_key": 1},
]


# the cases of UNPORTED whose feature the boosting tail has ported since:
# each now trains as the JAX package does on the same input
NOW_PORTED = ("bagging_fraction", "subsample", "bagging_freq",
              "pos_bagging_fraction", "neg_bagging_fraction",
              "feature_fraction", "colsample_bytree",
              "feature_fraction_bynode", "num_class", "objective",
              "early_stopping_round",
              # the tree learner's tail
              "categorical_feature", "cat_feature", "monotone_constraints",
              "linear_tree", "forced_splits", "forcedsplits_filename",
              "cegb_tradeoff", "cegb_penalty_split",
              "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled",
              "extra_trees", "path_smooth", "max_delta_step",
              "max_leaf_output", "interaction_constraints",
              # the rest of the boosting tail
              "boosting", "boosting_type", "use_nesterov_acc",
              "leaves_newton_update", "line_search_step_length",
              # the device-resident training loop
              "device_resident_boosting")


def _jax_and_port(params, X, y, **kw):
    """One round of the JAX package and of the port on the same input:
    (JAX booster or its exception, port booster or its exception)."""
    out = []
    for pkg, dkw in ((gpb, {}), (gpt, {"device": "cpu"})):
        try:
            out.append(pkg.train(dict(params), pkg.Dataset(X, label=y, **dkw),
                                 num_boost_round=1, **kw))
        except Exception as e:       # noqa: BLE001 - compared by type below
            out.append(e)
    return out


def _same_outcome(jb, tb):
    """The port raises what the JAX package raises, or trains the same
    round (training scores within 1e-10)."""
    if isinstance(jb, Exception):
        assert type(tb) is type(jb), (tb, jb)
        return
    assert not isinstance(tb, Exception), tb
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("extra", UNPORTED,
                         ids=[next(iter(d)) + "=" + str(next(iter(d.values())))
                              for d in UNPORTED])
def test_unported_parameters_raise(data, extra):
    if next(iter(extra)) in NOW_PORTED:
        _same_outcome(*_jax_and_port(dict(PARAMS, **extra), data["X"][:200],
                                     data["y"][:200]))
        return
    ds = gpt.Dataset(data["X"][:200], label=data["y"][:200], device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue A"):
        gpt.train(dict(PARAMS, **extra), ds, num_boost_round=1)


def test_deterministic_is_accepted_as_a_no_op():
    # training is deterministic on every route (config.py), so the key
    # changes nothing
    assert tcfg.resolve_params({"deterministic": True}) == {
        "deterministic": True}


def test_defaults_of_unported_parameters_pass(data):
    out = tcfg.resolve_params({
        "bagging_fraction": 1.0, "feature_fraction": 1, "boosting": "gbdt",
        "extra_trees": False, "categorical_feature": "", "num_class": 1,
        "monotone_constraints": None, "device_resident_boosting": "auto",
        "tree_learner": "serial", "n_estimators": 7, "num_iterations": 9,
        "max_delta_step": 0.0, "seed": 3})
    assert out["num_iterations"] == 9          # the canonical key wins
    assert "n_estimators" not in out


@pytest.mark.parametrize("kwargs", [
    dict(valid_sets=["x"]), dict(callbacks=[print]), dict(fobj=print),
    dict(feval=print), dict(early_stopping_rounds=3),
    dict(init_model="model.json")])
def test_unported_train_arguments_raise(data, kwargs):
    if "init_model" not in kwargs:
        # ported: the port does what the JAX package does with the same
        # arguments (a string as a validation set and a fobj that returns
        # None raise the same exception; the others train the same round)
        _same_outcome(*_jax_and_port(PARAMS, data["X"][:200],
                                     data["y"][:200], **kwargs))
        return
    ds = gpt.Dataset(data["X"][:200], label=data["y"][:200], device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        gpt.train(dict(PARAMS), ds, num_boost_round=1, **kwargs)
