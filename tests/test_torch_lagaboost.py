"""The LaGaBoost algorithm and the binary objective vs the JAX package
(CPU, float64; inputs from a numpy seed handed to both sides):

- three rounds of ``train(objective="binary", gp_model=gp)`` with a
  ``bernoulli_logit`` Vecchia GP at n = 500 (dense Laplace route, L-BFGS
  refits on the same ordering and neighbours): the same root split, training
  scores within 1e-3 of their standard deviation, covariance parameters at
  1e-2 relative, the refits' NLLs at 1e-6 relative; ``Booster.predict`` with
  the GP (response mean and variance; latent fixed and random effects) at
  1e-6; the saved model reloads to the same predictions;
- ``binary`` without a GP: gradients and hessians at 1e-12 for every
  weighting option, the initial score, the probabilities ``predict``
  returns, and five rounds of training (scores at 1e-10).
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting import objectives as jobj

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch import config as tcfg
from gpboost_tpu_torch.boosting import objectives as tobj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, M, ROUNDS = 500, 10, 3
PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    X = rng.uniform(size=(N, 5))
    Fb = 2 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    Fb -= Fb.mean()
    y = rng.binomial(1, 1 / (1 + np.exp(-(f + Fb)))).astype(float)
    return dict(coords=coords, X=X, y=y, Xp=rng.uniform(size=(40, 5)),
                cp=rng.uniform(size=(40, 2)))


@pytest.fixture(scope="module")
def trained(data):
    kw = dict(gp_coords=data["coords"], cov_function="exponential",
              gp_approx="vecchia", num_neighbors=M,
              likelihood="bernoulli_logit")
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    for m in (jm, tm):
        m.set_optim_params({"optimizer_cov": "lbfgs",
                            "init_cov_pars": [1.0, 0.1]})
    jb = gpb.train(dict(PARAMS), gpb.Dataset(data["X"], label=data["y"]),
                   gp_model=jm, num_boost_round=ROUNDS)
    tb = gpt.train(dict(PARAMS), gpt.Dataset(data["X"], label=data["y"],
                                             device="cpu"),
                   gp_model=tm, num_boost_round=ROUNDS)
    return jb, tb


def test_lagaboost_three_rounds_match_jax(trained):
    jb, tb = trained
    assert isinstance(tb.objective, tobj.GPBoostObjective)
    assert tb.num_trees() == ROUNDS
    assert tb.init_score[0] == pytest.approx(jb.init_score[0], abs=1e-12)
    for t_tree, j_tree in ((tb.trees[0], jb.trees[0]),):
        assert int(t_tree.split_feature[0]) == int(j_tree.split_feature[0])
        assert int(t_tree.threshold_bin[0]) == int(j_tree.threshold_bin[0])
    diff = np.max(np.abs(tb._score - jb._score))
    assert diff <= 1e-3 * np.std(jb._score)
    np.testing.assert_allclose(tb.gp_model.get_cov_pars(),
                               jb.gp_model.get_cov_pars(), rtol=1e-2)
    assert len(tb.objective.fits) == ROUNDS + 1
    nll_j = jb.gp_model.get_current_neg_log_likelihood()
    assert abs(tb.objective.fits[-1]["nll"] - nll_j) < 1e-6 * abs(nll_j)


@pytest.mark.parametrize("latent", [False, True])
def test_lagaboost_predict_matches_jax(trained, data, latent):
    jb, tb = trained
    pj = jb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True,
                    pred_latent=latent)
    pt = tb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True,
                    pred_latent=latent)
    for key in ("response_mean", "response_var", "fixed_effect",
                "random_effect_mean", "random_effect_cov"):
        if pj[key] is None:
            assert pt[key] is None, key
        else:
            np.testing.assert_allclose(pt[key], pj[key], rtol=0, atol=1e-6,
                                       err_msg=key)
    if not latent:
        assert np.all((pt["response_mean"] > 0) & (pt["response_mean"] < 1))
    # without the GP's coordinates: the trees' raw score
    np.testing.assert_allclose(tb.predict(data["Xp"]),
                               jb.predict(data["Xp"]), atol=1e-9)


def test_lagaboost_model_reloads(trained, data, tmp_path):
    _, tb = trained
    path = tmp_path / "lagaboost.json"
    tb.save_model(str(path))
    back = gpt.Booster(model_file=str(path), device="cpu")
    assert back.gp_model.likelihood == "bernoulli_logit"
    want = tb.predict(data["Xp"], gp_coords_pred=data["cp"], predict_var=True)
    got = back.predict(data["Xp"], gp_coords_pred=data["cp"],
                       predict_var=True)
    np.testing.assert_allclose(got["response_mean"], want["response_mean"],
                               atol=1e-10)


@pytest.mark.parametrize("opts", [
    {}, {"sigmoid": 0.7}, {"is_unbalance": True},
    {"scale_pos_weight": 2.5}])
def test_binary_gradients_match_jax(data, opts):
    jo = jobj.create_objective("binary", dict(opts))
    to = tobj.create_objective("binary_logloss", tcfg.resolve_params(opts))
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 1.5, size=N)
    for weight in (None, w):
        jo.init(data["y"], weight)
        to.init(data["y"], weight)
        score = rng.standard_normal(N)
        for got, want in zip(to.get_gradients(score),
                             jo.get_gradients(score)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert to.boost_from_average() == pytest.approx(
            jo.boost_from_average(), abs=1e-12)
        np.testing.assert_allclose(to.convert_output(score),
                                   jo.convert_output(score), atol=1e-15)


def test_binary_training_without_gp_matches_jax(data):
    jb = gpb.train(dict(PARAMS), gpb.Dataset(data["X"], label=data["y"]),
                   num_boost_round=5)
    tb = gpt.train(dict(PARAMS, unbalance=False),
                   gpt.Dataset(data["X"], label=data["y"], device="cpu"),
                   num_boost_round=5)
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-10)
    p = tb.predict(data["Xp"])
    np.testing.assert_allclose(p, jb.predict(data["Xp"]), atol=1e-10)
    assert np.all((p > 0) & (p < 1))
    np.testing.assert_allclose(tb.predict(data["Xp"], raw_score=True),
                               jb.predict(data["Xp"], raw_score=True),
                               atol=1e-10)


def test_binary_options_are_checked():
    with pytest.raises(ValueError, match="is_unbalance"):
        tobj.create_objective("binary", {"is_unbalance": True,
                                         "scale_pos_weight": 2.0})
    # cross_entropy without a gp_model is the boosting tail's objective,
    # as in the JAX package
    from gpboost_tpu.boosting import objectives as jobj
    tx = tobj.create_objective("cross_entropy", {})
    jx = jobj.create_objective("cross_entropy", {})
    assert type(tx).__name__ == type(jx).__name__ == "CrossEntropy"
    assert tcfg.resolve_params({"unbalanced_sets": True}) == {
        "is_unbalance": True}
