"""The objective names that LaGaBoost takes beside a ``gp_model`` (ROADMAP.md
fault C3): with a GPModel the JAX package accepts ``regression``,
``binary``, ``regression_gp``, ``poisson``, ``gamma`` and ``cross_entropy``
— the response distribution is the GPModel's likelihood — and refuses any
other name with a ``ValueError`` (``gpboost_tpu/boosting/objectives.py:
776-787``). Two rounds of ``train`` with a grouped Poisson / gamma GLMM
(n = 300, 10 groups, 2 uniform features, the fault's input) against the
JAX package: covariance parameters at 1e-6 relative, training scores at
1e-8 of their spread.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import objectives as tobj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 300


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 10, N)
    X = rng.uniform(size=(N, 2))
    eta = 0.5 * rng.standard_normal(10)[g] + X[:, 0]
    return dict(g=g, X=X, poisson=rng.poisson(np.exp(eta)).astype(float),
                gamma=np.exp(eta) * rng.gamma(2.0, 0.5, N))


@pytest.mark.parametrize("name", ["poisson", "gamma"])
def test_lagaboost_objective_matches_jax(data, name):
    y = data[name]
    params = {"objective": name, "verbose": -1}
    jm = gpb.GPModel(group_data=data["g"], likelihood=name)
    tm = gpt.GPModel(group_data=data["g"], likelihood=name, device="cpu")
    jb = gpb.train(dict(params), gpb.Dataset(data["X"], label=y),
                   num_boost_round=2, gp_model=jm)
    tb = gpt.train(dict(params), gpt.Dataset(data["X"], label=y,
                                             device="cpu"),
                   num_boost_round=2, gp_model=tm)
    assert isinstance(tb.objective, tobj.GPBoostObjective)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    if name == "poisson":       # the fault's recorded value
        np.testing.assert_allclose(tm.get_cov_pars(), [0.04586411],
                                   rtol=1e-6)
    st, sj = tb._score, np.asarray(jb._score)
    assert np.max(np.abs(st - sj)) < 1e-8 * np.std(sj)


def test_names_beside_a_gp_model(data):
    ds = gpt.Dataset(data["X"], label=data["poisson"], device="cpu")
    for name in ("xentropy", "regression_gp"):
        obj = tobj.create_objective(name, {}, gp_model=gpt.GPModel(
            group_data=data["g"], likelihood="poisson", device="cpu"))
        assert isinstance(obj, tobj.GPBoostObjective)
    for name in ("huber", "tweedie", "lambdarank"):
        with pytest.raises(ValueError, match="GPModel likelihood"):
            gpt.train({"objective": name}, ds, num_boost_round=1,
                      gp_model=gpt.GPModel(group_data=data["g"],
                                           likelihood="poisson",
                                           device="cpu"))
    # without a gp_model the name is the gamma objective of the boosting
    # tail: the JAX package's scores after a round, within 1e-12
    tb = gpt.train({"objective": "gamma"}, ds, num_boost_round=1)
    jb = gpb.train({"objective": "gamma"},
                   gpb.Dataset(data["X"], label=data["poisson"]),
                   num_boost_round=1)
    assert isinstance(tb.objective, tobj.Gamma)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-12)
