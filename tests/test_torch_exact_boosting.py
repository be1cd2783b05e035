"""GPBoost and LaGaBoost with an exact GP, and LaGaBoost with grouped
random effects, the port against the JAX package (mirrors the exact-GP and
LaGaBoost cases of ``tests/test_gpboost_algorithm.py``). CPU, float64,
n = 200 points, 5 rounds; the same numpy-seeded inputs through both
packages.

Tolerances: trees, scores and fitted parameters after the rounds 1e-6
relative (the same algorithm; the refits stop by the same rules);
``Booster.predict`` with the GP (mean and variance, with ``cluster_ids``
and an unseen cluster) 1e-6; the b-space grouped gradient d NLL / dF
against the JAX package's dense ``laplace.gradient_wrt_F`` 1e-8 relative
for three families.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax.numpy as jnp
from gpboost_tpu.models import laplace as jl

N = 200
PARAMS = {"num_leaves": 8, "learning_rate": 0.1, "min_data_in_leaf": 10,
          "verbose": -1}


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
def d():
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(N, 2))
    X = rng.uniform(size=(N, 3))
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    b = np.linalg.cholesky(np.exp(-D / 0.2) + 1e-9 * np.eye(N)) \
        @ rng.normal(size=N)
    f = 2 * np.sin(5 * X[:, 0]) + X[:, 1]
    return dict(coords=coords, X=X, b=b,
                y=b + f + 0.3 * rng.normal(size=N),
                yb=(rng.uniform(size=N) < 1 / (1 + np.exp(-(b + f - 1))))
                .astype(float),
                cid=np.repeat([1, 2, 3, 4], N // 4),
                Xp=rng.uniform(size=(30, 3)),
                cp=rng.uniform(size=(30, 2)),
                cid_p=rng.choice([1, 2, 3, 4, 9], 30))


def _train(pkg, d, label, objective, **gp_kw):
    gp = pkg.GPModel(gp_coords=d["coords"], cov_function="exponential",
                     **({} if pkg is gpb else {"device": "cpu"}), **gp_kw)
    ds = (gpb.Dataset(d["X"], label=label) if pkg is gpb else
          gpt.Dataset(d["X"], label=label, device="cpu"))
    bst = pkg.train(dict(PARAMS, objective=objective), ds, gp_model=gp,
                    num_boost_round=5)
    return bst, gp


@pytest.mark.parametrize("case", ["gpboost", "gpboost_cluster_ids",
                                  "lagaboost"])
def test_training_and_prediction_match_jax(d, case):
    """``train(..., gp_model=exact GP)``: ``regression`` (the GPBoost
    algorithm, Psi^-1 (y - F) by the dense Cholesky; with ``cluster_ids``
    by the cluster blocks) and ``binary`` with ``bernoulli_logit`` (the
    LaGaBoost gradient of the dense Laplace route); scores, cov_pars and
    the combined prediction with variances equal the JAX package's."""
    binary = case == "lagaboost"
    kw = {"likelihood": "bernoulli_logit"} if binary else {}
    pkw = dict(gp_coords_pred=d["cp"], predict_var=True)
    if case == "gpboost_cluster_ids":
        kw["cluster_ids"] = d["cid"]
        pkw["cluster_ids_pred"] = d["cid_p"]
    label = d["yb"] if binary else d["y"]
    obj = "binary" if binary else "regression"
    jb, jgp = _train(gpb, d, label, obj, **kw)
    tb, tgp = _train(gpt, d, label, obj, **kw)
    if case == "gpboost_cluster_ids":
        assert tgp._clustered_batched
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(tgp.get_cov_pars(), jgp.get_cov_pars(),
                               rtol=1e-6)
    pj = jb.predict(d["Xp"], **pkw)
    pt = tb.predict(d["Xp"], **pkw)
    for key in ("response_mean", "response_var"):
        np.testing.assert_allclose(pt[key], np.asarray(pj[key]), rtol=1e-6,
                                   atol=1e-8, err_msg=key)


@pytest.mark.parametrize("lik", ["bernoulli_logit", "poisson", "gamma"])
def test_grouped_gradient_wrt_F_matches_dense(lik):
    """LaGaBoost's gradient with grouped effects in b-space (the mode's
    implicit backward over the incidence, no [n, n] matrix) against the JAX
    package's dense ``laplace.gradient_wrt_F`` at n = 400, two crossed
    intercepts: 1e-8 relative."""
    rng = np.random.default_rng(8)
    n = 400
    g = np.column_stack([rng.integers(0, 15, n), rng.integers(0, 6, n)])
    lat = 0.6 * rng.standard_normal(15)[g[:, 0]] \
        + 0.4 * rng.standard_normal(6)[g[:, 1]]
    y = {"bernoulli_logit": (rng.uniform(size=n) < 1 / (1 + np.exp(-lat)))
         .astype(float),
         "poisson": rng.poisson(np.exp(lat)).astype(float),
         "gamma": rng.gamma(2.0, np.exp(lat) / 2.0)}[lik]
    aux = [2.0] if lik == "gamma" else None
    cp = np.array([0.5, 0.3])
    F = 0.2 * rng.standard_normal(n)
    tm = gpt.GPModel(group_data=g, likelihood=lik, device="cpu")
    tm.cov_pars_ = cp
    if aux is not None:
        tm.aux_pars_ = np.asarray(aux)
    got = tm._grad_F_laplace(y, F).numpy()
    jm = gpb.GPModel(group_data=g, likelihood=lik)
    want = np.asarray(jl.gradient_wrt_F(
        jm.spec, jm._with_y(y), jnp.asarray(cp),
        None if aux is None else jnp.asarray(aux), jnp.asarray(F)))
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
