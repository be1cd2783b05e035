"""The LaGaBoost branch of the port's device-resident loop
(``device_loop.train_device`` with a ``bernoulli_logit`` Vecchia GP on the
iterative Laplace route; ``vecchia_fit.ng_device_vg``) on the CPU, float64;
mirrors ``tests/test_device_loop_ng.py`` (N 500, binary).

The iterative Laplace NLL costs about a second an evaluation here (its CG
stop tests read the host every iteration, ~1 ms each) and the JAX package's
fused loop compiles for minutes, so this file cuts the depth: 10 probes and
10 Lanczos steps (the JAX package's ``GPBOOST_TPU_NG_MIN_PROBES`` and the
port's ``vecchia_fit.NG_MIN_PROBES`` set to 10 here), refits at ``maxit``
1, CG tolerance 0.1, 2 rounds (the JAX file: 4 at maxit 10), and holds the
JAX package through the loop's two primitives rather than its whole loop:

- ``ng_device_vg``'s value, gradient in theta and d NLL / dF against the
  JAX package's at the start of training, with the JAX package's probes
  (value 1e-9 relative, gradients 1e-6 of their largest entry);
- the fused loop against a stepwise orchestration of the same primitives
  (``optimizers.lbfgs_device_loop`` + the fixed-shape grower), scores and
  leaf values within 1e-10, the same refit iterations;
- the training's log loss below the constant model's;
- the eligibility gates equal to the JAX package's on the same boosters.

The fused run's trailing refit (``objective.get_gradients`` at the final
score, the host loop's own path, ~30 s here) is recorded, not run: the test
checks that the loop asks for it once, at the final score.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu import likelihoods as jlk
from gpboost_tpu.boosting import device_loop as jdl
from gpboost_tpu.models import vecchia_fit as jvf
from gpboost_tpu.ops import cg as jcg

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch import likelihoods as tlk
from gpboost_tpu_torch.boosting import device_loop
from gpboost_tpu_torch.boosting import objectives as tobj
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.models import optimizers as topt
from gpboost_tpu_torch.models import vecchia_fit as tvf

N = 500
R = 2
PROBES = 10
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
          "min_data_in_leaf": 10, "verbose": -1}
ON = dict(PARAMS, device_resident_boosting="true")
OPTIM = {"optimizer_cov": "lbfgs", "maxit": 1, "init_cov_pars": [1.0, 0.1],
         "num_rand_vec_trace": PROBES, "cg_max_num_it_tridiag": 10,
         "cg_delta_conv": 0.1}
GP_KW = dict(cov_function="exponential", gp_approx="vecchia",
             num_neighbors=8, vecchia_ordering="none",
             likelihood="bernoulli_logit",
             matrix_inversion_method="iterative")
VALUE_RTOL, GRAD_TOL, STEP_TOL = 1e-9, 1e-6, 1e-10


@pytest.fixture(autouse=True, scope="module")
def _settings():
    """One intra-op thread (the suite runs in several worker processes at
    once) and both packages' probe floors at ``PROBES``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPBOOST_TPU_NG_MIN_PROBES", str(PROBES))
        mp.setattr(tvf, "NG_MIN_PROBES", PROBES)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    coords = rng.uniform(size=(N, 2))
    X = rng.uniform(size=(N, 3))
    F = 1.5 * np.sin(5 * X[:, 0]) + X[:, 1]
    F = F - F.mean()
    lat = np.sin(4 * coords[:, 0]) + np.cos(3 * coords[:, 1])
    p = 1.0 / (1.0 + np.exp(-(F + lat)))
    y = rng.binomial(1, p).astype(np.float64)
    return coords, X, y


@pytest.fixture(scope="module")
def jax_gp(data):
    gp = gpb.GPModel(gp_coords=data[0], **GP_KW)
    gp.set_optim_params(dict(OPTIM))
    return gp


def _port_gp(data, jax_gp):
    """A port GP on the JAX package's ordering and neighbours, drawing the
    JAX package's probes (``jax.random.split(PRNGKey(seed), 3)``: normal
    value probes from the first key, Rademacher gradient probes from the
    second)."""
    gp = gpt.GPModel(gp_coords=data[0], device="cpu", **GP_KW)
    gp.set_optim_params(dict(OPTIM))
    gp._approx.load_structure(np.asarray(jax_gp._approx.perm),
                              np.asarray(jax_gp._approx.neighbors))
    seed = int(gp.optim_cfg.seed_rand_vec_trace)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    e = np.asarray(jax.random.normal(k1, (N, PROBES), jnp.float64))
    zg = np.asarray(jcg.rademacher_probes(k2, N, PROBES, jnp.float64))
    gp._approx._probe_cache = ((PROBES, seed, 0),
                               (torch.tensor(e), torch.tensor(zg)))
    return gp


@pytest.fixture(scope="module")
def port_fused(data, jax_gp):
    """The fused LaGaBoost run, its trailing refit recorded."""
    coords, X, y = data
    gp = _port_gp(data, jax_gp)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tobj.GPBoostObjective, "get_gradients",
                   lambda self, score: calls.append(np.array(score)))
        bst = gpt.train(dict(ON), gpt.Dataset(X, label=y, device="cpu"),
                        gp_model=gp, num_boost_round=R)
    return bst, gp, calls


def test_ng_primitives_match_jax(data, jax_gp):
    coords, X, y = data
    theta = np.log(np.asarray(OPTIM["init_cov_pars"]))
    F = 0.3 * np.sin(3 * X[:, 0])
    jvg, jgF = jvf.ng_device_vg(jax_gp, 2, 0, None,
                                jlk.get_family("bernoulli_logit"))
    jv, jg = jvg(jnp.asarray(theta), jnp.asarray(y), jnp.asarray(F))
    jgf = np.asarray(jgF(jnp.asarray(theta), jnp.asarray(y),
                         jnp.asarray(F)))
    gp = _port_gp(data, jax_gp)
    tvg, tgF = tvf.ng_device_vg(gp, 2, 0, None,
                                tlk.get_family("bernoulli_logit"))
    args = (torch.as_tensor(theta), torch.as_tensor(y), torch.as_tensor(F))
    tv, tg = tvg(*args)
    tgf = tgF(*args).numpy()
    assert abs(float(tv) - float(jv)) <= VALUE_RTOL * abs(float(jv))
    jg = np.asarray(jg)
    assert np.max(np.abs(tg.numpy() - jg)) <= GRAD_TOL * np.max(np.abs(jg))
    assert np.max(np.abs(tgf - jgf)) <= GRAD_TOL * np.max(np.abs(jgf))
    # the functions are cached on the model: stable identities
    assert tvf.ng_device_vg(gp, 2, 0, None,
                            tlk.get_family("bernoulli_logit"))[0] is tvg


def test_ng_fused_matches_stepwise_orchestration(data, jax_gp, port_fused):
    bst, _, calls = port_fused
    coords, X, y = data
    assert len(bst.trees) == R
    assert bst.device_training_info_["cov_nll"].shape == (R,)
    # the trailing refit: asked for once, at the final score
    assert len(calls) == 1 and np.array_equal(calls[0], bst._score)
    gp = _port_gp(data, jax_gp)
    ds = gpt.Dataset(X, label=y, device="cpu")
    b2 = gpt.Booster(params=dict(ON), train_set=ds, gp_model=gp)
    vg, grad_F, dt = device_loop._fns_for(b2)
    th = torch.log(torch.tensor(OPTIM["init_cov_pars"], dtype=dt))
    F = torch.as_tensor(b2._score, dtype=torch.float64)
    yt = torch.as_tensor(y)
    grower = tt.FixedGrower(ds.binned, ds.max_num_bins, b2.grower,
                            torch.float32, binned_t=ds.binned_t)
    lr = PARAMS["learning_rate"]
    for r in range(R):
        th, v, k, gF, _ = topt.lbfgs_device_loop(
            vg, th, gp.optim_cfg, dt, yt, F, final_fn=grad_F)
        out = grower.grow(gF.to(torch.float32), torch.ones(N),
                          torch.ones(N, dtype=torch.bool),
                          torch.as_tensor(ds.num_bins))
        F = F + (lr * out["leaf_value"])[out["row_leaf"].long()]
        np.testing.assert_allclose(bst.trees[r].leaf_value,
                                   lr * out["leaf_value"].numpy(), rtol=0,
                                   atol=STEP_TOL)
        assert bst.device_training_info_["refit_iterations"][r] == k
    np.testing.assert_allclose(bst._score, F.numpy(), rtol=0, atol=STEP_TOL)


def test_ng_fused_quality(data, port_fused):
    bst, gp, _ = port_fused
    y = data[2]
    info = bst.device_training_info_
    assert np.all(np.isfinite(info["cov_nll"]))
    assert info["cov_nll"][-1] < info["cov_nll"][0]
    # the host reads: the refits' evaluations and CG iterations, one fetch
    assert info["host_reads"] > int(info["refit_evaluations"].sum()) + 1
    p0 = np.mean(y)
    base = -np.mean(y * np.log(p0) + (1 - y) * np.log(1 - p0))
    pd = 1.0 / (1.0 + np.exp(-bst._score))
    ll = -np.mean(y * np.log(pd) + (1 - y) * np.log(1 - pd))
    assert ll < base


def _gate_cases(data):
    coords, X, y = data
    yg = np.exp(np.clip(y + 0.5, 0.1, None))
    return [
        # estimated aux parameters (the gamma shape) keep the host loop
        (dict(GP_KW, likelihood="gamma"), dict(OPTIM), "gamma", yg),
        # the dense (Cholesky) route at small n keeps the host loop
        (dict(GP_KW, matrix_inversion_method="cholesky"), dict(OPTIM),
         "binary", y),
        # gradient descent keeps the host loop
        (GP_KW, dict(OPTIM, optimizer_cov="gradient_descent"), "binary", y),
        # the iterative bernoulli_logit case engages the loop
        (GP_KW, dict(OPTIM), "binary", y)]


def test_ng_eligibility_gates_equal_jax(data, monkeypatch):
    coords, X, y = data
    monkeypatch.setenv("GPBOOST_TPU_FORCE_DEVICE_LOOP", "1")
    got = []
    for kw, optim, objective, label in _gate_cases(data):
        params = dict(PARAMS, objective=objective)
        jm = gpb.GPModel(gp_coords=coords, **kw)
        jm.set_optim_params(dict(optim))
        jb = gpb.Booster(params=dict(params), train_set=gpb.Dataset(
            X, label=label), gp_model=jm)
        tm = gpt.GPModel(gp_coords=coords, device="cpu", **kw)
        tm.set_optim_params(dict(optim))
        tb = gpt.Booster(params=dict(params, device_resident_boosting="true"),
                         train_set=gpt.Dataset(X, label=label, device="cpu"),
                         gp_model=tm)
        got.append((jdl.eligible(jb, R), device_loop.eligible(tb)))
    assert [t for _, t in got] == [j for j, _ in got] == [False, False,
                                                           False, True]
    assert os.environ["GPBOOST_TPU_FORCE_DEVICE_LOOP"] == "1"
    # "auto" leaves the LaGaBoost branch to "true": not on the CPU, and not
    # on a card either (the booster's device set to CUDA for the gate)
    tb.params["device_resident_boosting"] = "auto"
    assert device_loop.eligible(tb) is False
    tb.device = torch.device("cuda", 0)
    assert device_loop.eligible(tb) is False


def test_ng_gates_refuse_a_gp_without_vecchia(data):
    """A non-Gaussian GP that is not a Vecchia GP (grouped effects on the
    iterative route) keeps the host loop: the gates answer False, they do
    not fail on its missing Vecchia structure."""
    coords, X, y = data
    gm = gpt.GPModel(group_data=np.arange(N) % 20, likelihood="poisson",
                     matrix_inversion_method="iterative", device="cpu")
    tb = gpt.Booster(params=dict(PARAMS, objective="poisson",
                                 device_resident_boosting="true"),
                     train_set=gpt.Dataset(X, label=y, device="cpu"),
                     gp_model=gm)
    assert device_loop.eligible(tb) is False
