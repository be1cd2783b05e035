"""The device-resident GPBoost loop of the port (``boosting/device_loop.py``)
on the CPU, float64 GP, against the JAX package's fused loop and against a
stepwise orchestration of the port's own primitives; mirrors
``tests/test_device_loop.py`` (N 600, R 5; the JAX package's loop runs on
the CPU through its test switch ``GPBOOST_TPU_FORCE_DEVICE_LOOP=1``, set
here with ``monkeypatch``; the port needs no switch:
``device_resident_boosting="true"`` engages it on the CPU).

Tolerances: against the JAX fused loop (both grow on float32 gradients; the
JAX package's leaf values are float32, the port's float64 from the same
float32 sums) the same splits and leaves in every tree, leaf values within
1e-6, training scores within 1e-6, covariance parameters 1e-6 and the
refits' NLLs 1e-7 relative, the same L-BFGS iterations; against the
stepwise orchestration (``optimizers.lbfgs_device_loop`` + the fixed-shape
grower, round by round) scores and leaf values within 1e-10. Quality,
prediction, a model-text round trip (1e-10), the eligibility gates through
a spy, and an exception in ``train_device`` propagating out of ``train``.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import device_loop
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.models import optimizers as topt

N = 600
R = 5
PARAMS = {"objective": "regression", "num_leaves": 15,
          "learning_rate": 0.1, "min_data_in_leaf": 10, "verbose": -1}
ON = dict(PARAMS, device_resident_boosting="true")
JAX_TOL = dict(score=1e-6, leaf=1e-6, cov_pars=1e-6, nll=1e-7)
STEP_TOL = 1e-10


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
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(N, 2))
    X = rng.uniform(size=(N, 3))
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    L = np.linalg.cholesky(0.8 * np.exp(-D / 0.3) + 0.05 * np.eye(N))
    y = f + L @ rng.standard_normal(N)
    return coords, X, y


GP_KW = dict(cov_function="exponential", gp_approx="vecchia",
             num_neighbors=8, vecchia_ordering="none")
OPTIM = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.25, 1.0, 0.1]}


def _port_gp(coords):
    gp = gpt.GPModel(gp_coords=coords, device="cpu", **GP_KW)
    gp.set_optim_params(dict(OPTIM))
    return gp


def _port_train(data, params=ON, rounds=R, **kw):
    coords, X, y = data
    gp = _port_gp(coords)
    bst = gpt.train(dict(params), gpt.Dataset(X, label=y, device="cpu"),
                    gp_model=gp, num_boost_round=rounds, **kw)
    return bst, gp


@pytest.fixture(scope="module")
def jax_fused(data):
    """The JAX package's fused loop, run once."""
    coords, X, y = data
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPBOOST_TPU_FORCE_DEVICE_LOOP", "1")
        gp = gpb.GPModel(gp_coords=coords, **GP_KW)
        gp.set_optim_params(dict(OPTIM))
        bst = gpb.train(dict(PARAMS), gpb.Dataset(X, label=y), gp_model=gp,
                        num_boost_round=R)
    return bst, gp


@pytest.fixture(scope="module")
def port_fused(data):
    return _port_train(data)


def test_fused_matches_jax_fused_loop(port_fused, jax_fused):
    tb, tgp = port_fused
    jb, jgp = jax_fused
    assert len(tb.trees) == len(jb.trees) == R
    for t, j in zip(tb.trees, jb.trees):
        assert t.num_leaves == j.num_leaves
        np.testing.assert_array_equal(t.split_feature, j.split_feature)
        np.testing.assert_array_equal(t.threshold_bin, j.threshold_bin)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0,
                                   atol=JAX_TOL["leaf"])
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=JAX_TOL["score"])
    np.testing.assert_allclose(tgp.cov_pars_, np.asarray(jgp.cov_pars_),
                               rtol=JAX_TOL["cov_pars"])
    ti, ji = tb.device_training_info_, jb.device_training_info_
    np.testing.assert_allclose(ti["cov_nll"], ji["cov_nll"],
                               rtol=JAX_TOL["nll"])
    np.testing.assert_array_equal(ti["refit_iterations"],
                                  ji["refit_iterations"])


def test_fused_matches_stepwise_orchestration(data, port_fused):
    """The loop == a Python loop over the same primitives, round for round
    (the same refits, trees and score)."""
    bst, _ = port_fused
    coords, X, y = data
    gp = _port_gp(coords)
    ds = gpt.Dataset(X, label=y, device="cpu")
    b2 = gpt.Booster(params=dict(ON), train_set=ds, gp_model=gp)
    vg, psi, dt = device_loop._fns_for(b2)
    cfg = gp.optim_cfg
    th = torch.log(torch.tensor(OPTIM["init_cov_pars"], dtype=dt))
    F = torch.as_tensor(b2._score, dtype=torch.float64)
    yt = torch.as_tensor(y)
    grower = tt.FixedGrower(ds.binned, ds.max_num_bins, b2.grower,
                            torch.float32, nan_mask=ds.has_nan,
                            binned_t=ds.binned_t, efb=ds.efb)
    lr = PARAMS["learning_rate"]
    for r in range(R):
        th, v, k, aux, _ = topt.lbfgs_device_loop(
            vg, th, cfg, dt, (yt - F).to(dt), final_fn=psi)
        out = grower.grow((-aux).to(torch.float32), torch.ones(N),
                          torch.ones(N, dtype=torch.bool),
                          torch.as_tensor(ds.num_bins))
        F = F + (lr * out["leaf_value"])[out["row_leaf"].long()]
        np.testing.assert_allclose(bst.trees[r].leaf_value,
                                   lr * out["leaf_value"].numpy(), rtol=0,
                                   atol=STEP_TOL)
        assert bst.device_training_info_["cov_nll"][r] == v
        assert bst.device_training_info_["refit_iterations"][r] == k
    np.testing.assert_allclose(bst._score, F.numpy(), rtol=0, atol=STEP_TOL)


def test_device_loop_quality_predict_and_model_text(data, port_fused):
    coords, X, y = data
    bst, gp = port_fused
    rmse = float(np.sqrt(np.mean((bst._score - y) ** 2)))
    assert rmse < 0.9 * float(np.std(y))
    assert np.all(gp.cov_pars_ > 0)
    info = bst.device_training_info_
    assert info["cov_nll"].shape == (R,)
    assert np.all(np.isfinite(info["cov_nll"]))
    assert info["cov_nll"][-1] < info["cov_nll"][0]
    assert np.all(info["refit_iterations"] >= 0)
    # the host reads: the refits' evaluations (one each) and one fetch
    assert info["host_reads"] == int(info["refit_evaluations"].sum()) + 1
    assert info["includes_compile"] is False      # no graph on the CPU
    # the trailing refit ran through the host path: one fit recorded
    assert bst.objective.num_fits == 1
    pred = bst.predict(X, gp_coords_pred=coords)
    mean = pred["response_mean"] if isinstance(pred, dict) else pred
    assert np.asarray(mean).shape == (N,)
    assert np.all(np.isfinite(np.asarray(mean)))
    b2 = gpt.Booster(model_str=bst.model_to_string(), device="cpu")
    np.testing.assert_allclose(b2.predict(X), bst.predict(X), rtol=0,
                               atol=1e-10)
    b3 = gpt.Booster(model_str=bst.model_to_string(format="text"),
                     device="cpu")
    np.testing.assert_allclose(b3.predict(X), bst.predict(X), rtol=0,
                               atol=1e-10)


def test_eligibility_gates(data, monkeypatch):
    coords, X, y = data
    calls = {"n": 0}
    orig = device_loop.train_device

    def spy(b, r):
        calls["n"] += 1
        return orig(b, r)

    monkeypatch.setattr(device_loop, "train_device", spy)
    # bagging keeps the host loop
    _port_train(data, dict(ON, bagging_fraction=0.8, bagging_freq=1), 2)
    assert calls["n"] == 0
    # no gp_model keeps the host loop
    gpt.train(dict(ON), gpt.Dataset(X, label=y, device="cpu"),
              num_boost_round=2)
    assert calls["n"] == 0
    # callbacks and validation sets keep the host loop
    _port_train(data, ON, 2, callbacks=[lambda env: None])
    assert calls["n"] == 0
    _port_train(data, ON, 2, valid_sets=[gpt.Dataset(
        X[:100], label=y[:100], device="cpu")],
        use_gp_model_for_validation=False)
    assert calls["n"] == 0
    # "false", and "auto" on the CPU, keep the host loop
    _port_train(data, dict(PARAMS, device_resident_boosting="false"), 2)
    _port_train(data, PARAMS, 2)
    assert calls["n"] == 0
    # the common GPBoost case engages it
    _port_train(data, ON, 2)
    assert calls["n"] == 1
    # the fixed-shape grower's options engage it (categorical features,
    # monotone and interaction constraints, forced splits); CEGB, extra
    # trees and node sampling keep the host loop (ROADMAP.md item 10b)
    Xc = np.column_stack([X, np.arange(N) % 5])
    for extra, want in (
            ({"categorical_feature": "3"}, True),
            ({"monotone_constraints": [1, 0, -1, 0]}, True),
            ({"interaction_constraints": [[0, 1], [2, 3]]}, True),
            ({"forced_splits": {"feature": 0, "threshold": 0.5}}, True),
            ({"cegb_penalty_split": 1e-4}, False),
            ({"extra_trees": True}, False),
            ({"feature_fraction_bynode": 0.5}, False)):
        b = gpt.Booster(params=dict(ON, **extra), train_set=gpt.Dataset(
            Xc, label=y, device="cpu"), gp_model=_port_gp(coords))
        assert device_loop.eligible(b) is want, extra
    with pytest.raises(ValueError, match="device_resident_boosting"):
        _port_train(data, dict(PARAMS, device_resident_boosting="maybe"), 2)


def test_exception_in_train_device_propagates(data, monkeypatch):
    """No fallback to the host loop (the JAX package's train has one)."""
    def broken(b, r):
        raise RuntimeError("device loop failed")

    monkeypatch.setattr(device_loop, "train_device", broken)
    with pytest.raises(RuntimeError, match="device loop failed"):
        _port_train(data, ON, 2)


def test_gradient_that_is_not_finite_raises(data, monkeypatch):
    """A refit whose gradient is not finite gives NaN trees in the loop:
    ``train_device`` raises the host route's ``ValueError`` after its one
    fetch instead of returning them."""
    orig = device_loop._fns_for

    def nan_fns(b):
        vg, final, kdt = orig(b)
        return vg, (lambda *a: final(*a) * float("nan")), kdt

    monkeypatch.setattr(device_loop, "_fns_for", nan_fns)
    with pytest.raises(ValueError, match="device loop: a leaf value is not "
                       "finite"):
        _port_train(data, ON, 2)


OPT_N = 400
OPT_R = 3
OPT_PARAMS = {"objective": "regression", "num_leaves": 8,
              "learning_rate": 0.1, "verbose": -1, "min_data_per_group": 20,
              # the forced split on a feature without a constraint: on a
              # monotone one the JAX package's fused grower tightens the
              # children's bounds, its host grower and the port's do not
              # (ROADMAP.md, Not faults)
              "monotone_constraints": [0, 1, 0, 0],
              "forced_splits": {"feature": 0, "threshold": 0.5}}


@pytest.fixture(scope="module")
def opt_data():
    """``test_device_loop_accepts_monotone_and_forced``'s data with a
    categorical column of 6 levels (feature 3) whose effect is in y."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(OPT_N, 2))
    X = rng.uniform(size=(OPT_N, 3))
    cat = rng.integers(0, 6, OPT_N)
    y = (np.sin(3 * coords[:, 0]) + X[:, 0] + 0.5 * X[:, 1]
         + np.array([0.0, 1.0, -0.5, 0.3, 1.2, -1.0])[cat]
         + 0.1 * rng.standard_normal(OPT_N))
    return coords, np.column_stack([X, cat.astype(float)]), y


def test_categorical_monotone_forced_loop_vs_jax_and_stepwise(opt_data,
                                                              monkeypatch):
    """A categorical feature, a monotone constraint and a forced split in
    the fused loop: against the JAX package's fused loop (mirrors
    ``test_device_loop_accepts_monotone_and_forced``; scores, covariance
    parameters, NLLs and L-BFGS iterations at ``JAX_TOL``, the forced root
    split in every tree, a categorical split) and against the port's own
    primitives round by round (``STEP_TOL``)."""
    coords, X, y = opt_data
    gp = _port_gp(coords)
    bst = gpt.train(dict(OPT_PARAMS, device_resident_boosting="true"),
                    gpt.Dataset(X, label=y, categorical_feature=[3],
                                device="cpu"),
                    gp_model=gp, num_boost_round=OPT_R)
    assert "device_training_info_" in bst.__dict__
    monkeypatch.setenv("GPBOOST_TPU_FORCE_DEVICE_LOOP", "1")
    jgp = gpb.GPModel(gp_coords=coords, **GP_KW)
    jgp.set_optim_params(dict(OPTIM))
    jb = gpb.train(dict(OPT_PARAMS), gpb.Dataset(X, label=y,
                                                 categorical_feature=[3]),
                   gp_model=jgp, num_boost_round=OPT_R)
    assert len(bst.trees) == len(jb.trees) == OPT_R
    for t, j in zip(bst.trees, jb.trees):
        assert t.num_leaves == j.num_leaves
        assert t.split_feature[0] == j.split_feature[0] == 0
    assert any(t.has_categorical() for t in bst.trees)
    np.testing.assert_allclose(bst._score, np.asarray(jb._score), rtol=0,
                               atol=JAX_TOL["score"])
    np.testing.assert_allclose(gp.cov_pars_, np.asarray(jgp.cov_pars_),
                               rtol=JAX_TOL["cov_pars"])
    ti, ji = bst.device_training_info_, jb.device_training_info_
    np.testing.assert_allclose(ti["cov_nll"], ji["cov_nll"],
                               rtol=JAX_TOL["nll"])
    np.testing.assert_array_equal(ti["refit_iterations"],
                                  ji["refit_iterations"])
    # the port's primitives, round by round, with the loop's grower
    ds = gpt.Dataset(X, label=y, categorical_feature=[3], device="cpu")
    b2 = gpt.Booster(params=dict(OPT_PARAMS, device_resident_boosting="true"),
                     train_set=ds, gp_model=_port_gp(coords))
    vg, psi, dt = device_loop._fns_for(b2)
    grower = device_loop._grower_of(b2)
    assert grower.cat_idx is not None and grower.mono is not None
    assert len(grower.forced_ops) == 1
    th = torch.log(torch.tensor(OPTIM["init_cov_pars"], dtype=dt))
    F = torch.as_tensor(b2._score, dtype=torch.float64)
    yt = torch.as_tensor(y)
    lr = OPT_PARAMS["learning_rate"]
    for r in range(OPT_R):
        th, v, k, aux, _ = topt.lbfgs_device_loop(
            vg, th, b2.gp_model.optim_cfg, dt, (yt - F).to(dt),
            final_fn=psi)
        out = grower.grow((-aux).to(torch.float32), torch.ones(OPT_N),
                          torch.ones(OPT_N, dtype=torch.bool),
                          torch.as_tensor(ds.num_bins))
        F = F + (lr * out["leaf_value"])[out["row_leaf"].long()]
        np.testing.assert_allclose(bst.trees[r].leaf_value,
                                   lr * out["leaf_value"].numpy(), rtol=0,
                                   atol=STEP_TOL)
        np.testing.assert_array_equal(bst.trees[r].cat_mask,
                                      out["catmask"].numpy())
        assert ti["cov_nll"][r] == v
    np.testing.assert_allclose(bst._score, F.numpy(), rtol=0, atol=STEP_TOL)

