"""The five ``vecchia_pred_type`` variants of the port
(``set_prediction_data(vecchia_pred_type=, num_neighbors_pred=)``;
``ops/vecchia.py::predict_vecchia_cond_all`` / ``_pred_first`` /
``_latent``) on the CPU, float64 — the counterpart of
``tests/test_vecchia_pred_types.py``, with its reference goldens
(``tests/data/predtype_goldens.json``) at that file's tolerance (1e-5), and
against the JAX package on the same inputs:

- mean and variance of every type equal the JAX package's at 1e-10
  relative (the latent types, CG to 1e-10 on both sides, at 1e-8), the full
  covariance too;
- ``num_neighbors_pred`` takes effect (and is capped at n, as in the JAX
  package); with every point conditioning each type meets the exact GP;
- the types are distinct estimators; the latent types refuse
  duplicates between training and prediction points;
- an unknown type raises; the validation data keywords are stored as the
  JAX package stores them.
"""
import json
import os

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import vecchia_model as tvm

PRED_TYPES = ["order_obs_first_cond_obs_only", "order_obs_first_cond_all",
              "order_pred_first", "latent_order_obs_first_cond_obs_only",
              "latent_order_obs_first_cond_all"]
CP = [0.15, 1.1, 0.25]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "predtype_goldens.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(42)
    n = 150
    coords = rng.uniform(size=(n, 2))
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    L = np.linalg.cholesky(1.1 * np.exp(-D / 0.25) + 0.15 * np.eye(n))
    y = L @ rng.standard_normal(n)
    return coords, y, rng.uniform(size=(7, 2))


def _model(coords, pkg=gpt, nn=15, **kw):
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=nn,
              vecchia_ordering="none", **kw)
    return gpt.GPModel(device="cpu", **kw) if pkg is gpt else gpb.GPModel(**kw)


@pytest.mark.parametrize("pred_type", PRED_TYPES)
def test_pred_type_golden_and_jax(dataset, golden, pred_type):
    coords, y, coords_pred = dataset
    tm, jm = _model(coords), _model(coords, gpb)
    for m in (tm, jm):
        m.set_prediction_data(vecchia_pred_type=pred_type,
                              num_neighbors_pred=15)
    tol = 1e-8 if pred_type.startswith("latent") else 1e-10
    for resp in (True, False):
        kw = dict(y=y, gp_coords_pred=coords_pred, cov_pars=CP,
                  predict_var=True, predict_cov_mat=True,
                  predict_response=resp)
        pt = tm.predict(**kw)
        mu_ref, var_ref = golden[f"{pred_type}|{'resp' if resp else 'lat'}"]
        np.testing.assert_allclose(pt["mu"], mu_ref, atol=1e-5)
        np.testing.assert_allclose(pt["var"], var_ref, atol=1e-5)
        if resp:
            pj = jm.predict(**kw)
            for key in ("mu", "var", "cov"):
                np.testing.assert_allclose(pt[key], pj[key], rtol=tol,
                                           atol=tol * 1e-2, err_msg=key)


def test_latent_types_count_cg_iterations(dataset):
    coords, y, coords_pred = dataset
    tm = _model(coords)
    tm.set_prediction_data(
        vecchia_pred_type="latent_order_obs_first_cond_all")
    tvm.LAPLACE_COUNTS.clear()
    tm.predict(y=y, gp_coords_pred=coords_pred, cov_pars=CP,
               predict_var=True)
    assert tvm.LAPLACE_COUNTS["latent_cg_iters"] > 0


def test_num_neighbors_pred_capped_and_read(dataset):
    coords, y, coords_pred = dataset
    tm = _model(coords)
    tm.set_prediction_data(num_neighbors_pred=10 ** 6)
    assert tm._approx.num_neighbors_pred == len(y)
    tm.set_prediction_data(num_neighbors_pred=5)
    p5 = tm.predict(y=y, gp_coords_pred=coords_pred, cov_pars=CP)["mu"]
    tm.set_prediction_data(num_neighbors_pred=15)
    p15 = tm.predict(y=y, gp_coords_pred=coords_pred, cov_pars=CP)["mu"]
    assert not np.allclose(p5, p15, atol=1e-8)


def test_pred_types_differ(dataset):
    coords, y, coords_pred = dataset
    mus = {}
    for pt in ["order_obs_first_cond_obs_only", "order_pred_first",
               "latent_order_obs_first_cond_obs_only"]:
        m = _model(coords)
        m.set_prediction_data(vecchia_pred_type=pt, num_neighbors_pred=15)
        mus[pt] = m.predict(y=y, gp_coords_pred=coords_pred, cov_pars=CP)["mu"]
    assert not np.allclose(mus["order_obs_first_cond_obs_only"],
                           mus["order_pred_first"], atol=1e-8)
    assert not np.allclose(mus["order_obs_first_cond_obs_only"],
                           mus["latent_order_obs_first_cond_obs_only"],
                           atol=1e-8)


def test_latent_duplicate_train_test_raises(dataset):
    coords, y, _ = dataset
    m = _model(coords)
    m.set_prediction_data(
        vecchia_pred_type="latent_order_obs_first_cond_obs_only",
        num_neighbors_pred=15)
    with pytest.raises(ValueError, match="Duplicates"):
        m.predict(y=y, gp_coords_pred=coords[:3], cov_pars=CP)


def test_all_neighbors_converge_to_exact(dataset):
    coords, y, coords_pred = dataset
    n = len(y)
    cp = np.asarray(CP)
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    Dpo = np.sqrt(((coords_pred[:, None] - coords[None]) ** 2).sum(-1))
    Koo = cp[1] * np.exp(-D / cp[2]) + cp[0] * np.eye(n)
    mu_exact = cp[1] * np.exp(-Dpo / cp[2]) @ np.linalg.solve(Koo, y)
    for pt in PRED_TYPES:
        m = _model(coords, nn=30)
        m.set_prediction_data(vecchia_pred_type=pt, num_neighbors_pred=n + 7)
        p = m.predict(y=y, gp_coords_pred=coords_pred, cov_pars=cp)
        np.testing.assert_allclose(p["mu"], mu_exact, atol=2e-5, err_msg=pt)


def test_unknown_type_and_validation_data(dataset):
    coords, _, _ = dataset
    m = _model(coords)
    with pytest.raises(ValueError, match="vecchia_pred_type"):
        m.set_prediction_data(vecchia_pred_type="order_random")
    # the validation data are stored for the boosting's validation, as the
    # JAX package stores them
    m.set_prediction_data(gp_coords_pred=coords[:2])
    jm = _model(coords, pkg=gpb)
    jm.set_prediction_data(gp_coords_pred=coords[:2])
    assert m._valid_pred_data.keys() == jm._valid_pred_data.keys()
    np.testing.assert_array_equal(m._valid_pred_data["gp_coords_pred"],
                                  jm._valid_pred_data["gp_coords_pred"])
