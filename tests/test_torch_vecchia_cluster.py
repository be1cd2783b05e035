"""``cluster_ids`` on the port's Vecchia GP (``models/vecchia_model.py``
with ``cluster_codes``) on the CPU, float64 — the counterpart of
``tests/test_vecchia_cluster_golden.py`` (its R goldens at that file's
tolerances) and of the cluster half of
``tests/test_vecchia_laplace_cluster_svc.py``, held against the JAX
package on the same inputs:

- the cluster-masked neighbour searches equal the JAX package's;
- the NLL, the gradient and the predictions (the default type and
  ``order_obs_first_cond_all``, an unseen cluster at the prior) equal the
  JAX package's at 1e-10 relative;
- the ARD redetermination keeps the clusters apart, and meets the
  reference goldens of ``tests/test_ard_neighbor_redetermination.py`` at
  that file's tolerances;
- ``bernoulli_logit`` with clusters: the dense Laplace NLL and prediction
  at 1e-8 (the mode finders' stop rules), the CG route above the dense
  limit against the dense one at 1e-5;
- ``cluster_ids_pred`` is required; an unseen id gets the prior.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.ops import vecchia as jvops

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import vecchia_model as tvm
from gpboost_tpu_torch.ops import vecchia as tvops

CP_REF = [0.05870373, 1.05572659, 0.12775754]
COORD_TEST = np.column_stack([[0.1, 0.2, 0.1001], [0.9, 0.4, 0.9001]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cl(gp_fixture_data):
    d = gp_fixture_data
    return dict(y=d["eps"] + d["xi"], coords=d["coords"],
                cluster_ids=d["cluster_ids"], n=d["n"])


def _pair(cl, **kw):
    kw = dict(dict(gp_coords=cl["coords"], cov_function="exponential",
                   gp_approx="vecchia", num_neighbors=30,
                   vecchia_ordering="none", cluster_ids=cl["cluster_ids"]),
              **kw)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


def test_cluster_masked_searches_equal_jax():
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(300, 2))
    codes = rng.integers(0, 4, size=300)
    nb_j = np.asarray(jvops.find_neighbors(coords, 12, method="exact",
                                           codes=codes))
    nb_t = tvops.find_neighbors(torch.as_tensor(coords), 12,
                                codes=torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(nb_t, nb_j)
    cp = rng.uniform(size=(40, 2))
    cdp = rng.integers(0, 5, size=40)
    nbx_j = np.asarray(jvops.find_neighbors_cross(
        cp, coords, 15, codes_pred=cdp, codes_obs=codes, method="exact"))
    nbx_t = tvops.find_neighbors_cross(
        torch.as_tensor(cp), torch.as_tensor(coords), 15,
        codes_pred=torch.as_tensor(cdp),
        codes_obs=torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(nbx_t, nbx_j)
    # unseen code 4: every slot padding
    assert np.all(nbx_t[cdp == 4] == -1)


def test_nll_golden_and_jax(cl):
    jm, tm = _pair(cl)
    np.testing.assert_array_equal(tm._approx.neighbors.numpy(),
                                  np.asarray(jm._approx.neighbors))
    nt = tm.neg_log_likelihood(cov_pars=CP_REF, y=cl["y"])
    assert abs(nt - 129.3761486) < 1e-4
    nj = jm.neg_log_likelihood(cov_pars=CP_REF, y=cl["y"])
    assert abs(nt - nj) <= 1e-10 * abs(nj)
    # the gradient in log-parameters, by autograd through the plain build
    th = torch.log(torch.as_tensor(CP_REF, dtype=torch.float64))
    _, gt = tm._approx._vg_gaussian(th, tm._y_tensor(cl["y"]), None)
    import jax.numpy as jnp
    _, gj = jm._approx._vg_gaussian(jnp.log(jnp.asarray(CP_REF)),
                                    jnp.asarray(cl["y"]), None)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("pred_type", [None, "order_obs_first_cond_all"])
def test_prediction_golden_and_jax(cl, pred_type):
    jm, tm = _pair(cl)
    for m in (jm, tm):
        m.set_prediction_data(vecchia_pred_type=pred_type,
                              num_neighbors_pred=30)
    kw = dict(y=cl["y"], gp_coords_pred=COORD_TEST,
              cluster_ids_pred=np.array([1, 3, 1]),
              cov_pars=[0.1, 1.0, 0.15], predict_cov_mat=True,
              predict_var=True)
    pt, pj = tm.predict(**kw), jm.predict(**kw)
    expected_mu = np.array([-0.01438585, 0.0, -0.01500132])
    assert np.sum(np.abs(pt["mu"] - expected_mu)) < 1e-5
    # the unseen cluster 3 at the prior: mean 0, variance sigma2 + nugget
    assert pt["mu"][1] == 0.0 and abs(pt["var"][1] - 1.1) < 1e-12
    if pred_type is not None:
        expected_cov = np.array(
            [0.7430552, 0.0, 0.6423148, 0.0, 1.1, 0.0,
             0.6423148, 0.0, 0.7434589]).reshape(3, 3)
        assert np.sum(np.abs(pt["cov"] - expected_cov)) < 1e-5
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(pt["cov"], pj["cov"], rtol=1e-10, atol=1e-12)


def test_requires_cluster_ids_pred(cl):
    _, tm = _pair(cl)
    with pytest.raises(ValueError, match="cluster_ids_pred"):
        tm.predict(y=cl["y"], gp_coords_pred=np.zeros((2, 2)),
                   cov_pars=[0.1, 1.0, 0.15])


def test_fit_reaches_reference_optimum(cl):
    jm, tm = _pair(cl)
    tm.fit(y=cl["y"], params={"optimizer_cov": "lbfgs", "maxit": 200})
    assert tm.current_nll_ <= 129.3761486 + 1e-3
    assert np.sum(np.abs(tm.cov_pars_ - np.array(CP_REF))) < 0.05


def test_ard_redetermination_keeps_clusters():
    rng = np.random.default_rng(11)
    n = 200
    coords = rng.uniform(size=(n, 2))
    cid = np.repeat([0, 1, 2, 3], n // 4)
    y = rng.standard_normal(n)
    kw = dict(gp_coords=coords, cov_function="matern_ard", cov_fct_shape=1.5,
              gp_approx="vecchia", num_neighbors=10, cluster_ids=cid)
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    cp = np.array([0.3, 1.0, 0.05, 0.4])
    nt = tm.neg_log_likelihood(cp, y)
    nj = jm.neg_log_likelihood(cp, y)
    np.testing.assert_array_equal(tm._approx.neighbors.numpy(),
                                  np.asarray(jm._approx.neighbors))
    assert abs(nt - nj) <= 1e-10 * abs(nj)
    nb = tm._approx.neighbors.numpy()
    cperm = cid[tm._approx.perm]
    assert np.all((nb < 0) | (cperm[np.maximum(nb, 0)] == cperm[:, None]))


@pytest.fixture(scope="module")
def binary():
    rng = np.random.default_rng(5)
    n = 300
    coords = rng.uniform(size=(n, 2))
    cid = np.repeat([0, 1, 2], n // 3)
    f = np.sin(5 * coords[:, 0]) + np.cos(3 * coords[:, 1]) + (cid - 1) * 0.3
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)
    cpp = rng.uniform(size=(10, 2))
    return coords, cid, y, cpp


def test_laplace_with_clusters_matches_jax(binary):
    coords, cid, y, cpp = binary
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=10, cluster_ids=cid,
              likelihood="bernoulli_logit")
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    cp = np.array([1.2, 0.2])
    nt, nj = tm.neg_log_likelihood(cp, y), jm.neg_log_likelihood(cp, y)
    assert abs(nt - nj) <= 1e-8 * abs(nj)
    cidp = np.array([0, 1, 2, 7, 7, 0, 1, 2, 0, 1])
    for resp in (False, True):
        kp = dict(y=y, gp_coords_pred=cpp, cluster_ids_pred=cidp,
                  cov_pars=cp, predict_var=True, predict_response=resp)
        pt, pj = tm.predict(**kp), jm.predict(**kp)
        np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-7,
                                   atol=1e-9)
    # the unseen cluster 7 at the prior (latent scale)
    pt = tm.predict(y=y, gp_coords_pred=cpp, cluster_ids_pred=cidp,
                    cov_pars=cp, predict_var=True, predict_response=False)
    np.testing.assert_allclose(pt["mu"][3:5], 0.0, atol=1e-12)
    np.testing.assert_allclose(pt["var"][3:5], cp[0], rtol=1e-12)


def test_laplace_cg_route_matches_dense(binary, monkeypatch):
    """Above the dense limit the prediction finds the mode by Newton-CG and
    solves the variance's system by CG: the dense route's numbers at 1e-5
    (the limit lowered so both run at n = 300)."""
    coords, cid, y, cpp = binary
    tm = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=10, cluster_ids=cid,
                     likelihood="bernoulli_logit", device="cpu")
    kp = dict(y=y, gp_coords_pred=cpp, cluster_ids_pred=cid[:10],
              cov_pars=[1.2, 0.2], predict_var=True, predict_response=False)
    dense = tm.predict(**kp)
    monkeypatch.setattr(tvm, "DENSE_LAPLACE_MAX_N", 100)
    cg = tm.predict(**kp)
    np.testing.assert_allclose(cg["mu"], dense["mu"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cg["var"], dense["var"], rtol=1e-5, atol=1e-6)


# the counterpart of tests/test_ard_neighbor_redetermination.py: its
# reference goldens (matern_ard 0.5, n = 500, nn = 15, ordering none, on
# anisotropic data, ranges 0.05 / 0.5) at that file's tolerances
ARD_REF_COV_PARS = np.array([0.03910980157575392, 1.8733467246712538,
                             0.053664948544046326, 0.43160282231559743])
ARD_REF_NLL = 550.7744813335787


@pytest.fixture(scope="module")
def aniso():
    rng = np.random.default_rng(11)
    n = 500
    coords = rng.uniform(size=(n, 2))
    D1 = np.abs(coords[:, None, 0] - coords[None, :, 0]) / 0.05
    D2 = np.abs(coords[:, None, 1] - coords[None, :, 1]) / 0.5
    K = 1.5 * np.exp(-np.sqrt(D1 ** 2 + D2 ** 2))
    y = np.linalg.cholesky(K + 0.1 * np.eye(n)) @ rng.standard_normal(n)
    return coords, y


def _ard_fit(coords, y, redetermine=True):
    gp = gpt.GPModel(gp_coords=coords, cov_function="matern_ard",
                     cov_fct_shape=0.5, gp_approx="vecchia",
                     num_neighbors=15, vecchia_ordering="none", device="cpu")
    if not redetermine:
        gp._approx.ensure_neighbors(np.array([0.1, 1.0, 1.0, 1.0]))
        gp._approx.ensure_neighbors = lambda *a, **k: None
    gp.fit(y=y, params={"maxit": 200, "trace": False})
    return gp


def test_ard_redetermination_fit_and_fixed_neighbours(aniso):
    """The fit redetermines the neighbours in the scaled space: the
    reference's nugget within 5 %, its parameters within 15 %, its range
    ratio within 5 %, its NLL within 1; with the neighbours frozen at the
    isotropic inits the same point scores more than 5 nats worse."""
    coords, y = aniso
    gp = _ard_fit(coords, y)
    cp = gp.get_cov_pars()
    np.testing.assert_allclose(cp[0], ARD_REF_COV_PARS[0], rtol=0.05)
    np.testing.assert_allclose(cp, ARD_REF_COV_PARS, rtol=0.15)
    np.testing.assert_allclose(cp[2] / cp[3],
                               ARD_REF_COV_PARS[2] / ARD_REF_COV_PARS[3],
                               rtol=0.05)
    nll = gp.neg_log_likelihood(cp, y)
    assert nll < ARD_REF_NLL + 1.0
    fixed = _ard_fit(coords, y, redetermine=False)
    assert fixed.neg_log_likelihood(cp, y) > nll + 5.0
    assert not np.allclose(fixed.get_cov_pars(), cp, rtol=0.02)
