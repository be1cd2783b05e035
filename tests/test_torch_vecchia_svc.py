"""GP random coefficients on the port's Vecchia GP (the SVC build,
``ops/vecchia.py::build_factors_svc``) on the CPU, float64 — the
counterpart of ``tests/test_vecchia_rand_coef_golden.py`` (its R goldens at
that file's tolerances) and of the SVC half of
``tests/test_vecchia_laplace_cluster_svc.py``, held against the JAX
package on the same inputs:

- the SVC factors, the NLL and its gradient equal the JAX package's at
  1e-10 relative; the predictions (default and ``order_obs_first_cond_all``,
  with ``gp_rand_coef_data_pred``) too;
- a float32 model stays outside the kernel gate (the JAX package's gate
  excludes random coefficients), so its fits run the plain build;
- ``bernoulli_probit`` with two coefficients: the dense Laplace NLL and
  prediction at 1e-8, the reference's numbers at the JAX file's
  tolerances, a fit that improves on the evaluation point;
- the refusals of the JAX package: an anisotropic covariance, the
  order_pred_first and latent prediction types, ``vecchia_latent``.
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
from gpboost_tpu.ops import vecchia as jvops
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops import vecchia as tvops
from gpboost_tpu_torch.ops.cov_fns import CovFunction

COV_PARS = [0.1, 1.0, 0.1, 0.8, 0.15, 1.1, 0.08]
COORD_TEST = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
Z_TEST = np.column_stack([[0.1, 0.3, 0.7], [0.5, 0.2, 0.4]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def svc(gp_fixture_data):
    d = gp_fixture_data
    return dict(y=d["eps_svc"] + d["xi"], coords=d["coords"], Z=d["Z_SVC"],
                n=d["n"])


def _pair(svc, nn=30, **kw):
    kw = dict(dict(gp_coords=svc["coords"], cov_function="exponential",
                   gp_approx="vecchia", num_neighbors=nn,
                   vecchia_ordering="none", gp_rand_coef_data=svc["Z"]), **kw)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


def test_svc_factors_equal_jax(svc):
    import jax.numpy as jnp
    from gpboost_tpu.ops.cov_fns import CovFunction as JCov
    coords = svc["coords"]
    z = np.column_stack([np.ones(svc["n"]), svc["Z"]])
    ps = np.asarray(COV_PARS[1:]).reshape(3, 2)
    nb = np.array(jvops.find_neighbors(coords, 10, method="exact"))
    aj, dj = jvops.build_factors_svc(JCov.create("exponential"),
                                     jnp.asarray(ps), jnp.asarray(coords),
                                     jnp.asarray(nb), jnp.asarray(z),
                                     jnp.asarray(0.1), True)
    at, dt = tvops.build_factors_svc(CovFunction.create("exponential"),
                                     torch.as_tensor(ps),
                                     torch.as_tensor(coords),
                                     torch.as_tensor(nb), torch.as_tensor(z),
                                     torch.as_tensor(0.1), True)
    # the two Cholesky routines (the JAX package's unrolled one, LAPACK's)
    # round differently on these blocks: ~1e-9 apart, as the plain build's
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-8)


@pytest.mark.parametrize("nn,golden", [(102, 149.4422184),
                                       (30, 149.4840466)])
def test_nll_golden_and_jax(svc, nn, golden):
    jm, tm = _pair(svc, nn)
    nt = tm.neg_log_likelihood(cov_pars=COV_PARS, y=svc["y"])
    assert abs(nt - golden) < 1e-5
    nj = jm.neg_log_likelihood(cov_pars=COV_PARS, y=svc["y"])
    assert abs(nt - nj) <= 1e-10 * abs(nj)
    import jax.numpy as jnp
    th = np.log(np.asarray(COV_PARS))
    _, gt = tm._approx._vg_gaussian(torch.as_tensor(th),
                                    tm._y_tensor(svc["y"]), None)
    _, gj = jm._approx._vg_gaussian(jnp.asarray(th), jnp.asarray(svc["y"]),
                                    None)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("nn,pred_type,mu,cov", [
    (30, None, [-0.1688452, 1.6181756, 0.2849745],
     np.diag([0.9643376, 0.5155030, 0.7702683])),
    (102, "order_obs_first_cond_all", [-0.1669209, 1.6166381, 0.2861320],
     np.array([9.643323e-01, 3.536846e-04, -1.783557e-04, 3.536846e-04,
               5.155009e-01, 4.554321e-07, -1.783557e-04, 4.554321e-07,
               7.701614e-01]).reshape(3, 3)),
], ids=["cond_obs_only", "cond_all"])
def test_prediction_golden_and_jax(svc, nn, pred_type, mu, cov):
    jm, tm = _pair(svc, nn)
    for m in (jm, tm):
        # cond_all keeps the default 2 m: every earlier point conditions
        m.set_prediction_data(vecchia_pred_type=pred_type,
                              num_neighbors_pred=None if pred_type else nn)
    kw = dict(y=svc["y"], gp_coords_pred=COORD_TEST,
              gp_rand_coef_data_pred=Z_TEST, cov_pars=COV_PARS,
              predict_cov_mat=True, predict_response=True)
    pt, pj = tm.predict(**kw), jm.predict(**kw)
    assert np.sum(np.abs(pt["mu"] - mu)) < 1e-5
    assert np.sum(np.abs(pt["cov"] - cov)) < 1e-5
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(pt["cov"], pj["cov"], rtol=1e-10, atol=1e-12)
    # without the coefficient data the coefficient processes are absent
    kw.pop("gp_rand_coef_data_pred")
    np.testing.assert_allclose(tm.predict(**kw)["mu"], jm.predict(**kw)["mu"],
                               rtol=1e-10, atol=1e-12)


def test_fit_reaches_good_nll(svc):
    _, tm = _pair(svc)
    tm.fit(y=svc["y"], params={"optimizer_cov": "lbfgs", "maxit": 200})
    r_pars = [0.34489931519, 0.79813421101, 0.15144409082, 1.14797483590,
              0.10321260903, 0.32243986621, 0.10613523300]
    assert tm.current_nll_ <= tm.neg_log_likelihood(r_pars, svc["y"]) + 1e-3
    assert tm.get_cov_pars().shape == (7,)


def test_float32_stays_outside_the_kernel_gate(svc):
    tm = gpt.GPModel(gp_coords=svc["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=30,
                     gp_rand_coef_data=svc["Z"], dtype=torch.float32,
                     device="cpu")
    assert tm._approx._kernel_shape is None
    t64 = gpt.GPModel(gp_coords=svc["coords"], cov_function="exponential",
                      gp_approx="vecchia", num_neighbors=30,
                      gp_rand_coef_data=svc["Z"], device="cpu")
    assert abs(tm.neg_log_likelihood(COV_PARS, svc["y"])
               - t64.neg_log_likelihood(COV_PARS, svc["y"])) < 1e-3


@pytest.mark.parametrize("kwargs,match", [
    (dict(cov_function="matern_ard"), "isotropic"),
    (dict(gp_approx="vecchia_latent"), "random coefficients"),
], ids=["ard", "vecchia_latent"])
def test_refusals_as_jax(svc, kwargs, match):
    kw = dict(gp_coords=svc["coords"], cov_function="exponential",
              gp_approx="vecchia", num_neighbors=10,
              gp_rand_coef_data=svc["Z"])
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=match):
        gpb.GPModel(**kw)
    with pytest.raises(NotImplementedError, match=match):
        gpt.GPModel(device="cpu", **kw)


@pytest.mark.parametrize("pred_type", [
    "order_pred_first", "latent_order_obs_first_cond_all"])
def test_prediction_types_refused_as_jax(svc, pred_type):
    jm, tm = _pair(svc, 10)
    for m in (jm, tm):
        m.set_prediction_data(vecchia_pred_type=pred_type)
        with pytest.raises(NotImplementedError):
            m.predict(y=svc["y"], gp_coords_pred=COORD_TEST,
                      gp_rand_coef_data_pred=Z_TEST, cov_pars=COV_PARS)


@pytest.fixture(scope="module")
def probit():
    n, d = 100, 2
    x = sim_rand_unif(n * d, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    L = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    b_1 = sim_rand_normal(n, 0.8)
    Z = sim_rand_unif(n * 2, init_c=0.6)
    Z = np.column_stack([Z[:n], Z[n:]])
    lat = (L @ b_1 + Z[:, 0] * (L @ sim_rand_normal(n, 0.17))
           + Z[:, 1] * (L @ sim_rand_normal(n, 0.42)))
    y = (sim_rand_unif(n, 0.2341) < norm.cdf(lat)).astype(float)
    return coords, Z, y


def test_laplace_svc_golden_and_jax(probit):
    coords, Z, y = probit
    cp6 = [1.0, 0.1, 0.8, 0.15, 1.1, 0.08]
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=30, vecchia_ordering="none",
              gp_rand_coef_data=Z, likelihood="bernoulli_probit")
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    nt, nj = tm.neg_log_likelihood(cp6, y), jm.neg_log_likelihood(cp6, y)
    assert abs(nt - 68.09646538002839) < 1e-2
    assert abs(nt - nj) <= 1e-8 * abs(nj)
    kp = dict(y=y, gp_coords_pred=COORD_TEST, gp_rand_coef_data_pred=Z_TEST,
              cov_pars=cp6, predict_var=True, predict_response=False)
    pt, pj = tm.predict(**kp), jm.predict(**kp)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-7, atol=1e-9)
    assert np.sum(np.abs(pt["mu"] - [-0.58896723, 0.80410562,
                                     0.05818104])) < 1e-2
    assert np.sum(np.abs(pt["var"] - [1.05326874, 0.75989763,
                                      0.90526827])) < 5e-2
    pr = tm.predict(**dict(kp, predict_response=True))
    assert np.sum(np.abs(pr["mu"] - [0.3405271, 0.72778746,
                                     0.51681067])) < 1e-2


def test_laplace_svc_fit(probit):
    coords, Z, y = probit
    tm = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=30,
                     vecchia_ordering="none", gp_rand_coef_data=Z,
                     likelihood="bernoulli_probit", device="cpu")
    tm.fit(y=y, params={"optimizer_cov": "lbfgs", "maxit": 100,
                        "init_cov_pars": [1.0, 0.1, 0.8, 0.15, 1.1, 0.08]})
    assert tm.current_nll_ <= 68.09646538002839 + 1e-3
