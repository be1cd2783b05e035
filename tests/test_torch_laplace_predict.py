"""The port's Vecchia-Laplace prediction vs the JAX package's, float64 on
the CPU, on the same ordering and neighbours:

- ``predict_laplace`` (dense mode, local kriging on it, posterior variance
  through Q + W): latent and response mean and variance at 1e-6;
- ``predict_laplace_sim`` (Newton-CG mode, simulated variances): the mean at
  1e-6 against the JAX package's; the variance, a Monte-Carlo estimate of
  D_p + diag(B_po (Q + W)^-1 B_po'), against that quantity computed densely
  here, within 5 standard errors of the estimate
  (sqrt(2 / nsim) relative to its simulated part) — the two packages draw
  different normal vectors;
- ``GPModel.predict`` takes the simulated route with ``nsim_var_pred``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops import vecchia as tv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, M, NP, NSIM = 150, 8, 12, 256
CP = [1.3, 0.2]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    args = dict(gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=M,
                likelihood="bernoulli_logit")
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    return dict(jm=jm, tm=tm, y=y, fe=0.3 * rng.standard_normal(N),
                pred=rng.uniform(size=(NP, 2)),
                fep=0.2 * rng.standard_normal(NP))


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("response", [False, True])
def test_predict_laplace_matches_jax(case, response):
    jv, tv_ = case["jm"]._approx, case["tm"]._approx
    mj, vj = jv.predict_laplace(jnp.asarray(CP), jnp.asarray(case["y"]), None,
                                case["pred"], jnp.asarray(case["fe"]),
                                jnp.asarray(case["fep"]), response, True)
    mt, vt = tv_.predict_laplace(_t(CP), _t(case["y"]), None, _t(case["pred"]),
                                 _t(case["fe"]), _t(case["fep"]), response,
                                 True)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)


def test_predict_laplace_sim_matches_jax_mean_and_mc_variance(case):
    jv, vec = case["jm"]._approx, case["tm"]._approx
    mj, _ = jv.predict_laplace_sim(jnp.asarray(CP), jnp.asarray(case["y"]),
                                   None, case["pred"], jnp.asarray(case["fe"]),
                                   None, False, True, nsim=8)
    with torch.no_grad():
        mt, vt = vec.predict_laplace_sim(_t(CP), _t(case["y"]), None,
                                         _t(case["pred"]), _t(case["fe"]),
                                         None, False, True, nsim=NSIM)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
    # the quantity the draws estimate, densely: D_p + diag(B H^-1 B'),
    # H = Q + W at the mode, B the latent conditioning weights (observed
    # points in original order)
    with torch.no_grad():
        cp = _t(CP)
        b, w, Q = vec._find_mode_dense(cp, _t(case["y"]), None, _t(case["fe"]))
        w = torch.clamp(w, min=1e-10)
        H = Q + torch.diag(w)
        pred = _t(case["pred"])
        nb = vec._pred_neighbors(cp, pred)
        a_p, d_p = tv.build_factors(vec.cov_fn, cp, vec.coords, nb, None,
                                    False, row_coords=pred)
        Bpo = torch.zeros((NP, N), dtype=torch.float64)
        for i in range(NP):
            for j in range(nb.shape[1]):
                if nb[i, j] >= 0:
                    Bpo[i, vec.inv_perm[int(nb[i, j])]] += a_p[i, j]
        sim_part = torch.einsum("pn,nm,pm->p", Bpo, torch.linalg.inv(H), Bpo)
    want = (d_p + sim_part).numpy()
    err = np.abs(vt.numpy() - want)
    assert np.all(err <= 5 * np.sqrt(2.0 / NSIM) * sim_part.numpy() + 1e-10)


def test_gp_model_predict_routes(case):
    tm = case["tm"]
    tm.cov_pars_ = np.asarray(CP)
    dense = tm.predict(y=case["y"], gp_coords_pred=case["pred"],
                       predict_var=True)
    tm.set_prediction_data(nsim_var_pred=NSIM)
    sim = tm.predict(y=case["y"], gp_coords_pred=case["pred"],
                     predict_var=True)
    tm.nsim_var_pred = None
    np.testing.assert_allclose(sim["mu"], dense["mu"], atol=2e-2)
    assert np.all((sim["mu"] > 0) & (sim["mu"] < 1))
    np.testing.assert_allclose(sim["var"], sim["mu"] * (1 - sim["mu"]),
                               rtol=1e-12)
