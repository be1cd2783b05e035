"""A Vecchia GP with grouped random effects in the port
(``models/vecchia_combined.py``: Woodbury in the q columns of the grouped
part, Cholesky and iterative routes) on the CPU, float64 — the
counterpart of ``tests/test_combined_golden.py::TestCombinedVecchia`` and
``tests/test_vecchia_combined_iterative.py``, against the JAX package on
the same inputs:

- with n - 1 neighbours the NLL is the dense combined model's (1e-6, the
  JAX file's bound); with 20 the NLL equals the JAX package's at 1e-10
  relative, its gradient at 1e-8, Psi^-1 R at 1e-10;
- the L-BFGS fit meets the JAX package's optimum (1e-5 relative), the
  prediction with unseen levels its numbers (1e-7: its distances come from
  inner products);
- the iterative route with the JAX package's probes equals its NLL and
  gradient at 1e-5, and its Psi^-1 R and predictions meet the Cholesky
  route's at 1e-4 (the JAX file's tolerances);
- GPBoost with the combined model and held covariance parameters: the
  training scores after each of 3 rounds and ``Booster.predict`` (unseen
  levels included) equal the JAX package's at 1e-6;
- the combinations the JAX package refuses raise here too.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.utils.rng import sim_rand_normal

import gpboost_tpu_torch as gpt

CP = [0.1, 0.5, 1.0, 0.15]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cdata(gp_fixture_data):
    f = gp_fixture_data
    n, m = f["n"], 10
    group = np.repeat(np.arange(1, m + 1), n // m)
    y = f["eps"] + sim_rand_normal(m, 0.56)[group - 1] + f["xi"]
    return dict(coords=f["coords"], group=group, y=y, n=n)


def _pair(cd, nn=20, **kw):
    kw = dict(dict(group_data=cd["group"], gp_coords=cd["coords"],
                   cov_function="exponential", gp_approx="vecchia",
                   num_neighbors=nn, vecchia_ordering="none"), **kw)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


def test_all_neighbors_equal_dense(cdata):
    _, tm = _pair(cdata, cdata["n"] - 1)
    dense = gpt.GPModel(group_data=cdata["group"], gp_coords=cdata["coords"],
                        cov_function="exponential", device="cpu")
    assert abs(tm.neg_log_likelihood(CP, cdata["y"])
               - dense.neg_log_likelihood(CP, cdata["y"])) < 1e-6


def test_nll_gradient_psi_inv_match_jax(cdata):
    import jax.numpy as jnp
    jm, tm = _pair(cdata)
    nt = tm.neg_log_likelihood(CP, cdata["y"])
    nj = jm.neg_log_likelihood(CP, cdata["y"])
    assert abs(nt - nj) <= 1e-10 * abs(nj)
    th = np.log(CP)
    _, gt = tm._approx._vg_gaussian(torch.as_tensor(th),
                                    tm._y_tensor(cdata["y"]), None)
    _, gj = jm._approx._vg_gaussian(jnp.asarray(th), jnp.asarray(cdata["y"]),
                                    None)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-10)
    R = np.random.default_rng(1).standard_normal((cdata["n"], 3))
    pt = tm._approx.psi_inv_mul(torch.as_tensor(CP, dtype=torch.float64),
                                torch.as_tensor(R))
    pj = jm._approx.psi_inv_mul(jnp.asarray(CP), jnp.asarray(R))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-10,
                               atol=1e-10)


def test_fit_and_predict_match_jax(cdata):
    jm, tm = _pair(cdata)
    params = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.05, 0.5, 1.0,
                                                          0.1]}
    tm.fit(y=cdata["y"], params=params)
    jm.fit(y=cdata["y"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)
    coord_test = np.array([[0.1, 0.9], [0.2, 0.4], [0.7, 0.55]])
    kw = dict(y=cdata["y"], gp_coords_pred=coord_test,
              group_data_pred=[1, 3, 9999], predict_var=True,
              predict_response=True, cov_pars=CP)
    pt, pj = tm.predict(**kw), jm.predict(**kw)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-7)
    # unseen levels only: the grouped part adds its prior variance, the
    # mean is the GP's
    ku = dict(kw, group_data_pred=[9999, 9998, 9999], predict_response=False)
    pu, ju = tm.predict(**ku), jm.predict(**ku)
    np.testing.assert_allclose(pu["mu"], ju["mu"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(pu["var"], ju["var"], rtol=1e-7)


def _jax_probes(jm, k):
    import jax
    from gpboost_tpu.ops import cg as jcg
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    q = jm._approx.q_total
    return (torch.as_tensor(np.asarray(jax.random.normal(k1, (q, k)))),
            torch.as_tensor(np.asarray(jcg.rademacher_probes(k2, q, k))))


def test_iterative_matches_jax_and_cholesky(cdata):
    import jax.numpy as jnp
    jc, tc = _pair(cdata)
    ji, ti = _pair(cdata, matrix_inversion_method="iterative")
    for m in (ji, ti):
        m.set_optim_params(params={"cg_delta_conv": 1e-6,
                                   "num_rand_vec_trace": 200})
    ti._approx.sync_iter_cfg(ti.optim_cfg)
    ji._approx.sync_iter_cfg(ji.optim_cfg)
    probes = _jax_probes(ji, 200)
    th = torch.log(torch.as_tensor(CP, dtype=torch.float64)
                   ).requires_grad_(True)
    nt = ti._approx.nll_gaussian_iterative(torch.exp(th),
                                           ti._y_tensor(cdata["y"]),
                                           probes=probes)
    (gt,) = torch.autograd.grad(nt, th)
    nj, gj = ji._approx._vg_gaussian(jnp.log(jnp.asarray(CP)),
                                     jnp.asarray(cdata["y"]), None)
    assert abs(float(nt) - float(nj)) <= 1e-5 * abs(float(nj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)
    # the iterative value against the Cholesky one (stochastic Lanczos)
    assert abs(float(nt) - tc.neg_log_likelihood(CP, cdata["y"])) \
        < 1e-3 * abs(float(nt))
    R = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (cdata["n"], 3)))
    cpt = torch.as_tensor(CP, dtype=torch.float64)
    np.testing.assert_allclose(ti._approx.psi_inv_mul(cpt, R).numpy(),
                               tc._approx.psi_inv_mul(cpt, R).numpy(),
                               rtol=1e-4, atol=1e-5)
    kw = dict(y=cdata["y"], gp_coords_pred=np.array([[0.1, 0.9],
                                                     [0.5, 0.5]]),
              group_data_pred=[1, 999], cov_pars=CP, predict_var=True)
    pi, pc = ti.predict(**kw), tc.predict(**kw)
    np.testing.assert_allclose(pi["mu"], pc["mu"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pi["var"], pc["var"], rtol=1e-4, atol=1e-5)


def test_gpboost_with_held_cov_pars_matches_jax(cdata):
    rng = np.random.default_rng(3)
    n = cdata["n"]
    X = rng.uniform(size=(n, 2))
    y = cdata["y"] + 2 * np.sin(4 * X[:, 0])
    params = {"objective": "regression", "num_leaves": 4,
              "learning_rate": 0.1, "min_data_in_leaf": 5, "verbose": -1,
              "train_gp_model_cov_pars": False}
    jm, tm = _pair(cdata)
    jm.cov_pars_ = tm.cov_pars_ = np.asarray(CP, np.float64)
    jb = gpb.Booster(params=dict(params), train_set=gpb.Dataset(X, label=y),
                     gp_model=jm)
    tb = gpt.Booster(params=dict(params),
                     train_set=gpt.Dataset(X, label=y, device="cpu"),
                     gp_model=tm)
    for _ in range(3):
        jb.update()
        tb.update()
        np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-6)
    Xp = rng.uniform(size=(4, 2))
    kw = dict(gp_coords_pred=rng.uniform(size=(4, 2)),
              group_data_pred=[1, 2, 3, 999], predict_var=True,
              pred_latent=True)
    got, want = tb.predict(Xp, **kw), jb.predict(Xp, **kw)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kwargs", [
    dict(likelihood="bernoulli_logit"),
    dict(cluster_ids=np.repeat([0, 1], 50)),
    dict(gp_rand_coef_data=np.ones((100, 1))),
    dict(gp_approx="vecchia_latent")],
    ids=["bernoulli", "cluster_ids", "rand_coef", "vecchia_latent"])
def test_refusals_as_jax(cdata, kwargs):
    kw = dict(group_data=cdata["group"], gp_coords=cdata["coords"],
              gp_approx="vecchia", num_neighbors=10)
    kw.update(kwargs)
    with pytest.raises(NotImplementedError):
        gpb.GPModel(**kw)
    with pytest.raises(NotImplementedError):
        gpt.GPModel(device="cpu", **kw)


@pytest.mark.parametrize("kind", ["group_data", "cluster_ids",
                                  "gp_rand_coef_data"])
def test_model_dict_round_trip(cdata, kind):
    """``model_to_dict`` / ``from_dict`` keep the structure beside the
    Vecchia GP: the rebuilt model's NLL is the original's."""
    value = {"group_data": cdata["group"],
             "cluster_ids": np.repeat([0, 1], cdata["n"] // 2),
             "gp_rand_coef_data": np.linspace(0, 1, cdata["n"])}[kind]
    tm = gpt.GPModel(gp_coords=cdata["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=10, device="cpu",
                     **{kind: value})
    cp = ([0.1, 0.5, 1.0, 0.15] if kind == "group_data" else
          [0.1, 1.0, 0.15] + ([0.5, 0.2] if kind == "gp_rand_coef_data"
                              else []))
    tm.cov_pars_ = np.asarray(cp)
    back = gpt.GPModel.from_dict(tm.model_to_dict(), device="cpu")
    assert back.neg_log_likelihood(cp, cdata["y"]) == \
        tm.neg_log_likelihood(cp, cdata["y"])
