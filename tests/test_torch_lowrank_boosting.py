"""GPBoost and LaGaBoost with the low-rank GPs, the port against the JAX
package (mirrors the fitc / full-scale-tapering cases of
``tests/test_gpboost_algorithm.py:199-262`` and the slice as a whole). CPU,
float64, the same numpy-seeded inputs through both packages.

- 5 rounds of the GPBoost algorithm with a FITC GP and with a full-scale
  Vecchia GP (on the JAX model's ordering and neighbours): scores 1e-8,
  fitted parameters 1e-6 relative, ``Booster.predict`` with variances 1e-7
  (the JAX package's inner-product distances, see test_torch_fitc.py);
- 3 rounds of LaGaBoost with a ``bernoulli_logit`` FITC GP: scores 1e-8,
  predictions 1e-7;
- the R goldens of ``test_z_GPBoost_algorithm.R:1131,1181`` (friedman3 plus
  an exponential GP, 100 training points) with fitc and full-scale
  tapering at the JAX test's bounds: GP variance within 0.5 and range
  within 0.05 of the reference's, the combined predictions beating the
  trees alone;
- ``Booster`` round trip through its dict keeps the low-rank GP.
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
from gpboost_tpu.utils.rng import sim_rand_unif_boost

import gpboost_tpu_torch as gpt

N = 200
PARAMS = {"num_leaves": 8, "learning_rate": 0.1, "min_data_in_leaf": 10,
          "verbose": -1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def d():
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(N, 2))
    X = rng.uniform(size=(N, 5))
    f = 2 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    b = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    return dict(coords=coords, X=X,
                y=f + b + 0.3 * rng.standard_normal(N),
                yb=(rng.uniform(size=N) < 1 / (1 + np.exp(-(f - 1 + b))))
                .astype(float),
                Xp=rng.uniform(size=(30, 5)), cp=rng.uniform(size=(30, 2)))


def _pair(d, **kw):
    args = dict(gp_coords=d["coords"], cov_function="exponential", **kw)
    jg, tg = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    if kw.get("gp_approx", "").startswith("full_scale_vecchia"):
        tg._approx.load_structure(np.asarray(jg._approx.perm),
                                  np.asarray(jg._approx.neighbors))
    return jg, tg


@pytest.mark.parametrize("approx,kw,objective,rounds", [
    ("fitc", dict(num_ind_points=20), "regression", 5),
    ("full_scale_vecchia", dict(num_ind_points=15, num_neighbors=6),
     "regression", 5),
    ("fitc", dict(num_ind_points=20, likelihood="bernoulli_logit"), "binary",
     3),
])
def test_boosting_with_low_rank_gp_matches_jax(d, approx, kw, objective,
                                               rounds):
    jg, tg = _pair(d, gp_approx=approx, **kw)
    if objective == "regression":
        for g in (jg, tg):
            g.set_optim_params({"optimizer_cov": "lbfgs"})
    label = d["y"] if objective == "regression" else d["yb"]
    params = dict(PARAMS, objective=objective)
    jb = gpb.train(params, gpb.Dataset(d["X"], label), gp_model=jg,
                   num_boost_round=rounds)
    tb = gpt.train(params, gpt.Dataset(d["X"], label=label, device="cpu"),
                   gp_model=tg, num_boost_round=rounds)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tg.get_cov_pars(), jg.get_cov_pars(),
                               rtol=1e-6)
    pj = jb.predict(d["Xp"], gp_coords_pred=d["cp"], predict_var=True)
    pt = tb.predict(d["Xp"], gp_coords_pred=d["cp"], predict_var=True)
    for key in ("response_mean", "response_var"):
        np.testing.assert_allclose(pt[key], pj[key], rtol=0, atol=1e-7)
    # the Booster keeps the low-rank GP through its dict
    tb2 = gpt.Booster(model_str=tb.model_to_string(), device="cpu")
    assert tb2.gp_model.gp_approx == approx
    p2 = tb2.predict(d["Xp"], gp_coords_pred=d["cp"], predict_var=True)
    np.testing.assert_allclose(p2["response_mean"], pt["response_mean"],
                               rtol=1e-10, atol=1e-12)


def _sim_gp_boost_data():
    """test_z_GPBoost_algorithm.R:1131-1161 (fitc / FSA blocks): friedman3
    fixed effects + an exponential GP + noise, 100 train / 100 test."""
    n = 200
    x = sim_rand_unif_boost(4 * n, init_c=0.24234)
    X = np.column_stack([x[:n], x[n:2 * n], x[2 * n:3 * n], x[3 * n:]])
    X[:, 0] = 100 * X[:, 0]
    X[:, 1] = X[:, 1] * np.pi * (560 - 40) + 40 * np.pi
    X[:, 3] = X[:, 3] * 10 + 1
    f = np.sqrt(10) * np.arctan(
        (X[:, 1] * X[:, 2] - 1 / (X[:, 1] * X[:, 3])) / X[:, 0])
    xi = sim_rand_unif_boost(5 * n, init_c=0.6543)
    X = np.column_stack([np.ones(n), X] + [xi[i * n:(i + 1) * n]
                                           for i in range(5)])
    u = sim_rand_unif_boost(n * 2, init_c=0.63)
    coords = np.column_stack([u[:n], u[n:]])
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    eps = C @ norm.ppf(sim_rand_unif_boost(n, 0.864))
    y = f + eps + np.sqrt(0.1) * norm.ppf(sim_rand_unif_boost(n, 0.36))
    return dict(X=X, coords=coords, y=y)


@pytest.mark.parametrize("approx,kw,ref_cov", [
    ("fitc", dict(num_ind_points=50), (0.009778865, 1.142124739, 0.072746954)),
    ("full_scale_tapering", dict(num_ind_points=50, cov_fct_taper_range=0.5),
     (0.00947784, 1.14864, 0.0729985)),
])
def test_gpboost_algorithm_with_gp_approximations(approx, kw, ref_cov):
    f = _sim_gp_boost_data()
    nt = 100
    ct = f["coords"][:nt]
    dists = np.sqrt(((ct[:, None] - ct[None]) ** 2).sum(-1))
    y_train = f["y"][:nt]
    init = [np.var(y_train) / 2, np.var(y_train) / 2,
            np.mean(dists[np.triu_indices(nt, 1)]) / 3]
    gp = gpt.GPModel(gp_coords=ct, cov_function="matern", cov_fct_shape=1.5,
                     gp_approx=approx, device="cpu", **kw)
    gp.set_optim_params(params=dict(maxit=20,
                                    optimizer_cov="gradient_descent",
                                    init_cov_pars=init))
    bst = gpt.train({"learning_rate": 0.05, "max_depth": 6,
                     "min_data_in_leaf": 5, "objective": "regression_l2",
                     "verbose": -1},
                    gpt.Dataset(f["X"][:nt], label=y_train, device="cpu"),
                    gp_model=gp, num_boost_round=20)
    cp = gp.get_cov_pars()
    assert np.all(np.isfinite(cp))
    assert abs(cp[1] - ref_cov[1]) < 0.5 and abs(cp[2] - ref_cov[2]) < 0.05
    pred = bst.predict(f["X"][nt:], gp_coords_pred=f["coords"][nt:],
                       predict_var=True, pred_latent=True)
    assert np.all(np.isfinite(pred["fixed_effect"]))
    assert np.all(np.isfinite(pred["random_effect_mean"]))
    assert np.all(np.asarray(pred["random_effect_cov"]) >= 0)
    resp = pred["fixed_effect"] + pred["random_effect_mean"]
    mse_combined = float(np.mean((f["y"][nt:] - resp) ** 2))
    mse_trees = float(np.mean((f["y"][nt:] - pred["fixed_effect"]) ** 2))
    assert mse_combined < mse_trees
