"""The ported path as a whole vs the JAX package: ``GPModel`` construct,
NLL, L-BFGS fit, predict, state carried across (n = 600, m = 10, d = 2,
float64, CPU; inputs from a numpy seed handed to both sides).

Tolerances: NLL 1e-8; fitted NLL 1e-5 relative and ``cov_pars_`` rtol 2e-2
(both packages fit with scipy's L-BFGS-B on the CPU; kept from when the
port ran its device loop there); coefficients 1e-3; predictions at
carried-over parameters 1e-8. Gradient descent (the default route) and
Nelder-Mead: 1e-6 relative. Std errors: 1e-6 relative.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other (a GD fit here took
    ~580 s with six processes at once, 4.5 s with one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

N, M = 600, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    # an exponential-GP draw (range 0.1) plus noise: a well-identified
    # optimum, so that two optimisers with different stop rules agree on it
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    chol = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-10 * np.eye(N))
    X = np.column_stack([np.ones(N), coords[:, 0] - 0.5])
    y = (chol @ rng.standard_normal(N) + 0.4 * rng.standard_normal(N)
         + X @ np.array([0.5, 1.0]))
    pred = rng.uniform(size=(150, 2))
    return dict(coords=coords, y=y, X=X, pred=pred,
                Xp=np.column_stack([np.ones(150), pred[:, 0] - 0.5]))


def _models(data, cov_function="exponential", **kw):
    jm = gpb.GPModel(gp_coords=data["coords"], cov_function=cov_function,
                     gp_approx="vecchia", num_neighbors=M, **kw)
    tm = gpt.GPModel(gp_coords=data["coords"], cov_function=cov_function,
                     gp_approx="vecchia", num_neighbors=M, device="cpu",
                     **kw)
    return jm, tm


@pytest.fixture(scope="module")
def fitted(data):
    jm, tm = _models(data)
    jm.fit(data["y"], params={"optimizer_cov": "lbfgs"})
    tm.fit(data["y"], params={"optimizer_cov": "lbfgs"})
    return jm, tm


def test_structure_matches_jax(data):
    jm, tm = _models(data)
    np.testing.assert_array_equal(tm._approx.perm, np.asarray(jm._approx.perm))
    np.testing.assert_array_equal(
        np.sort(tm._approx.neighbors.numpy(), axis=1),
        np.sort(np.asarray(jm._approx.neighbors), axis=1))
    assert tm._approx.num_neighbors_pred == jm._approx.num_neighbors_pred == 20


@pytest.mark.parametrize("cov_function,shape,cp", [
    ("exponential", 1.5, [0.25, 1.0, 0.1]),
    ("matern", 2.5, [0.25, 1.0, 0.1]),
    ("gaussian", 1.5, [0.25, 1.0, 0.1]),
    ("matern_ard", 1.5, [0.25, 1.0, 0.1, 0.2]),
])
def test_neg_log_likelihood_matches_jax(data, cov_function, shape, cp):
    jm, tm = _models(data, cov_function, cov_fct_shape=shape)
    want = jm.neg_log_likelihood(cp, data["y"])
    got = tm.neg_log_likelihood(cp, data["y"])
    assert abs(got - want) < 1e-8
    fe = 0.1 * data["X"][:, 1]
    assert abs(tm.neg_log_likelihood(cp, data["y"], fixed_effects=fe)
               - jm.neg_log_likelihood(cp, data["y"], fixed_effects=fe)) < 1e-8


def test_default_init_matches_jax(data):
    jm, tm = _models(data)
    np.testing.assert_allclose(tm._default_init_cov_pars(data["y"]),
                               jm._default_init_cov_pars(data["y"]),
                               rtol=1e-14)


def test_fit_lbfgs_reaches_the_jax_optimum(fitted):
    jm, tm = fitted
    nll_j = jm.get_current_neg_log_likelihood()
    nll_t = tm.get_current_neg_log_likelihood()
    assert abs(nll_t - nll_j) < 1e-5 * abs(nll_j)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=2e-2)
    assert tm.get_num_optim_iter() > 0
    assert np.all(tm.get_cov_pars() > 0)


def test_fit_with_linear_predictor_matches_jax(data):
    jm, tm = _models(data)
    jm.fit(data["y"], X=data["X"], params={"optimizer_cov": "lbfgs"})
    tm.fit(data["y"], X=data["X"], params={"optimizer_cov": "lbfgs"})
    np.testing.assert_allclose(tm.get_coef(), jm.coefs_, rtol=0, atol=1e-3)
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(tm.get_current_neg_log_likelihood() - nll_j) \
        < 1e-5 * abs(nll_j)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=2e-2)
    pj = jm.predict(gp_coords_pred=data["pred"], X_pred=data["Xp"],
                    predict_var=True, cov_pars=tm.get_cov_pars())
    tm_pred = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    pt = tm_pred.predict(gp_coords_pred=data["pred"], X_pred=data["Xp"],
                         predict_var=True, cov_pars=tm.get_cov_pars())
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("predict_response", [True, False])
def test_predict_from_jax_state_matches_jax(data, fitted, predict_response):
    """``from_dict`` of the JAX model's ``model_to_dict()``: same
    predictions from the carried-over parameters."""
    jm, _ = fitted
    tm = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(tm.get_cov_pars(), jm.get_cov_pars())
    pj = jm.predict(gp_coords_pred=data["pred"], predict_var=True,
                    predict_response=predict_response)
    pt = tm.predict(gp_coords_pred=data["pred"], predict_var=True,
                    predict_response=predict_response)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-8)
    assert pt["cov"] is None
    assert np.all(pt["var"] > 0)


def test_round_trip_through_own_dict_and_file(data, fitted, tmp_path):
    _, tm = fitted
    tm.save_model(tmp_path / "m.json")
    back = gpt.GPModel.load_model(tmp_path / "m.json", device="cpu")
    p0 = tm.predict(gp_coords_pred=data["pred"], predict_var=True)
    p1 = back.predict(gp_coords_pred=data["pred"], predict_var=True)
    np.testing.assert_allclose(p1["mu"], p0["mu"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(p1["var"], p0["var"], rtol=0, atol=1e-12)
    # and the JAX package reads the port's dictionary
    jm = gpb.GPModel.from_dict(tm.model_to_dict())
    pj = jm.predict(gp_coords_pred=data["pred"], predict_var=True)
    np.testing.assert_allclose(p0["mu"], pj["mu"], rtol=0, atol=1e-8)


def test_float32_model_takes_the_kernel_route_on_cpu_plain(data):
    """A float32 model is inside the kernel gate; on CPU tensors the
    wrappers use the plain versions and count no launch."""
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    vk.reset_launch_counts()
    tm = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M,
                     dtype=torch.float32, device="cpu")
    assert tm._approx._kernel_shape == (0.5, False)
    _, t64 = _models(data)
    assert t64._approx._kernel_shape is None
    cp = [0.25, 1.0, 0.1]
    assert abs(tm.neg_log_likelihood(cp, data["y"])
               - t64.neg_log_likelihood(cp, data["y"])) < 1e-3
    # on the CPU the fit runs scipy's L-BFGS-B, as the JAX package's CPU
    # route does; the device loop (and its fused Psi^-1 r) is for CUDA
    tm.fit(data["y"], params={"optimizer_cov": "lbfgs", "maxit": 5})
    assert tm._fit_result.aux is None
    assert tm._fit_result.num_evals >= 2
    assert vk.launch_counts() == {"vecchia_factors": 0,
                                  "vecchia_nll_grad": 0}


@pytest.mark.parametrize("kwargs", [
    dict(gp_approx="none"), dict(gp_approx="fitc"),
    dict(gp_approx="vecchia", likelihood="gaussian_heteroscedastic"),
    dict(gp_approx="vecchia", group_data=np.zeros(N)),
    dict(gp_approx="vecchia", cluster_ids=np.zeros(N)),
    dict(gp_approx="vecchia", gp_rand_coef_data=np.ones((N, 1))),
    dict(gp_approx="vecchia", cov_function="wendland"),
    dict(gp_approx="vecchia", cov_function="matern", cov_fct_shape=0.7),
])
def test_unported_options_raise_not_implemented(data, kwargs):
    """Structures the port does not have raise naming their ROADMAP item.
    ``gp_approx="none"`` (the exact GP) and ``"fitc"`` are ported, and so
    are (ROADMAP.md item 15) the heteroscedastic model, grouped effects,
    ``cluster_ids`` and GP random coefficients beside a Vecchia GP, and
    (item 14) the wendland covariance and a general Matern shape: they
    construct, and their NLL is the JAX package's within 1e-10 relative."""
    ported = {"none": [0.25, 1.0, 0.1], "fitc": [0.25, 1.0, 0.1],
              "likelihood": [1.0, 0.1, 0.1, 0.2],
              "group_data": [0.25, 0.3, 1.0, 0.1],
              "cluster_ids": [0.25, 1.0, 0.1],
              "gp_rand_coef_data": [0.25, 1.0, 0.1, 0.5, 0.1],
              "cov_function": ([0.25, 1.0] if kwargs.get("cov_function")
                               == "wendland" else [0.25, 1.0, 0.1])}
    key = next((k for k in kwargs if k in ported), kwargs["gp_approx"])
    if key == "cov_function":
        # the wendland covariance and a general Matern shape (ROADMAP.md
        # item 14) on the JAX package's neighbour structure
        tm = gpt.GPModel(gp_coords=data["coords"], device="cpu", **kwargs)
        jm = gpb.GPModel(gp_coords=data["coords"], **kwargs)
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
        cp = ported[key]
        nll_j = jm.neg_log_likelihood(cp, data["y"])
        assert abs(tm.neg_log_likelihood(cp, data["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    if key in ported:
        tm = gpt.GPModel(gp_coords=data["coords"], device="cpu", **kwargs)
        jm = gpb.GPModel(gp_coords=data["coords"], **kwargs)
        assert tm._exact == (kwargs["gp_approx"] == "none")
        cp = ported[key]
        nll_j = jm.neg_log_likelihood(cp, data["y"])
        assert abs(tm.neg_log_likelihood(cp, data["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt.GPModel(gp_coords=data["coords"], device="cpu", **kwargs)


@pytest.mark.parametrize("optimizer", ["gradient_descent", "nelder_mead"])
def test_gd_and_nelder_mead_fits_match_jax(gp_fixture_data, optimizer):
    """The host routes of the reference's other optimizers (gradient
    descent on the CPU, Nelder-Mead) reach the JAX package's parameters on
    the R-test fixture (n = 100, m = 10): NLL and cov_pars 1e-6 relative."""
    kw = dict(gp_coords=gp_fixture_data["coords"],
              cov_function="exponential", gp_approx="vecchia",
              num_neighbors=10)
    y = gp_fixture_data["eps"] + gp_fixture_data["xi"]
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    jm.fit(y, params={"optimizer_cov": optimizer})
    tm.fit(y, params={"optimizer_cov": optimizer})
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(tm.get_current_neg_log_likelihood() - nll_j) \
        < 1e-6 * abs(nll_j)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    assert tm._fit_result.num_evals > tm.get_num_optim_iter() > 1


def test_unported_optimizer_params_raise(data):
    """Unported optimizer settings raise. A held parameter
    (``estimate_cov_par_index``) is ported: the Vecchia fit keeps it at its
    init and runs L-BFGS on the others. The JAX package's Vecchia fit does
    not read the setting, so the reference is scipy's L-BFGS-B on the JAX
    package's NLL over the free log-parameters: cov_pars within 1e-4
    relative of its optimum; the JAX NLL at the port's optimum is the
    port's within 1e-8 relative, and its gradient there in the free
    parameters below 1 % of the one at the inits."""
    jm, tm = _models(data)
    with pytest.raises(NotImplementedError, match="not ported"):
        tm.set_optim_params({"lr_coef": 0.1})
    with pytest.raises(ValueError, match="convergence_criterion"):
        tm.set_optim_params({"convergence_criterion": "relative_change"})
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    init = [0.2, 1.0, 0.1]
    tm.set_optim_params({"estimate_cov_par_index": [1, 0, 1],
                         "init_cov_pars": init})
    tm.fit(data["y"])
    cp = tm.get_cov_pars()
    assert cp[1] == init[1] and cp[0] != init[0] and cp[2] != init[2]
    import jax.numpy as jnp
    y_j = jm._with_y(data["y"]).y
    nll_j, g_j = jm._approx._vg_gaussian(jnp.log(jnp.asarray(cp)), y_j, None)
    _, g0_j = jm._approx._vg_gaussian(jnp.log(jnp.asarray(init)), y_j, None)
    assert abs(tm.get_current_neg_log_likelihood() - float(nll_j)) \
        < 1e-8 * abs(float(nll_j))
    assert np.linalg.norm(np.asarray(g_j)[[0, 2]]) \
        < 1e-2 * np.linalg.norm(np.asarray(g0_j)[[0, 2]])
    from scipy.optimize import minimize

    def ref_vg(t_free):
        t = np.log(init)
        t[[0, 2]] = t_free
        v, g = jm._approx._vg_gaussian(jnp.asarray(t), y_j, None)
        return float(v), np.asarray(g, np.float64)[[0, 2]]

    ref = minimize(ref_vg, np.log(init)[[0, 2]], jac=True,
                   method="L-BFGS-B", options={"ftol": 1e-14,
                                               "gtol": 1e-10})
    np.testing.assert_allclose(cp[[0, 2]], np.exp(ref.x), rtol=1e-4)


C2_KEYWORDS = ("ind_effect_group_rand_coef",
               "drop_intercept_group_rand_effect", "cov_fct_taper_range",
               "cov_fct_taper_shape", "ind_points_selection",
               "num_ind_points", "cover_tree_radius",
               "matrix_inversion_method", "likelihood_additional_param",
               "free_raw_data", "vecchia_approx", "num_parallel_threads",
               "num_data")


def test_every_jax_keyword_at_its_default_constructs(data):
    """The port's constructor takes every keyword of the JAX package's, and
    each of the ones that select structures it does not port passes at the
    JAX default; ``vecchia_approx=True`` selects the Vecchia model,
    ``free_raw_data`` and ``num_parallel_threads`` have no effect."""
    import inspect
    jpars = inspect.signature(gpb.GPModel).parameters
    tpars = inspect.signature(gpt.GPModel).parameters
    assert set(jpars) <= set(tpars)
    defaults = {k: jpars[k].default for k in C2_KEYWORDS}
    tm = gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                     num_neighbors=M, device="cpu", **defaults)
    assert tm.matrix_inversion_method == "cholesky"
    via = gpt.GPModel(gp_coords=data["coords"], vecchia_approx=True,
                      num_neighbors=M, free_raw_data=True,
                      num_parallel_threads=4, device="cpu")
    assert via.gp_approx == "vecchia"
    assert via.get_cov_pars() is None
    via.fit(data["y"], params={"maxit": 2})
    np.testing.assert_array_equal(via.get_cov_pars(std_err=False),
                                  via.get_cov_pars())


@pytest.mark.parametrize("kwargs,item", [
    (dict(ind_effect_group_rand_coef=[1]), None),
    (dict(drop_intercept_group_rand_effect=[True]), None),
    (dict(num_data=N), None),
    (dict(cov_fct_taper_range=0.5), "item 17"),
    (dict(cov_fct_taper_shape=2.0), "item 17"),
    (dict(ind_points_selection="random"), "item 17"),
    (dict(num_ind_points=100), "item 17"),
    (dict(cover_tree_radius=0.5), "item 17"),
    (dict(matrix_inversion_method="iterative"), None),
    (dict(likelihood_additional_param=2.0), None),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else None)
def test_jax_keyword_at_another_value_names_its_item(data, kwargs, item):
    """Keywords at values the port does not run raise naming their item.
    ``matrix_inversion_method="iterative"`` is accepted since fault C4's
    repair: a Gaussian Vecchia GP and an exact GP take the Cholesky route,
    as the JAX package does — on ROADMAP.md's input (n = 200,
    ``default_rng(1)``, y = sin(5 x1) + 0.3 eps, exponential,
    ``num_neighbors=10``) the JAX package's NLLs at [0.1, 1.0, 0.2] at
    1e-12 relative, and the same bits as the Cholesky models. The grouped
    keywords without ``group_data``, ``num_data`` beside ``gp_coords`` and
    ``likelihood_additional_param`` with the gaussian likelihood are
    accepted and not read by a Gaussian Vecchia GP, as in the JAX package
    (ROADMAP.md item 15): the JAX package's NLL at 1e-10 relative."""
    if item is None and "matrix_inversion_method" not in kwargs:
        tm = gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                         num_neighbors=M, device="cpu", **kwargs)
        jm = gpb.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                         num_neighbors=M, **kwargs)
        cp = [0.25, 1.0, 0.1]
        nll_j = jm.neg_log_likelihood(cp, data["y"])
        assert abs(tm.neg_log_likelihood(cp, data["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    if item is None:
        rng = np.random.default_rng(1)
        x = rng.uniform(size=(200, 2))
        y = np.sin(5 * x[:, 0]) + 0.3 * rng.standard_normal(200)
        for approx, want in (("vecchia", 135.0316502558083),
                             ("none", 134.83850277500795)):
            nll = {}
            for method in ("iterative", "cholesky"):
                m = gpt.GPModel(gp_coords=x, cov_function="exponential",
                                gp_approx=approx, num_neighbors=10,
                                matrix_inversion_method=method, device="cpu")
                nll[method] = m.neg_log_likelihood([0.1, 1.0, 0.2], y)
            assert abs(nll["iterative"] - want) < 1e-12 * want
            assert nll["iterative"] == nll["cholesky"]
        return
    with pytest.raises(NotImplementedError, match=item):
        gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                    device="cpu", **kwargs)


def test_default_route_fit_reaches_jax(gp_fixture_data):
    """``fit(y)`` with the reference's default optimizer (gradient descent)
    as in the JAX package's ``TestVecchiaGaussian::test_fit_gd_no_covariates``
    (n = 100, m = 30, random ordering): cov_pars within 1e-6 relative of
    the JAX package's, near the exact optimum."""
    vf = gp_fixture_data
    y = vf["eps"] + vf["xi"]
    iu = np.triu_indices(vf["n"], 1)
    init = [np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
            np.mean(vf["D"][iu]) / 3]
    kw = dict(gp_coords=vf["coords"], cov_function="exponential",
              gp_approx="vecchia", num_neighbors=30,
              vecchia_ordering="random", seed=1)
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    assert tm.optim_cfg.optimizer_cov == "gradient_descent"
    jm.fit(y=y, params={"optimizer_cov": "gradient_descent",
                        "init_cov_pars": init})
    tm.fit(y=y, params={"init_cov_pars": init})
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    assert tm.get_num_optim_iter() == jm.get_num_optim_iter()
    cov = tm.get_cov_pars()
    assert abs(cov[1] - 1.076) < 0.2 and abs(cov[2] - 0.1135) < 0.05
    assert tm._fit_result.lr_after_first == pytest.approx(
        jm._fit_result.lr_after_first, rel=1e-10)


def _std_err_models(data, X=None):
    """JAX and port models on one structure at the same parameters (and
    coefficients), fitted for one step only so that they hold the data."""
    jm, tm = _models(data)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    jm.fit(data["y"], X=X, params={"maxit": 1})
    tm.fit(data["y"], X=X, params={"maxit": 1})
    tm.cov_pars_ = np.array([0.16, 0.9, 0.12])
    jm.cov_pars_ = tm.cov_pars_.copy()
    if X is not None:
        tm.coefs_ = np.array([0.45, 1.1])
        jm.coefs_ = tm.coefs_.copy()
    return jm, tm


def test_std_errors_dense_route_match_jax(data):
    """n <= 8192: std errors of the covariance parameters from the dense
    expected Fisher information, and of the coefficients from
    (X' Psi^-1 X)^-1, both within 1e-6 relative of the JAX package's."""
    jm, tm = _std_err_models(data, X=data["X"])
    got, want = tm.get_cov_pars(std_err=True), jm.get_cov_pars(std_err=True)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[1] > 0)
    got_c, want_c = tm.get_coef(std_err=True), jm.get_coef(std_err=True)
    assert got_c.shape == (2, 2)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-6)
    # computed once, and afresh after the next fit
    assert tm.get_cov_pars(std_err=True) is not got
    assert tm.std_dev_cov_pars_ is not None
    tm.fit(data["y"], X=data["X"], params={"maxit": 1})
    assert tm.std_dev_cov_pars_ is None and tm.std_dev_coefs_ is None


def test_std_errors_finite_difference_route_matches_jax(data, monkeypatch):
    """Beyond n = 8192 the std errors come from forward differences of the
    NLL gradient (eps = 1e-4): the port's helper against the JAX package's
    formula on the same gradients — both switched to that route at n = 600
    (a JAX model above 8192 points takes ~25 s to build on the CPU)."""
    from gpboost_tpu_torch.models import gp_model as tgp
    jm, tm = _std_err_models(data)
    dense = tm.get_cov_pars(std_err=True)
    tm.std_dev_cov_pars_ = None
    monkeypatch.setattr(tgp, "_DENSE_FISHER_MAX_N", N - 1)
    monkeypatch.setattr(jm, "num_data", 8193)
    got, want = tm.get_cov_pars(std_err=True), jm.get_cov_pars(std_err=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not np.allclose(got[1], dense[1], rtol=1e-6)   # another route


def test_default_device_raises_without_a_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia")


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, gpboost_tpu_torch\n"
            "import gpboost_tpu_torch.ops.kernels.vecchia_factors\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'gpboost_tpu' "
            "or m.startswith('gpboost_tpu.')]\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True)
