"""The ported path as a whole vs the JAX package: ``GPModel`` construct,
NLL, L-BFGS fit, predict, state carried across (n = 600, m = 10, d = 2,
float64, CPU; inputs from a numpy seed handed to both sides).

Tolerances: NLL 1e-8; fitted NLL 1e-5 relative and ``cov_pars_`` rtol 2e-2
(the JAX package fits with scipy's L-BFGS-B on the CPU, the port with its
device-resident loop: different optimisers, same optimum); coefficients
1e-3; predictions at carried-over parameters 1e-8.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt

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
    tm.fit(data["y"], params={"optimizer_cov": "lbfgs", "maxit": 5})
    assert tm._fit_result.aux.shape == (N,)
    assert tm._fit_result.num_evals >= 2
    assert vk.launch_counts() == {"vecchia_factors": 0,
                                  "vecchia_nll_grad": 0}


@pytest.mark.parametrize("kwargs", [
    dict(gp_approx="none"), dict(gp_approx="fitc"),
    dict(gp_approx="vecchia", likelihood="bernoulli_probit"),
    dict(gp_approx="vecchia", group_data=np.zeros(N)),
    dict(gp_approx="vecchia", cluster_ids=np.zeros(N)),
    dict(gp_approx="vecchia", gp_rand_coef_data=np.ones((N, 1))),
    dict(gp_approx="vecchia", cov_function="wendland"),
    dict(gp_approx="vecchia", cov_function="matern", cov_fct_shape=0.7),
])
def test_unported_options_raise_not_implemented(data, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt.GPModel(gp_coords=data["coords"], device="cpu", **kwargs)


@pytest.mark.parametrize("optimizer", ["gradient_descent", "nelder_mead"])
def test_unported_optimizers_raise_not_implemented(data, optimizer):
    _, tm = _models(data)
    with pytest.raises(NotImplementedError, match="lbfgs"):
        tm.fit(data["y"], params={"optimizer_cov": optimizer})
    with pytest.raises(NotImplementedError, match="not ported"):
        tm.set_optim_params({"use_nesterov_acc": False})


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
