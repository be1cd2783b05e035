"""The exact GP's covariance and Gaussian likelihood, the port against the
JAX package (``gpboost_tpu_torch/models/{covariance,gaussian}.py`` vs
``gpboost_tpu/models/{covariance,gaussian}.py``). CPU, float64: the R test
fixture (n = 100) and n = 240 numpy-seeded points, for a GP alone, a GP
with a grouped intercept and slope, GP random coefficients and
``cluster_ids``; the same inputs through both packages.

Tolerances: the covariances 1e-12 absolute; NLLs (full, profiled, at a
given nugget), gradients and the Fisher information 1e-10 relative;
predictions (mean, variance, covariance) 1e-10; the R goldens at the JAX
tests' 1e-5.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax.numpy as jnp
from gpboost_tpu.models import covariance as jcov
from gpboost_tpu.models import gaussian as jga
from gpboost_tpu_torch.models import covariance as tcov
from gpboost_tpu_torch.models import gaussian as tga

N = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def d():
    rng = np.random.default_rng(11)
    coords = rng.uniform(size=(N, 2))
    return dict(coords=coords, y=rng.standard_normal(N) + 0.5,
                g=rng.integers(0, 12, N), x=rng.uniform(-1, 1, N),
                z=rng.standard_normal((N, 2)),
                cid=np.repeat([5, 2, 9], N // 3),
                pred=rng.uniform(size=(30, 2)), g_pred=rng.integers(0, 14, 30),
                x_pred=rng.uniform(-1, 1, 30), z_pred=rng.standard_normal(
                    (30, 2)), cid_pred=rng.choice([5, 2, 9, 4], 30))


STRUCTURES = {
    "gp": (dict(), [0.3, 1.2, 0.15]),
    "gp_grouped_slope": (dict(group_data="g", group_rand_coef_data="x",
                              ind_effect_group_rand_coef=[1]),
                         [0.3, 0.4, 0.2, 1.2, 0.15]),
    "gp_rand_coef": (dict(gp_rand_coef_data="z"),
                     [0.3, 1.2, 0.15, 0.5, 0.1, 0.7, 0.2]),
    "cluster_ids": (dict(cluster_ids="cid"), [0.3, 1.2, 0.15]),
}


def _models(d, name, cov_function="matern", shape=1.5):
    kw, cp = STRUCTURES[name]
    kw = {k: (d[v] if isinstance(v, str) else v) for k, v in kw.items()}
    common = dict(gp_coords=d["coords"], cov_function=cov_function,
                  cov_fct_shape=shape, **kw)
    jm = gpb.GPModel(**common)
    tm = gpt.GPModel(device="cpu", **common)
    return jm, tm, np.asarray(cp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("cov,shape,want", [
    ("exponential", 0.5, 124.2549533), ("matern", 0.5, 124.2549533),
    ("matern", 1.5, 141.3502172), ("matern", 2.5, 158.1111626)])
def test_r_fixture_nll_goldens(gp_fixture_data, cov, shape, want):
    """``test_GPModel_gaussian_process.R:80-117``: the exact NLL at
    (0.1, 1.6, 0.2) on the R fixture, through ``GPModel``; 1e-5 absolute
    to R, 1e-10 relative to the JAX package."""
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    kw = dict(gp_coords=f["coords"], cov_function=cov, cov_fct_shape=shape)
    tm = gpt.GPModel(device="cpu", **kw)
    got = tm.neg_log_likelihood([0.1, 1.6, 0.2], y)
    assert abs(got - want) < 1e-5
    jgot = gpb.GPModel(**kw).neg_log_likelihood([0.1, 1.6, 0.2], y)
    assert abs(got - jgot) < 1e-10 * abs(jgot)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_covariances_match_jax(d, name):
    """``total_re_cov`` on the training data and against prediction data
    (new levels, new clusters, new covariates), and the prior variance's
    diagonal: 1e-12 absolute."""
    jm, tm, cp = _models(d, name)
    _, comps_t = tcov.split_cov_pars(tm.spec, torch.as_tensor(cp))
    _, comps_j = jcov.split_cov_pars(jm.spec, jnp.asarray(cp))
    sig_t = tcov.total_re_cov(tm.spec, tm.data, comps_t).numpy()
    sig_j = np.asarray(jcov.total_re_cov(jm.spec, jm.data, comps_j))
    np.testing.assert_allclose(sig_t, sig_j, rtol=0, atol=1e-12)
    kw = dict(gp_coords_pred=d["pred"])
    if tm.data.group_codes is not None:
        kw.update(group_data_pred=d["g_pred"],
                  group_rand_coef_data_pred=d["x_pred"])
    if tm.data.gp_rand_coef_data is not None:
        kw["gp_rand_coef_data_pred"] = d["z_pred"]
    if tm.data.cluster_codes is not None:
        kw["cluster_ids_pred"] = d["cid_pred"]
    dp_t = tm._build_pred_data(
        kw.get("group_data_pred"), kw.get("group_rand_coef_data_pred"),
        kw["gp_coords_pred"], kw.get("gp_rand_coef_data_pred"),
        kw.get("cluster_ids_pred"))
    dp_j, cross_j, _ = jm._build_pred_data(
        kw.get("group_data_pred"), kw.get("group_rand_coef_data_pred"),
        kw["gp_coords_pred"], kw.get("gp_rand_coef_data_pred"),
        kw.get("cluster_ids_pred"), None)
    cr_t = tcov.total_re_cov(tm.spec, tm.data, comps_t, data2=dp_t).numpy()
    cr_j = np.asarray(jcov.total_re_cov(jm.spec, jm.data, comps_j,
                                        data2=dp_j, cross_dists=cross_j))
    np.testing.assert_allclose(cr_t, cr_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tga._prior_var_diag(tm.spec, dp_t, comps_t).numpy(),
        np.asarray(jga._prior_var_diag(jm.spec, dp_j, comps_j)),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_nlls_and_gradients_match_jax(d, name):
    """The NLL (the logdet_quad route and the twice-differentiable one),
    its gradient in the log parameters, the profiled NLL with its gradient
    and sigma2_hat, and the NLL at a given nugget: 1e-10 relative."""
    jm, tm, cp = _models(d, name)
    jd = jm._with_y(d["y"])
    r = torch.as_tensor(d["y"])
    lp = np.log(cp)
    want = float(jga.neg_log_likelihood(jm.spec, jd, jnp.asarray(cp)))
    for fn in (tga.neg_log_likelihood, tga.neg_log_likelihood_twice):
        got = float(fn(tm.spec, tm.data, torch.as_tensor(cp), r))
        assert abs(got - want) < 1e-10 * abs(want)
    g_j = np.asarray(jga.gradient_log_scale(jm.spec, jd, jnp.asarray(lp)))
    g_t = tga.gradient_log_scale(tm.spec, tm.data, torch.as_tensor(lp), r)
    assert _rel(g_t.numpy(), g_j) < 1e-10
    ratio = cp[1:].copy()
    ratio[tm._variance_index()] /= cp[0]
    v_j, gr_j, s_j = jga.nll_profiled_value_and_grad(
        jm.spec, jd, jnp.asarray(np.log(ratio)))
    v_t, gr_t, s_t = tga.nll_profiled_value_and_grad(
        tm.spec, tm.data, torch.as_tensor(np.log(ratio)), r)
    assert abs(float(v_t) - float(v_j)) < 1e-10 * abs(float(v_j))
    assert _rel(gr_t.numpy(), np.asarray(gr_j)) < 1e-10
    assert abs(float(s_t) - float(s_j)) < 1e-10 * float(s_j)
    ng_j = float(jga.nll_given_sigma2(jm.spec, jd, jnp.asarray(ratio),
                                      jnp.asarray(cp[0])))
    ng_t = float(tga.nll_given_sigma2(tm.spec, tm.data,
                                      torch.as_tensor(ratio),
                                      torch.as_tensor(cp[0]), r))
    assert abs(ng_t - ng_j) < 1e-10 * abs(ng_j)


@pytest.mark.parametrize("name", ["gp", "gp_grouped_slope", "gp_rand_coef"])
def test_fisher_information_and_gls_match_jax(d, name):
    """The Fisher information of the log parameters (one [n, n] derivative
    at a time here, the [n, n, p] Jacobian in the JAX package) and the GLS
    coefficients: 1e-10 relative."""
    jm, tm, cp = _models(d, name)
    jd = jm._with_y(d["y"])
    fi_j = np.asarray(jga.fisher_information(jm.spec, jd,
                                             jnp.log(jnp.asarray(cp))))
    fi_t = tga.fisher_information(tm.spec, tm.data,
                                  torch.log(torch.as_tensor(cp))).numpy()
    assert _rel(fi_t, fi_j) < 1e-10
    X = np.column_stack([np.ones(N), d["x"]])
    jd.X = jnp.asarray(X)
    b_j = np.asarray(jga.wls_coefficients(jm.spec, jd, jnp.asarray(cp)))
    b_t = tga.wls_coefficients(tm.spec, tm.data, torch.as_tensor(cp),
                               torch.as_tensor(d["y"]),
                               torch.as_tensor(X)).numpy()
    assert _rel(b_t, b_j) < 1e-10


@pytest.mark.parametrize("name", list(STRUCTURES))
@pytest.mark.parametrize("response", [True, False])
def test_predict_matches_jax(d, name, response):
    """``GPModel.predict`` at given parameters: mean, variances and the
    covariance matrix, latent and response scale (unseen levels and a new
    cluster included): 1e-10 relative to the JAX package."""
    jm, tm, cp = _models(d, name)
    kw = dict(gp_coords_pred=d["pred"], cov_pars=cp,
              predict_response=response)
    if tm.data.group_codes is not None:
        kw.update(group_data_pred=d["g_pred"],
                  group_rand_coef_data_pred=d["x_pred"])
    if tm.data.gp_rand_coef_data is not None:
        kw["gp_rand_coef_data_pred"] = d["z_pred"]
    if tm.data.cluster_codes is not None:
        kw["cluster_ids_pred"] = d["cid_pred"]
    for flag in ("predict_var", "predict_cov_mat"):
        pj = jm.predict(y=d["y"], **kw, **{flag: True})
        pt = tm.predict(y=d["y"], **kw, **{flag: True})
        assert _rel(pt["mu"], pj["mu"]) < 1e-10
        assert _rel(pt["var"], pj["var"]) < 1e-10
        if flag == "predict_cov_mat":
            assert _rel(pt["cov"], pj["cov"]) < 1e-10


def test_float32_exact_model_needs_tf32_off(d):
    """A float32 exact GP checks that TF32 is off for its distance
    products (on the card: it raises otherwise); on the CPU it builds."""
    tm = gpt.GPModel(gp_coords=d["coords"], dtype=torch.float32,
                     device="cpu")
    assert tm.data.dists.dtype == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32
