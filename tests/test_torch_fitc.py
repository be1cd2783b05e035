"""FITC and full-scale tapering in the port (``ops/fitc.py``,
``models/fitc_model.py``) against the JAX package on the CPU, float64 —
the port's counterpart of ``tests/test_fitc_golden.py`` (its class
``TestFullScaleTaperingIterative`` is mirrored in
``tests/test_torch_fsa_iterative.py``).

Tolerances: Gaussian NLLs and gradients 1e-10 relative to the JAX package;
Laplace NLLs 1e-8, their gradients 1e-6 relative, d NLL / dF and the
Laplace predictions 1e-7 (both packages' mode finders stop at a relative
change of 1e-9 in the objective, ~1e-7 absolute from the converged mode's
NLL, so they agree to that, not to rounding); fitted parameters 1e-6.
Gaussian predictions: 1e-12 against a dense float64 reference built here
with numpy (coordinate differences) and 1e-7 against the JAX package, whose
own
predictions lie up to ~2e-8 from that reference (its distances come from
inner products, which leave ~1e-8 where two points coincide, and it forms
the [n_p, n] cross-covariance). The full-scale-tapering Laplace NLL is held
to the dense reference at 1e-12 and to the JAX package at 1e-8 for the same
reason. The R goldens of the JAX file are kept at its tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.ops import cg as jcg
from gpboost_tpu.utils.rng import sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.fitc_model import FITCGP
from gpboost_tpu_torch.models.laplace import _laplace_nll_from_sigma
from gpboost_tpu_torch.ops.cov_fns import CovFunction


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CP = [0.1, 1.6, 0.2]


def _pair(f, **kw):
    args = dict(gp_coords=f["coords"], cov_function="exponential", **kw)
    return gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)


def _dense_fitc(coords, ip, cp, cpp):
    """(Psi, Q_pn) of FITC from coordinate differences (numpy)."""
    def cov(a, b):
        d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
        return cp[1] * np.exp(-d / cp[2])
    c_mm = cov(ip, ip) + 1e-8 * cp[1] * np.eye(len(ip))
    c_nm = cov(coords, ip)
    Q = c_nm @ np.linalg.solve(c_mm, c_nm.T)
    psi = Q + np.diag(cp[1] - np.diag(Q) + cp[0])
    return psi, cov(cpp, ip) @ np.linalg.solve(c_mm, c_nm.T)


class TestFITC:
    def test_nll_all_inducing_equals_exact(self, gp_fixture_data):
        f = gp_fixture_data
        m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        gp_approx="fitc", num_ind_points=f["n"],
                        ind_points_selection="random", device="cpu")
        nll = m.neg_log_likelihood(cov_pars=CP, y=f["eps"] + f["xi"])
        assert abs(nll - 124.2549533) < 1e-4

    def test_too_many_inducing_points_errors(self, gp_fixture_data):
        f = gp_fixture_data
        with pytest.raises(ValueError, match="inducing points"):
            gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        gp_approx="fitc", num_ind_points=f["n"] + 1,
                        ind_points_selection="random", device="cpu")

    def test_fit_all_inducing_matches_exact(self, gp_fixture_data):
        f = gp_fixture_data
        y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
        iu = np.triu_indices(f["n"], 1)
        init = [np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
                np.mean(f["D"][iu]) / 3]
        params = {"optimizer_cov": "lbfgs", "init_cov_pars": init}
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        exact.fit(y=y, X=f["X"], params=params)
        jm, tm = _pair(f, gp_approx="fitc", num_ind_points=f["n"],
                       ind_points_selection="random")
        tm.fit(y=y, X=f["X"], params=params)
        np.testing.assert_allclose(tm.get_cov_pars(), exact.get_cov_pars(),
                                   rtol=5e-2, atol=5e-3)
        np.testing.assert_allclose(tm.get_coef(), exact.get_coef(),
                                   atol=1e-2)
        jm.fit(y=y, X=f["X"], params=params)
        np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-6)

    def test_predict_all_inducing_matches_exact(self, gp_fixture_data):
        f = gp_fixture_data
        y = f["eps"] + f["xi"]
        ct = np.array([[0.1, 0.9], [0.2, 0.4], [0.7, 0.55]])
        cp = [0.02, 1.2, 0.9]
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        pe = exact.predict(y=y, gp_coords_pred=ct, cov_pars=cp,
                           predict_var=True)
        m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        gp_approx="fitc", num_ind_points=f["n"],
                        ind_points_selection="random", device="cpu")
        pf = m.predict(y=y, gp_coords_pred=ct, cov_pars=cp, predict_var=True)
        np.testing.assert_allclose(pf["mu"], pe["mu"], atol=1e-4)
        np.testing.assert_allclose(pf["var"], pe["var"], atol=1e-4)

    def test_fewer_inducing_points_reasonable(self, gp_fixture_data):
        f = gp_fixture_data
        m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        gp_approx="fitc", num_ind_points=50, device="cpu")
        nll = m.neg_log_likelihood(cov_pars=CP, y=f["eps"] + f["xi"])
        assert abs(nll - 124.2549533) < 5.0

    def test_fitc_laplace_probit(self, gp_fixture_data):
        from scipy.stats import norm
        f = gp_fixture_data
        y = (sim_rand_unif(f["n"], 0.2341) < norm.cdf(f["eps"])).astype(float)
        m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        likelihood="bernoulli_probit", gp_approx="fitc",
                        num_ind_points=f["n"], ind_points_selection="random",
                        device="cpu")
        assert abs(m.neg_log_likelihood(cov_pars=[0.9, 0.2], y=y)
                   - 63.6205917) < 1e-3


class TestFullScaleTapering:
    def test_fsa_nll_close_to_exact(self, gp_fixture_data):
        f = gp_fixture_data
        m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                        gp_approx="full_scale_tapering", num_ind_points=40,
                        cov_fct_taper_range=0.5, cov_fct_taper_shape=0.0,
                        device="cpu")
        nll = m.neg_log_likelihood(cov_pars=CP, y=f["eps"] + f["xi"])
        assert abs(nll - 124.2549533) < 2.0

    def test_fsa_fit_and_predict(self, gp_fixture_data):
        f = gp_fixture_data
        y = f["eps"] + f["xi"]
        iu = np.triu_indices(f["n"], 1)
        init = [np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
                np.mean(f["D"][iu]) / 3]
        jm, tm = _pair(f, gp_approx="full_scale_tapering", num_ind_points=50,
                       cov_fct_taper_range=0.8, cov_fct_taper_shape=0.0)
        params = {"optimizer_cov": "lbfgs", "init_cov_pars": init}
        tm.fit(y=y, params=params)
        jm.fit(y=y, params=params)
        np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                                   rtol=1e-6)
        pred = tm.predict(y=y, gp_coords_pred=f["coords"][:4],
                          predict_var=True, predict_response=False)
        assert np.all(np.isfinite(pred["mu"])) and np.all(pred["var"] >= 0)

    def test_fsa_iterative_raises_item_12(self, gp_fixture_data):
        """The iterative route this case pinned as a raise (item 12) is
        ported: with the JAX package's probes (its FITC preconditioner's
        normals from the first key of ``split(PRNGKey(1))``, split once
        more, Rademacher probes from the second) the NLL equals the JAX
        package's at 1e-8 (``tests/test_torch_fsa_iterative.py`` holds
        the route)."""
        f = gp_fixture_data
        y = f["eps"] + f["xi"]
        jm, tm = _pair(f, gp_approx="full_scale_tapering",
                       num_ind_points=20, matrix_inversion_method="iterative")
        nll_j = float(jm._approx.nll_gaussian(jnp.asarray(CP),
                                              jnp.asarray(y)))
        a, k = jm._approx, jm._approx.num_rand_vec_trace
        k1, k2 = jax.random.split(jax.random.PRNGKey(a.seed_rand_vec_trace))
        k1a, k1b = jax.random.split(k1)
        draws = (jax.random.normal(k1a, (20, k), jnp.float64),
                 jax.random.normal(k1b, (f["n"], k), jnp.float64),
                 jcg.rademacher_probes(k2, f["n"], k, jnp.float64))
        ta = tm._approx
        ta.lanczos_steps, ta.cg_tol = a.lanczos_steps, a.cg_tol
        with torch.no_grad():
            nll_t = float(ta._nll_gaussian_iterative(
                torch.tensor(CP, dtype=torch.float64), torch.tensor(y), None,
                *[torch.tensor(np.asarray(d)) for d in draws]))
        assert abs(nll_t - nll_j) < 1e-8 * abs(nll_j)


class TestFITCLaplaceWoodbury:
    def test_matches_dense(self):
        rng = np.random.default_rng(0)
        n = 300
        coords = rng.uniform(size=(n, 2))
        gp = FITCGP(coords, CovFunction.create("exponential"),
                    num_ind_points=40, likelihood="poisson", device="cpu")
        y = torch.tensor(rng.poisson(np.ones(n)).astype(float))
        cov = torch.tensor([1.0, 0.15], dtype=torch.float64,
                           requires_grad=True)

        def dense(c):
            V, dD, _ = gp._latent_lowrank(c)
            return _laplace_nll_from_sigma(
                "poisson", V.T @ V + torch.diag(dD), y,
                torch.zeros(n, dtype=torch.float64), None)

        nll_w = gp.nll_laplace(cov, y, None)
        nll_d = dense(cov)
        assert abs(nll_w.item() - nll_d.item()) < 1e-9 * abs(nll_d.item())
        (g_w,) = torch.autograd.grad(nll_w, cov)
        (g_d,) = torch.autograd.grad(dense(cov), cov)
        torch.testing.assert_close(g_w, g_d, rtol=1e-6, atol=0)


@pytest.mark.parametrize("approx,kw", [
    ("fitc", dict(num_ind_points=30)),
    ("full_scale_tapering", dict(num_ind_points=30, cov_fct_taper_range=0.3,
                                 cov_fct_taper_shape=1.0)),
])
def test_nll_gradient_and_prediction_match_jax(gp_fixture_data, approx, kw):
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    jm, tm = _pair(f, gp_approx=approx, **kw)
    np.testing.assert_allclose(tm._approx.ind_points.numpy(),
                               np.asarray(jm._approx.ind_points), atol=1e-12)
    nll_j = jm.neg_log_likelihood(CP, y)
    assert abs(tm.neg_log_likelihood(CP, y) - nll_j) < 1e-10 * abs(nll_j)
    th = np.log(CP)
    _, g_j = jm._approx._vg_gaussian(jnp.asarray(th), jnp.asarray(y), None)
    _, g_t = tm._approx._vg_gaussian(torch.tensor(th), torch.tensor(y), None)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10)
    cpp = np.random.default_rng(1).uniform(size=(7, 2))
    pj = jm.predict(y=y, gp_coords_pred=cpp, cov_pars=CP, predict_var=True)
    pt = tm.predict(y=y, gp_coords_pred=cpp, cov_pars=CP, predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-7)
    if approx == "fitc":
        psi, q_pn = _dense_fitc(f["coords"], tm._approx.ind_points.numpy(),
                                CP, cpp)
        mu = q_pn @ np.linalg.solve(psi, y)
        var = CP[1] + CP[0] - np.einsum(
            "pn,np->p", q_pn, np.linalg.solve(psi, q_pn.T))
        np.testing.assert_allclose(pt["mu"], mu, rtol=0, atol=1e-12)
        np.testing.assert_allclose(pt["var"], var, rtol=0, atol=1e-12)
        # the diagonal of the covariance, as the JAX package returns it
        pc = tm.predict(y=y, gp_coords_pred=cpp, cov_pars=CP,
                        predict_cov_mat=True)
        np.testing.assert_allclose(np.diag(pc["cov"]), pt["var"])


@pytest.mark.parametrize("approx", ["fitc", "full_scale_tapering"])
def test_laplace_nll_gradient_and_prediction_match_jax(gp_fixture_data,
                                                       approx):
    f = gp_fixture_data
    y = (f["eps"] > 0).astype(float)
    kw = dict(num_ind_points=30, likelihood="bernoulli_logit")
    if approx == "full_scale_tapering":
        kw["cov_fct_taper_range"] = 0.3
    jm, tm = _pair(f, gp_approx=approx, **kw)
    cp = [1.2, 0.15]
    fe = 0.2 * np.cos(7 * f["coords"][:, 0])
    # the mode finders of both packages stop at a relative change of 1e-9
    # in the objective, ~1e-7 from the converged mode's NLL here
    tol = 1e-8
    nll_j = jm.neg_log_likelihood(cp, y, fixed_effects=fe)
    assert abs(tm.neg_log_likelihood(cp, y, fixed_effects=fe) - nll_j) \
        < tol * abs(nll_j)
    g_j = jax.grad(lambda c: jm._approx.nll_laplace(
        c, jnp.asarray(y), None, jnp.asarray(fe)))(jnp.asarray(cp))
    c = torch.tensor(cp, dtype=torch.float64, requires_grad=True)
    (g_t,) = torch.autograd.grad(tm._approx.nll_laplace(
        c, torch.tensor(y), None, torch.tensor(fe)), c)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6)
    # LaGaBoost's gradient d NLL / dF
    gf_j = jm._approx.grad_F_laplace(jnp.asarray(cp), jnp.asarray(y), None,
                                     jnp.asarray(fe))
    gf_t = tm._approx.grad_F_laplace(torch.tensor(cp, dtype=torch.float64),
                                     torch.tensor(y), None, torch.tensor(fe))
    np.testing.assert_allclose(gf_t.numpy(), np.asarray(gf_j), rtol=0,
                               atol=1e-7)
    cpp = np.random.default_rng(2).uniform(size=(6, 2))
    for resp in (False, True):
        pj = jm.predict(y=y, gp_coords_pred=cpp, cov_pars=cp,
                        predict_var=True, predict_response=resp)
        pt = tm.predict(y=y, gp_coords_pred=cpp, cov_pars=cp,
                        predict_var=True, predict_response=resp)
        np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-7)


def test_fsa_laplace_nll_matches_dense_reference(gp_fixture_data):
    """The full-scale-tapering Laplace NLL against the dense route built
    from numpy (coordinate differences) at 1e-12."""
    f = gp_fixture_data
    y = (f["eps"] > 0).astype(float)
    tm = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                     gp_approx="full_scale_tapering", num_ind_points=30,
                     cov_fct_taper_range=0.3, likelihood="bernoulli_logit",
                     device="cpu")
    cp = [1.2, 0.15]
    c, ip = f["coords"], tm._approx.ind_points.numpy()

    def dist(a, b):
        return np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))

    def cov(d):
        return cp[0] * np.exp(-d / cp[1])
    c_nm = cov(dist(c, ip))
    Q = c_nm @ np.linalg.solve(cov(dist(ip, ip)) + 1e-8 * cp[0]
                               * np.eye(len(ip)), c_nm.T)
    mu = tm._approx.taper_mu
    r = np.minimum(dist(c, c) / 0.3, 1.0)
    T = np.where(r >= 1.0, 0.0, (1 - r) ** (mu + 1.0) * (1 + r * (mu + 1.0)))
    sigma = Q + T * (cov(dist(c, c)) - Q)
    ref = float(_laplace_nll_from_sigma(
        "bernoulli_logit", torch.tensor(sigma), torch.tensor(y),
        torch.zeros(len(y)), None))
    assert abs(tm.neg_log_likelihood(cp, y) - ref) < 1e-12 * abs(ref)


@pytest.mark.parametrize("optimizer", ["gradient_descent", "lbfgs"])
def test_fits_and_std_errors_match_jax(gp_fixture_data, optimizer):
    """The default gradient descent and L-BFGS fits of a FITC
    model with covariates, and the std errors (n <= 8192: the dense Fisher
    information of the exact covariance, as the JAX package), 1e-6."""
    f = gp_fixture_data
    y = f["eps"] + f["X"] @ f["beta"] + f["xi"]
    jm, tm = _pair(f, gp_approx="fitc", num_ind_points=25)
    params = {"optimizer_cov": optimizer, "maxit": 200}
    jm.fit(y, X=f["X"], params=params)
    tm.fit(y, X=f["X"], params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-6)
    if optimizer == "lbfgs":
        np.testing.assert_allclose(tm.get_cov_pars(std_err=True),
                                   np.asarray(jm.get_cov_pars(std_err=True)),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm.get_coef(std_err=True),
                                   np.asarray(jm.get_coef(std_err=True)),
                                   rtol=1e-6)


def test_from_dict_of_jax_model_predicts_like_it(gp_fixture_data):
    """``GPModel.from_dict`` on the JAX package's ``model_to_dict()`` of a
    fitted FITC model rebuilds the inducing points and gives its
    predictions (1e-8; see the module docstring) and the port's own dict
    round trip gives the same bits."""
    f = gp_fixture_data
    y = f["eps"] + f["xi"]
    jm = gpb.GPModel(gp_coords=f["coords"], cov_function="exponential",
                     gp_approx="fitc", num_ind_points=30)
    jm.fit(y, params={"optimizer_cov": "lbfgs"})
    tm = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    assert tm.gp_approx == "fitc" and tm.num_ind_points == 30
    cpp = f["coords"][:5] + 0.01
    pj = jm.predict(gp_coords_pred=cpp, predict_var=True)
    pt = tm.predict(gp_coords_pred=cpp, predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-8)
    tm2 = gpt.GPModel.from_dict(tm.model_to_dict(), device="cpu")
    p2 = tm2.predict(gp_coords_pred=cpp, predict_var=True)
    assert np.array_equal(p2["mu"], pt["mu"])
    assert np.array_equal(p2["var"], pt["var"])
