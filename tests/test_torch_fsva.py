"""The full-scale Vecchia approximation in the port
(``models/fsva_model.py``, ``ops/vecchia.py::build_factors_residual``) and
the simulated predictive variances (``models/predvar.py``) against the JAX
package on the CPU, float64 — the port's counterpart of
``tests/test_fsva.py`` and ``tests/test_sim_pred_var_gaussian.py``.

Both packages run on the same ordering and neighbours (the JAX model's,
carried over by ``load_structure``). Tolerances: the residual factors and
their gradients 1e-12; Gaussian NLLs and gradients 1e-9 relative (the JAX
package builds K_nm and K_mm from inner-product distances, which leave
~1e-8 on the diagonal of K_mm; the NLLs differ by 1e-11 to 2e-10
relative; the Psi^-1 r solve of GPBoost 1e-7, the Woodbury matrix
amplifying that rounding); residual-correlation neighbours equal; fitted
parameters 1e-6; predictions 1e-8. The R-derived corners of the JAX file
are kept at its tolerances. Simulated variances: the port's
probes come from a ``torch.Generator``, so they are held, as the JAX test
holds its own, to the exact variances (25 %) and to shrinking with nsim.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.ops import vecchia as jvops
from gpboost_tpu.ops.cov_fns import CovFunction as JCovFunction

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops import vecchia as tvops
from gpboost_tpu_torch.ops.cov_fns import CovFunction


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


Y_COV_PARS = [0.1, 1.0, 0.2]


@pytest.fixture(scope="module")
def ydata(gp_fixture_data):
    f = gp_fixture_data
    return f, f["eps"] + f["xi"]


def _fsva(f, approx="full_scale_vecchia", nn=None, m=20):
    return gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                       gp_approx=approx, num_neighbors=nn or f["n"] - 1,
                       num_ind_points=m, vecchia_ordering="none",
                       device="cpu")


def _pair(f, **kw):
    args = dict(gp_coords=f["coords"], cov_function="exponential",
                gp_approx="full_scale_vecchia", **kw)
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    return jm, tm


def test_build_factors_residual_matches_jax():
    """(A, D) of the residual Vecchia and their gradients w.r.t. the
    covariance parameters, the inducing-point rows and the nugget, on the
    plain route (scatter transpose) and the CUDA route (gathers), 1e-12."""
    rng = np.random.default_rng(3)
    n, m, k = 80, 6, 9
    coords = rng.uniform(size=(n, 2))
    nb = np.asarray(tvops.find_neighbors(torch.tensor(coords), m))
    pars, nug = np.array([1.1, 0.2]), 0.15
    # P = (L_mm^-1 K_mn)' of k inducing points: a positive semi-definite
    # residual, as the model builds it
    ip = rng.uniform(size=(k, 2))

    def kern(a, b):
        return pars[0] * np.exp(-np.sqrt(((a[:, None] - b[None]) ** 2)
                                         .sum(-1)) / pars[1])
    P = np.linalg.solve(np.linalg.cholesky(kern(ip, ip) + 1e-8 * np.eye(k)),
                        kern(ip, coords)).T
    jcf, tcf = JCovFunction.create("exponential"), CovFunction.create(
        "exponential")

    def jf(p, lr, nu):
        a, d = jvops.build_factors_residual(jcf, p, jnp.asarray(coords),
                                            jnp.asarray(nb), lr.T, nu, True)
        return jnp.sum(a * jnp.cos(a)) + jnp.sum(jnp.log(d)), (a, d)

    (vj, (aj, dj)), gj = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(pars), jnp.asarray(P), jnp.asarray(nug))
    nb_t = torch.tensor(nb)
    for slices in (None, tvops.build_incoming_sliced(nb_t)):
        p, lr, nu = (torch.tensor(x, requires_grad=True)
                     for x in (pars, P, np.float64(nug)))
        a, d = tvops.build_factors_residual(tcf, p, torch.tensor(coords),
                                            nb_t, lr, nu, True, slices)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(aj),
                                   atol=1e-12)
        np.testing.assert_allclose(d.detach().numpy(), np.asarray(dj),
                                   rtol=1e-12)
        v = torch.sum(a * torch.cos(a)) + torch.sum(torch.log(d))
        for got, want in zip(torch.autograd.grad(v, (p, lr, nu)), gj):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-12)


class TestFSVAGaussian:
    def test_corner_all_neighbors_equals_exact(self, ydata):
        f, y = ydata
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        nll_exact = exact.neg_log_likelihood(cov_pars=Y_COV_PARS, y=y)
        for approx in ("full_scale_vecchia",
                       "full_scale_vecchia_correlation_based"):
            m = _fsva(f, approx=approx, nn=f["n"] - 1, m=20)
            assert abs(m.neg_log_likelihood(cov_pars=Y_COV_PARS, y=y)
                       - nll_exact) < 1e-5

    def test_corner_all_inducing_points(self, ydata):
        f, y = ydata
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        nll_exact = exact.neg_log_likelihood(cov_pars=Y_COV_PARS, y=y)
        m = _fsva(f, nn=5, m=f["n"])
        assert abs(m.neg_log_likelihood(cov_pars=Y_COV_PARS, y=y)
                   - nll_exact) < 1e-3

    def test_midrange_accuracy(self, ydata):
        f, y = ydata
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        nll_exact = exact.neg_log_likelihood(cov_pars=Y_COV_PARS, y=y)
        nll = _fsva(f, nn=30, m=20).neg_log_likelihood(cov_pars=Y_COV_PARS,
                                                         y=y)
        assert abs(nll - nll_exact) < 0.5

    def test_fit_and_predict(self, ydata):
        """The JAX test's fit and prediction against the exact GP, and the
        fit (L-BFGS with covariates) and predictions against the JAX
        package on one structure."""
        f, y = ydata
        iu = np.triu_indices(f["n"], 1)
        params = {"optimizer_cov": "lbfgs",
                  "init_cov_pars": [0.05, 1.0, float(f["D"][iu].mean()) / 3]}
        exact = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                            device="cpu")
        exact.fit(y=y, X=f["X"], params=params)
        jm, tm = _pair(f, num_neighbors=f["n"] - 1, num_ind_points=30,
                       vecchia_ordering="none")
        tm.fit(y=y, X=f["X"], params=params)
        assert np.sum(np.abs(tm.get_cov_pars() - exact.get_cov_pars())) < 5e-2
        assert np.sum(np.abs(tm.get_coef() - exact.get_coef())) < 5e-2
        jm.fit(y=y, X=f["X"], params=params)
        np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm.get_coef(), jm.get_coef(), rtol=1e-6)
        ct = np.array([[0.1, 0.9], [0.11, 0.91], [0.7, 0.55]])
        Xt = np.column_stack([np.ones(3), [0.1, 0.2, 0.3]])
        pe = exact.predict(y=y, gp_coords_pred=ct, X_pred=Xt,
                           predict_var=True)
        pm = tm.predict(y=y, gp_coords_pred=ct, X_pred=Xt, predict_var=True)
        assert np.sum(np.abs(pe["mu"] - pm["mu"])) < 1e-2
        assert np.sum(np.abs(pe["var"] - pm["var"])) < 1e-2
        pj = jm.predict(y=y, gp_coords_pred=ct, X_pred=Xt, predict_var=True)
        np.testing.assert_allclose(pm["mu"], pj["mu"], atol=1e-8)
        np.testing.assert_allclose(pm["var"], pj["var"], atol=1e-8)
        np.testing.assert_allclose(tm.get_cov_pars(std_err=True),
                                   np.asarray(jm.get_cov_pars(std_err=True)),
                                   rtol=1e-6)

    def test_correlation_based_fit(self, ydata):
        f, y = ydata
        m = _fsva(f, approx="full_scale_vecchia_correlation_based", nn=20,
                  m=15)
        m.fit(y=y, params={"optimizer_cov": "lbfgs",
                           "init_cov_pars": [0.05, 1.0, 0.1]})
        cov = m.get_cov_pars()
        assert cov.shape == (3,) and np.all(np.isfinite(cov)) \
            and np.all(cov > 0)
        assert 0.3 < cov[1] < 3.0 and 0.02 < cov[2] < 0.5


def test_nll_and_gradient_match_jax(ydata):
    f, y = ydata
    jm, tm = _pair(f, num_neighbors=8, num_ind_points=20)
    nll_j = jm.neg_log_likelihood(Y_COV_PARS, y)
    assert abs(tm.neg_log_likelihood(Y_COV_PARS, y) - nll_j) \
        < 1e-9 * abs(nll_j)
    th = np.log(Y_COV_PARS)
    _, g_j = jm._approx._vg_gaussian(jnp.asarray(th), jnp.asarray(y), None)
    _, g_t = tm._approx._vg_gaussian(torch.tensor(th), torch.tensor(y), None)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-9)
    # the GPBoost pseudo-gradient solve Psi^-1 r, on the CUDA route's
    # gathers too
    r = y - 0.3
    pj = np.asarray(jm._psi_solve(jnp.asarray(Y_COV_PARS), jnp.asarray(r)))
    pt = tm._psi_solve(Y_COV_PARS, r).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-7)
    ap = tm._approx
    ap._incoming = tvops.build_incoming_sliced(ap.neighbors)
    np.testing.assert_allclose(tm._psi_solve(Y_COV_PARS, r).numpy(), pt,
                               rtol=1e-12, atol=1e-13)
    _, g_s = ap._vg_gaussian(torch.tensor(th), torch.tensor(y), None)
    np.testing.assert_allclose(g_s.numpy(), g_t.numpy(), rtol=1e-12)


def test_correlation_neighbors_match_jax(ydata):
    """Residual-correlation neighbours at given parameters equal the JAX
    package's; the NLL there 1e-9."""
    f, y = ydata
    args = dict(gp_coords=f["coords"], cov_function="exponential",
                gp_approx="full_scale_vecchia_correlation_based",
                num_neighbors=10, num_ind_points=15, vecchia_ordering="none")
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    assert tm._approx.neighbors is None
    nll_j = jm.neg_log_likelihood(Y_COV_PARS, y)
    nll_t = tm.neg_log_likelihood(Y_COV_PARS, y)
    np.testing.assert_array_equal(tm._approx.neighbors.numpy(),
                                  np.asarray(jm._approx.neighbors))
    assert abs(nll_t - nll_j) < 1e-9 * abs(nll_j)


@pytest.fixture(scope="module")
def sim():
    rng = np.random.default_rng(3)
    n = 400
    return (rng.uniform(size=(n, 2)), rng.standard_normal(n),
            rng.uniform(size=(30, 2)))


@pytest.mark.parametrize("approx,kw", [
    ("full_scale_tapering", dict(num_ind_points=50, cov_fct_taper_range=0.5)),
    ("full_scale_vecchia", dict(num_ind_points=50, num_neighbors=15)),
])
def test_sim_var_converges_to_exact(sim, approx, kw):
    coords, y, coords_p = sim
    cp = np.array([0.3, 1.0, 0.2])
    m = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                    gp_approx=approx, device="cpu", **kw)
    pr_exact = m.predict(y=y, gp_coords_pred=coords_p, cov_pars=cp,
                         predict_var=True)
    m.set_prediction_data(nsim_var_pred=4000)
    pr_sim = m.predict(y=y, gp_coords_pred=coords_p, cov_pars=cp,
                       predict_var=True)
    np.testing.assert_allclose(pr_sim["mu"], pr_exact["mu"], atol=1e-10)
    rel = np.max(np.abs(pr_sim["var"] - pr_exact["var"]) / pr_exact["var"])
    assert rel < 0.25
    m.set_prediction_data(nsim_var_pred=100)
    pr_small = m.predict(y=y, gp_coords_pred=coords_p, cov_pars=cp,
                         predict_var=True)
    assert np.mean(np.abs(pr_sim["var"] - pr_exact["var"])) \
        < np.mean(np.abs(pr_small["var"] - pr_exact["var"]))
    # the exact variances are the JAX package's (1e-8)
    jm = gpb.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx=approx, **kw)
    if approx == "full_scale_vecchia":
        m._approx.load_structure(np.asarray(jm._approx.perm),
                                 np.asarray(jm._approx.neighbors))
        m.nsim_var_pred = None
        pr_exact = m.predict(y=y, gp_coords_pred=coords_p, cov_pars=cp,
                             predict_var=True)
    pj = jm.predict(y=y, gp_coords_pred=coords_p, cov_pars=cp,
                    predict_var=True)
    np.testing.assert_allclose(pr_exact["mu"], pj["mu"], atol=1e-8)
    np.testing.assert_allclose(pr_exact["var"], pj["var"], atol=1e-8)


def test_sim_var_never_materializes_np_by_n(sim):
    coords, y, _ = sim
    coords_p = np.random.default_rng(9).uniform(size=(2500, 2))
    m = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                    gp_approx="full_scale_vecchia", num_ind_points=50,
                    num_neighbors=15, device="cpu")
    m.set_prediction_data(nsim_var_pred=200)
    pr = m.predict(y=y, gp_coords_pred=coords_p,
                   cov_pars=np.array([0.3, 1.0, 0.2]), predict_var=True)
    assert pr["mu"].shape == (2500,)
    assert np.all(np.isfinite(pr["var"])) and np.all(pr["var"] >= 0)


def test_from_dict_of_jax_model_predicts_like_it(ydata):
    """``GPModel.from_dict`` on the JAX package's dict of a fitted FSVA
    model: the same ordering seed, inducing points and neighbours, its
    predictions (1e-8)."""
    f, y = ydata
    jm = gpb.GPModel(gp_coords=f["coords"], cov_function="exponential",
                     gp_approx="full_scale_vecchia", num_neighbors=8,
                     num_ind_points=20)
    jm.fit(y, params={"optimizer_cov": "lbfgs"})
    tm = gpt.GPModel.from_dict(jm.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(tm._approx.perm, np.asarray(jm._approx.perm))
    np.testing.assert_array_equal(tm._approx.neighbors.numpy(),
                                  np.asarray(jm._approx.neighbors))
    cpp = f["coords"][:5] + 0.01
    pj = jm.predict(gp_coords_pred=cpp, predict_var=True)
    pt = tm.predict(gp_coords_pred=cpp, predict_var=True)
    np.testing.assert_allclose(pt["mu"], pj["mu"], atol=1e-8)
    np.testing.assert_allclose(pt["var"], pj["var"], atol=1e-8)
