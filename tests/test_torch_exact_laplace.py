"""The Laplace approximation of exact models, the port against the JAX
package and the R goldens (``gpboost_tpu_torch/models/laplace.py``'s
``ModelSpec`` half vs ``gpboost_tpu/models/laplace.py``; mirrors the GP
classes of ``tests/test_non_gaussian_golden.py`` and the dense column of
``tests/test_ng_matrix_golden.py``). CPU, float64, the R fixtures
(n = 100).

Tolerances: the mode, the NLL and its gradients (covariance, aux and
coefficient parameters, and F) 1e-10 relative; ``test_nll_adaptive_gh``
1e-10; predictions (latent and response scale) 1e-9 relative; the R
goldens at the JAX tests' own (NLL 1e-5; the probit fit rtol 2e-2, its NLL
1e-3); the exact NLL of each family against the reference's Vecchia
golden at nn = 30 within the JAX test's 5e-3 relative.
"""
import json
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax.numpy as jnp
from gpboost_tpu.models import laplace as jl
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif
from gpboost_tpu_torch.models import laplace as tl

FAMILIES = ["poisson", "gamma", "negative_binomial", "t", "beta",
            "bernoulli_logit"]


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
def ng():
    """``test_non_gaussian_golden.py``'s fixture (R:27-85)."""
    n = 100
    x = sim_rand_unif(2 * n, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    L = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    b = L @ sim_rand_normal(n, 0.8)
    X = np.column_stack([np.ones(n), np.sin(
        (np.arange(1, n + 1) - n / 2) ** 2 * 2 * np.pi / n)])
    return dict(n=n, coords=coords, D=D, b=b, X=X)


@pytest.fixture(scope="module")
def mx():
    """``test_ng_matrix_golden.py``'s base data, responses and goldens."""
    from tests.test_ng_matrix_golden import GOLD, base, make_y
    coords, eps = base.__wrapped__()
    return dict(coords=coords, eps=eps, make_y=make_y, gold=GOLD)


def _pair(coords, lik):
    kw = dict(gp_coords=coords, cov_function="exponential", likelihood=lik)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _aux(lik):
    return {"gamma": [1.5], "negative_binomial": [2.0], "t": [0.4, 5.0],
            "beta": [3.0]}.get(lik)


@pytest.mark.parametrize("lik", FAMILIES)
def test_nll_and_gradients_match_jax(mx, lik):
    """The dense column of the NG matrix: each family's exact Laplace NLL
    at (1, 0.1) against the JAX package (1e-10 relative) and the
    reference's Vecchia golden (5e-3, its own structural offset); with a
    fixed effect X beta, the gradients in the covariance, aux and
    coefficient parameters, d NLL / dF and the mode, 1e-10 relative."""
    y = mx["make_y"](lik, mx["eps"])
    jm, tm = _pair(mx["coords"], lik)
    cp = np.array([1.0, 0.1])
    nll_t = tm.neg_log_likelihood(cp, y)
    nll_j = jm.neg_log_likelihood(cp, y)
    assert abs(nll_t - nll_j) < 1e-10 * abs(nll_j)
    want = mx["gold"][f"{lik}|vecchia"]["nll"]
    assert abs(nll_t - want) < 5e-3 * abs(want)
    n = len(y)
    X = np.column_stack([np.ones(n), np.linspace(-1, 1, n)])
    beta = np.array([0.1, -0.2])
    aux = _aux(lik)
    jd = jm._with_y(y)
    jd.X = jnp.asarray(X)
    v_j, (gc_j, ga_j, gb_j) = jl.nll_value_and_grad(
        jm.spec, jd, jnp.asarray(cp), None if aux is None
        else jnp.asarray(aux), jnp.asarray(beta), None)
    v_t, (gc_t, ga_t, gb_t) = tl.nll_value_and_grad(
        tm.spec, tm.data, torch.as_tensor(cp), None if aux is None
        else torch.as_tensor(np.asarray(aux)), torch.as_tensor(y),
        torch.as_tensor(X), torch.as_tensor(beta))
    assert abs(float(v_t) - float(v_j)) < 1e-10 * abs(float(v_j))
    assert _rel(gc_t.numpy(), gc_j) < 1e-10
    assert _rel(gb_t.numpy(), gb_j) < 1e-10
    if aux is not None:
        assert _rel(ga_t.numpy(), ga_j) < 1e-10
    F = X @ beta
    gF_j = jl.gradient_wrt_F(jm.spec, jd, jnp.asarray(cp), None if aux is None
                             else jnp.asarray(aux), jnp.asarray(F))
    gF_t = tl.gradient_wrt_F(tm.spec, tm.data, torch.as_tensor(cp),
                             None if aux is None
                             else torch.as_tensor(np.asarray(aux)),
                             torch.as_tensor(y), torch.as_tensor(F))
    assert _rel(gF_t.numpy(), gF_j) < 1e-10
    sig = tl._latent_cov(tm.spec, tm.data, torch.as_tensor(cp))
    b_t = tl.find_mode(lik, sig, torch.as_tensor(y), torch.as_tensor(F),
                       None if aux is None else torch.as_tensor(
                           np.asarray(aux)))
    b_j = jl.find_mode(lik, jnp.asarray(sig.numpy()), jnp.asarray(y),
                       jnp.asarray(F), jnp.zeros(0) if aux is None
                       else jnp.asarray(aux))
    assert _rel(b_t.numpy(), b_j) < 1e-10


def _probit_y(ng):
    probs = norm.cdf(ng["b"])
    return (sim_rand_unif(ng["n"], 0.2341) < probs).astype(float)


def test_bernoulli_goldens(ng):
    """``TestBernoulliProbitGP.test_nll`` (63.6205917) and
    ``TestBernoulliLogitGP.test_nll`` (66.299571) at (0.9, 0.2), 1e-5;
    a response other than 0/1 raises."""
    y = _probit_y(ng)
    tm = gpt.GPModel(gp_coords=ng["coords"], cov_function="exponential",
                     likelihood="bernoulli_probit", device="cpu")
    assert abs(tm.neg_log_likelihood([0.9, 0.2], y) - 63.6205917) < 1e-5
    bad = y.copy()
    bad[3] += 1e-6
    with pytest.raises(ValueError):
        tm.neg_log_likelihood([1.0, 0.1], bad)
    probs = 1.0 / (1.0 + np.exp(-ng["b"]))
    yl = (sim_rand_unif(ng["n"], 0.2341) < probs).astype(float)
    tl_ = gpt.GPModel(gp_coords=ng["coords"], cov_function="exponential",
                      likelihood="bernoulli_logit", device="cpu")
    assert abs(tl_.neg_log_likelihood([0.9, 0.2], yl) - 66.299571) < 1e-5


@pytest.mark.parametrize("optimizer", ["gradient_descent", "lbfgs"])
def test_probit_fit_matches_r_and_jax(ng, optimizer):
    """``TestBernoulliProbitGP.test_fit`` / ``test_fit_lbfgs`` (R:106-115):
    (0.9419234, 0.1866877) to 2e-2, the GD NLL 63.61263619 to 1e-3; the
    port's estimates are the JAX package's within 1e-6 relative."""
    y = _probit_y(ng)
    iu = np.triu_indices(ng["n"], 1)
    params = {"optimizer_cov": optimizer,
              "init_cov_pars": [1.0, np.mean(ng["D"][iu]) / 3]}
    if optimizer == "gradient_descent":
        params.update(lr_cov=0.1, use_nesterov_acc=False,
                      convergence_criterion="relative_change_in_parameters")
    jm, tm = _pair(ng["coords"], "bernoulli_probit")
    jm.fit(y=y, params=dict(params))
    tm.fit(y=y, params=dict(params))
    np.testing.assert_allclose(tm.get_cov_pars(), [0.9419234, 0.1866877],
                               rtol=2e-2)
    if optimizer == "gradient_descent":
        assert abs(tm.get_current_neg_log_likelihood() - 63.61263619) < 1e-3
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)


def test_predict_and_training_effects_match_jax(ng):
    """``laplace.predict`` through ``GPModel.predict`` with X (latent and
    response scale, variances and covariance) and the training-data random
    effects at the same parameters and coefficients: 1e-9 relative."""
    y = _probit_y(ng)
    jm, tm = _pair(ng["coords"], "bernoulli_logit")
    for m in (jm, tm):
        m.fit(y=y, X=ng["X"], params={"maxit": 3})
    tm.cov_pars_ = np.asarray(jm.get_cov_pars())
    tm.coefs_ = np.asarray(jm.get_coef())
    coord_test = np.array([[0.1, 0.2], [0.9, 0.4], [0.7, 0.55]])
    kw = dict(gp_coords_pred=coord_test, X_pred=ng["X"][:3])
    for resp in (False, True):
        for flag in ("predict_var", "predict_cov_mat"):
            pj = jm.predict(predict_response=resp, **kw, **{flag: True})
            pt = tm.predict(predict_response=resp, **kw, **{flag: True})
            assert _rel(pt["mu"], pj["mu"]) < 1e-9
            assert _rel(pt["var"], pj["var"]) < 1e-9
            if flag == "predict_cov_mat" and not resp:
                assert _rel(pt["cov"], pj["cov"]) < 1e-9
    assert _rel(tm.predict_training_data_random_effects(predict_var=True),
                jm.predict_training_data_random_effects(predict_var=True)) \
        < 1e-9


@pytest.mark.parametrize("lik,aux", [("bernoulli_logit", None),
                                     ("poisson", None), ("gamma", [2.0])])
def test_nll_adaptive_gh_matches_jax(lik, aux):
    """The predictive NLL by adaptive Gauss-Hermite quadrature, per point:
    1e-10 relative."""
    rng = np.random.default_rng(3)
    n = 40
    mean, var = rng.normal(size=n), rng.uniform(0.1, 2.0, n)
    y = {"bernoulli_logit": (rng.uniform(size=n) < 0.5).astype(float),
         "poisson": rng.poisson(2.0, n).astype(float),
         "gamma": rng.gamma(2.0, size=n)}[lik]
    got = tl.test_nll_adaptive_gh(lik, torch.as_tensor(y),
                                  torch.as_tensor(mean),
                                  torch.as_tensor(var),
                                  None if aux is None
                                  else torch.as_tensor(np.asarray(aux)))
    want = jl.test_nll_adaptive_gh(lik, jnp.asarray(y), jnp.asarray(mean),
                                   jnp.asarray(var), None if aux is None
                                   else jnp.asarray(aux))
    assert _rel(got.numpy(), want) < 1e-10


def test_std_errors_of_a_laplace_model_raise(ng):
    """The JAX package has no std errors of the covariance parameters of a
    Laplace model (its Fisher information is the Gaussian one); the port
    says so instead of returning numbers; the coefficients' std errors
    (the inverse Hessian of the Laplace NLL in beta) exist."""
    y = _probit_y(ng)
    tm = gpt.GPModel(gp_coords=ng["coords"], cov_function="exponential",
                     likelihood="bernoulli_logit", device="cpu")
    tm.fit(y=y, X=ng["X"], params={"maxit": 3})
    with pytest.raises(NotImplementedError, match="non-Gaussian"):
        tm.get_cov_pars(std_err=True)
    sd = tm.get_coef(std_err=True)[1]
    assert np.all(np.isfinite(sd)) and np.all(sd > 0)
