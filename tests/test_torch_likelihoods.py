"""The port's likelihood families vs the JAX package's (``likelihoods/``):
log-density, its first three derivatives w.r.t. the location (nested
autograd on both sides), the response-scale moments of a latent normal
(``models/laplace.py::_response_moments``) and the aux-parameter transforms,
for every ported family, float64 on the CPU, inputs from a numpy seed.

Tolerance: 1e-10 (absolute, and relative to the size of the value) for
everything. The two zero-one-censored families (incomplete beta / gamma,
``likelihoods/special.py``) are held at their log-density and response
moments; the heteroscedastic family's single-location functions raise, as
in the JAX package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpboost_tpu import likelihoods as jlk
from gpboost_tpu.models import laplace as jlap

from gpboost_tpu_torch import likelihoods as tlk
from gpboost_tpu_torch.models import laplace as tlap

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 40
PORTED = ("gaussian", "bernoulli_probit", "bernoulli_logit",
          "binomial_logit", "binomial_probit", "poisson", "gamma",
          "negative_binomial", "negative_binomial_1", "beta", "t",
          "t_fix_df", "lognormal", "beta_binomial", "zero_inflated_gamma",
          "zero_censored_power_transformed_normal", "zoctn")
AUX = {"gaussian": [0.7], "gamma": [1.8], "negative_binomial": [2.5],
       "negative_binomial_1": [0.6], "beta": [4.0], "t": [1.3, 4.0],
       "t_fix_df": [1.3], "lognormal": [0.4], "beta_binomial": [12.0],
       "zero_inflated_gamma": [1.6, 0.3],
       "zero_censored_power_transformed_normal": [0.8, 1.4],
       "zoctn": [0.5, 0.3, 1.2]}


def _response(name, rng):
    u = rng.uniform(size=N)
    if name in ("bernoulli_probit", "bernoulli_logit", "beta_binomial"):
        return (u < 0.4).astype(float)
    if name in ("binomial_logit", "binomial_probit"):
        return np.floor(u * 6) / 5
    if name in ("poisson", "negative_binomial", "negative_binomial_1"):
        return np.floor(u * 7)
    if name in ("gamma", "lognormal"):
        return 0.1 + 3 * u
    if name == "beta":
        return 0.05 + 0.9 * u
    if name in ("zero_inflated_gamma",
                "zero_censored_power_transformed_normal"):
        return np.where(u < 0.3, 0.0, 0.2 + 2 * u)
    if name == "zoctn":
        return np.where(u < 0.2, 0.0, np.where(u > 0.85, 1.0, u))
    return rng.standard_normal(N)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * scale, f"{what}: off by {err} (scale {scale})"


@pytest.mark.parametrize("name", PORTED)
def test_family_matches_jax(name):
    rng = np.random.default_rng(PORTED.index(name))
    y = _response(name, rng)
    loc = 0.8 * rng.standard_normal(N)
    if name == "zoctn":
        loc = 0.5 + 0.3 * rng.standard_normal(N)
    aux_np = AUX.get(name)
    jf, tf = jlk.get_family(name), tlk.get_family(name)
    assert (tf.num_aux_pars, tf.aux_names, tf.default_aux, tf.discrete,
            tf.clip_information, tf.aux_transforms) == (
        jf.num_aux_pars, jf.aux_names, jf.default_aux, jf.discrete,
        jf.clip_information, jf.aux_transforms)
    ja = jnp.zeros((0,)) if aux_np is None else jnp.asarray(aux_np)
    ta = None if aux_np is None else torch.tensor(aux_np, dtype=torch.float64)
    jy, jl = jnp.asarray(y), jnp.asarray(loc)
    ty, tl = torch.tensor(y), torch.tensor(loc)
    _close(tf.log_lik(ty, tl, ta), jf.log_lik(jy, jl, ja), "log_lik")
    _close(tf.d_loc(ty, tl, ta), jf.d_loc(jy, jl, ja), "d_loc")
    _close(tf.d2_loc(ty, tl, ta), jf.d2_loc(jy, jl, ja), "d2_loc")
    _close(tf.d3_loc(ty, tl, ta), jf.d3_loc(jy, jl, ja), "d3_loc")
    if jf.log_lik_weighted is not None:
        w = np.floor(1 + 5 * rng.uniform(size=N))
        _close(tf.log_lik_weighted(ty, tl, ta, torch.tensor(w)),
               jf.log_lik_weighted(jy, jl, ja, jnp.asarray(w)),
               "log_lik_weighted")
    # response moments of a latent N(mu, var)
    var = 0.1 + rng.uniform(size=N)
    tm, tv = tlap._response_moments(name, tl, torch.tensor(var), ta)
    jm, jv = jlap._response_moments(name, jl, jnp.asarray(var), ja)
    _close(tm, jm, "response mean")
    assert (tv is None) == (jv is None)
    if jv is not None:
        _close(tv, jv, "response variance")
    # aux transforms (user scale <-> optimizer scale)
    if aux_np is not None:
        t_opt = tlk.aux_to_optim_scale(tf, aux_np)
        _close(t_opt, jlk.aux_to_optim_scale(jf, aux_np), "aux_to_optim")
        _close(tlk.aux_from_optim_scale(tf, torch.tensor(t_opt, dtype=torch.float64)),
               jlk.aux_from_optim_scale(jf, jnp.asarray(t_opt)),
               "aux_from_optim")
        _close(tlk.aux_chain_factors(tf, t_opt),
               jlk.aux_chain_factors(jf, t_opt), "aux_chain_factors")
        np.testing.assert_array_equal(
            tf.default_aux_pars(2.5), jf.default_aux_pars(2.5))


def test_derivatives_stay_differentiable_through_loc_and_aux():
    """d2_loc keeps its graph when the caller's loc or aux carries one
    (what the Laplace NLL's gradient needs: d3 terms and aux terms)."""
    fam = tlk.get_family("gamma")
    y = torch.tensor([0.5, 1.2, 2.0], dtype=torch.float64)
    loc = torch.tensor([0.1, -0.3, 0.4], dtype=torch.float64,
                       requires_grad=True)
    aux = torch.tensor([1.7], dtype=torch.float64, requires_grad=True)
    d2 = fam.d2_loc(y, loc, aux)
    g_loc, g_aux = torch.autograd.grad(d2.sum(), (loc, aux))
    torch.testing.assert_close(g_loc, fam.d3_loc(y, loc.detach(), aux.detach()),
                               rtol=1e-12, atol=1e-12)
    # gamma: d2 = -g y exp(-loc), d(sum d2)/dg = -sum y exp(-loc)
    assert abs(float(g_aux) + float(torch.sum(y * torch.exp(-loc)))) < 1e-12
    plain = fam.d2_loc(y, loc.detach(), aux.detach())
    assert not plain.requires_grad


@pytest.mark.parametrize("name,alias", [
    ("bernoulli_probit", "binary"), ("bernoulli_logit", "binary_logit"),
    ("t", "student_t"), ("zero_inflated_gamma", "gamma_zero_inflated"),
    ("t", "t_fisher_laplace"), ("poisson", "poisson_quasi_newton")])
def test_names_and_variants_match_jax(name, alias):
    assert tlk.parse_likelihood_variants(alias) == \
        jlk.parse_likelihood_variants(alias)
    assert tlk.get_family(tlk.parse_likelihood_variants(alias)[0]).name == name
    assert set(tlk.supported_likelihoods()) == set(jlk.supported_likelihoods())


@pytest.mark.parametrize("name", ["zero_one_censored_transformed_beta",
                                  "zero_one_censored_shifted_gamma"])
def test_censored_families_need_special_functions(name):
    """The two censored families take the incomplete beta / gamma functions
    of ``likelihoods/special.py`` (ROADMAP.md item 11): their log-density
    (at 0, in (0, 1) and at 1), response mean and variance are the JAX
    family's within 1e-10 relative."""
    fam, jfam = tlk.get_family(name), jlk.get_family(name)
    assert fam.num_aux_pars == jfam.num_aux_pars
    assert fam.default_aux == jfam.default_aux
    rng = np.random.default_rng(3)
    y = np.concatenate([[0.0, 1.0, 0.0, 1.0], rng.uniform(0.02, 0.98, 12)])
    loc = rng.normal(-0.3, 0.8, y.shape[0])
    aux = np.array([12.0, 0.1]) if "beta" in name else np.array([3.0, 0.1])
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    np.testing.assert_allclose(
        fam.log_lik(t(y), t(loc), t(aux)).numpy(),
        np.asarray(jfam.log_lik(jnp.asarray(y), jnp.asarray(loc),
                                jnp.asarray(aux))), rtol=TOL)
    for got, want in ((fam.response_mean, jfam.response_mean),
                      (fam.response_var, jfam.response_var)):
        np.testing.assert_allclose(
            got(t(loc), t(aux)).numpy(),
            np.asarray(want(jnp.asarray(loc), jnp.asarray(aux))), rtol=TOL)


def test_heteroscedastic_family_is_registered_and_raises():
    """The family's single-location functions raise, as the JAX package's
    do: its model is the two-set engine (``models/heteroscedastic.py``)."""
    fam = tlk.get_family("gaussian_heteroscedastic")
    with pytest.raises(NotImplementedError, match="two-set engine"):
        fam.log_lik(torch.zeros(2), torch.zeros(2), None)
    with pytest.raises(NotImplementedError, match="two-set engine"):
        jlk.get_family("gaussian_heteroscedastic").log_lik(
            np.zeros(2), np.zeros(2), None)
    with pytest.raises(ValueError, match="not supported"):
        tlk.get_family("no_such_family")
