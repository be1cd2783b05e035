"""PyTorch port vs the JAX package: LCG streams and covariance functions.

Inputs are made with numpy from a seed and handed to both sides. Tolerances:
LCG streams bit-equal; correlations and covariance matrices 1e-12 (float64,
the same formulas on both sides, so only rounding differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.ops import cov_fns as jcov
from gpboost_tpu.utils import rng as jrng
from gpboost_tpu_torch.ops import cov_fns as tcov
from gpboost_tpu_torch.utils import rng as trng


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

FAMILIES = [
    ("exponential", 0.0), ("matern", 0.5), ("matern", 1.5), ("matern", 2.5),
    ("gaussian", 0.0), ("matern_ard", 0.5), ("matern_ard", 1.5),
    ("matern_ard", 2.5), ("gaussian_ard", 0.0),
]


@pytest.mark.parametrize("init_c", [0.1, 0.8, 0.17])
def test_lcg_unif_bit_equal(init_c):
    np.testing.assert_array_equal(trng.sim_rand_unif(500, init_c),
                                  jrng.sim_rand_unif(500, init_c))


def test_lcg_boost_and_normal_bit_equal():
    np.testing.assert_array_equal(trng.sim_rand_unif_boost(300, 0.3),
                                  jrng.sim_rand_unif_boost(300, 0.3))
    np.testing.assert_array_equal(trng.sim_rand_normal(300, 0.42),
                                  jrng.sim_rand_normal(300, 0.42))


def _pars(cf, rng):
    return np.concatenate([[1.3], rng.uniform(0.1, 0.4, cf.num_cov_par - 1)])


@pytest.mark.parametrize("name,shape", FAMILIES)
def test_cov_matrix_matches_jax(name, shape):
    rng = np.random.default_rng(3)
    c1 = rng.uniform(size=(40, 3))
    c2 = rng.uniform(size=(25, 3))
    jf = jcov.CovFunction.create(name, shape=shape, dim_coords=3)
    tf = tcov.CovFunction.create(name, shape=shape, dim_coords=3)
    assert (tf.cov_fct_type, tf.num_cov_par, tf.is_isotropic,
            tf.has_coord_scaling) == (jf.cov_fct_type, jf.num_cov_par,
                                      jf.is_isotropic, jf.has_coord_scaling)
    pars = _pars(jf, rng)
    want = np.asarray(jf.cov_between(jnp.asarray(pars), jnp.asarray(c1),
                                     jnp.asarray(c2)))
    got = tf.cov_between(torch.tensor(pars), torch.tensor(c1),
                         torch.tensor(c2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,shape", FAMILIES)
def test_correlation_matches_jax(name, shape):
    rng = np.random.default_rng(4)
    jf = jcov.CovFunction.create(name, shape=shape, dim_coords=2)
    tf = tcov.CovFunction.create(name, shape=shape, dim_coords=2)
    pars = _pars(jf, rng)
    dist = np.concatenate([[0.0], rng.uniform(0, 2, 63)]).reshape(8, 8)
    if jf.is_isotropic:
        want = jf.correlation_from_dist(jnp.asarray(dist), jnp.asarray(pars))
        got = tf.correlation_from_dist(torch.tensor(dist), torch.tensor(pars))
    else:
        want = jf.corr_from_scaled_dist(jnp.asarray(dist), jnp.asarray(pars))
        got = tf.corr_from_scaled_dist(torch.tensor(dist), torch.tensor(pars))
        c = rng.uniform(size=(9, 2))
        np.testing.assert_allclose(
            tf.scale_coords(torch.tensor(c), torch.tensor(pars)).numpy(),
            np.asarray(jf.scale_coords(jnp.asarray(c), jnp.asarray(pars))),
            rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_euclidean_distance_and_consts_match_jax():
    rng = np.random.default_rng(5)
    c1 = rng.uniform(size=(30, 2))
    np.testing.assert_allclose(
        tcov.euclidean_distance(torch.tensor(c1), torch.tensor(c1)).numpy(),
        np.asarray(jcov.euclidean_distance(jnp.asarray(c1), jnp.asarray(c1))),
        rtol=0, atol=1e-12)
    for s in (0.5, 1.5, 2.5):
        assert tcov._matern_mult_const(s) == jcov._matern_mult_const(s)
    assert tcov.parse_cov_alias("exponential", 0.0) == \
        jcov.parse_cov_alias("exponential", 0.0)
    assert tcov.parse_cov_alias("rbf", 0.0) == jcov.parse_cov_alias("rbf", 0.0)


@pytest.mark.parametrize("name,shape", [
    ("wendland", 0.0), ("powered_exponential", 1.0), ("matern", 0.8),
    ("matern_space_time", 1.5), ("linear", 0.0), ("hurst", 0.0),
    ("matern_estimate_shape", 1.5)])
def test_unported_families_raise(name, shape):
    """These families raised before they were ported (ROADMAP.md item 14);
    each is now the JAX package's covariance matrix within 1e-12 (more in
    ``tests/test_torch_cov_tail.py``)."""
    rng = np.random.default_rng(6)
    dim = 3 if name == "matern_space_time" else 2
    c1 = rng.uniform(size=(25, dim))
    c2 = rng.uniform(size=(15, dim))
    jf = jcov.CovFunction.create(name, shape=shape, dim_coords=dim)
    tf = tcov.CovFunction.create(name, shape=shape, dim_coords=dim)
    assert tf.num_cov_par == jf.num_cov_par
    pars = np.concatenate([[1.3], rng.uniform(0.8, 1.2, jf.num_cov_par - 1)])
    if name == "hurst":
        pars[1] = 0.3
    want = np.asarray(jf.cov_between(jnp.asarray(pars), jnp.asarray(c1),
                                     jnp.asarray(c2)))
    got = tf.cov_between(torch.tensor(pars), torch.tensor(c1),
                         torch.tensor(c2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
