"""The port's inducing-point selection, Wendland taper and the low-rank
family's distances (``ops/inducing.py``, ``ops/cov_fns.py``,
``ops/fitc.py``) against the JAX package on the CPU, float64.

- ``select_inducing_points``: kmeans++ (the same numpy draws for the
  seeding, PyTorch Lloyd steps), random and cover_tree, within 1e-12;
- ``wendland_correlation`` for taper shapes 0, 1, 2 within 1e-14, and the
  unsupported shape raising;
- ``ops/fitc.py::distance``: exactly zero where two points coincide (the
  inner-product formula is not), equal to the differences' norm;
- the fit loop's ``device_loop_eligible`` takes the host route for the
  low-rank models (they have no fused kernel) without reading the Vecchia
  kernel gate.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpboost_tpu.ops.cov_fns import wendland_correlation as jwendland
from gpboost_tpu.ops.inducing import select_inducing_points as jselect

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import vecchia_fit
from gpboost_tpu_torch.ops import fitc as tfitc
from gpboost_tpu_torch.ops.cov_fns import (euclidean_distance,
                                           wendland_correlation)
from gpboost_tpu_torch.ops.inducing import select_inducing_points


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(4)
    c = rng.uniform(size=(240, 2))
    c[7] = c[3]                      # a duplicate: uniq drops it
    return c


@pytest.mark.parametrize("method,k,seed", [
    ("kmeans++", 24, 0), ("kmeans++", 10, 3), ("random", 24, 1),
    ("random", 239, 0), ("cover_tree", 50, 2)])
def test_select_inducing_points_matches_jax(coords, method, k, seed):
    j = jselect(coords, k, method, seed, cover_tree_radius=0.2)
    t = select_inducing_points(coords, k, method, seed,
                               cover_tree_radius=0.2)
    assert t.dtype == torch.float64 and t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                               atol=1e-12)


def test_select_inducing_points_rejects_unknown_method(coords):
    with pytest.raises(ValueError, match="not supported"):
        select_inducing_points(coords, 5, "hierarchical")


@pytest.mark.parametrize("shape", [0.0, 1.0, 2.0])
def test_wendland_correlation_matches_jax(shape):
    d = np.linspace(0.0, 0.6, 61)
    mu = (1.0 + 2.0) / 2.0 + shape + 0.5
    j = np.asarray(jwendland(jnp.asarray(d), 0.4, shape, mu))
    t = wendland_correlation(torch.tensor(d), 0.4, shape, mu).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-14, atol=1e-16)
    assert t[0] == 1.0 and np.all(t[d >= 0.4] == 0.0)


def test_wendland_correlation_rejects_other_shapes():
    with pytest.raises(ValueError, match="taper_shape"):
        wendland_correlation(torch.zeros(3), 0.4, 0.5, 2.0)


def test_distance_is_exact_where_points_coincide(coords):
    c = torch.tensor(coords)
    ip = c[:30]
    d = tfitc.distance(c, ip)
    ref = torch.sqrt(((c[:, None, :] - ip[None, :, :]) ** 2).sum(-1))
    torch.testing.assert_close(d, ref, rtol=0, atol=1e-15)
    assert torch.all(torch.diagonal(d[:30]) == 0.0)
    # batched: [C, n, d] x [C, k, d]
    db = tfitc.distance(c.reshape(2, 120, 2), c.reshape(2, 120, 2)[:, :10])
    torch.testing.assert_close(db[1], tfitc.distance(c[120:], c[120:130]))
    # the inner-product formula leaves rounding there (why the low-rank
    # models do not use it)
    assert euclidean_distance(c, c).shape == (240, 240)


def test_device_loop_takes_host_route_for_low_rank(coords):
    y = np.sin(6 * coords[:, 0])
    for approx in ("fitc", "full_scale_vecchia"):
        gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                         gp_approx=approx, num_ind_points=20,
                         num_neighbors=8, device="cpu")
        assert not hasattr(gp._approx, "_kernel_shape")
        assert vecchia_fit.device_loop_eligible(gp._approx) is False
        gp.fit(y, params={"optimizer_cov": "lbfgs", "maxit": 3})
        assert gp._fit_result.aux is None and gp._fit_result.num_evals >= 2
