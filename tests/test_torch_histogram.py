"""The histogram's plain PyTorch version vs the JAX package (CPU; inputs
from a numpy seed handed to both sides), and the ``build_histogram`` gate.

Tolerances: ``histogram_plain`` vs ``_build_histogram_xla`` 1e-12 in
float64 (both add the rows of a bin in increasing order); float32 plain vs
the Pallas kernel in interpret mode atol 1e-4 on the gradient / hessian sums
and 1e-6 on the counts at n = 3000, F = 10, B = 64 — the tolerances the JAX
package's own test holds its kernel to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.boosting.tree import _build_histogram_xla
from gpboost_tpu.ops.kernels.histogram import histogram_pallas
from gpboost_tpu_torch.boosting.tree import build_histogram
from gpboost_tpu_torch.ops.kernels import histogram as hk


def _inputs(n, F, B, seed=0, keep=0.8):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, F)).astype(np.int32)
    g = rng.standard_normal(n)
    h = np.abs(rng.standard_normal(n))
    mask = rng.random(n) < keep
    return binned, g, h, mask


@pytest.mark.parametrize("n,F,B,keep", [(3000, 10, 64, 0.8),
                                        (1001, 3, 256, 0.03),
                                        (500, 1, 7, 1.0),
                                        (400, 5, 32, 0.0)])
def test_plain_matches_jax_scatter_add_float64(n, F, B, keep):
    binned, g, h, mask = _inputs(n, F, B, keep=keep)
    want = _build_histogram_xla(jnp.asarray(binned), jnp.asarray(g),
                                jnp.asarray(h), jnp.asarray(mask), B)
    got = hk.histogram_plain(torch.as_tensor(binned), torch.as_tensor(g),
                             torch.as_tensor(h), torch.as_tensor(mask), B)
    for a, b in zip(got, want):
        assert a.shape == (F, B) and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    # counts are whole numbers and add up to F * rows in the mask
    assert float(got[2].sum()) == F * int(mask.sum())


def test_plain_float32_matches_pallas_interpret():
    n, F, B = 3000, 10, 64
    binned, g, h, mask = _inputs(n, F, B)
    pg, ph, pc = histogram_pallas(jnp.asarray(binned), jnp.asarray(g),
                                  jnp.asarray(h), jnp.asarray(mask), B)
    got = hk.histogram_plain(
        torch.as_tensor(binned), torch.as_tensor(g, dtype=torch.float32),
        torch.as_tensor(h, dtype=torch.float32), torch.as_tensor(mask), B)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pg), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ph), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(pc), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_and_gate_take_the_plain_version_on_cpu_tensors(dtype):
    n, F, B = 700, 4, 16
    binned, g, h, mask = _inputs(n, F, B, seed=3)
    bt = torch.as_tensor(binned)
    panel = torch.as_tensor(np.ascontiguousarray(binned.T.astype(np.uint8)))
    args = (torch.as_tensor(g, dtype=dtype), torch.as_tensor(h, dtype=dtype),
            torch.as_tensor(mask), B)
    before = hk.histogram.launches
    want = hk.histogram_plain(bt, *args)
    for got in (hk.histogram(bt, *args), hk.histogram(bt, *args,
                                                      binned_t=panel),
                build_histogram(bt, *args),
                build_histogram(bt, *args, binned_t=panel)):
        for a, b in zip(got, want):
            assert a.dtype == dtype
            assert torch.equal(a, b)
    assert hk.histogram.launches == before      # no kernel on the CPU


def test_uint8_panel_holds_256_bins():
    # a feature with missing values has up to 256 bins: 0...255 in a byte
    n = 600
    rng = np.random.default_rng(5)
    binned = rng.integers(0, 256, size=(n, 2)).astype(np.int32)
    binned[:3, 0] = [0, 255, 255]
    got = hk.histogram_plain(torch.as_tensor(binned), torch.ones(n),
                             torch.ones(n), torch.ones(n, dtype=torch.bool),
                             256)
    want = np.bincount(binned[:, 0], minlength=256)
    np.testing.assert_array_equal(got[2][0].numpy(), want)
    assert hk.MAX_BINS == 256
