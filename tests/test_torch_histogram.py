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


@pytest.mark.parametrize("max_abs,n", [(3.0, 100_000), (1e-3, 7),
                                       (2.5e30, 1_000_003), (1.0, 1)])
def test_fixed_point_scale_keeps_a_sum_below_2_63(max_abs, n):
    """The kernel's scale 2^k: n max|v| 2^k in [2^61, 2^62), so that a sum
    of n rounded terms stays below 2^63 whatever the mask, with the most
    bits the bound allows; from tensors, one scale for g and one for h."""
    s = hk.fixed_point_scale(max_abs, n)
    assert np.frexp(s)[0] == 0.5                       # a power of two
    assert 2.0 ** 61 <= n * max_abs * s < 2.0 ** 62
    g = torch.full((n,), -max_abs, dtype=torch.float32)
    sg, sh = hk.fixed_point_scales(g, g.abs() / 4)
    assert sg == hk.fixed_point_scale(float(g.abs().max()), n)
    assert sh == 4 * sg


def test_fixed_point_scale_edges():
    assert hk.fixed_point_scale(0.0, 1000) == 1.0      # all zero: any scale
    assert hk.fixed_point_scale(1e-38, 10) == 2.0 ** 100     # clamped
    with pytest.raises(ValueError, match="not finite"):
        hk.fixed_point_scale(float("inf"), 10)
    # the rounded fixed-point sum of float32 values is their float64 sum
    # to ~n / scale (what the kernel computes, emulated with numpy)
    rng = np.random.default_rng(2)
    v = rng.standard_normal(100_000).astype(np.float32)
    s = hk.fixed_point_scale(float(np.abs(v).max()), len(v))
    fixed = np.sum(np.rint(v.astype(np.float64) * s).astype(np.int64)) / s
    assert abs(fixed - v.astype(np.float64).sum()) <= len(v) / s


@pytest.mark.parametrize("n,scale", [(20_000, 1.0), (3000, 1e-200),
                                     (7, 1e250), (0, 1.0)])
def test_fixed_point_words_sum_exactly(n, scale):
    """The CUDA route of ``histogram_plain`` (``gpu_use_dp``): sums of two
    64-bit fixed-point words a value, order-free; on the CPU here, against
    the exact sum of each bin (``math.fsum``): equal to float64 rounding."""
    import math
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 97, n)
    v = rng.standard_normal((n, 3)) * scale
    v[:, 2] = 1.0
    words, s1, s2 = hk.fixed_point_words(torch.as_tensor(v))
    acc = torch.zeros((97, 6), dtype=torch.int64).index_add_(
        0, torch.as_tensor(idx), words)
    got = hk.from_fixed_point_words(acc, s1, s2).numpy()
    want = np.array([[math.fsum(v[idx == b, c]) for c in range(3)]
                     for b in range(97)])
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert np.array_equal(got[:, 2], np.bincount(idx, minlength=97))
