"""Gradient / hessian / count histograms: hand-written CUDA for Hopper +
plain version.

:func:`histogram` replaces the TPU kernel
``gpboost_tpu/ops/kernels/histogram.py::histogram_pallas``: for binned
features ``[n, F]``, gradients, hessians and a row mask it returns the
per-feature per-bin sums of gradient, hessian and row count over the rows
inside the mask, three ``[F, num_bins]`` arrays.

The TPU kernel is a one-hot x values matrix product because the TPU has no
scatter; the CUDA kernel (``csrc/histogram.cu``, ``sm_90a``, built by
``ops/kernels/_build.py`` at first use) is the native form: per-block
histograms in shared memory filled with shared-memory atomics from a
features-major uint8 panel. A call is one kernel launch: a thread-block
cluster of 16 blocks per tile of features (as few features a cluster as keep
the grid within one block an SM), whose blocks add their histograms through
distributed shared memory and write the result whole (no memset, no global
atomics, no conversion kernel). Its bound is bytes (one byte per row and
feature, nine per row for gradient, hessian and mask), far less at n = 1e5
than what it takes: the shared atomics and the clustered launch.

The gradient and hessian sums are 64-bit fixed-point integers with
power-of-two scales that the caller passes once per tree, so they do not
depend on the order of the atomics: two launches on the same inputs give the
same bits, and a sum is exact to far below float32's rounding. Counts are
integers, exact. There is no cap on the number of rows. The scales come from
the host (:func:`fixed_point_scales`, one read) or stay on the device
(:func:`fixed_point_scales_device`, a float32 tensor the kernel reads when
it starts: what a grower without host reads and a CUDA graph need); both
give the same scales, so the same bits.

Beside it stands :func:`histogram_plain` (``index_add_``), the twin of the
JAX package's ``tree._build_histogram_xla``. The wrapper takes it only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. ``histogram.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from gpboost_tpu_torch.ops.kernels import _build

MAX_BINS = 256       # HIST_MAX_BINS of the .cu file (uint8 bins)
FIXED_POINT_BITS = 62    # n max|v| scale < 2^62: a sum stays below 2^63
_MAX_SCALE_EXP = 100     # scales within [2^-100, 2^100] (float32 range)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its argument types set."""
    global _LIB
    if _LIB is None:
        lib = _build.load("histogram")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cf = ctypes.c_float
        lib.histogram_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf,
                                         cf, vp]
        lib.histogram_launch.restype = ci
        lib.histogram_launch_dev_scales.argtypes = [vp, vp, vp, vp, vp, ci,
                                                    ci, ci, vp, vp]
        lib.histogram_launch_dev_scales.restype = ci
        lib.histogram_empty_launch.argtypes = [vp]
        lib.histogram_empty_launch.restype = ci
        for fn in (lib.hist_max_bins, lib.hist_cluster_blocks):
            fn.argtypes = []
            fn.restype = ci
        if lib.hist_max_bins() != MAX_BINS:
            raise RuntimeError(
                f"csrc/histogram.cu was built for {lib.hist_max_bins()} "
                f"bins; this module expects {MAX_BINS}")
        _LIB = lib
    return _LIB


def fixed_point_scale(max_abs: float, n_rows: int) -> float:
    """The power of two 2^k with n_rows * max_abs * 2^k < 2^62, k within
    [-100, 100]: the fixed-point scale of a sum of at most ``n_rows`` values
    of magnitude at most ``max_abs``."""
    if not math.isfinite(max_abs):
        raise ValueError(f"histogram: a gradient or hessian is not finite "
                         f"(max |v| = {max_abs})")
    if max_abs <= 0.0:
        return 1.0
    _, e = math.frexp(float(n_rows) * max_abs)     # n max|v| < 2^e
    k = min(max(FIXED_POINT_BITS - e, -_MAX_SCALE_EXP), _MAX_SCALE_EXP)
    return math.ldexp(1.0, k)


def fixed_point_scales(grad, hess) -> tuple:
    """(scale_g, scale_h) for :func:`histogram` from the round's gradients
    and hessians over all their rows: one reduction and one host read, to be
    made once per tree (every mask is a subset of the rows)."""
    n = grad.shape[0]
    g_max, h_max = torch.stack([grad.abs().max(),
                                hess.abs().max()]).double().tolist()
    return fixed_point_scale(g_max, n), fixed_point_scale(h_max, n)


def fixed_point_scales_device(grad, hess) -> torch.Tensor:
    """The scales of :func:`fixed_point_scales` as a float32 tensor [2] on
    the gradients' device, by the rule of :func:`fixed_point_scale`
    (``torch.frexp`` of n max|v| in float64), with no host read. A value
    that is not finite gives a NaN scale (and NaN sums): the fixed-shape
    grower raises on the NaN leaves after its fetch
    (``tree.check_finite_leaves``), where the host route raises here."""
    n = grad.shape[0]
    top = torch.stack([grad.abs().max(), hess.abs().max()]).double()
    _, e = torch.frexp(float(n) * top)
    k = torch.clamp(FIXED_POINT_BITS - e, -_MAX_SCALE_EXP, _MAX_SCALE_EXP)
    one = torch.ones((), dtype=torch.float64, device=top.device)
    scale = torch.where(top > 0.0, _pow2(k), one)
    scale = torch.where(torch.isfinite(top), scale, torch.nan)
    return scale.to(torch.float32)


def histogram_plain(binned, grad, hess, row_mask, num_bins: int):
    """Plain version of :func:`histogram`: one ``index_add_`` over the
    flattened ``feature * num_bins + bin`` index. Any device, any float
    dtype; returns (hist_g, hist_h, hist_c), each ``[F, num_bins]`` in the
    dtype of ``grad``. On the CPU rows are added in increasing order. On
    CUDA (the float64 route of ``gpu_use_dp``) ``index_add_`` would add
    floats with atomics in no fixed order, so it adds the integer words of
    :func:`fixed_point_words` instead: the same bits on every call."""
    n, F = binned.shape
    dt = grad.dtype
    zero = torch.zeros((), dtype=dt, device=grad.device)
    vals = torch.stack([torch.where(row_mask, grad, zero),
                        torch.where(row_mask, hess, zero),
                        row_mask.to(dt)])                       # [3, n]
    offsets = torch.arange(F, device=binned.device) * num_bins
    idx = (binned.long() + offsets).reshape(-1)                 # [n * F]
    if grad.is_cuda:
        # a bin sums at most n rows: the words of the [n, 3] values, each
        # row's repeated for its F features
        words, s1, s2 = fixed_point_words(vals.t())
        acc = torch.zeros((F * num_bins, 6), dtype=torch.int64,
                          device=grad.device)
        acc.index_add_(0, idx, words[:, None, :].expand(n, F, 6)
                       .reshape(-1, 6))
        out = from_fixed_point_words(acc, s1, s2).to(dt)
        out = out.t().reshape(3, F, num_bins)
        return out[0], out[1], out[2]
    out = torch.zeros((3, F * num_bins), dtype=dt, device=grad.device)
    out.index_add_(1, idx, vals[:, :, None].expand(3, n, F).reshape(3, -1))
    out = out.view(3, F, num_bins)
    return out[0], out[1], out[2]


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float64, exact, for integer ``e`` in [-1022, 1023]: the
    exponent bits set directly."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def fixed_point_words(vals):
    """``vals`` [N, C] as two 64-bit fixed-point words a value, for sums of
    at most N of them that integer addition makes order-free: the multiple
    of 2^-k (k per column from its max |v|, so that N max|v| 2^k < 2^62)
    and the remainder in units of 2^-(k + 61 - bits(N)). Returns (words
    [N, 2C] int64, s1 [C] = 2^k, s2); :func:`from_fixed_point_words` turns
    summed words back into float64 sums, exact to far below float64's
    rounding of them. All on the device of ``vals``, no host read."""
    N, C = vals.shape
    v = vals.to(torch.float64)
    top = v.abs().amax(dim=0) if N else v.new_zeros(C)
    _, e = torch.frexp(torch.clamp(top * max(N, 1), min=1e-290))
    s1 = _pow2(torch.clamp(62 - e, max=960))       # N max|v| s1 < 2^62
    s2 = 2.0 ** (61 - max(N, 1).bit_length())       # N / 2 s2 < 2^61
    hi = torch.round(v * s1)
    lo = torch.round((v * s1 - hi) * s2)
    return torch.cat([hi, lo], dim=1).to(torch.int64), s1, s2


def from_fixed_point_words(acc, s1, s2) -> torch.Tensor:
    """float64 sums [M, C] from summed words [M, 2C] of
    :func:`fixed_point_words`."""
    C = acc.shape[1] // 2
    return (acc[:, :C].to(torch.float64) / s1
            + acc[:, C:].to(torch.float64) / (s1 * s2))


def histogram(binned, grad, hess, row_mask, num_bins: int, binned_t=None,
              scales=None):
    """Per-feature histograms of gradient, hessian and count over the rows
    of a mask: ``hist[f, b] = sum over {i: row_mask[i], binned[i, f] == b}``
    of ``(grad[i], hess[i], 1)``.

    binned ``[n, F]`` integer bins in ``[0, num_bins)``; grad, hess ``[n]``;
    row_mask ``[n]`` bool. Returns (hist_g, hist_h, hist_c), each
    ``[F, num_bins]``.

    CUDA tensors go through the hand-written kernel: float32 ``grad`` and
    ``hess``, ``num_bins <= 256``, and ``scales`` = (scale_g, scale_h), the
    fixed-point scales of :func:`fixed_point_scales` (a caller computes them
    once per tree, so that a call stays one stream operation), or the
    float32 CUDA tensor [2] of :func:`fixed_point_scales_device`, which the
    kernel reads from device memory (its values are not checked). ``binned_t``
    is the features-major ``[F, n]`` uint8 copy of ``binned`` that the
    kernel reads (``Dataset.binned_t``); without it the wrapper transposes
    ``binned`` on every call. CPU tensors go through :func:`histogram_plain`
    (``scales`` is not needed there).

    Shapes, dtypes, devices and contiguity are checked before the launch;
    the VALUES of the bins are not (that would cost a synchronisation): a
    bin >= ``num_bins`` is dropped by the kernel. A scale too small for the
    values loses their low bits; one too large wraps the sums around.
    """
    if not grad.is_cuda:
        return histogram_plain(binned, grad, hess, row_mask, num_bins)
    device = grad.device
    if not isinstance(binned, torch.Tensor) or binned.dim() != 2:
        raise ValueError("binned: expected an integer tensor [n, F]")
    n, F = binned.shape
    if n < 1 or F < 1:
        raise ValueError(f"binned: shape {tuple(binned.shape)}, the kernel "
                         "takes at least one row and one feature")
    if not 1 <= int(num_bins) <= MAX_BINS:
        raise ValueError(f"num_bins: {num_bins}, the kernel takes "
                         f"1 <= num_bins <= {MAX_BINS}")
    dev_scales = isinstance(scales, torch.Tensor)
    if dev_scales:
        _build.check_tensor("scales", scales, torch.float32, (2,), device)
    elif scales is None or len(scales) != 2 or not all(
            s > 0 and math.frexp(s)[0] == 0.5 for s in scales):
        raise ValueError(f"scales: {scales!r}, the kernel takes two "
                         "positive powers of two (fixed_point_scales)")
    if binned_t is None:
        if binned.device != device:
            raise ValueError(f"binned: lies on {binned.device}, the kernel "
                             f"runs on {device}")
        binned_t = binned.t().contiguous().to(torch.uint8)
    _build.check_tensor("binned_t", binned_t, torch.uint8, (F, n), device)
    _build.check_tensor("grad", grad, torch.float32, (n,), device)
    _build.check_tensor("hess", hess, torch.float32, (n,), device)
    _build.check_tensor("row_mask", row_mask, torch.bool, (n,), device)
    out = torch.empty((3, F, int(num_bins)), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        if dev_scales:
            err = _lib().histogram_launch_dev_scales(
                binned_t.data_ptr(), grad.data_ptr(), hess.data_ptr(),
                row_mask.data_ptr(), out.data_ptr(), n, F, int(num_bins),
                scales.data_ptr(), _build.current_stream())
        else:
            err = _lib().histogram_launch(
                binned_t.data_ptr(), grad.data_ptr(), hess.data_ptr(),
                row_mask.data_ptr(), out.data_ptr(), n, F, int(num_bins),
                float(scales[0]), float(scales[1]), _build.current_stream())
    _build.raise_on_error(err, "histogram")
    histogram.launches += 1
    return out[0], out[1], out[2]


histogram.launches = 0


def empty_launch() -> None:
    """Launch one empty kernel on the current stream: the floor under the
    time of any launch, to be timed beside :func:`histogram`. Not counted."""
    with torch.cuda.device(torch.cuda.current_device()):
        err = _lib().histogram_empty_launch(_build.current_stream())
    _build.raise_on_error(err, "empty launch")
