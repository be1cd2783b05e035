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
distributed shared memory in a fixed order and write the result whole (no
memset, no global atomics, no conversion kernel). Its bound is bytes (one
byte per row and feature, nine per row for gradient, hessian and mask), far
less at n = 1e5 than what it takes: the shared float atomics (a
compare-and-swap loop on this card) and the clustered launch. Counts are
accumulated as integers and are exact, the float sums depend on the order of
the shared atomics in their last bits. There is no cap on the number of
rows.

Beside it stands :func:`histogram_plain` (``index_add_``), the twin of the
JAX package's ``tree._build_histogram_xla``. The wrapper takes it only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. ``histogram.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpboost_tpu_torch.ops.kernels import _build

MAX_BINS = 256       # HIST_MAX_BINS of the .cu file (uint8 bins)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its argument types set."""
    global _LIB
    if _LIB is None:
        lib = _build.load("histogram")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.histogram_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.histogram_launch.restype = ci
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


def histogram_plain(binned, grad, hess, row_mask, num_bins: int):
    """Plain version of :func:`histogram`: one ``index_add_`` over the
    flattened ``feature * num_bins + bin`` index. Any device, any float
    dtype; returns (hist_g, hist_h, hist_c), each ``[F, num_bins]`` in the
    dtype of ``grad``. On the CPU rows are added in increasing order."""
    n, F = binned.shape
    dt = grad.dtype
    zero = torch.zeros((), dtype=dt, device=grad.device)
    vals = torch.stack([torch.where(row_mask, grad, zero),
                        torch.where(row_mask, hess, zero),
                        row_mask.to(dt)])                       # [3, n]
    offsets = torch.arange(F, device=binned.device) * num_bins
    idx = (binned.long() + offsets).reshape(-1)                 # [n * F]
    out = torch.zeros((3, F * num_bins), dtype=dt, device=grad.device)
    out.index_add_(1, idx, vals[:, :, None].expand(3, n, F).reshape(3, -1))
    out = out.view(3, F, num_bins)
    return out[0], out[1], out[2]


def histogram(binned, grad, hess, row_mask, num_bins: int, binned_t=None):
    """Per-feature histograms of gradient, hessian and count over the rows
    of a mask: ``hist[f, b] = sum over {i: row_mask[i], binned[i, f] == b}``
    of ``(grad[i], hess[i], 1)``.

    binned ``[n, F]`` integer bins in ``[0, num_bins)``; grad, hess ``[n]``;
    row_mask ``[n]`` bool. Returns (hist_g, hist_h, hist_c), each
    ``[F, num_bins]``.

    CUDA tensors go through the hand-written kernel: float32 ``grad`` and
    ``hess``, ``num_bins <= 256``. ``binned_t`` is the features-major
    ``[F, n]`` uint8 copy of ``binned`` that the kernel reads
    (``Dataset.binned_t``); without it the wrapper transposes ``binned`` on
    every call. CPU tensors go through :func:`histogram_plain`.

    Shapes, dtypes, devices and contiguity are checked before the launch;
    the VALUES of the bins are not (that would cost a synchronisation): a
    bin >= ``num_bins`` is dropped by the kernel.
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
        err = _lib().histogram_launch(
            binned_t.data_ptr(), grad.data_ptr(), hess.data_ptr(),
            row_mask.data_ptr(), out.data_ptr(), n, F, int(num_bins),
            _build.current_stream())
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
