"""The ``min_data_per_group`` group scan of the categorical split scan:
hand-written CUDA for Hopper + plain version.

:func:`group_boundaries` replaces the sequential scan of the JAX package's
categorical split search (``gpboost_tpu/boosting/tree.py:328``, a
``jax.lax.scan`` over the bins; the reference's ``feature_histogram.hpp``
``cnt_cur_group``). It has no Pallas kernel. For each row of ``counts`` and
``ok`` ``[D, B]`` it walks the bins in order and marks a position as a
boundary once ``min_data_per_group`` rows have accrued since the last one
(where ``ok`` allows it); the carry then resets.

The CUDA kernel (``csrc/cat_group_scan.cu``, ``sm_90a``, built by
``ops/kernels/_build.py`` at first use) runs one thread a row, sequential
over the at most 256 bins, on the current stream, so that the fixed-shape
grower's CUDA graph captures it: one launch where a host read and a numpy
loop used to be. Its bound is its bytes (the counts, ``ok`` and the output,
each touched once), far below a launch's latency at the grower's shapes
(D = twice the categorical features).

The carry is float64 in both versions whatever the counts' dtype (float32
or float64): counts are integers, so every partial sum is exact and the
kernel, :func:`group_boundaries_plain` and the host numpy scan it replaces
give the same bits. The wrapper takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
``group_boundaries.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpboost_tpu_torch.ops.kernels import _build

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its argument types set."""
    global _LIB
    if _LIB is None:
        lib = _build.load("cat_group_scan")
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.cat_group_scan_f32, lib.cat_group_scan_f64):
            fn.argtypes = [vp, vp, vp, ci, ci, cd, vp]
            fn.restype = ci
        _LIB = lib
    return _LIB


def group_boundaries_plain(counts: torch.Tensor, ok: torch.Tensor,
                           min_data_per_group: float) -> torch.Tensor:
    """Plain version of :func:`group_boundaries`: a loop over the bins of
    tensor operations on all the rows at once (float64 carry), on any
    device, with no read into Python. Returns bool ``[D, B]``."""
    carry = torch.zeros(counts.shape[0], dtype=torch.float64,
                        device=counts.device)
    zero = torch.zeros((), dtype=torch.float64, device=counts.device)
    cols = []
    for b in range(counts.shape[1]):
        cur = carry + counts[:, b].to(torch.float64)
        bound = ok[:, b] & (cur >= min_data_per_group)
        cols.append(bound)
        carry = torch.where(bound, zero, cur)
    return torch.stack(cols, dim=1)


def group_boundaries(counts: torch.Tensor, ok: torch.Tensor,
                     min_data_per_group: float) -> torch.Tensor:
    """The group boundaries of ``counts`` (float32 or float64 ``[D, B]``)
    under ``ok`` (bool ``[D, B]``): bool ``[D, B]``, True where
    ``min_data_per_group`` rows have accrued since the last boundary and
    ``ok`` holds. CUDA tensors launch the kernel (contiguous, one device;
    raises otherwise); CPU tensors run :func:`group_boundaries_plain`."""
    if not counts.is_cuda:
        return group_boundaries_plain(counts, ok, min_data_per_group)
    device = counts.device
    if counts.dim() != 2:
        raise ValueError(f"counts: shape {tuple(counts.shape)}, expected "
                         "[D, B]")
    D, B = counts.shape
    if D < 1 or B < 1:
        raise ValueError(f"counts: shape {(D, B)}, the kernel takes at "
                         "least one row and one bin")
    if counts.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"counts: dtype {counts.dtype}, the kernel takes "
                         "float32 or float64")
    counts, ok = counts.contiguous(), ok.contiguous()
    _build.check_tensor("counts", counts, counts.dtype, (D, B), device)
    _build.check_tensor("ok", ok, torch.bool, (D, B), device)
    out = torch.empty((D, B), dtype=torch.uint8, device=device)
    fn = (_lib().cat_group_scan_f32 if counts.dtype == torch.float32
          else _lib().cat_group_scan_f64)
    with torch.cuda.device(device):
        err = fn(counts.data_ptr(), ok.data_ptr(), out.data_ptr(), D, B,
                 float(min_data_per_group), _build.current_stream())
    _build.raise_on_error(err, "cat_group_scan")
    group_boundaries.launches += 1
    return out.view(torch.bool)


group_boundaries.launches = 0
