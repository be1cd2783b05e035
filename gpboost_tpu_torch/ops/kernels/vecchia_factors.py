"""Fused Vecchia factor kernels: hand-written CUDA for Hopper + plain versions.

Two kernels, both in ``csrc/vecchia_factors.cu`` (CUDA C++, ``sm_90a``, built
by ``ops/kernels/_build.py`` at first use):

- :func:`vecchia_factors` replaces the TPU kernel
  ``gpboost_tpu/ops/kernels/vecchia_factors.py::vecchia_factors_pallas``:
  (A [n, m], D [n]) of the Vecchia approximation, forward only.
- :func:`vecchia_nll_grad` replaces
  ``gpboost_tpu/ops/kernels/vecchia_factors.py::vecchia_nll_grad_pallas``:
  the Gaussian Vecchia NLL and its gradient w.r.t. the log covariance
  parameters in one pass. The TPU kernel traced reverse-mode AD inside its
  body; the CUDA kernel carries the gradient derived by hand (formulas in the
  header of the ``.cu`` file).

A row reads (m + d + 1) and writes (m + 1) floats but costs ~m^3/3 FLOPs of
Cholesky and m(m+1)/2 exp/sqrt, so the per-row problem stays on the SM (no
intermediate in device memory): both kernels are bound by operations, and in
practice by the latency of a row's dependent chain. Both keep every per-row
array in dynamic shared memory, element-major, and give a row 128 / R threads
(lanes), R rows a block, with R chosen from (m, d) at launch: the lanes split
the gather, the fill and the rows of each column of the Cholesky. The factors
kernel then solves on one lane and the block stores its R rows of A together
(coalesced); the NLL kernel solves on two lanes and splits its gradient walk.
The geometry is exported by the ``.cu`` file (:func:`factors_launch_geometry`
reads it; :func:`nll_launch_geometry` mirrors the NLL kernel's, whose scratch
tensor has one row per block, and is checked equal when the library loads).

Beside each kernel stands its plain PyTorch version
(:func:`vecchia_factors_plain`, :func:`vecchia_nll_grad_plain`); a wrapper
takes it only for tensors that lie on the CPU. For CUDA tensors the wrapper
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute.

Supports isotropic exponential / Matern 1.5, 2.5 / gaussian covariances and
their ARD forms; f32 in/out.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch.ops import vecchia as vops
from gpboost_tpu_torch.ops.cov_fns import CovFunction, _matern_mult_const
from gpboost_tpu_torch.ops.kernels import _build
from gpboost_tpu_torch.ops.kernels._build import check_tensor as _check
from gpboost_tpu_torch.ops.kernels._build import current_stream as _stream
from gpboost_tpu_torch.ops.kernels._build import raise_on_error as _raise_on

_SUPPORTED_SHAPES = (0.5, 1.5, 2.5, -1.0)  # -1.0 = gaussian (sq-exp)
MAX_M = 64   # VF_MAX_M of the .cu file (the packed triangle's capacity)
MAX_D = 8    # VF_MAX_D
SMEM_BUDGET = 76 * 1024       # VF_SMEM_BUDGET: bytes a block of 32 or 16
                              # rows of either kernel may take
SMEM_PER_BLOCK_MAX = 232_448  # the most shared memory a block of sm_90 has
BLOCK_THREADS = 128           # VF_BLOCK_THREADS: threads a block of either
                              # kernel, R rows x lanes
NLL_PARTS = 7 + 4 * MAX_D     # VF_NLL_PARTS: partial sums a lane hands on


def _shape_code(shape: float) -> int:
    for code, s in enumerate(_SUPPORTED_SHAPES):
        if abs(shape - s) < 1e-10:
            return code
    raise ValueError(f"shape: unsupported shape {shape} (supported: "
                     f"{_SUPPORTED_SHAPES}, -1.0 = gaussian)")


def nll_launch_geometry(m: int, d: int) -> tuple:
    """(rows per block, dynamic shared memory bytes per block) of the NLL
    kernel for ``m`` neighbours in ``d`` dimensions: the Python mirror of
    ``vf_nll_rows_per_block`` / ``vf_nll_smem_bytes`` of the ``.cu`` file.

    A block has ``BLOCK_THREADS`` threads: R rows of ``BLOCK_THREADS // R``
    lanes. A row keeps its packed triangle (whose room must also take the
    lanes' ``NLL_PARTS`` partial sums each), neighbour coordinates, a and u
    in shared memory; the block takes the largest R in {32, 16} whose rows
    fit ``SMEM_BUDGET``, else 8."""
    def block_bytes(rows):
        lanes = BLOCK_THREADS // rows
        tri_room = max(m * (m + 1) // 2, lanes * NLL_PARTS)
        return 4 * rows * (tri_room + m * d + 2 * m)

    rows = 32
    while rows > 8 and block_bytes(rows) > SMEM_BUDGET:
        rows //= 2
    return rows, block_bytes(rows)


def factors_launch_geometry(m: int, d: int) -> tuple:
    """(rows per block, dynamic shared memory bytes per block) of the factors
    kernel for ``m`` neighbours in ``d`` dimensions, as the ``.cu`` file
    exports them (``vf_factors_rows_per_block`` / ``vf_factors_smem_bytes``;
    needs the built library). A row keeps its packed triangle, neighbour
    coordinates, c and a in shared memory."""
    lib = _lib()
    return lib.vf_factors_rows_per_block(m, d), lib.vf_factors_smem_bytes(m, d)


def nll_blocks(n: int, rows_per_block: int) -> int:
    """Blocks of the NLL kernel for n rows = rows of its scratch tensor."""
    return -(-n // rows_per_block)


def _cov_fn(shape: float, ard: bool, dim: int) -> CovFunction:
    _shape_code(shape)
    if shape == -1.0:
        return CovFunction.create("gaussian_ard" if ard else "gaussian",
                                  dim_coords=dim)
    return CovFunction.create("matern_ard" if ard else "matern", shape=shape,
                              dim_coords=dim)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def vecchia_factors_plain(cov_pars, coords, neighbors, nugget,
                          include_nugget: bool, shape: float,
                          ard: bool = False, row_coords=None):
    """Plain version of :func:`vecchia_factors`: the batched
    ``ops.vecchia.build_factors`` (``torch.linalg.cholesky``); any dtype,
    differentiable."""
    cov_fn = _cov_fn(shape, ard, coords.shape[1])
    return vops.build_factors(cov_fn, cov_pars, coords, neighbors, nugget,
                              include_nugget, row_coords=row_coords)


def _nll_from_log_pars(log_cov_pars, coords, neighbors, r, shape, ard,
                       row_r, row_valid, row_coords, include_const):
    cp = torch.exp(log_cov_pars)
    a, d = vecchia_factors_plain(cp[1:], coords, neighbors, cp[0], True,
                                 shape, ard=ard, row_coords=row_coords)
    idx = torch.clamp(neighbors, min=0).long()
    rnb = torch.where(neighbors >= 0, r[idx], 0.0)
    br = (r if row_r is None else row_r) - torch.sum(a * rnb, dim=1)
    per_row = torch.log(d) + br * br / d
    if row_valid is not None:
        per_row = per_row * row_valid
    nll = 0.5 * torch.sum(per_row)
    if include_const:
        nll = nll + 0.5 * neighbors.shape[0] * vops.LOG_2PI
    return nll


def vecchia_nll_grad_plain(log_cov_pars, coords, neighbors, r, shape: float,
                           ard: bool = False, row_r=None, row_valid=None,
                           row_coords=None, include_const: bool = True):
    """Plain version of :func:`vecchia_nll_grad`: ``torch.autograd`` of the
    Vecchia NLL of the plain factors at ``exp(log_cov_pars)``; any dtype."""
    lp = log_cov_pars.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        nll = _nll_from_log_pars(lp, coords, neighbors, r, shape, ard, row_r,
                                 row_valid, row_coords, include_const)
        (grad,) = ag.grad(nll, lp)
    return nll.detach(), grad


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its argument types set (``c_void_p`` for
    every pointer and the stream: ctypes would cut them to 32 bits)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("vecchia_factors")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.vecchia_factors_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.vecchia_factors_launch.restype = ci
        lib.vecchia_nll_grad_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.vecchia_nll_grad_launch.restype = ci
        for fn in (lib.vf_max_m, lib.vf_max_d):
            fn.argtypes = []
            fn.restype = ci
        for fn in (lib.vf_nll_rows_per_block, lib.vf_nll_smem_bytes,
                   lib.vf_factors_rows_per_block, lib.vf_factors_smem_bytes):
            fn.argtypes = [ci, ci]
            fn.restype = ci
        built = (lib.vf_max_m(), lib.vf_max_d())
        if built != (MAX_M, MAX_D):
            raise RuntimeError(
                f"csrc/vecchia_factors.cu was built with (max m, max d) = "
                f"{built}; this module expects {(MAX_M, MAX_D)}")
        for m in range(1, MAX_M + 1):
            for d in range(1, MAX_D + 1):
                got = (lib.vf_nll_rows_per_block(m, d),
                       lib.vf_nll_smem_bytes(m, d))
                if got != nll_launch_geometry(m, d):
                    raise RuntimeError(
                        f"csrc/vecchia_factors.cu launches the NLL kernel at "
                        f"m = {m}, d = {d} with (rows, shared bytes) = {got}; "
                        f"nll_launch_geometry says "
                        f"{nll_launch_geometry(m, d)}")
                rows, nbytes = (lib.vf_factors_rows_per_block(m, d),
                                lib.vf_factors_smem_bytes(m, d))
                if rows not in (8, 16, 32) or not (
                        0 < nbytes <= SMEM_PER_BLOCK_MAX
                        and (rows == 8 or nbytes <= SMEM_BUDGET)):
                    raise RuntimeError(
                        f"csrc/vecchia_factors.cu launches the factors kernel "
                        f"at m = {m}, d = {d} with {rows} rows and {nbytes} "
                        f"bytes of shared memory a block")
        _LIB = lib
    return _LIB


def _check_problem(coords, neighbors, row_coords):
    """Checks shared by both kernels; returns (n, m, n_obs, d, device)."""
    if not isinstance(neighbors, torch.Tensor) or neighbors.dim() != 2:
        raise ValueError("neighbors: expected an int32 tensor [n, m]")
    if not isinstance(coords, torch.Tensor) or coords.dim() != 2:
        raise ValueError("coords: expected a float32 tensor [n_obs, d]")
    n, m = neighbors.shape
    n_obs, d = coords.shape
    device = coords.device
    if not 1 <= m <= MAX_M:
        raise ValueError(f"neighbors: m = {m} neighbours per row, the kernel "
                         f"takes 1 <= m <= {MAX_M}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"coords: d = {d} coordinate dimensions, the kernel "
                         f"takes 1 <= d <= {MAX_D}")
    _check("coords", coords, torch.float32, (n_obs, d), device)
    _check("neighbors", neighbors, torch.int32, (n, m), device)
    _check("row_coords", row_coords, torch.float32, (n, d), device)
    return n, m, n_obs, d, device


def vecchia_factors(cov_pars, coords, neighbors, nugget,
                    include_nugget: bool, shape: float, ard: bool = False,
                    row_coords=None):
    """Fused (A [n, m], D [n]) Vecchia factor build; cov_pars = [var, range]
    (isotropic) or [var, rho_1..rho_d] (``ard=True``); ``nugget`` a scalar
    tensor or None.

    ``row_coords`` (default = ``coords``): coordinates of the rows the
    ``neighbors`` matrix refers to — pass the PREDICTION points with the
    observed-coordinate gather table for prediction factor builds.

    CUDA tensors: f32 in/out through the hand-written kernel, forward only
    (gradients come from :func:`vecchia_nll_grad` or the plain version).
    CPU tensors: the plain version.

    Shapes, dtypes, devices and contiguity are checked before the launch.
    The VALUES of ``neighbors`` are not (that would cost a device
    synchronisation per call): every entry must be -1 or a row index of
    ``coords``, as ``ops.vecchia.find_neighbors`` produces them.
    """
    if row_coords is None:
        row_coords = coords
    code = _shape_code(shape)
    if not coords.is_cuda:
        return vecchia_factors_plain(cov_pars, coords, neighbors, nugget,
                                     include_nugget, shape, ard=ard,
                                     row_coords=row_coords)
    n, m, _, d, device = _check_problem(coords, neighbors, row_coords)
    n_ranges = d if ard else 1
    _check("cov_pars", cov_pars, torch.float32, (1 + n_ranges,), device)
    if nugget is None:
        nugget = cov_pars.new_zeros(())
    _check("nugget", nugget, torch.float32, (), device)
    scales = (_matern_mult_const(shape) if code != 3 else 1.0) / cov_pars[1:]
    if not ard:
        scales = scales.expand(d)
    pars = torch.cat([cov_pars[:1], nugget[None], scales]).contiguous()
    a = torch.empty((n, m), dtype=torch.float32, device=device)
    d_cond = torch.empty((n,), dtype=torch.float32, device=device)
    # the launch is asynchronous; temporaries such as ``pars`` may be freed
    # on return because the caching allocator hands their memory out again
    # only to work queued behind the kernel on this same stream
    with torch.cuda.device(device):
        err = _lib().vecchia_factors_launch(
            pars.data_ptr(), coords.data_ptr(), neighbors.data_ptr(),
            row_coords.data_ptr(), a.data_ptr(), d_cond.data_ptr(), n, m, d,
            code, int(bool(include_nugget)), _stream())
    _raise_on(err, "vecchia_factors")
    vecchia_factors.launches += 1
    return a, d_cond


vecchia_factors.launches = 0


def vecchia_nll_grad(log_cov_pars, coords, neighbors, r, shape: float,
                     ard: bool = False, row_r=None, row_valid=None,
                     row_coords=None, include_const: bool = True):
    """Fused Gaussian Vecchia (NLL, dNLL/dlog cov_pars) in one kernel pass.

    log_cov_pars = log([nugget, gp_var, range]) (isotropic) or
    log([nugget, gp_var, rho_1..rho_d]) (``ard=True``); r = centered
    residual [n_obs] (order of ``coords``/``neighbors``). Returns
    (nll, grad [2 + n_ranges]) as f32 tensors on the inputs' device; nothing
    is read back to the host.

    Row shards: ``neighbors`` may be a LOCAL row shard whose indices point
    into the full ``coords``/``r`` tables; pass the local rows' coordinates
    as ``row_coords`` [n_rows, d], their residual as ``row_r`` [n_rows],
    their 0/1 validity as ``row_valid`` (padding rows), and
    ``include_const=False`` so the caller adds the 0.5 * n_total * log(2 pi)
    constant once after the reduction across shards.

    CUDA tensors go through the hand-written kernel; CPU tensors through
    the plain version. As for :func:`vecchia_factors`, the values of
    ``neighbors`` are the caller's to keep inside ``[-1, n_obs)``.
    """
    if row_coords is None:
        row_coords = coords
    code = _shape_code(shape)
    if not coords.is_cuda:
        return vecchia_nll_grad_plain(
            log_cov_pars, coords, neighbors, r, shape, ard=ard, row_r=row_r,
            row_valid=row_valid, row_coords=row_coords,
            include_const=include_const)
    n, m, n_obs, d, device = _check_problem(coords, neighbors, row_coords)
    p = 2 + (d if ard else 1)
    _check("log_cov_pars", log_cov_pars, torch.float32, (p,), device)
    _check("r", r, torch.float32, (n_obs,), device)
    if row_r is None:
        if n != n_obs:
            raise ValueError(
                f"row_r: required when neighbors has {n} rows but r has "
                f"{n_obs} entries")
        row_r = r
    _check("row_r", row_r, torch.float32, (n,), device)
    if row_valid is not None:
        _check("row_valid", row_valid, torch.float32, (n,), device)
    lib = _lib()
    # one row of per-block sums for each block the kernel launches with
    blocks = nll_blocks(n, lib.vf_nll_rows_per_block(m, d))
    scratch = torch.empty((blocks, 1 + p), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.vecchia_nll_grad_launch(
            log_cov_pars.data_ptr(), coords.data_ptr(), neighbors.data_ptr(),
            row_coords.data_ptr(), r.data_ptr(), row_r.data_ptr(),
            None if row_valid is None else row_valid.data_ptr(),
            scratch.data_ptr(), n, m, d, code, int(bool(ard)), _stream())
    _raise_on(err, "vecchia_nll_grad")
    vecchia_nll_grad.launches += 1
    # deterministic second pass of the reduction: per-block partial sums,
    # added in float64
    tot = scratch.sum(0, dtype=torch.float64)
    nll = tot[0]
    if include_const:
        nll = nll + 0.5 * n * math.log(2.0 * math.pi)
    return nll.to(torch.float32), tot[1:].to(torch.float32)


vecchia_nll_grad.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {"vecchia_factors": vecchia_factors.launches,
            "vecchia_nll_grad": vecchia_nll_grad.launches}


def reset_launch_counts() -> None:
    vecchia_factors.launches = 0
    vecchia_nll_grad.launches = 0
