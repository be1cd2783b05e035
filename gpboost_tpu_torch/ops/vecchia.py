"""Vecchia approximation: neighbor search + sparse factor construction.

Batched redesign of the reference's Vecchia machinery
(``src/GPBoost/Vecchia_utils.cpp``): instead of CoverTrees and per-row Eigen
solves, everything is dense-blocked and batched —

- neighbor search (:697 ``find_nearest_neighbors_Vecchia``) is a blocked
  brute-force distance + ``torch.topk`` sweep; the [n, m] neighbor-index
  matrix IS the sparsity structure.
- factor construction ``B = I - A``, ``D`` (:1307
  ``CalcCovFactorGradientVecchia``) is one batched [n, m, m] Cholesky solve;
  covariance-parameter gradients come from ``torch.autograd`` through the
  whole build.
- predictions (:1634 ``CalcPredVecchiaObservedFirstOrder`` with
  ``order_obs_first_cond_obs_only``) are batched local kriging on the
  prediction points' observed neighbors.

For Gaussian likelihood the approximation is applied to the *response*
covariance (nugget on the diagonal) — with num_neighbors = n-1 it reproduces
the exact NLL (R test ``test_GPModel_gaussian_process.R:702-716``).

The functions here are also the plain PyTorch versions that the hand-written
CUDA kernels of ``ops/kernels/vecchia_factors.py`` are held against.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.ops.cov_fns import CovFunction

LOG_2PI = math.log(2.0 * math.pi)


def _safe_dist(sq: torch.Tensor) -> torch.Tensor:
    """sqrt with zero (not inf) gradient at 0 — required when distances are
    differentiated through parameter-scaled coordinates (ARD kernels) and
    i == j entries are exactly 0 (double-where trick)."""
    sq = torch.clamp(sq, min=0.0)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def apply_ordering(n: int, ordering: str, seed: int = 0,
                   time_col: Optional[np.ndarray] = None) -> np.ndarray:
    """Permutation used before neighbor search (``docs/Main_parameters.rst:184``:
    none / random / time / time_random_space). ``time`` stable-sorts by the
    first (time) coordinate; ``time_random_space`` shuffles first so spatial
    points at equal times land in random order (``Vecchia_utils.cpp:1094-1120``:
    shuffle then stable sort by coordinate 0)."""
    if ordering in ("none", None):
        return np.arange(n)
    if ordering == "random":
        rng = np.random.default_rng(seed)
        return rng.permutation(n)
    if ordering in ("time", "time_random_space") and time_col is None:
        raise ValueError(f"vecchia_ordering '{ordering}' needs 'time_col'")
    if ordering == "time":
        return np.argsort(time_col, kind="stable")
    if ordering == "time_random_space":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        return perm[np.argsort(np.asarray(time_col)[perm], kind="stable")]
    raise ValueError(f"vecchia_ordering '{ordering}' not supported")


def _sq_dists(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Squared distances [r, c] summed dimension by dimension from the
    coordinate differences: no ``|x|^2 + |y|^2 - 2 x.y`` cancellation, so
    float32 selects the same neighbors as float64 would."""
    d2 = None
    for k in range(rows.shape[1]):
        dk = rows[:, k, None] - cols[None, :, k]
        d2 = dk * dk if d2 is None else d2 + dk * dk
    return d2


def _nearest(d2: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` smallest finite entries per row, nearest first;
    -1 where fewer than ``m`` candidates are finite."""
    if d2.shape[1] < m:
        pad = d2.new_full((d2.shape[0], m - d2.shape[1]), math.inf)
        d2 = torch.cat([d2, pad], dim=1)
    vals, idx = torch.topk(d2, m, dim=1, largest=False, sorted=True)
    return torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)


def find_neighbors(coords: torch.Tensor, num_neighbors: int,
                   chunk: int = 1024) -> torch.Tensor:
    """Nearest ``m`` *previous* points for each row (data order = ordering).

    Returns [n, m] int32; entry -1 marks padding (i < m has only i neighbors).
    Blocked brute force: distances for a row chunk against the points before
    the chunk's end, mask j >= i, exact top-k — the dense answer to CoverTree
    kNN (``Vecchia_utils.cpp:93-168``).
    """
    n = coords.shape[0]
    out = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        d2 = _sq_dists(coords[start:end], coords[:end])
        row_ids = torch.arange(start, end, device=coords.device)[:, None]
        col_ids = torch.arange(end, device=coords.device)[None, :]
        d2 = torch.where(col_ids < row_ids, d2, math.inf)
        out.append(_nearest(d2, num_neighbors))
    return torch.cat(out, dim=0)


def find_neighbors_cross(coords_pred: torch.Tensor, coords_obs: torch.Tensor,
                         num_neighbors: int, chunk: int = 1024
                         ) -> torch.Tensor:
    """Nearest observed points for each prediction point. [n_p, m] int32
    with m = min(num_neighbors, n_obs)."""
    m = min(num_neighbors, coords_obs.shape[0])
    out = []
    for start in range(0, coords_pred.shape[0], chunk):
        d2 = _sq_dists(coords_pred[start:start + chunk], coords_obs)
        out.append(_nearest(d2, m))
    return torch.cat(out, dim=0)


def build_factors(cov_fn: CovFunction, cov_pars: torch.Tensor,
                  coords: torch.Tensor, neighbors: torch.Tensor,
                  nugget: Optional[torch.Tensor], include_nugget: bool,
                  row_coords: Optional[torch.Tensor] = None):
    """Batched Vecchia factors.

    A [n, m]: conditioning weights; D [n]: conditional variances, for the
    covariance ``pars[0]*corr(dist) (+ nugget I if include_nugget)``.
    B = I - scatter(A); Sigma^-1 ~ B' D^-1 B.

    ``row_coords`` (default = coords) are the coordinates of the rows the
    ``neighbors`` matrix refers to — pass the prediction points with the
    observed-coordinate gather table for prediction factor builds, or a
    shard of rows with the full ``coords`` table.
    """
    if row_coords is None:
        row_coords = coords
    scaled = not cov_fn.is_isotropic and cov_fn.has_coord_scaling
    if scaled:
        # ARD: isotropic with unit range in scaled coordinates
        coords = cov_fn.scale_coords(coords, cov_pars)
        row_coords = cov_fn.scale_coords(row_coords, cov_pars)
    n, m = neighbors.shape
    mask = neighbors >= 0
    idx = torch.clamp(neighbors, min=0).long()
    nb_coords = coords[idx]                                        # [n, m, d]
    diffs = nb_coords[:, :, None, :] - nb_coords[:, None, :, :]
    d_nn = _safe_dist(torch.sum(diffs * diffs, -1))                # [n, m, m]
    di = row_coords[:, None, :] - nb_coords
    d_in = _safe_dist(torch.sum(di * di, -1))                      # [n, m]
    if scaled:
        c_nn = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_nn, cov_pars)
        c_in = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_in, cov_pars)
    else:
        c_nn = cov_fn.cov_matrix(cov_pars, dist=d_nn)
        c_in = cov_fn.cov_matrix(cov_pars, dist=d_in)
    var_ii = cov_pars[0] * torch.ones(n, dtype=row_coords.dtype,
                                      device=row_coords.device)
    eye = torch.eye(m, dtype=row_coords.dtype, device=row_coords.device)
    if include_nugget and nugget is not None:
        c_nn = c_nn + nugget * eye[None]
        var_ii = var_ii + nugget
    # mask padding: identity rows/cols so the solve yields 0 weights there
    pair_mask = mask[:, :, None] & mask[:, None, :]
    c_nn = torch.where(pair_mask, c_nn, eye[None])
    c_in = torch.where(mask, c_in, 0.0)

    # cholesky_ex does not raise on a block that is not positive definite
    # (parameters a line search overshot to): such rows get D = NaN, so the
    # NLL is NaN and the optimizer backs off, instead of an exception
    chol, info = torch.linalg.cholesky_ex(c_nn)
    a = torch.cholesky_solve(c_in[..., None], chol)[..., 0]
    a = torch.where(mask, a, 0.0)
    d_cond = var_ii - torch.sum(c_in * a, dim=1)
    d_cond = torch.where(info == 0, d_cond, math.nan)
    return a, d_cond


# entries of one [n, m, q] gather of a wide right-hand side (1.6 GB in
# float64): the residual factor build and a wide precision product take
# their columns in chunks of :func:`col_chunk` to stay below it
GATHER_BUDGET = 3 * 2 ** 26


def col_chunk(n: int, m: int) -> int:
    """Columns of an [n, q] right-hand side whose [n, m, q] gather fits
    ``GATHER_BUDGET``."""
    return max(1, GATHER_BUDGET // max(n * m, 1))


def incoming_pair_sums(W: torch.Tensor, neighbors: torch.Tensor,
                       slices: Optional["IncomingSlices"]) -> torch.Tensor:
    """sum_{(j, k): nb[j, k] = i} W[j, k] for every row i, W [n, m, q]:
    the transpose of the neighbour gather. With ``slices`` (CUDA) a gather
    over the incoming pairs and a row sum per slice, in a fixed order; on
    the CPU the plain ``index_add_`` (padding slots must hold zeros)."""
    n, m, q = W.shape
    if slices is None:
        idx = torch.clamp(neighbors, min=0).long().reshape(-1)
        return torch.zeros((n, q), dtype=W.dtype, device=W.device
                           ).index_add_(0, idx, W.reshape(n * m, q))
    if not len(slices):
        return torch.zeros((n, q), dtype=W.dtype, device=W.device)
    prod = torch.where(slices.valid[:, None], W.reshape(n * m, q)[slices.flat],
                       0.0)
    sums, at = [], 0
    for t, w in slices.shapes:
        sums.append(prod[at:at + t * w].view(t, w, q).sum(dim=1))
        at += t * w
    return torch.zeros((n, q), dtype=W.dtype, device=W.device).index_copy_(
        0, slices.targets, torch.cat(sums))


class _LowRankPairs(torch.autograd.Function):
    """(G [n, m, m], g [n, m]) with G_i = V_i V_i' and g_i = V_i p_i,
    V_i = P[nb_i] [m, k] the rows of P [n, k] at row i's neighbours: the
    low-rank part of the residual covariances of a full-scale Vecchia
    approximation. Built :func:`col_chunk` columns of P at a time (the
    [n, m, k] gather stays within ``GATHER_BUDGET``), the chunks added in a
    fixed order.

    Backward, with S_i = Gbar_i + Gbar_i': dV_i = S_i V_i + gbar_i p_i' and
    dP = V-gather transpose of dV plus sum_j gbar_ij V_ij — the transpose is
    :func:`incoming_pair_sums`, a gather with a fixed order on CUDA (the
    backward of ``P[nb]`` would be an accumulating scatter)."""

    @staticmethod
    def forward(ctx, P, neighbors, slices):
        idx = torch.clamp(neighbors, min=0).long()
        n, m = neighbors.shape
        G = torch.zeros((n, m, m), dtype=P.dtype, device=P.device)
        g = torch.zeros((n, m), dtype=P.dtype, device=P.device)
        step = col_chunk(n, m)
        for s in range(0, P.shape[1], step):
            Pc = P[:, s:s + step]
            Vc = Pc[idx]
            G = G + Vc @ Vc.mT
            g = g + (Vc @ Pc[:, :, None])[..., 0]
        ctx.save_for_backward(P)
        ctx.neighbors, ctx.slices = neighbors, slices
        return G, g

    @staticmethod
    def backward(ctx, Gbar, gbar):
        (P,) = ctx.saved_tensors
        nb, slices = ctx.neighbors, ctx.slices
        idx = torch.clamp(nb, min=0).long()
        S = Gbar + Gbar.mT
        gbar = torch.where(nb >= 0, gbar, 0.0)
        parts = []
        step = col_chunk(*nb.shape)
        for s in range(0, P.shape[1], step):
            Pc = P[:, s:s + step]
            Vc = Pc[idx]
            dV = S @ Vc + gbar[:, :, None] * Pc[:, None, :]
            dV = torch.where((nb >= 0)[:, :, None], dV, 0.0)
            parts.append(incoming_pair_sums(dV, nb, slices)
                         + (gbar[:, None, :] @ Vc)[:, 0, :])
        return torch.cat(parts, dim=1), None, None


def build_factors_residual(cov_fn: CovFunction, cov_pars: torch.Tensor,
                           coords: torch.Tensor, neighbors: torch.Tensor,
                           lr_rows: torch.Tensor,
                           nugget: Optional[torch.Tensor],
                           include_nugget: bool, slices=None):
    """Vecchia factors of the RESIDUAL process of a full-scale Vecchia
    approximation (the JAX package's ``build_factors_residual``): residual
    covariance r(s_i, s_j) = k(s_i, s_j) - p_i . p_j with p_i =
    ``lr_rows[i]`` = (L_mm^-1 K_m,i)' [n, k] (``re_model_template.h:
    4667-4771``). Returns (A, D): B = I - scatter(A), Lambda^-1 ~ B' D^-1 B
    for Vecchia(residual (+ nugget I with ``include_nugget``)). The
    low-rank products go through :class:`_LowRankPairs` (column chunks,
    gather-only backward with ``slices`` on CUDA)."""
    scaled = not cov_fn.is_isotropic and cov_fn.has_coord_scaling
    if scaled:
        coords = cov_fn.scale_coords(coords, cov_pars)
    n, m = neighbors.shape
    mask = neighbors >= 0
    idx = torch.clamp(neighbors, min=0).long()
    nb_coords = coords[idx]
    diffs = nb_coords[:, :, None, :] - nb_coords[:, None, :, :]
    d_nn = _safe_dist(torch.sum(diffs * diffs, -1))
    di = coords[:, None, :] - nb_coords
    d_in = _safe_dist(torch.sum(di * di, -1))
    if scaled:
        c_nn = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_nn, cov_pars)
        c_in = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_in, cov_pars)
    else:
        c_nn = cov_fn.cov_matrix(cov_pars, dist=d_nn)
        c_in = cov_fn.cov_matrix(cov_pars, dist=d_in)
    G, g = _LowRankPairs.apply(lr_rows, neighbors, slices)
    c_nn = c_nn - G
    c_in = c_in - g
    var_ii = cov_pars[0] - torch.sum(lr_rows * lr_rows, dim=1)
    eye = torch.eye(m, dtype=coords.dtype, device=coords.device)
    if include_nugget and nugget is not None:
        c_nn = c_nn + nugget * eye[None]
        var_ii = var_ii + nugget
    pair_mask = mask[:, :, None] & mask[:, None, :]
    c_nn = torch.where(pair_mask, c_nn, eye[None])
    c_in = torch.where(mask, c_in, 0.0)
    chol, info = torch.linalg.cholesky_ex(c_nn)
    a = torch.cholesky_solve(c_in[..., None], chol)[..., 0]
    a = torch.where(mask, a, 0.0)
    d_cond = var_ii - torch.sum(c_in * a, dim=1)
    d_cond = torch.where(info == 0, d_cond, math.nan)
    return a, torch.clamp(d_cond, min=1e-12)


def _cols(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` [n] broadcast against ``like`` [n] or [n, k]."""
    return x if like.dim() == 1 else x[:, None]


def apply_B(a: torch.Tensor, neighbors: torch.Tensor, v: torch.Tensor):
    """(B v)_i = v_i - sum_k A[i,k] v[nb[i,k]], for v [n] or [n, k] (a
    batched [1, m] x [m, k] product a row: one pass over the gathered
    rows; on the CPU one sparse product, :func:`_sparse_A`). ``a`` must be 0
    in the padding slots."""
    idx = torch.clamp(neighbors, min=0).long()
    if v.dim() == 1:
        return v - torch.sum(a * v[idx], dim=1)
    if not v.is_cuda:
        return v - torch.sparse.mm(_sparse_A(a, neighbors, v.shape[0]), v)
    return v - (a[:, None, :] @ v[idx])[:, 0, :]


def _sparse_A(a: torch.Tensor, neighbors: torch.Tensor, n: int,
              transpose: bool = False) -> torch.Tensor:
    """A (or A') [n, n] as a sparse COO matrix: A[i, nb[i, k]] = a[i, k]
    (each pair once, no duplicates)."""
    mask = neighbors >= 0
    rows = torch.arange(neighbors.shape[0], device=a.device)[:, None]
    rows, cols = rows.expand_as(neighbors)[mask], neighbors[mask].long()
    return torch.sparse_coo_tensor(
        torch.stack([cols, rows] if transpose else [rows, cols]), a[mask],
        (n, n), check_invariants=False)


def apply_Bt(a: torch.Tensor, neighbors: torch.Tensor, v: torch.Tensor):
    """(B' v)_i = v_i - sum_{j: i in nb(j)} A[j, pos] v_j (scatter-add), for
    v [n] or [n, k].

    The plain version: ``index_add_`` adds in row order on the CPU but with
    float atomics, in no fixed order, on CUDA — the CUDA route is
    :func:`apply_Bt_sliced`. Many columns on the CPU: one sparse product
    A' v (:func:`_sparse_A`; ``index_add_`` there adds row by row, ~10x
    slower)."""
    idx = torch.clamp(neighbors, min=0).long()
    if v.dim() == 1:
        contrib = torch.where(neighbors >= 0, a * v[:, None], 0.0)
        return v - torch.zeros_like(v).index_add_(
            0, idx.reshape(-1), contrib.reshape(-1))
    if not v.is_cuda:
        return v - torch.sparse.mm(
            _sparse_A(a, neighbors, v.shape[0], transpose=True), v)
    contrib = torch.where((neighbors >= 0)[:, :, None],
                          a[:, :, None] * v[:, None, :], 0.0)
    return v - torch.zeros_like(v).index_add_(
        0, idx.reshape(-1), contrib.reshape(-1, v.shape[1]))


def _incoming_csr(neighbors: torch.Tensor):
    """The neighbour structure transposed, in CSR form: for every target
    row i, the (source row j, slot k) pairs with ``neighbors[j, k] == i``,
    in increasing (j, k). Returns (flat [nnz] = j * m + k ordered by target,
    counts [n], starts [n]) on the device of ``neighbors``."""
    n, m = neighbors.shape
    tgt = neighbors.reshape(-1).long()
    flat = torch.nonzero(tgt >= 0).reshape(-1)        # increasing j * m + k
    tgt = tgt[flat]
    tgt, order = torch.sort(tgt, stable=True)
    flat = flat[order]
    counts = torch.bincount(tgt, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    return flat, counts, starts


def _incoming_rows(flat, counts, starts, targets, width: int, m: int):
    """(inc_row, inc_slot) [len(targets), width] of the given target rows,
    padded with -1 / 0 beyond each row's in-degree."""
    pos = torch.arange(width, device=flat.device)
    valid = pos[None, :] < counts[targets][:, None]
    at = torch.clamp(starts[targets][:, None] + pos[None, :], 0,
                     max(flat.numel() - 1, 0))
    src = flat[at] if flat.numel() else torch.zeros_like(at)
    inc_row = torch.where(valid, src // m, -1).to(torch.int32)
    inc_slot = torch.where(valid, src % m, 0).to(torch.int32)
    return inc_row, inc_slot


def build_incoming(neighbors: torch.Tensor):
    """Transpose the neighbour structure: for each row i, the (source row
    j, slot k) pairs with ``neighbors[j, k] == i`` in increasing j, padded
    to the maximum in-degree K with -1 (the JAX package's
    ``ops/vecchia.py::build_incoming``). Returns (inc_row [n, K],
    inc_slot [n, K]) int32 on the device of ``neighbors``.

    With a random ordering early rows are neighbours of ~ m ln(n / i)
    later rows, so K is many times the mean in-degree m: the model keeps
    the same pairs grouped by in-degree instead
    (:func:`build_incoming_sliced`)."""
    n, m = neighbors.shape
    flat, counts, starts = _incoming_csr(neighbors)
    K = max(int(counts.max()) if n else 0, 1)
    targets = torch.arange(n, device=neighbors.device)
    return _incoming_rows(flat, counts, starts, targets, K, m)


class IncomingSlices:
    """The pairs of :func:`build_incoming` grouped by in-degree, and the
    gather plan of :func:`apply_Bt_sliced`.

    Iterating yields the slices (targets [t], inc_row [t, w], inc_slot
    [t, w]), one per width w = min_width, 2 min_width, 4 min_width, ...
    (the last cut to the maximum in-degree K), holding the rows whose
    in-degree lies in (w / 2, w] (the first: [1, min_width]). Each slice's
    rows are the rows ``targets`` of :func:`build_incoming`'s arrays cut to
    width w, so the padding is at most about as large as the pairs, not
    K / m times it. Rows that no other row conditions on appear in no
    slice.

    The plan flattens all slices into one row of gathers: ``flat`` (j m + k
    into A), ``src`` (j into v) and ``valid`` over the slices' entries one
    after the other, and ``targets`` of all slices; ``shapes`` the (t, w)
    of each. It is what :func:`apply_Bt_sliced` runs."""

    def __init__(self, slices, m: int):
        self.slices = slices
        if slices:
            rows = torch.cat([r.reshape(-1) for _, r, _ in slices])
            slots = torch.cat([k.reshape(-1) for _, _, k in slices])
            self.valid = rows >= 0
            self.src = torch.clamp(rows, min=0).long()
            self.flat = torch.where(self.valid, self.src * m + slots.long(), 0)
            self.targets = torch.cat([t for t, _, _ in slices])
        self.shapes = [tuple(r.shape) for _, r, _ in slices]

    def __iter__(self):
        return iter(self.slices)

    def __len__(self):
        return len(self.slices)

    def nbytes(self) -> int:
        """Bytes of the gather plan the model keeps."""
        if not self.slices:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (self.valid, self.src, self.flat, self.targets))


def build_incoming_sliced(neighbors: torch.Tensor,
                          min_width: int = 8) -> IncomingSlices:
    """The pairs of :func:`build_incoming` grouped by in-degree
    (:class:`IncomingSlices`), built without the padded [n, K] arrays."""
    n, m = neighbors.shape
    flat, counts, starts = _incoming_csr(neighbors)
    slices = []
    lo, width = 0, int(min_width)
    max_deg = int(counts.max()) if n else 0
    while lo < max_deg:
        targets = torch.nonzero((counts > lo) & (counts <= width)).reshape(-1)
        if targets.numel():
            slices.append((targets,) + _incoming_rows(
                flat, counts, starts, targets, min(width, max_deg), m))
        lo, width = width, 2 * width
    return IncomingSlices(slices, m)


def _incoming_sums(a, inc_row, inc_slot, v):
    """sum_k A[inc_row[i, k], inc_slot[i, k]] v[inc_row[i, k]] per row i,
    padding excluded; a gather and a row sum, so the order of the terms is
    fixed."""
    src = torch.clamp(inc_row, min=0).long()
    coef = a[src, inc_slot.long()]
    return torch.sum(torch.where(inc_row >= 0, coef * v[src], 0.0), dim=1)


def apply_Bt_gather(a: torch.Tensor, inc_row: torch.Tensor,
                    inc_slot: torch.Tensor, v: torch.Tensor):
    """(B' v) through the padded incoming structure of
    :func:`build_incoming`: gathers only."""
    return v - _incoming_sums(a, inc_row, inc_slot, v)


def incoming_sums(coef: torch.Tensor, slices: IncomingSlices,
                  v: torch.Tensor) -> torch.Tensor:
    """sum_{(j, k): nb[j, k] = i} coef[j, k] v_j for every row i, for v [n]
    or [n, k], through the slices of :func:`build_incoming_sliced`: one
    gather over all slices' entries, a row sum per slice, one copy into
    place — every row's terms added in the same order on every call
    (bit-reproducible on CUDA, unlike a scatter)."""
    if not len(slices):
        return torch.zeros_like(v)
    c = torch.where(slices.valid, coef.reshape(-1)[slices.flat], 0.0)
    sums, at = [], 0
    for t, w in slices.shapes:
        src, cs = slices.src[at:at + t * w], c[at:at + t * w].view(t, w)
        if v.dim() == 1:
            sums.append(torch.sum(cs * v[src].view(t, w), dim=1))
        else:
            # a [1, w] x [w, k] product a target row
            sums.append((cs[:, None, :] @ v[src].view(t, w, -1))[:, 0, :])
        at += t * w
    return torch.zeros_like(v).index_copy_(0, slices.targets,
                                           torch.cat(sums))


def apply_Bt_sliced(a: torch.Tensor, slices: IncomingSlices,
                    v: torch.Tensor):
    """(B' v) through the slices of :func:`build_incoming_sliced`, for v [n]
    or [n, k]: gathers only, a fixed summation order
    (:func:`incoming_sums`)."""
    return v - incoming_sums(a, slices, v)


def precision_matvec(a, neighbors, d_cond, v):
    """(B' D^-1 B) v — matrix-free Vecchia precision product, O(n m), for v
    [n] or [n, k]; the plain version (scatter-add transpose)."""
    bv = apply_B(a, neighbors, v)
    return apply_Bt(a, neighbors, bv / _cols(d_cond, bv))


def precision_diag(a, neighbors, d_cond, slices=None):
    """diag(B' D^-1 B): 1/d_i + sum_{j: i in nb(j)} A[j, .]^2 / d_j (the
    JAX package's ``vecchia_model._precision_diag``). With ``slices`` the
    sum is the gather of :func:`incoming_sums`; without, the plain scatter."""
    if slices is not None:
        return 1.0 / d_cond + incoming_sums(a * a, slices, 1.0 / d_cond)
    idx = torch.clamp(neighbors, min=0).long()
    contrib = torch.where(neighbors >= 0, a * a / d_cond[:, None], 0.0)
    return 1.0 / d_cond + torch.zeros_like(d_cond).index_add_(
        0, idx.reshape(-1), contrib.reshape(-1))


class _PrecisionProduct(torch.autograd.Function):
    """Q(a, d) V = B' D^-1 B V with a backward made of gathers only.

    With s = B V, u = s / d and the output's cotangent G:
    grad u = B G; grad d_i = -sum_k (B G)_ik s_ik / d_i^2;
    grad V = B' (B G / d); grad a_ij = -sum_k u_ik G[nb_ij, k]
    - sum_k (B G / d)_ik V[nb_ij, k]. ``B'`` is the transpose ``bt``
    (the sliced gather on CUDA, the scatter on the CPU); nothing in the
    backward scatters, so with the gather transpose no ``index_add_`` with
    colliding indices runs, forward or backward."""

    @staticmethod
    def forward(ctx, a, d, V, neighbors, slices):
        # padding slots contribute nothing, whatever ``a`` holds there
        a = torch.where(neighbors >= 0, a, 0.0)
        s = apply_B(a, neighbors, V)
        u = s / _cols(d, s)
        out = _bt(a, neighbors, slices, u)
        ctx.save_for_backward(a, d, V, s)
        ctx.neighbors, ctx.slices = neighbors, slices
        return out

    @staticmethod
    def backward(ctx, G):
        a, d, V, s = ctx.saved_tensors
        nb, slices = ctx.neighbors, ctx.slices
        vec = V.dim() == 1
        if vec:
            G, V, s = G[:, None], V[:, None], s[:, None]
        G = G.contiguous()
        dc = d[:, None]
        BG = apply_B(a, nb, G)
        BGd = BG / dc
        grad_a = grad_d = grad_V = None
        if ctx.needs_input_grad[0]:
            idx = torch.clamp(nb, min=0).long()
            u = s / dc
            ga = -((G[idx] @ u[:, :, None])[..., 0]
                   + (V[idx] @ BGd[:, :, None])[..., 0])
            grad_a = torch.where(nb >= 0, ga, 0.0)
        if ctx.needs_input_grad[1]:
            grad_d = -torch.sum(BG * s, dim=1) / (d * d)
        if ctx.needs_input_grad[2]:
            grad_V = _bt(a, nb, slices, BGd)
            if vec:
                grad_V = grad_V[:, 0]
        return grad_a, grad_d, grad_V, None, None


def _bt(a, neighbors, slices, v):
    if slices is not None:
        return apply_Bt_sliced(a, slices, v)
    return apply_Bt(a, neighbors, v)


def precision_product(a: torch.Tensor, d_cond: torch.Tensor,
                      V: torch.Tensor, neighbors: torch.Tensor,
                      slices: Optional[IncomingSlices] = None,
                      col_chunk: Optional[int] = None):
    """Q V = B' D^-1 B V for V [n] or [n, k], differentiable in (a, d, V)
    with the gather-only backward of :class:`_PrecisionProduct`. ``slices``
    (:func:`build_incoming_sliced`) selects the gather transpose — the CUDA
    route; without them the plain scatter (the CPU route). ``col_chunk``
    bounds the [n, m, q] gathers of a wide V: its columns go through in
    chunks of that many."""
    if col_chunk is None or V.dim() == 1 or V.shape[1] <= col_chunk:
        return _PrecisionProduct.apply(a, d_cond, V, neighbors, slices)
    return torch.cat([_PrecisionProduct.apply(a, d_cond, V[:, s:s + col_chunk],
                                              neighbors, slices)
                      for s in range(0, V.shape[1], col_chunk)], dim=1)


def vecchia_nll(a, d_cond, neighbors, r, row_weight=None):
    """Gaussian Vecchia NLL for centered residual r.

    nll = 0.5 [ sum log D_i + sum (B r)_i^2 / D_i + n log 2pi ].

    ``row_weight`` (0/1) excludes padding rows — sharded layouts pad the
    row count to a device multiple and weight the pads out of the reduction.
    """
    br = apply_B(a, neighbors, r)
    per_row = torch.log(d_cond) + br * br / d_cond + LOG_2PI
    if row_weight is not None:
        per_row = per_row * row_weight
    return 0.5 * torch.sum(per_row)


def predict_vecchia_response(cov_fn: CovFunction, cov_pars: torch.Tensor,
                             nugget, coords_obs, coords_pred, nb_pred,
                             r_obs, predict_response: bool):
    """Batched local kriging: pred point conditions on its observed neighbors
    (``CalcPredVecchiaObservedFirstOrder`` cond_obs_only, Vecchia_utils.cpp:1634).

    Returns (mean, var); var includes the nugget iff predict_response.
    """
    # the training factor build serves prediction too (row_coords = the
    # prediction points)
    a, d_cond = build_factors(cov_fn, cov_pars, coords_obs, nb_pred, nugget,
                              True, row_coords=coords_pred)
    return kriging_from_factors(a, d_cond, nb_pred, r_obs, nugget,
                                predict_response)


def kriging_from_factors(a, d_cond, nb_pred, r_obs, nugget,
                         predict_response: bool):
    """(mean, var) of local kriging from prediction factors (A, D):
    mean_i = sum_k A[i,k] r[nb[i,k]], var_i = D_i (response scale; the
    nugget is taken off again for the latent process)."""
    mask = nb_pred >= 0
    idx = torch.clamp(nb_pred, min=0).long()
    mean = torch.sum(torch.where(mask, a, 0.0) * r_obs[idx], dim=1)
    var = d_cond  # = prior + nugget - c_in' C_nn^-1 c_in (response scale)
    if not predict_response:
        var = var - nugget
    return mean, torch.clamp(var, min=0.0)
