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


def _same_code(d2: torch.Tensor, row_codes: Optional[torch.Tensor],
               col_codes: Optional[torch.Tensor]) -> torch.Tensor:
    """``d2`` with the pairs of different cluster codes set to inf."""
    if row_codes is None:
        return d2
    return torch.where(col_codes[None, :] == row_codes[:, None], d2,
                       math.inf)


def find_neighbors(coords: torch.Tensor, num_neighbors: int,
                   chunk: int = 1024,
                   codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest ``m`` *previous* points for each row (data order = ordering).

    Returns [n, m] int32; entry -1 marks padding (i < m has only i neighbors).
    Blocked brute force: distances for a row chunk against the points before
    the chunk's end, mask j >= i, exact top-k — the dense answer to CoverTree
    kNN (``Vecchia_utils.cpp:93-168``). ``codes`` [n] (cluster codes, in
    row order): a row takes neighbours of its own code only (independent
    realisations per ``cluster_ids``), padded with -1 where its cluster has
    fewer than m earlier points.
    """
    n = coords.shape[0]
    out = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        d2 = _sq_dists(coords[start:end], coords[:end])
        row_ids = torch.arange(start, end, device=coords.device)[:, None]
        col_ids = torch.arange(end, device=coords.device)[None, :]
        d2 = torch.where(col_ids < row_ids, d2, math.inf)
        if codes is not None:
            d2 = _same_code(d2, codes[start:end], codes[:end])
        out.append(_nearest(d2, num_neighbors))
    return torch.cat(out, dim=0)


def find_neighbors_cross(coords_pred: torch.Tensor, coords_obs: torch.Tensor,
                         num_neighbors: int, chunk: int = 1024,
                         codes_pred: Optional[torch.Tensor] = None,
                         codes_obs: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Nearest observed points for each prediction point. [n_p, m] int32
    with m = min(num_neighbors, n_obs). With ``codes_pred`` / ``codes_obs``
    only observed points of the same code are eligible (-1 where fewer)."""
    m = min(num_neighbors, coords_obs.shape[0])
    out = []
    for start in range(0, coords_pred.shape[0], chunk):
        d2 = _sq_dists(coords_pred[start:start + chunk], coords_obs)
        if codes_pred is not None:
            d2 = _same_code(d2, codes_pred[start:start + chunk], codes_obs)
        out.append(_nearest(d2, m))
    return torch.cat(out, dim=0)


def find_neighbors_appended(search: torch.Tensor, n_o: int, m: int,
                            codes: Optional[torch.Tensor] = None,
                            chunk: int = 1024) -> torch.Tensor:
    """Neighbours of the points appended after the first ``n_o`` of
    ``search``: each row ``n_o + i`` takes its ``m`` nearest among all
    points before it (the observations and the earlier appended points),
    of its own code with ``codes``. Returns [len(search) - n_o, m] int32,
    indices into ``search`` (the ``order_obs_first_cond_all`` search)."""
    n_tot = search.shape[0]
    out = []
    for start in range(n_o, n_tot, chunk):
        end = min(start + chunk, n_tot)
        d2 = _sq_dists(search[start:end], search[:end])
        row_ids = torch.arange(start, end, device=search.device)[:, None]
        col_ids = torch.arange(end, device=search.device)[None, :]
        d2 = torch.where(col_ids < row_ids, d2, math.inf)
        if codes is not None:
            d2 = _same_code(d2, codes[start:end], codes[:end])
        out.append(_nearest(d2, m))
    if not out:
        return torch.zeros((0, m), dtype=torch.int32, device=search.device)
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
    if cov_fn.cov_fct_type in ("linear", "hurst"):
        c_nn, c_in, var_ii = _nonstationary_blocks(cov_fn, cov_pars, coords,
                                                   row_coords, neighbors)
    else:
        _, d_nn, d_in = _gathered_dists(coords, row_coords, neighbors)
        if scaled:
            c_nn = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_nn, cov_pars)
            c_in = cov_pars[0] * cov_fn.corr_from_scaled_dist(d_in, cov_pars)
        else:
            c_nn = cov_fn.cov_matrix(cov_pars, dist=d_nn)
            c_in = cov_fn.cov_matrix(cov_pars, dist=d_in)
        var_ii = cov_pars[0] * torch.ones(n, dtype=row_coords.dtype,
                                          device=row_coords.device)
    if include_nugget and nugget is not None:
        c_nn = c_nn + nugget * torch.eye(m, dtype=row_coords.dtype,
                                         device=row_coords.device)[None]
        var_ii = var_ii + nugget
    a, c_in, info = _solve_masked(c_nn, c_in, neighbors >= 0)
    d_cond = var_ii - torch.sum(c_in * a, dim=1)
    return a, torch.where(info == 0, d_cond, math.nan)


def _nonstationary_blocks(cov_fn: CovFunction, cov_pars: torch.Tensor,
                          coords, row_coords, neighbors):
    """(C_NN [n, m, m], c [n, m], var [n]) of the non-stationary ``linear``
    (sigma2 x'x) and ``hurst`` (fractional Brownian motion sigma2/2 (|x|^2H
    + |y|^2H - |x-y|^2H)) covariances, whose variance is per point (JAX
    ``ops/vecchia.py:414-450``)."""
    nb = coords[torch.clamp(neighbors, min=0).long()]          # [n, m, d]
    if cov_fn.cov_fct_type == "linear":
        c_nn = cov_pars[0] * torch.einsum("nmd,nkd->nmk", nb, nb)
        c_in = cov_pars[0] * torch.sum(row_coords[:, None, :] * nb, -1)
        return c_nn, c_in, cov_pars[0] * torch.sum(row_coords * row_coords,
                                                   dim=1)
    H = cov_pars[1]
    s2h = cov_pars[0] / 2.0

    def powh(sq):
        return torch.pow(torch.clamp(sq, min=1e-300), H)

    r_nb = powh(torch.sum(nb * nb, -1))                         # [n, m]
    r_row = powh(torch.sum(row_coords * row_coords, -1))        # [n]
    diffs = nb[:, :, None, :] - nb[:, None, :, :]
    d2_nn = powh(torch.sum(diffs * diffs, -1))
    di = row_coords[:, None, :] - nb
    d2_in = powh(torch.sum(di * di, -1))
    c_nn = s2h * (r_nb[:, :, None] + r_nb[:, None, :] - d2_nn)
    c_in = s2h * (r_row[:, None] + r_nb - d2_in)
    return c_nn, c_in, cov_pars[0] * r_row


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
    _, d_nn, d_in = _gathered_dists(coords, coords, neighbors)
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
    if include_nugget and nugget is not None:
        c_nn = c_nn + nugget * torch.eye(m, dtype=coords.dtype,
                                         device=coords.device)[None]
        var_ii = var_ii + nugget
    a, c_in, info = _solve_masked(c_nn, c_in, neighbors >= 0)
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


# ---------------------------------------------------------------------------
# GP random coefficients (several components on the same coordinates)
# ---------------------------------------------------------------------------

def _svc_cov(cov_fn: CovFunction, pars_stack: torch.Tensor, d_nn, d_in,
             z_nb, row_z):
    """(C_NN [n, m, m], c [n, m], var [n]) of the total process
    u(s) = sum_c z_c(s) b_c(s): each component's covariance weighted by the
    covariates of the pair."""
    c_nn = c_in = var = None
    for c in range(pars_stack.shape[0]):
        pc = pars_stack[c]
        zc = z_nb[:, :, c]
        k_nn = (zc[:, :, None] * zc[:, None, :]) * cov_fn.cov_matrix(
            pc, dist=d_nn)
        k_in = (row_z[:, c][:, None] * zc) * cov_fn.cov_matrix(pc, dist=d_in)
        v = row_z[:, c] * row_z[:, c] * pc[0]
        c_nn = k_nn if c_nn is None else c_nn + k_nn
        c_in = k_in if c_in is None else c_in + k_in
        var = v if var is None else var + v
    return c_nn, c_in, var


def _gathered_dists(coords, row_coords, neighbors):
    idx = torch.clamp(neighbors, min=0).long()
    nb_coords = coords[idx]
    diffs = nb_coords[:, :, None, :] - nb_coords[:, None, :, :]
    d_nn = _safe_dist(torch.sum(diffs * diffs, -1))
    di = row_coords[:, None, :] - nb_coords
    return idx, d_nn, _safe_dist(torch.sum(di * di, -1))


def _solve_masked(c_nn, c_in, mask):
    """a = C_NN^-1 c with the padding slots masked out (identity rows and
    columns, zero weights), and ``info`` for the rows whose block is not
    positive definite: ``cholesky_ex`` does not raise there (parameters a
    line search overshot to), the callers set those rows' D to NaN, so the
    NLL is NaN and the optimizer backs off."""
    m = c_nn.shape[-1]
    eye = torch.eye(m, dtype=c_nn.dtype, device=c_nn.device)
    c_nn = torch.where(mask[:, :, None] & mask[:, None, :], c_nn, eye[None])
    c_in = torch.where(mask, c_in, 0.0)
    chol, info = torch.linalg.cholesky_ex(c_nn)
    a = torch.cholesky_solve(c_in[..., None], chol)[..., 0]
    return torch.where(mask, a, 0.0), c_in, info


def build_factors_svc(cov_fn: CovFunction, pars_stack: torch.Tensor,
                      coords: torch.Tensor, neighbors: torch.Tensor,
                      z: torch.Tensor, nugget: Optional[torch.Tensor],
                      include_nugget: bool,
                      row_coords: Optional[torch.Tensor] = None,
                      row_z: Optional[torch.Tensor] = None):
    """Vecchia factors of a GP with random coefficients (SVC; the JAX
    package's ``build_factors_svc``): covariance K_ij = sum_c z_ic z_jc
    k_c(d_ij), ``pars_stack`` [C, p] the components' parameters, ``z``
    [n, C] their covariates (z[:, 0] = 1, the base GP). ``row_coords`` /
    ``row_z`` (default ``coords`` / ``z``) are the rows the ``neighbors``
    refer to. Returns (A [n, m], D [n])."""
    if row_coords is None:
        row_coords = coords
    if row_z is None:
        row_z = z
    mask = neighbors >= 0
    idx, d_nn, d_in = _gathered_dists(coords, row_coords, neighbors)
    c_nn, c_in, var_ii = _svc_cov(cov_fn, pars_stack, d_nn, d_in, z[idx],
                                  row_z)
    if include_nugget and nugget is not None:
        m = neighbors.shape[1]
        c_nn = c_nn + nugget * torch.eye(m, dtype=c_nn.dtype,
                                         device=c_nn.device)[None]
        var_ii = var_ii + nugget
    a, c_in, info = _solve_masked(c_nn, c_in, mask)
    d_cond = var_ii - torch.sum(c_in * a, dim=1)
    return a, torch.where(info == 0, d_cond, math.nan)


def predict_vecchia_response_svc(cov_fn: CovFunction, pars_stack, nugget,
                                 coords_obs, coords_pred, nb_pred, z_obs,
                                 z_pred, r_obs, predict_response: bool):
    """Local kriging of a GP with random coefficients on each prediction
    point's observed neighbours (the JAX package's
    ``predict_vecchia_response_svc``). Returns (mean, var)."""
    mask = nb_pred >= 0
    idx, d_nn, d_in = _gathered_dists(coords_obs, coords_pred, nb_pred)
    c_nn, c_in, var_pp = _svc_cov(cov_fn, pars_stack, d_nn, d_in,
                                  z_obs[idx], z_pred)
    m = nb_pred.shape[1]
    c_nn = c_nn + nugget * torch.eye(m, dtype=c_nn.dtype,
                                     device=c_nn.device)[None]
    a, c_in, _ = _solve_masked(c_nn, c_in, mask)
    mean = torch.sum(a * r_obs[idx], dim=1)
    var = var_pp - torch.sum(c_in * a, dim=1)
    if predict_response:
        var = var + nugget
    return mean, torch.clamp(var, min=0.0)


# ---------------------------------------------------------------------------
# the other prediction types (``vecchia_pred_type``)
# ---------------------------------------------------------------------------

def _scaled_search(cov_fn: CovFunction, coords, gp_pars):
    if not cov_fn.is_isotropic and cov_fn.has_coord_scaling:
        return cov_fn.scale_coords(coords, gp_pars)
    return coords


def _pairs_dense(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 shape, eye: bool = False) -> torch.Tensor:
    """A dense matrix holding ``vals`` at the (row, col) pairs (each pair
    at most once, so the write needs no accumulation), on an identity or
    zeros."""
    n_r, n_c = shape
    out = (torch.eye(n_r, n_c, dtype=vals.dtype, device=vals.device) if eye
           else torch.zeros((n_r, n_c), dtype=vals.dtype, device=vals.device))
    return out.index_put_((rows, cols), vals)


def predict_vecchia_cond_all(cov_fn: CovFunction, cov_pars, nugget,
                             coords_obs, coords_pred, r_obs,
                             num_neighbors: int, codes_obs=None,
                             codes_pred=None, predict_response: bool = True):
    """``order_obs_first_cond_all`` prediction
    (``CalcPredVecchiaObservedFirstOrder`` with CondObsOnly=false,
    ``Vecchia_utils.cpp:1634``): the prediction points follow the
    observations and each conditions on its ``m`` nearest among the
    observations and the earlier prediction points (of its own cluster
    with codes). Returns (mean [n_p], cov [n_p, n_p])."""
    n_o, n_p = coords_obs.shape[0], coords_pred.shape[0]
    m = min(num_neighbors, n_o + n_p - 1)
    combined = torch.cat([coords_obs, coords_pred], dim=0)
    codes = (None if codes_obs is None
             else torch.cat([codes_obs, codes_pred]).to(combined.device))
    nb = find_neighbors_appended(_scaled_search(cov_fn, combined, cov_pars),
                                 n_o, m, codes)
    a, d = build_factors(cov_fn, cov_pars, combined, nb, nugget, True,
                         row_coords=coords_pred)
    return _cond_all_assemble(a, d, nb, n_o, n_p, r_obs, nugget,
                              predict_response)


def _cond_all_assemble(a, d, nb, n_o, n_p, r_obs, nugget, predict_response):
    """Mean and covariance from obs-first cond-all factors: with
    B = [[B_oo, 0], [B_po, B_pp]], mean = -B_pp^-1 B_po r and
    cov = B_pp^-1 D_p B_pp^-T (one dense triangular solve on the
    prediction set)."""
    is_obs = (nb >= 0) & (nb < n_o)
    is_prd = nb >= n_o
    rhs = torch.sum(torch.where(is_obs, a, 0.0)
                    * r_obs[torch.where(is_obs, nb, 0).long()], dim=1)
    rows = torch.arange(n_p, device=a.device)[:, None].expand_as(nb)
    M = _pairs_dense(rows[is_prd], (nb[is_prd] - n_o).long(), -a[is_prd],
                     (n_p, n_p), eye=True)
    mean = torch.linalg.solve_triangular(M, rhs[:, None], upper=False)[:, 0]
    V = torch.linalg.solve_triangular(
        M, torch.eye(n_p, dtype=a.dtype, device=a.device), upper=False)
    cov = (V * d[None, :]) @ V.T
    if not predict_response:
        cov = cov - nugget * torch.eye(n_p, dtype=a.dtype, device=a.device)
    return mean, cov


def predict_vecchia_cond_all_svc(cov_fn: CovFunction, pars_stack, nugget,
                                 coords_obs, coords_pred, z_obs, z_pred,
                                 r_obs, num_neighbors: int,
                                 predict_response: bool = True):
    """``order_obs_first_cond_all`` for a GP with random coefficients (the
    search on the coordinates; the covariances the covariate-weighted sums
    of :func:`build_factors_svc`). Returns (mean, cov)."""
    n_o, n_p = coords_obs.shape[0], coords_pred.shape[0]
    m = min(num_neighbors, n_o + n_p - 1)
    combined = torch.cat([coords_obs, coords_pred], dim=0)
    nb = find_neighbors_appended(combined, n_o, m)
    a, d = build_factors_svc(cov_fn, pars_stack, combined, nb,
                             torch.cat([z_obs, z_pred], dim=0), nugget, True,
                             row_coords=coords_pred, row_z=z_pred)
    return _cond_all_assemble(a, d, nb, n_o, n_p, r_obs, nugget,
                              predict_response)


def predict_vecchia_pred_first(cov_fn: CovFunction, cov_pars, nugget,
                               coords_obs, coords_pred, r_obs,
                               num_neighbors: int,
                               predict_response: bool = True):
    """``order_pred_first`` prediction
    (``CalcPredVecchiaPredictedFirstOrder``, ``Vecchia_utils.cpp:2018``):
    one Vecchia approximation over [pred; obs], the prediction points
    first; the conditional precision P = Bp' Dp^-1 Bp + Bop' Do^-1 Bop
    gives mean = -P^-1 Bop' Do^-1 Bo r and cov = P^-1. The
    observation-to-prediction block Bop is assembled on the observations
    that condition on a prediction point only (the other rows of the JAX
    package's dense [n_o, n_p] block are zero). Returns (mean, cov)."""
    n_o, n_p = coords_obs.shape[0], coords_pred.shape[0]
    m = min(num_neighbors, n_o + n_p - 1)
    combined = torch.cat([coords_pred, coords_obs], dim=0)
    nb = find_neighbors(_scaled_search(cov_fn, combined, cov_pars), m)
    a, d = build_factors(cov_fn, cov_pars, combined, nb, nugget, True)
    a_p, nb_p, a_o, nb_o = a[:n_p], nb[:n_p], a[n_p:], nb[n_p:]
    dp_inv, do_inv = 1.0 / d[:n_p], 1.0 / d[n_p:]
    rows_p = torch.arange(n_p, device=a.device)[:, None].expand_as(nb_p)
    mp = nb_p >= 0
    Bp = _pairs_dense(rows_p[mp], nb_p[mp].long(), -a_p[mp], (n_p, n_p),
                      eye=True)
    is_pred_nb = (nb_o >= 0) & (nb_o < n_p)
    sel = torch.nonzero(torch.any(is_pred_nb, dim=1)).reshape(-1)
    nb_s, a_s, pm = nb_o[sel], a_o[sel], is_pred_nb[sel]
    rows_s = torch.arange(sel.numel(), device=a.device)[:, None].expand_as(
        nb_s)
    Bop = _pairs_dense(rows_s[pm], nb_s[pm].long(), -a_s[pm],
                       (sel.numel(), n_p))
    is_obs_nb = nb_o >= n_p
    Bo_r = r_obs - torch.sum(
        torch.where(is_obs_nb, a_o, 0.0)
        * r_obs[torch.where(is_obs_nb, nb_o - n_p, 0).long()], dim=1)
    do_s = do_inv[sel]
    cond_prec = (Bp.T * dp_inv[None, :]) @ Bp + (Bop.T * do_s[None, :]) @ Bop
    y_aux = Bop.T @ (do_s * Bo_r[sel])
    Lc = torch.linalg.cholesky(cond_prec)
    mean = -torch.cholesky_solve(y_aux[:, None], Lc)[:, 0]
    cov = torch.cholesky_inverse(Lc)
    if not predict_response:
        cov = cov - nugget * torch.eye(n_p, dtype=a.dtype, device=a.device)
    return mean, cov


class TriangularSchedule:
    """The rows of a Vecchia factor's unit lower-triangular B = I - A
    grouped by level (a row's level is one more than its neighbours'
    highest; level 0 has none), so that B x = b and B' x = b are solved one
    level at a time, each level a gather over rows already known — with a
    random ordering a few hundred levels at n = 1e5 instead of n rows. The transposed solve reads the padded incoming structure of
    :func:`build_incoming`. Every write goes to distinct rows; nothing adds
    with colliding indices."""

    def __init__(self, neighbors: torch.Tensor):
        nb = neighbors.cpu().numpy()
        n = nb.shape[0]
        level = np.zeros(n, np.int64)
        for i in range(n):
            row = nb[i]
            row = row[row >= 0]
            if row.size:
                level[i] = level[row].max() + 1
        order = np.argsort(level, kind="stable")
        bounds = np.cumsum(np.bincount(level))
        dev = neighbors.device
        self.levels = [torch.as_tensor(order[lo:hi], device=dev)
                       for lo, hi in zip(np.r_[0, bounds[:-1]], bounds)]
        self.neighbors = neighbors
        self.inc_row, self.inc_slot = build_incoming(neighbors)
        self.width = max(max(int(r.numel()) for r in self.levels)
                         * max(int(self.inc_row.shape[1]), nb.shape[1]), 1)


def _solve_B(a, sched: TriangularSchedule, b, transpose: bool):
    """x = B^-1 b (or B^-T b), b [n, k], level by level."""
    x = b.clone()
    for rows in (reversed(sched.levels) if transpose else sched.levels[1:]):
        if transpose:
            ir = sched.inc_row[rows]
            src = torch.clamp(ir, min=0).long()
            coef = torch.where(ir >= 0, a[src, sched.inc_slot[rows].long()],
                               0.0)
        else:
            nbr = sched.neighbors[rows]
            src = torch.clamp(nbr, min=0).long()
            coef = torch.where(nbr >= 0, a[rows], 0.0)
        x[rows] = b[rows] + (coef[:, None, :] @ x[src])[:, 0]
    return x


def precision_solve(a, d, sched: TriangularSchedule, V: torch.Tensor):
    """Q^-1 V = B^-1 D B^-T V for V [n] or [n, k] by two level-scheduled
    triangular solves (exact up to rounding), in column chunks that keep the
    gathers of the widest level within ``GATHER_BUDGET``."""
    vec = V.dim() == 1
    V = V[:, None] if vec else V
    step = max(1, GATHER_BUDGET // sched.width)
    out = torch.cat([
        _solve_B(a, sched, d[:, None] * _solve_B(a, sched, V[:, s:s + step],
                                                 True), False)
        for s in range(0, V.shape[1], step)], dim=1)
    return out[:, 0] if vec else out


def _member_rows(idx: np.ndarray, n_u: int):
    """[n_u, w] rows of each unique location (-1 padded), in row order: the
    transpose of the incidence ``idx`` (row -> unique location) as a
    gather plan."""
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n_u)
    w = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.cumsum(counts) - counts
    pos = np.arange(idx.size) - np.repeat(starts, counts)
    out = np.full((n_u, w), -1, np.int64)
    out[idx[order], pos] = order
    return out


def _incidence_t(members: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Z' v for the incidence whose transpose ``members`` holds: per
    unique location the sum of its rows of v ([n] or [n, k]), a gather in
    a fixed order."""
    g = v[torch.clamp(members, min=0)]
    mask = members >= 0
    return torch.sum(torch.where(mask if v.dim() == 1 else mask[..., None],
                                 g, 0.0), dim=1)


def predict_vecchia_latent(cov_fn: CovFunction, gp_pars, nugget, coords_obs,
                           coords_pred, y_obs, num_neighbors: int,
                           cond_obs_only: bool,
                           predict_response: bool = True,
                           cg_tol: float = 1e-10, cg_max_iter: int = 10000,
                           stats=None):
    """``latent_order_obs_first_cond_obs_only`` / ``..._cond_all``
    (``CalcPredVecchiaLatentObservedFirstOrder``,
    ``Vecchia_utils.cpp:2241``): a Vecchia approximation of the LATENT
    process over the unique locations (observed first), exact Gaussian
    noise on top:

      mean = Zp S Zo' (Zo S Zo' + s0 I)^-1 y,
      cov  = Zp S Zp' - Zp S Zo' (Zo S Zo' + s0 I)^-1 Zo S Zp' (+ s0 I),

    S = Q^-1, Q = B' D^-1 B. The solves with W = s0 Q + Zo'Zo are
    Jacobi-preconditioned CG to ``cg_tol`` (the JAX package's matrix-free
    route); those with Q are the two triangular solves of
    :func:`precision_solve` — the JAX package runs CG on Q too, whose
    iterations grow with Q's condition and reach their cap at n = 1e5 with
    a long range, where the triangular solves take ~500 levels. ``stats``
    (a Counter) receives the CG iterations (``latent_cg_iters``). Returns
    (mean [n_p], var [n_p], cov [n_p, n_p])."""
    from gpboost_tpu_torch.ops import cg as cgops
    dev, dtype = coords_obs.device, coords_obs.dtype
    co = coords_obs.detach().cpu().numpy().astype(np.float64)
    cpn = coords_pred.detach().cpu().numpy().astype(np.float64)
    n_o, n_p = co.shape[0], cpn.shape[0]
    all_np = np.concatenate([co, cpn], axis=0)
    # unique locations in first-occurrence order (exact equality)
    _, first_idx, inv = np.unique(all_np, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    u_idx = rank[np.asarray(inv).ravel()]
    coords_u = all_np[np.sort(first_idx)]
    n_u = coords_u.shape[0]
    zo_idx, zp_idx = u_idx[:n_o], u_idx[n_o:]
    n_uo = int(zo_idx.max()) + 1 if n_o else 0
    if np.any(zp_idx < n_uo):
        raise ValueError(
            "Duplicates found among training and test coordinates. This is "
            "not supported for predictions with a Vecchia approximation for "
            "the latent process ('latent_')")
    m = min(num_neighbors, n_u - 1)
    cu = torch.as_tensor(coords_u, dtype=dtype, device=dev)
    search = _scaled_search(cov_fn, cu, gp_pars)
    nb_obs = find_neighbors(search[:n_uo], min(m, n_uo - 1))
    if cond_obs_only:
        nb_pred = find_neighbors_cross(search[n_uo:], search[:n_uo],
                                       min(m, n_uo))
    else:
        nb_pred = find_neighbors_appended(search, n_uo, m)

    def pad_to_m(x):
        k = x.shape[1]
        return x if k == m else torch.cat(
            [x, torch.full((x.shape[0], m - k), -1, dtype=x.dtype,
                           device=x.device)], dim=1)

    nb = torch.cat([pad_to_m(nb_obs), pad_to_m(nb_pred)], dim=0).contiguous()
    a, du = build_factors(cov_fn, gp_pars, cu, nb, None, False)
    a = torch.where(nb >= 0, a, 0.0)
    slices = build_incoming_sliced(nb) if nb.is_cuda else None
    chunk = col_chunk(n_u, m)

    def q_mv(V):
        return precision_product(a, du, V, nb, slices, col_chunk=chunk)

    counts = torch.as_tensor(np.bincount(zo_idx, minlength=n_u),
                             dtype=dtype, device=dev)
    diag_q = precision_diag(a, nb, du, slices)

    def w_mv(V):                        # W = nugget Q + Zo'Zo
        return nugget * q_mv(V) + _cols(counts, V) * V

    pre_w = torch.clamp(nugget * diag_q + counts, min=1e-300)
    sched = TriangularSchedule(nb)

    def solve_w(B):
        X, it = cgops.pcg(w_mv, B, lambda R: R / _cols(pre_w, R), tol=cg_tol,
                          max_iter=cg_max_iter)
        if stats is not None:
            stats["latent_cg_iters"] += it
        return X

    def solve_q(B):
        return precision_solve(a, du, sched, B)

    members = torch.as_tensor(_member_rows(zo_idx, n_u), device=dev)
    zo_j = torch.as_tensor(zo_idx, device=dev)
    zp_j = torch.as_tensor(zp_idx, device=dev)
    y_obs = y_obs.to(dtype)
    # mean = Zp Q^-1 Zo' t with t = (y - Zo W^-1 Zo'y) / nugget
    t = (y_obs - solve_w(_incidence_t(members, y_obs))[zo_j]) / nugget
    mean = solve_q(_incidence_t(members, t))[zp_j]
    # C = Q^-1 Zp'  [n_u, n_p]
    E = _pairs_dense(zp_j, torch.arange(n_p, device=dev),
                     torch.ones(n_p, dtype=dtype, device=dev), (n_u, n_p))
    C = solve_q(E)
    Kpp, KopC = C[zp_j], C[zo_j]
    S2 = solve_w(_incidence_t(members, KopC))
    A_KopC = (KopC - S2[zo_j]) / nugget     # (K_oo + s0 I)^-1 K_op
    cov = Kpp - KopC.T @ A_KopC
    if predict_response:
        cov = cov + nugget * torch.eye(n_p, dtype=dtype, device=dev)
    return mean, torch.diagonal(cov), cov
