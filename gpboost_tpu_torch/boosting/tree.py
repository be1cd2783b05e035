"""Histogram-based decision tree: growth functions + structure.

The serial tree learner of the reference
(``src/LightGBM/treelearner/serial_tree_learner.cpp:159-210`` Train loop,
``feature_histogram.hpp`` split gains, ``data_partition.hpp``) as plain
functions on tensors: the grower is a host-driven leaf-wise loop (tree
growth is data-dependent control flow), and every O(n) step runs on the
device of the tensors it is given:

- histogram build: the hand-written CUDA kernel of
  ``ops/kernels/histogram.py`` (the role of the reference's OpenCL/CUDA
  ``histogram16/64/256`` kernels; fixed-point sums, with scales taken once
  per tree) or its plain version, see :func:`build_histogram`;
- split finding: a vectorized cumulative-sum gain scan over ``[F, B]`` —
  replaces ``FeatureHistogram::FindBestThreshold``;
- partition: elementwise leaf-id update, no row shuffling.

Histogram subtraction (parent - child = sibling) halves the histogram work
as in ``serial_tree_learner.cpp``. In float32 it loses digits for a sibling
that is tiny beside its parent; the reference's accelerator learners behave
the same. Every step adds in a fixed order, so a tree grown twice from the
same gradients is the same tree, on the card too.

The grower reads the host once per leaf: the leaf's totals and its best
split travel in one packed tensor; on the histogram kernel's route once
more per tree, for the fixed-point scales (``grow_tree.host_reads`` counts
the reads).

Numeric features only, with bagging (``row_mask``) and per-node feature
sampling (``feature_fraction_bynode``). Not ported (ROADMAP.md Queue A,
item 18b): categorical splits, monotone and interaction constraints, CEGB,
forced splits, extra trees, path smoothing, ``max_delta_step``, linear
leaves, EFB; the single-dispatch device-resident grower is item 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.ops.kernels.histogram import (MAX_BINS,
                                                     fixed_point_scales,
                                                     histogram,
                                                     histogram_plain)
from gpboost_tpu_torch.utils.timer import timed


def _on_kernel(grad, num_bins: int) -> bool:
    return (grad.is_cuda and grad.dtype == torch.float32
            and int(num_bins) <= MAX_BINS)


def histogram_scales(grad, hess, num_bins: int):
    """The histogram kernel's fixed-point scales for one tree's gradients
    (None off the kernel route): computed once per tree, passed to every
    :func:`build_histogram` call of it."""
    if not _on_kernel(grad, num_bins):
        return None
    return fixed_point_scales(grad, hess)


def build_histogram(binned, grad, hess, row_mask, num_bins: int,
                    binned_t=None, scales=None):
    """Per-feature histograms of gradient/hessian/count for masked rows.

    binned: [n, F] integer bins; grad/hess: [n]; row_mask: [n] bool.
    Returns (hist_g, hist_h, hist_c) each [F, B] in the dtype of ``grad``.

    The gate: CUDA tensors with float32 gradients and ``num_bins <= 256``
    go through the hand-written kernel (``binned_t``: the features-major
    uint8 panel of ``Dataset.binned_t``; ``scales``: the tree's
    :func:`histogram_scales`, computed here when not given), which launches
    or raises. float64 gradients or more than 256 bins on the GPU run the
    plain version there (fixed summation order); CPU tensors always do.
    Either way the same inputs give the same bits.
    """
    if _on_kernel(grad, num_bins):
        if scales is None:
            scales = fixed_point_scales(grad, hess)
        return histogram(binned, grad, hess, row_mask, num_bins,
                         binned_t=binned_t, scales=scales)
    return histogram_plain(binned, grad, hess, row_mask, num_bins)


# the block of XLA's CPU prefix sum (its reduce-window rewrite: sequential
# sums inside blocks of 16, the blocks' totals summed the same way)
SCAN_BLOCK = 16


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis. On the CPU in the order of the
    JAX package's ``jnp.cumsum`` there (XLA: sequential inside blocks of
    ``SCAN_BLOCK``, each block's offset the prefix sum of the blocks'
    totals, recursively), so that both packages round every prefix alike
    and break split gains that tie exactly (a two-valued gradient, or two
    features cutting a bag the same way) alike. On CUDA one
    ``torch.cumsum``."""
    n = x.shape[-1]
    if x.is_cuda or n <= SCAN_BLOCK:
        return torch.cumsum(x, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    lead = x.shape[:-1]
    inner = torch.cumsum(torch.nn.functional.pad(
        x, (0, nb * SCAN_BLOCK - n)).reshape(*lead, nb, SCAN_BLOCK), dim=-1)
    offsets = prefix_sum(inner[..., -1])
    offsets = torch.cat([torch.zeros_like(offsets[..., :1]),
                         offsets[..., :-1]], dim=-1)
    return (inner + offsets[..., None]).reshape(*lead, nb * SCAN_BLOCK)[
        ..., :n]


def _threshold_l1(g, l1):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _split_scan(hist, num_bins_per_feat, lambda_l1, lambda_l2,
                min_data_in_leaf, min_sum_hessian, nan_mask=None):
    """Best split of one leaf from its stacked histograms ``hist``
    [3, F, B] (gradient, hessian, count). Returns one tensor
    ``[flat index, gain, GL, HL, CL, default_left]`` in the dtype of
    ``hist`` (flat index = feature * B + bin; gain is -inf when no bin is
    valid), so that a caller on the host needs a single read."""
    _, F, B = hist.shape
    dt = hist.dtype
    neg_inf = torch.full((), -torch.inf, dtype=dt, device=hist.device)
    cum = prefix_sum(hist)
    tot = cum[:, :, -1:]
    bin_ids = torch.arange(B, device=hist.device)[None, :]
    in_range = bin_ids < (num_bins_per_feat[:, None] - 1)

    def score(g, h):
        t = g if lambda_l1 == 0.0 else _threshold_l1(g, lambda_l1)
        return t * t / (h + lambda_l2 + 1e-15)

    parent_score = score(tot[0], tot[1])

    def gain_and_valid(left):
        right = tot - left
        gain = (score(left[0], left[1]) + score(right[0], right[1])
                - parent_score)
        valid = (in_range
                 & (left[2] >= min_data_in_leaf)
                 & (right[2] >= min_data_in_leaf)
                 & (left[1] >= min_sum_hessian)
                 & (right[1] >= min_sum_hessian))
        return torch.where(valid, gain, neg_inf)

    gain = gain_and_valid(cum)  # NA bin (bin 0) on the LEFT
    if nan_mask is None:
        left = cum
        default_left = torch.ones((), dtype=dt, device=hist.device)
    else:
        # second pass: NA bin on the RIGHT (subtract it from every prefix)
        nm = nan_mask[:, None]
        left2 = cum - torch.where(nm, hist[:, :, :1],
                                  torch.zeros((), dtype=dt,
                                              device=hist.device))
        gain2 = gain_and_valid(left2)
        gain2 = torch.where(nm & (left2[2] > 0), gain2, neg_inf)
        goes_left = gain >= gain2
        gain = torch.maximum(gain, gain2)
        left = torch.where(goes_left, cum, left2)
        default_left = goes_left.to(dt)
    # torch.argmax returns the FIRST maximal element, as jnp.argmax does
    flat = torch.argmax(gain.reshape(-1))
    picked = torch.cat([gain[None], left]).reshape(4, -1)[:, flat]
    dl = (default_left if default_left.dim() == 0
          else default_left.reshape(-1)[flat])
    return torch.cat([flat.to(dt)[None], picked, dl[None]])


def find_best_split(hist_g, hist_h, hist_c, num_bins_per_feat,
                    lambda_l1, lambda_l2, min_data_in_leaf,
                    min_sum_hessian, min_gain_to_split, nan_mask=None):
    """Best (feature, bin, gain) over all features.

    Vectorized over [F, B]: left stats are prefix sums over bins; split at
    bin b sends bins <= b left. Matches ``FeatureHistogram::FindBestThreshold``
    gain math: gain = S(GL,HL) + S(GR,HR) - S(G,H),
    S(G,H) = ThresholdL1(G,l1)^2 / (H + l2). A bin is valid when
    ``bin < num_bins_per_feat - 1`` (a feature with 0 bins never wins) and
    both sides keep ``min_data_in_leaf`` rows and ``min_sum_hessian``.

    ``nan_mask`` [F] marks features with an exclusive NA bin at index 0: for
    those, both default directions for missing values are scored (LightGBM
    ``default_left`` learning, feature_histogram.hpp FindBestThreshold's
    NA-bin two-pass). Returns 0-dim tensors
    (feat, bin, gain, ok, GL, HL, CL, default_left).
    """
    hist = torch.stack([hist_g, hist_h, hist_c])
    B = hist.shape[2]
    out = _split_scan(hist, num_bins_per_feat, float(lambda_l1),
                      float(lambda_l2), min_data_in_leaf, min_sum_hessian,
                      nan_mask)
    flat = out[0].to(torch.int64)
    return ((flat // B).to(torch.int32), (flat % B).to(torch.int32), out[1],
            out[1] > min_gain_to_split, out[2], out[3], out[4], out[5] > 0)


def partition_rows(binned, row_leaf, leaf_id, feature, bin_thresh,
                   left_id, right_id, miss_right=False):
    """Send rows of ``leaf_id`` with bin[:, feature] <= bin_thresh to
    ``left_id``, the rest to ``right_id``. ``miss_right`` sends the NA bin
    (bin 0 of a feature with missing values) right instead."""
    in_leaf = row_leaf == leaf_id
    b = binned[:, feature]
    go_left = b <= bin_thresh
    if miss_right:
        go_left = go_left & (b != 0)
    new_leaf = go_left.to(row_leaf.dtype) * (left_id - right_id) + right_id
    return torch.where(in_leaf, new_leaf, row_leaf)


@dataclass
class Tree:
    """Grown tree in flat-array form (reference ``Tree``, ``io/tree.cpp``).

    Internal nodes: split_feature/threshold(+bin); leaves: leaf_value.
    ``left/right`` of a leaf point to itself, so a traversal of fixed length
    reaches a fixed point. The fields (and ``to_dict``) are those of the JAX
    package's ``Tree``; the ones of features that are not ported
    (categorical splits, linear leaves) are carried but never set.
    """
    split_feature: np.ndarray   # [M] int32
    threshold: np.ndarray       # [M] float64 (raw-value threshold, <= left)
    threshold_bin: np.ndarray   # [M] int32
    left: np.ndarray            # [M] int32
    right: np.ndarray           # [M] int32
    leaf_value: np.ndarray      # [M] float64 (0 for internal)
    is_leaf: np.ndarray         # [M] bool
    node_count: np.ndarray = None  # [M] float64 training cover
    is_categorical: np.ndarray = None  # [M] bool categorical split marker
    cat_mask: np.ndarray = None        # [M, B] bool left-set membership
    lin_features: np.ndarray = None    # [M, K] int32 feature ids (-1 pad)
    lin_coefs: np.ndarray = None       # [M, K] float64 coefficients
    split_gain: np.ndarray = None      # [M] float64 gain of each split
    default_left: np.ndarray = None    # [M] bool NA default direction
    num_leaves: int = 0
    max_depth_used: int = 1
    shrinkage: float = 1.0

    def internal_nodes(self) -> np.ndarray:
        """Indices of REAL internal (split) nodes. The flat arrays are
        fixed-size [2*num_leaves-1]; nodes never allocated (growth stopped
        early) have ``is_leaf=False`` but ``left`` pointing to themselves —
        ``~is_leaf`` alone would count them as feature-0 splits."""
        idx = np.arange(len(self.is_leaf))
        return np.flatnonzero(~self.is_leaf & (self.left != idx))

    def to_dict(self):
        def lst(a, cast=None):
            if a is None:
                return None
            return (a if cast is None else a.astype(cast)).tolist()

        return {
            "split_feature": self.split_feature.tolist(),
            "threshold": self.threshold.tolist(),
            "threshold_bin": self.threshold_bin.tolist(),
            "left": self.left.tolist(), "right": self.right.tolist(),
            "leaf_value": self.leaf_value.tolist(),
            "is_leaf": self.is_leaf.tolist(),
            "node_count": lst(self.node_count),
            "is_categorical": lst(self.is_categorical),
            "cat_mask": lst(self.cat_mask, int),
            "lin_features": lst(self.lin_features),
            "lin_coefs": lst(self.lin_coefs),
            "split_gain": lst(self.split_gain),
            "default_left": lst(self.default_left),
            "num_leaves": self.num_leaves,
            "max_depth_used": self.max_depth_used,
            "shrinkage": self.shrinkage,
        }

    @classmethod
    def from_dict(cls, d):
        """A tree from ``to_dict`` output — this package's or the JAX
        package's."""
        def arr(key, dtype):
            return None if d.get(key) is None else np.asarray(d[key], dtype)

        return cls(
            split_feature=np.asarray(d["split_feature"], np.int32),
            threshold=np.asarray(d["threshold"], np.float64),
            threshold_bin=np.asarray(d["threshold_bin"], np.int32),
            left=np.asarray(d["left"], np.int32),
            right=np.asarray(d["right"], np.int32),
            leaf_value=np.asarray(d["leaf_value"], np.float64),
            is_leaf=np.asarray(d["is_leaf"], bool),
            node_count=arr("node_count", np.float64),
            is_categorical=arr("is_categorical", bool),
            cat_mask=arr("cat_mask", bool),
            lin_features=arr("lin_features", np.int32),
            lin_coefs=arr("lin_coefs", np.float64),
            split_gain=arr("split_gain", np.float64),
            default_left=arr("default_left", bool),
            num_leaves=int(d["num_leaves"]),
            max_depth_used=int(d["max_depth_used"]),
            shrinkage=float(d.get("shrinkage", 1.0)))

    def add_shrinkage(self, rate: float):
        self.leaf_value = self.leaf_value * rate
        self.shrinkage *= rate

    def leaf_index_order(self):
        """Node ids of leaves in creation order (= leaf numbering)."""
        return np.flatnonzero(self.is_leaf)


@dataclass
class GrowerParams:
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    feature_fraction_bynode: float = 1.0


def grow_tree(binned: torch.Tensor, num_bins_per_feat: torch.Tensor,
              grad: torch.Tensor, hess: torch.Tensor, max_num_bins: int,
              params: GrowerParams,
              row_mask: Optional[torch.Tensor] = None,
              nan_mask: Optional[np.ndarray] = None,
              binned_t: Optional[torch.Tensor] = None,
              rng: Optional[np.random.Generator] = None):
    """Grow one tree leaf-wise (best-first), LightGBM-style.

    ``row_mask`` [n] bool (bagging) keeps the rows outside it out of every
    histogram; the partition still moves them, so ``row_leaf`` places every
    row. ``nan_mask`` [F] marks features whose bin 0 is an exclusive NA bin
    (default-direction learning). ``binned_t`` is the features-major uint8
    copy of ``binned`` (``Dataset.binned_t``) for the histogram kernel and
    the partition. With ``params.feature_fraction_bynode`` < 1 each leaf's
    split search sees ``ceil(fraction * F)`` features drawn from ``rng``
    (without replacement, one draw a leaf in the order the leaves are
    evaluated, as the JAX package's host grower draws them; a feature left
    out gets 0 bins, which ``_split_scan`` never picks). Returns (Tree,
    row_leaf_node [n] int32 node-id per row).
    """
    n, F = binned.shape
    device = binned.device
    if nan_mask is not None and not bool(np.any(nan_mask)):
        nan_mask = None
    nan_mask_t = (None if nan_mask is None
                  else torch.as_tensor(np.asarray(nan_mask, bool),
                                       device=device))
    # a column of the transposed view of the panel is a contiguous row
    part_src = binned if binned_t is None else binned_t.t()
    max_nodes = 2 * params.num_leaves - 1
    feature = np.zeros(max_nodes, np.int32)
    threshold_bin = np.zeros(max_nodes, np.int32)
    left = np.arange(max_nodes, dtype=np.int32)
    right = np.arange(max_nodes, dtype=np.int32)
    leaf_value = np.zeros(max_nodes, np.float64)
    split_gain_arr = np.zeros(max_nodes, np.float64)
    default_left_arr = np.ones(max_nodes, bool)
    is_leaf = np.zeros(max_nodes, bool)
    is_leaf[0] = True
    depth = np.zeros(max_nodes, np.int32)
    depth[0] = 1

    row_leaf = torch.zeros(n, dtype=torch.int32, device=device)
    l1 = float(params.lambda_l1)
    l2 = float(params.lambda_l2)
    min_data = float(params.min_data_in_leaf)
    min_hess = float(params.min_sum_hessian_in_leaf)
    min_gain = float(params.min_gain_to_split)
    ffb = float(params.feature_fraction_bynode)
    if ffb < 1.0 and rng is None:
        rng = np.random.default_rng(0)

    def leaf_output(g_sum, h_sum):
        t = np.sign(g_sum) * max(abs(g_sum) - l1, 0.0)
        return float(-t / (h_sum + l2 + 1e-15))

    # the histogram kernel's fixed-point scales, once for the tree (a read)
    scales = histogram_scales(grad, hess, max_num_bins)
    if scales is not None:
        grow_tree.host_reads += 1

    def leaf_hist(leaf_id):
        with timed("grow_tree: histogram", sync=True):
            mask = row_leaf == leaf_id
            if row_mask is not None:
                mask = mask & row_mask
            return torch.stack(build_histogram(
                binned, grad, hess, mask, max_num_bins, binned_t=binned_t,
                scales=scales))

    # per-leaf cached state: stacked histograms [3, F, B], best split
    # (feature, bin, gain, ok, left count, default_left), totals (G, H, count)
    hist_cache: dict = {}
    best_cache: dict = {}
    stats_cache: dict = {}

    def compute_leaf(leaf_id, hist):
        hist_cache[leaf_id] = hist
        num_bins_leaf = num_bins_per_feat
        if ffb < 1.0:
            # feature_fraction_bynode (config.h:359): this leaf's features
            k = max(1, int(np.ceil(ffb * F)))
            allowed = np.zeros(F, bool)
            allowed[rng.choice(F, size=k, replace=False)] = True
            num_bins_leaf = torch.where(
                torch.as_tensor(allowed, device=device), num_bins_per_feat,
                torch.zeros_like(num_bins_per_feat))
        with timed("grow_tree: split scan + host read", sync=True):
            scan = _split_scan(hist, num_bins_leaf, l1, l2, min_data,
                               min_hess, nan_mask_t)
            # every row lands in one bin per column, so the all-column sum
            # is F * (per-leaf total) — normalize to the true leaf totals
            packed = torch.cat([hist.sum(dim=(1, 2)),
                                scan]).to(torch.float64)
            (g_all, h_all, c_all, flat, gain, _, _, cl, dl) = packed.tolist()
        grow_tree.host_reads += 1
        stats_cache[leaf_id] = (g_all / F, h_all / F, c_all / F)
        flat = int(flat)
        best_cache[leaf_id] = (flat // max_num_bins, flat % max_num_bins,
                               gain, gain > min_gain, cl, dl > 0)

    compute_leaf(0, leaf_hist(0))
    num_leaves = 1
    next_node = 1
    max_depth_used = 1

    while num_leaves < params.num_leaves:
        # pick splittable leaf with max gain
        best_leaf, best = None, None
        for leaf_id, b in best_cache.items():
            if not b[3]:
                continue
            if params.max_depth > 0 and depth[leaf_id] >= params.max_depth:
                continue
            if best is None or b[2] > best[2]:
                best_leaf, best = leaf_id, b
        if best_leaf is None:
            break
        f_b, b_b, gain, _, left_cnt, dflt_left = best
        cnt = stats_cache[best_leaf][2]
        left_id = next_node
        right_id = next_node + 1
        next_node += 2
        miss_right = bool(nan_mask is not None and nan_mask[f_b]
                          and not dflt_left)
        with timed("grow_tree: partition", sync=True):
            row_leaf = partition_rows(part_src, row_leaf, best_leaf, f_b,
                                      b_b, left_id, right_id,
                                      miss_right=miss_right)
        # bookkeeping
        is_leaf[best_leaf] = False
        feature[best_leaf] = f_b
        threshold_bin[best_leaf] = b_b
        split_gain_arr[best_leaf] = gain
        default_left_arr[best_leaf] = bool(dflt_left)
        left[best_leaf] = left_id
        right[best_leaf] = right_id
        is_leaf[left_id] = is_leaf[right_id] = True
        depth[left_id] = depth[right_id] = depth[best_leaf] + 1
        max_depth_used = max(max_depth_used, int(depth[left_id]))
        num_leaves += 1
        # child histograms: smaller side direct, sibling by subtraction
        parent_hist = hist_cache.pop(best_leaf)
        best_cache.pop(best_leaf)
        if left_cnt <= cnt / 2:
            hist_left = leaf_hist(left_id)
            hist_right = parent_hist - hist_left
        else:
            hist_right = leaf_hist(right_id)
            hist_left = parent_hist - hist_right
        compute_leaf(left_id, hist_left)
        compute_leaf(right_id, hist_right)

    node_count = np.zeros(max_nodes, np.float64)
    for node_id, (g_sum, h_sum, cnt) in stats_cache.items():
        node_count[node_id] = cnt
        if is_leaf[node_id]:
            leaf_value[node_id] = leaf_output(g_sum, h_sum)
    tree = Tree(split_feature=feature, threshold=np.zeros(max_nodes),
                threshold_bin=threshold_bin, left=left, right=right,
                leaf_value=leaf_value, is_leaf=is_leaf, node_count=node_count,
                is_categorical=np.zeros(max_nodes, bool),
                cat_mask=np.zeros((max_nodes, max_num_bins), bool),
                split_gain=split_gain_arr, default_left=default_left_arr,
                num_leaves=num_leaves, max_depth_used=max_depth_used)
    return tree, row_leaf


grow_tree.host_reads = 0


def predict_tree_binned(binned, feature, threshold_bin, left, right,
                        max_depth: int, leaf_value, default_left=None):
    """Evaluate one tree on binned data by a traversal of ``max_depth``
    steps (leaves point to themselves). All arguments but ``max_depth`` are
    tensors on one device; returns (values [n], node ids [n]).

    ``default_left`` [M]: False sends the NA bin (bin 0 of a feature with
    missing values — the grower only clears the flag on such nodes) right.
    """
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    feature, left, right = feature.long(), left.long(), right.long()
    for _ in range(max_depth):
        t = threshold_bin[node]
        vals = binned.gather(1, feature[node][:, None])[:, 0]
        go_left = vals <= t
        if default_left is not None:
            go_left = go_left & (default_left[node] | (vals != 0))
        node = torch.where(go_left, left[node], right[node])
    return leaf_value[node], node


def predict_tree_raw(X, feature, threshold, left, right, leaf_value,
                     max_depth: int, default_left=None):
    """Evaluate one tree on raw feature values (value <= threshold -> left);
    NaN routes by the node's learned ``default_left`` direction."""
    n = X.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=X.device)
    feature, left, right = feature.long(), left.long(), right.long()
    for _ in range(max_depth):
        t = threshold[node]
        vals = X.gather(1, feature[node][:, None])[:, 0]
        go_left = vals <= t
        if default_left is not None:
            go_left = torch.where(torch.isnan(vals), default_left[node],
                                  go_left)
        node = torch.where(go_left, left[node], right[node])
    return leaf_value[node], node
