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
  per tree) or its plain version, see :func:`build_histogram`; with EFB on
  the bundle panel, the per-feature histograms rebuilt exactly by
  :func:`expand_bundle_hist`;
- split finding: a vectorized cumulative-sum gain scan over ``[F, B]`` —
  replaces ``FeatureHistogram::FindBestThreshold`` — with monotone
  constraints, CEGB penalties, extra trees' one drawn bin a feature, path
  smoothing, output bounds (the intermediate monotone method,
  ``max_delta_step``) and gain multipliers (the monotone penalty,
  ``feature_contri``); categorical features by one-hot or sorted-subset
  scans (:func:`find_best_split_categorical`);
- partition: elementwise leaf-id update, no row shuffling.

Histogram subtraction (parent - child = sibling) halves the histogram work
as in ``serial_tree_learner.cpp``. In float32 it loses digits for a sibling
that is tiny beside its parent; the reference's accelerator learners behave
the same. Every step adds in a fixed order, so a tree grown twice from the
same gradients is the same tree, on the card too.

The host grower (:func:`grow_tree`) reads the host once per leaf: the
leaf's totals and its best splits (numeric, and categorical with its left
set) travel in one packed tensor. On the histogram kernel's route it reads
once more per tree, for the fixed-point scales. The categorical scan's
``min_data_per_group`` group boundaries (a sequential scan over the bins)
are a kernel of their own on the card (``ops/kernels/cat_group_scan.py``)
and read nothing. ``grow_tree.host_reads`` counts the reads.

The grower's options are the JAX package's host grower's (forced splits
root first, the three monotone methods as the JAX package approximates
them, interaction constraints, ``feature_fraction_bynode``, CEGB with its
re-scoring), drawn from the same numpy streams in the same order. Linear
leaves (:func:`fit_linear_leaves`) are fitted after the grower.

The fixed-shape grower (:func:`grow_tree_fast`, :func:`_grow_tree_fixed`,
the JAX package's ``grow_tree_fast`` / ``_grow_tree_jit``) grows the same
tree with no host read: ``num_leaves - 1`` masked steps on ``[M]`` node
arrays, on CUDA one captured graph a tree, then one fetch. It covers the
numeric and categorical splits and their options, the three monotone
methods, interaction constraints and forced splits; CEGB, extra trees and
``feature_fraction_bynode`` are ROADMAP.md Queue A, item 10b.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.ops.kernels.cat_group_scan import group_boundaries
from gpboost_tpu_torch.ops.kernels.histogram import (
    MAX_BINS, fixed_point_scales, fixed_point_scales_device, histogram,
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


# the block of XLA's CPU row reduction (sequential sums inside blocks of 32,
# then over the blocks' totals)
SUM_BLOCK = 32


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis. On the CPU in the order of the JAX package's
    ``jnp.sum(..., axis=-1)`` there (XLA: sequential inside blocks of
    ``SUM_BLOCK``, then sequentially over the blocks' totals), so that the
    categorical scan's totals and EFB's rebuilt default bins round as the
    JAX package's do and exact gain ties (a split and its mirror image)
    break alike. On CUDA one ``torch.sum``."""
    n = x.shape[-1]
    if x.is_cuda:
        return x.sum(dim=-1)
    nb = -(-n // SUM_BLOCK)
    blocks = torch.cumsum(torch.nn.functional.pad(
        x, (0, nb * SUM_BLOCK - n)).reshape(*x.shape[:-1], nb, SUM_BLOCK),
        dim=-1)[..., -1]
    return torch.cumsum(blocks, dim=-1)[..., -1]


def _threshold_l1(g, l1):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def expand_bundle_hist(hist, src_col, src_bin, default_bin, fix_mask):
    """Per-feature ``[3, F, B]`` histograms from EFB bundle histograms
    ``[3, G, Bh]`` (lossless; ``dataset.EFBInfo``): each feature's
    non-default bins gathered from its bundle column, its default-bin slot
    filled with the leaf total minus the non-default mass. Exact because
    every row lands in exactly one bin of every bundle column."""
    zero = torch.zeros((), dtype=hist.dtype, device=hist.device)
    B = src_bin.shape[1]
    per = torch.where(src_bin >= 0,
                      hist[:, src_col[:, None], src_bin.clamp(min=0)], zero)
    tot = hist.sum(dim=(1, 2)) / hist.shape[1]                      # [3]
    corr = torch.where(fix_mask, tot[:, None] - row_sum(per), zero)
    slot = torch.arange(B, device=hist.device)[None, :] == default_bin[:, None]
    return per + torch.where(slot, corr[:, :, None], zero)


def _split_scan(hist, num_bins_per_feat, lambda_l1, lambda_l2,
                min_data_in_leaf, min_sum_hessian, nan_mask=None,
                monotone=None, penalty=None, extra_bins=None,
                path_smooth=0.0, parent_output=0.0, mono_lo=0.0, mono_hi=0.0,
                mono_penalty_mult=None, gain_mult=None, use_smoothing=False,
                use_bounds=False, bounded=None):
    """Best split of one leaf from its stacked histograms ``hist``
    [3, F, B] (gradient, hessian, count). Returns one tensor
    ``[flat index, gain, raw gain, GL, HL, CL, default_left]`` in the dtype
    of ``hist`` (flat index = feature * B + bin; ``gain`` is the raw gain
    less the CEGB penalty, -inf when no bin is valid), so that a caller on
    the host needs a single read. The options are those of
    :func:`find_best_split`; ``mono_lo`` / ``mono_hi`` may be 0-dim tensors
    of the histograms' dtype, and ``bounded`` (a 0-dim bool tensor, with
    ``use_bounds``) selects between the bounded score and the closed form
    element by element, as a caller that passes bounds only where one of
    them is finite would (the fixed-shape grower; without smoothing the two
    forms round differently)."""
    _, F, B = hist.shape
    dt = hist.dtype
    dev = hist.device
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_inf = torch.full((), -torch.inf, dtype=dt, device=dev)
    l1, l2 = float(lambda_l1), float(lambda_l2)
    cum = prefix_sum(hist)
    tot = cum[:, :, -1:]
    bin_ids = torch.arange(B, device=dev)[None, :]
    in_range = bin_ids < (num_bins_per_feat[:, None] - 1)
    if extra_bins is not None:
        in_range = in_range & (bin_ids == extra_bins[:, None])

    def thr(g):
        return g if l1 == 0.0 else _threshold_l1(g, l1)

    def out_of(g, h, c):
        o = -thr(g) / (h + l2 + 1e-15)
        if use_smoothing:
            w = c / (c + path_smooth)
            o = o * w + (1.0 - w) * parent_output
        if use_bounds:
            o = torch.clamp(o, min=mono_lo, max=mono_hi)
        return o

    def score(s):
        if not (use_smoothing or use_bounds):
            t = thr(s[0])
            return t * t / (s[1] + l2 + 1e-15)
        # GetLeafGainGivenOutput: -(2 G w + (H + l2) w^2) at the (smoothed /
        # clamped) output; the closed form when unconstrained
        o = out_of(s[0], s[1], s[2])
        val = -(2.0 * s[0] * o + (s[1] + l2) * o * o)
        if bounded is not None and not use_smoothing:
            t = thr(s[0])
            val = torch.where(bounded, val, t * t / (s[1] + l2 + 1e-15))
        return val

    parent_score = score(tot)

    def gain_and_valid(left):
        right = tot - left
        gain = score(left) + score(right) - parent_score
        valid = (in_range
                 & (left[2] >= min_data_in_leaf)
                 & (right[2] >= min_data_in_leaf)
                 & (left[1] >= min_sum_hessian)
                 & (right[1] >= min_sum_hessian))
        if monotone is not None:
            # basic monotone feasibility (monotone_constraints.hpp): +1
            # needs left output <= right output, -1 the reverse
            lo = -thr(left[0]) / (left[1] + l2 + 1e-15)
            ro = -thr(right[0]) / (right[1] + l2 + 1e-15)
            mono = monotone[:, None]
            valid = valid & ~((mono > 0) & ~(lo <= ro)) \
                & ~((mono < 0) & ~(lo >= ro))
        if mono_penalty_mult is not None:
            gain = gain * mono_penalty_mult[:, None]
        if gain_mult is not None:
            # per-feature gain multipliers (feature_contri, config.h:505)
            gain = gain * gain_mult[:, None]
        return torch.where(valid, gain, neg_inf)

    gain = gain_and_valid(cum)  # NA bin (bin 0) on the LEFT
    if nan_mask is None:
        left = cum
        default_left = torch.ones((), dtype=dt, device=dev)
    else:
        # second pass: NA bin on the RIGHT (subtract it from every prefix)
        nm = nan_mask[:, None]
        left2 = cum - torch.where(nm, hist[:, :, :1], zero)
        gain2 = gain_and_valid(left2)
        gain2 = torch.where(nm & (left2[2] > 0), gain2, neg_inf)
        goes_left = gain >= gain2
        gain = torch.maximum(gain, gain2)
        left = torch.where(goes_left, cum, left2)
        default_left = goes_left.to(dt)
    # CEGB: the feature's cost comes off the gain before ranking
    # (cost_effective_gradient_boosting.hpp:66-84); the raw gain still
    # gates min_gain_to_split
    sel = gain if penalty is None else gain - penalty[:, None]
    # torch.argmax returns the FIRST maximal element, as jnp.argmax does;
    # index_select, not indexing by a 0-dim tensor (which reads it on the
    # host), so that the scan runs inside a CUDA graph
    flat = torch.argmax(sel.reshape(-1)).view(1)
    picked = torch.cat([sel[None], gain[None], left]).reshape(
        5, -1).index_select(1, flat)[:, 0]
    dl = (default_left.view(1) if default_left.dim() == 0
          else default_left.reshape(-1).index_select(0, flat))
    return torch.cat([flat.to(dt), picked, dl])


def find_best_split(hist_g, hist_h, hist_c, num_bins_per_feat,
                    lambda_l1, lambda_l2, min_data_in_leaf,
                    min_sum_hessian, min_gain_to_split, monotone=None,
                    penalty=None, nan_mask=None, extra_bins=None,
                    path_smooth=0.0, parent_output=0.0, mono_lo=0.0,
                    mono_hi=0.0, mono_penalty_mult=None, gain_mult=None,
                    use_smoothing=False, use_bounds=False):
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
    NA-bin two-pass). The LightGBM options, all tensors on the histograms'
    device:

    - ``monotone`` [F] -1 / 0 / +1: splits whose plain outputs break the
      direction are invalid;
    - ``penalty`` [F]: CEGB costs subtracted from the gain before ranking;
      the penalized gain must also be > 0;
    - ``extra_bins`` [F]: extra trees' one drawn candidate bin a feature
      (USE_RAND, config.h:368);
    - ``path_smooth`` / ``parent_output`` (``use_smoothing``): outputs shrink
      toward the parent's by n / (n + path_smooth), config.h:550;
    - ``mono_lo`` / ``mono_hi`` (``use_bounds``): the leaf's output bounds
      (the intermediate monotone method, ``max_delta_step``);
    - ``mono_penalty_mult`` / ``gain_mult`` [F]: gain multipliers (the
      monotone penalty, ``feature_contri``).

    Returns 0-dim tensors (feat, bin, gain, ok, GL, HL, CL, default_left),
    ``gain`` the penalized one.
    """
    hist = torch.stack([hist_g, hist_h, hist_c])
    B = hist.shape[2]
    out = _split_scan(hist, num_bins_per_feat, lambda_l1, lambda_l2,
                      min_data_in_leaf, min_sum_hessian, nan_mask, monotone,
                      penalty, extra_bins, path_smooth, parent_output,
                      mono_lo, mono_hi, mono_penalty_mult, gain_mult,
                      use_smoothing, use_bounds)
    flat = out[0].to(torch.int64)
    ok = out[2] > min_gain_to_split
    if penalty is not None:
        ok = ok & (out[1] > 0.0)
    return ((flat // B).to(torch.int32), (flat % B).to(torch.int32), out[1],
            ok, out[3], out[4], out[5], out[6] > 0)


def _cat_scan(hist, num_bins, lambda_l1, lambda_l2, min_data_in_leaf,
              min_sum_hessian, max_cat_threshold, penalty=None, cat_l2=0.0,
              cat_smooth=0.0, min_data_per_group=0.0, max_cat_to_onehot=0):
    """The categorical split scan over the histograms ``hist`` [3, Fc, B]
    of the categorical features only. Returns one tensor ``[flat, gain, raw
    gain, GL, HL, CL, order (B values)]``: ``flat`` indexes the candidates
    [3 (forward, reverse, one-hot), Fc, B]; the left set is the first
    ``flat % B + 1`` categories of ``order``. The ``min_data_per_group``
    scan reads the host once (counted in ``grow_tree.host_reads``)."""
    hg, hh, hc = hist
    _, Fc, B = hist.shape
    dt, dev = hist.dtype, hist.device
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_inf = torch.full((), -torch.inf, dtype=dt, device=dev)
    l1 = float(lambda_l1)
    bin_ids = torch.arange(B, device=dev)[None, :]
    in_range = bin_ids < num_bins[:, None]
    G, H, C = row_sum(torch.where(in_range, hist, zero))[:, :, None]

    def score(g, h, l2):
        t = g if l1 == 0.0 else _threshold_l1(g, l1)
        return t * t / (h + l2 + 1e-15)

    # one-hot candidates: left = one category
    l2 = float(lambda_l2)
    gain_oh = (score(hg, hh, l2) + score(G - hg, H - hh, l2)
               - score(G, H, l2))
    valid_oh = (in_range & (hc >= min_data_in_leaf)
                & ((C - hc) >= min_data_in_leaf)
                & (hh >= min_sum_hessian) & ((H - hh) >= min_sum_hessian))
    use_onehot = (num_bins <= max_cat_to_onehot)[:, None]
    gain_oh = torch.where(valid_oh & use_onehot, gain_oh, neg_inf)

    # many-vs-many: categories sorted by G / (H + cat_smooth), both
    # directions of the eligible prefix (jnp.argsort is stable)
    l2m = l2 + float(cat_l2)
    eligible = in_range & (hc >= max(float(cat_smooth), 1.0))
    inf = torch.full((), torch.inf, dtype=dt, device=dev)
    sort_key = torch.where(eligible, hg / (hh + cat_smooth + 1e-15), inf)
    order_fwd = torch.argsort(sort_key, dim=1, stable=True)
    used_bin = eligible.sum(dim=1)
    idx_rev = torch.clamp(used_bin[:, None] - 1 - bin_ids, 0, B - 1)
    order_rev = torch.gather(order_fwd, 1, idx_rev)
    max_num_cat = torch.clamp((used_bin + 1) // 2, max=int(max_cat_threshold))
    cut = bin_ids < torch.minimum(max_num_cat, used_bin)[:, None]

    def sums(order):
        s = torch.gather(hist, 2, order[None].expand(3, Fc, B))
        return prefix_sum(s), s[2]

    (cum_f, c_f), (cum_r, c_r) = sums(order_fwd), sums(order_rev)
    tot = torch.stack([G, H, C])                                  # [3, Fc, 1]

    def base_ok(cum):
        right = tot - cum
        return ((cum[2] >= min_data_in_leaf) & (cum[1] >= min_sum_hessian)
                & (right[2] >= min_data_in_leaf)
                & (right[1] >= min_sum_hessian) & cut), right

    ok_f, right_f = base_ok(cum_f)
    ok_r, right_r = base_ok(cum_r)
    if min_data_per_group > 0:
        # the group scan over the forward and the reverse rows at once
        bound = group_boundaries(
            torch.cat([c_f, c_r]),
            torch.cat([ok_f & (right_f[2] >= min_data_per_group),
                       ok_r & (right_r[2] >= min_data_per_group)]),
            min_data_per_group)
        ok_f, ok_r = bound[:Fc], bound[Fc:]

    def gain_of(cum, right, ok):
        gain = (score(cum[0], cum[1], l2m) + score(right[0], right[1], l2m)
                - score(G, H, l2m))
        return torch.where(ok & ~use_onehot, gain, neg_inf)

    gain_f = gain_of(cum_f, right_f, ok_f)
    gain_r = gain_of(cum_r, right_r, ok_r)
    # one-hot as (the winning category first, k = 0)
    oh_best = torch.argmax(gain_oh, dim=1)
    oh_gain = torch.gather(gain_oh, 1, oh_best[:, None])[:, 0]
    order_oh = torch.argsort(torch.where(bin_ids == oh_best[:, None], -1,
                                         bin_ids), dim=1, stable=True)
    gain_oh_mat = torch.where(bin_ids == 0, oh_gain[:, None], neg_inf)
    cum_oh, _ = sums(order_oh)

    raw = torch.stack([gain_f, gain_r, gain_oh_mat])          # [3, Fc, B]
    sel = raw if penalty is None else raw - penalty[None, :, None]
    # index_select, not indexing by a 0-dim tensor (a host read), so that
    # the scan runs inside a CUDA graph
    flat = torch.argmax(sel.reshape(-1)).view(1)
    cums = torch.stack([cum_f, cum_r, cum_oh])                 # [3, 3, Fc, B]
    picked = torch.cat([sel[None], raw[None], cums.permute(1, 0, 2, 3)]
                       ).reshape(5, -1).index_select(1, flat)[:, 0]
    order = torch.stack([order_fwd, order_rev, order_oh]).reshape(
        3 * Fc, B).index_select(0, flat // B)[0]
    return torch.cat([flat.to(dt), picked, order.to(dt)])


def find_best_split_categorical(hist_g, hist_h, hist_c, num_bins_per_feat,
                                cat_feature_mask, lambda_l1, lambda_l2,
                                min_data_in_leaf, min_sum_hessian,
                                min_gain_to_split, max_cat_threshold,
                                penalty=None, cat_l2=0.0, cat_smooth=0.0,
                                min_data_per_group=0.0, max_cat_to_onehot=0):
    """Best categorical split (``feature_histogram.hpp``
    FindBestThresholdCategoricalInner):

    - features with <= ``max_cat_to_onehot`` bins use ONE-HOT (one-vs-rest)
      splits with plain lambda_l2;
    - otherwise 'many-vs-many': categories with count >= ``cat_smooth`` are
      sorted by G / (H + cat_smooth) and BOTH prefix directions are scanned
      with l2 + cat_l2, left-set size capped at
      min(max_cat_threshold, (used_bin + 1) / 2), and split positions gated
      by the ``min_data_per_group`` group accumulation.

    ``cat_feature_mask`` [F] bool (host or device). Returns (feat, k, gain,
    ok, left_cats, GL, HL, CL): the left set ``left_cats`` is the first
    ``k + 1`` categories of the winning order (numpy).
    """
    cat_idx = np.flatnonzero(np.asarray(
        cat_feature_mask.cpu() if torch.is_tensor(cat_feature_mask)
        else cat_feature_mask))
    idx = torch.as_tensor(cat_idx, device=hist_g.device)
    hist = torch.stack([hist_g, hist_h, hist_c])[:, idx]
    out = _cat_scan(hist, num_bins_per_feat[idx], lambda_l1, lambda_l2,
                    min_data_in_leaf, min_sum_hessian, max_cat_threshold,
                    None if penalty is None else penalty[idx], cat_l2,
                    cat_smooth, min_data_per_group, max_cat_to_onehot)
    vals = out.to(torch.float64).tolist()
    B = hist.shape[2]
    flat = int(vals[0])
    k = flat % B
    ok = vals[2] > min_gain_to_split and (penalty is None or vals[1] > 0.0)
    left = np.asarray(vals[6:6 + k + 1], np.int64)
    return (int(cat_idx[(flat // B) % len(cat_idx)]), k, vals[1], ok, left,
            vals[3], vals[4], vals[5])


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


def partition_rows_categorical(binned, row_leaf, leaf_id, feature, cat_mask,
                               left_id, right_id):
    """Categorical split: rows of ``leaf_id`` whose category bin is in
    ``cat_mask`` [B] (bool, on the rows' device) go to ``left_id``."""
    in_leaf = row_leaf == leaf_id
    go_left = cat_mask[binned[:, feature].long()]
    new_leaf = go_left.to(row_leaf.dtype) * (left_id - right_id) + right_id
    return torch.where(in_leaf, new_leaf, row_leaf)


@dataclass
class Tree:
    """Grown tree in flat-array form (reference ``Tree``, ``io/tree.cpp``).

    Internal nodes: split_feature/threshold(+bin); leaves: leaf_value.
    ``left/right`` of a leaf point to itself, so a traversal of fixed length
    reaches a fixed point. The fields (and ``to_dict``) are those of the JAX
    package's ``Tree``: categorical splits carry their left set in
    ``cat_mask``, linear leaves their model in ``lin_features`` /
    ``lin_coefs`` (constant in ``leaf_value``).
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

    def has_categorical(self) -> bool:
        return (self.is_categorical is not None
                and bool(np.any(self.is_categorical)))

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
        if self.lin_coefs is not None:
            self.lin_coefs = self.lin_coefs * rate
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
    # LightGBM tail (config.h): leaf-path smoothing, extremely-randomized
    # splits, per-node feature sampling, categorical regularization,
    # monotone method/penalty
    path_smooth: float = 0.0
    extra_trees: bool = False
    feature_fraction_bynode: float = 1.0
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: float = 100.0
    max_cat_to_onehot: int = 4
    # cap on |leaf output| (config.h:389 max_delta_step; <= 0 = unlimited)
    max_delta_step: float = 0.0
    # per-feature split-gain multipliers (config.h:505 feature_contri)
    feature_contri: Optional[np.ndarray] = None


class CEGBState:
    """Cost-effective gradient boosting (CEGB) penalties and usage state.

    The JAX package's redesign of ``CostEfficientGradientBoosting``
    (``treelearner/cost_effective_gradient_boosting.hpp:22-156``): a dense
    per-feature penalty vector subtracted inside the split scan, the leaves
    re-scored from their cached histograms when a coupled feature first
    enters the model. The lazy penalty's per-row usage matrix ``[n, F]``
    and the leaf's fresh-row counts stay on ``device``; the penalty vector
    is computed there, so a leaf's scan needs no read of its own. Usage
    persists across trees.
    """

    def __init__(self, num_features: int, num_data: int,
                 tradeoff: float = 1.0, penalty_split: float = 0.0,
                 penalty_feature_coupled=None, penalty_feature_lazy=None,
                 device="cpu"):
        self.tradeoff = float(tradeoff)
        self.penalty_split = float(penalty_split)
        self.coupled = (None if penalty_feature_coupled is None
                        else np.asarray(penalty_feature_coupled, np.float64))
        self.lazy = (None if penalty_feature_lazy is None
                     else np.asarray(penalty_feature_lazy, np.float64))
        for name, arr in (("cegb_penalty_feature_coupled", self.coupled),
                          ("cegb_penalty_feature_lazy", self.lazy)):
            if arr is not None and arr.shape[0] != num_features:
                raise ValueError(
                    f"{name} should be the same size as feature number")
        self.device = torch.device(device)
        self.feature_used_in_split = np.zeros(num_features, bool)
        # [n, F]: whether row i already acquired feature f
        self.feature_used_in_data = (
            torch.zeros((num_data, num_features), dtype=torch.bool,
                        device=self.device)
            if self.lazy is not None else None)

    @staticmethod
    def from_params(p: dict, num_features: int, num_data: int, device):
        """From a LightGBM-style params dict; None when disabled
        (``CostEfficientGradientBoosting::IsEnable``)."""
        tradeoff = float(p.get("cegb_tradeoff", 1.0))
        penalty_split = float(p.get("cegb_penalty_split", 0.0))
        coupled = p.get("cegb_penalty_feature_coupled", None)
        lazy = p.get("cegb_penalty_feature_lazy", None)
        if (tradeoff >= 1.0 and penalty_split <= 0.0 and coupled is None
                and lazy is None):
            return None
        return CEGBState(num_features, num_data, tradeoff, penalty_split,
                         coupled, lazy, device)

    def penalty_vector(self, leaf_mask, dtype) -> torch.Tensor:
        """tradeoff * (penalty_split * n_leaf + coupled[new features] +
        lazy costs of the leaf's rows that lack the feature), per feature
        (cost_effective_gradient_boosting.hpp:66-84), on the device."""
        F = len(self.feature_used_in_split)
        cnt = leaf_mask.sum().to(dtype)
        pen = (self.tradeoff * self.penalty_split) * cnt.expand(F)
        if self.coupled is not None:
            pen = pen + torch.as_tensor(
                self.tradeoff * np.where(self.feature_used_in_split, 0.0,
                                         self.coupled),
                dtype=dtype, device=leaf_mask.device)
        if self.lazy is not None:
            fresh = (leaf_mask[:, None]
                     & ~self.feature_used_in_data).sum(dim=0).to(dtype)
            pen = pen + torch.as_tensor(self.tradeoff * self.lazy,
                                        dtype=dtype,
                                        device=leaf_mask.device) * fresh
        return pen

    def mark_split(self, leaf_mask, feature: int) -> bool:
        """Record a chosen split; True if other leaves must be re-scored
        (a feature newly coupled-penalized, hpp:93-109)."""
        rescore = (self.coupled is not None
                   and not self.feature_used_in_split[feature])
        self.feature_used_in_split[feature] = True
        if self.lazy is not None:
            self.feature_used_in_data[:, feature] |= leaf_mask
        return rescore


def _monotone_factor(penalty: float, depth: int) -> float:
    """The gain multiplier of a monotone feature's split at a node of
    ``depth`` (root 1; ComputeMonotoneSplitGainPenalty)."""
    d = float(depth) - 1.0
    if penalty >= d + 1.0:
        return 1e-15
    if penalty <= 1.0:
        return 1.0 - penalty / (2.0 ** d) + 1e-15
    return 1.0 - 2.0 ** (penalty - 1.0 - d) + 1e-15


def grow_tree(binned: torch.Tensor, num_bins_per_feat: torch.Tensor,
              grad: torch.Tensor, hess: torch.Tensor, max_num_bins: int,
              params: GrowerParams,
              row_mask: Optional[torch.Tensor] = None,
              nan_mask: Optional[np.ndarray] = None,
              binned_t: Optional[torch.Tensor] = None,
              rng: Optional[np.random.Generator] = None,
              categorical_mask: Optional[np.ndarray] = None,
              max_cat_threshold: int = 32,
              monotone_constraints: Optional[np.ndarray] = None,
              forced_splits: Optional[dict] = None,
              cegb: Optional[CEGBState] = None, efb=None,
              interaction_constraints=None,
              num_bins_host: Optional[np.ndarray] = None):
    """Grow one tree leaf-wise (best-first), LightGBM-style.

    ``row_mask`` [n] bool (bagging) keeps the rows outside it out of every
    histogram; the partition still moves them, so ``row_leaf`` places every
    row. ``nan_mask`` [F] marks features whose bin 0 is an exclusive NA bin
    (default-direction learning). ``binned_t`` is the features-major uint8
    copy of ``binned`` (``Dataset.binned_t``) for the histogram kernel and
    the partition; ``efb`` (``Dataset.efb``) moves the histograms onto the
    bundle panel, expanded to ``[F, B]`` for the scans. ``categorical_mask``
    [F] marks categorical features (sorted-subset splits).
    ``monotone_constraints`` [F] (-1 / 0 / +1) under
    ``params.monotone_constraints_method``; ``interaction_constraints``
    lists groups of features a path may combine; ``forced_splits`` is a
    tree of ``{"feature", "threshold_bin", "left", "right"}`` applied root
    first; ``cegb`` a :class:`CEGBState`.

    The draws come from ``rng`` as the JAX package's host grower takes
    them: in every leaf's scan (and every re-scan after a CEGB refund) the
    ``feature_fraction_bynode`` features (``ceil(fraction * F)`` without
    replacement), then extra trees' bins (``rng.integers(0, max(nb - 1,
    1))`` over ``num_bins_host``, the host copy of ``num_bins_per_feat``,
    read from the device once if not given). Returns (Tree, row_leaf_node
    [n] int32 node-id per row).
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
    if efb is not None:
        hist_binned, hist_panel = efb.binned_hist, efb.binned_hist_t
        hist_B = efb.max_bins_hist
    else:
        hist_binned, hist_panel, hist_B = binned, binned_t, max_num_bins
    has_cat = (categorical_mask is not None
               and bool(np.any(categorical_mask)))
    if has_cat:
        cat_idx = np.flatnonzero(categorical_mask)
        cat_idx_t = torch.as_tensor(cat_idx, device=device)
        num_bins_numerical = torch.where(
            torch.as_tensor(np.asarray(categorical_mask, bool),
                            device=device),
            torch.zeros_like(num_bins_per_feat), num_bins_per_feat)
    else:
        num_bins_numerical = num_bins_per_feat
    max_nodes = 2 * params.num_leaves - 1
    feature = np.zeros(max_nodes, np.int32)
    threshold_bin = np.zeros(max_nodes, np.int32)
    is_categorical = np.zeros(max_nodes, bool)
    cat_masks = np.zeros((max_nodes, max_num_bins), bool)
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
    bounds = {0: (-np.inf, np.inf)}  # monotone output bounds per node
    parent_out = {0: 0.0}            # node outputs (path_smooth chain)
    path_feats = {0: frozenset()}    # features used on the path
    if rng is None:
        rng = np.random.default_rng(0)
    if params.extra_trees and num_bins_host is None:
        num_bins_host = num_bins_per_feat.cpu().numpy()
        grow_tree.host_reads += 1
    ic_groups = ([frozenset(int(f) for f in g)
                  for g in interaction_constraints]
                 if interaction_constraints else None)
    l1 = float(params.lambda_l1)
    l2 = float(params.lambda_l2)
    min_data = float(params.min_data_in_leaf)
    min_hess = float(params.min_sum_hessian_in_leaf)
    min_gain = float(params.min_gain_to_split)
    ffb = float(params.feature_fraction_bynode)
    mds = float(params.max_delta_step)
    ps = float(params.path_smooth)
    mono_t = (None if monotone_constraints is None
              else torch.as_tensor(np.asarray(monotone_constraints, np.int32),
                                   device=device))
    hdt = grad.dtype
    contri_t = (None if params.feature_contri is None
                else torch.as_tensor(np.asarray(params.feature_contri,
                                                np.float64), dtype=hdt,
                                     device=device))

    def allowed_features(used: frozenset) -> np.ndarray:
        """Features usable at a leaf under interaction constraints: the
        union of the groups that hold every feature used on the branch
        (serial_tree_learner.cpp GetAllowedFeatures)."""
        allowed = np.zeros(F, bool)
        for g in ic_groups:
            if used <= g:
                for f in g:
                    if f < F:
                        allowed[f] = True
        return allowed

    def leaf_output(g_sum, h_sum, cnt=None, parent=0.0):
        t = np.sign(g_sum) * max(abs(g_sum) - l1, 0.0)
        raw = float(-t / (h_sum + l2 + 1e-15))
        if ps > 0.0 and cnt is not None:
            w = cnt / (cnt + ps)
            raw = raw * w + (1.0 - w) * parent
        if mds > 0.0:
            # max_delta_step (config.h:389): |output| capped
            raw = min(max(raw, -mds), mds)
        return raw

    # the histogram kernel's fixed-point scales, once for the tree (a read)
    scales = histogram_scales(grad, hess, hist_B)
    if scales is not None:
        grow_tree.host_reads += 1

    def leaf_mask(leaf_id):
        mask = row_leaf == leaf_id
        return mask if row_mask is None else mask & row_mask

    def leaf_hist(leaf_id):
        with timed("grow_tree: histogram", sync=True):
            return torch.stack(build_histogram(
                hist_binned, grad, hess, leaf_mask(leaf_id), hist_B,
                binned_t=hist_panel, scales=scales))

    # per-leaf cached state: stacked histograms [3, cols, B], best split
    # (kind, feature, bin, gain, ok, GL, HL, CL, left categories,
    # default_left), totals (G, H, count)
    hist_cache: dict = {}
    best_cache: dict = {}
    stats_cache: dict = {}

    def compute_leaf(leaf_id, hist=None):
        if hist is None:
            hist = leaf_hist(leaf_id)
        hist_cache[leaf_id] = hist
        num_bins_leaf = num_bins_numerical
        num_bins_cat = num_bins_per_feat
        # per-node feature restrictions: interaction constraints, then
        # feature_fraction_bynode (config.h:359)
        node_allowed = None
        if ic_groups is not None:
            node_allowed = allowed_features(path_feats.get(leaf_id,
                                                           frozenset()))
        if ffb < 1.0:
            k = max(1, int(np.ceil(ffb * F)))
            samp = np.zeros(F, bool)
            samp[rng.choice(F, size=k, replace=False)] = True
            node_allowed = (samp if node_allowed is None
                            else node_allowed & samp)
        if node_allowed is not None:
            allowed = torch.as_tensor(node_allowed, device=device)
            num_bins_leaf = torch.where(allowed, num_bins_leaf,
                                        torch.zeros_like(num_bins_leaf))
            num_bins_cat = torch.where(allowed, num_bins_cat,
                                       torch.zeros_like(num_bins_cat))
        opts = {}
        if params.extra_trees:
            # extremely randomized trees: ONE drawn candidate bin a feature
            # (USE_RAND, config.h extra_trees)
            opts["extra_bins"] = torch.as_tensor(
                rng.integers(0, np.maximum(num_bins_host - 1, 1)),
                device=device)
        if contri_t is not None:
            opts["gain_mult"] = contri_t
        if mono_t is not None:
            opts["monotone"] = mono_t
            if params.monotone_penalty > 0.0:
                factor = _monotone_factor(params.monotone_penalty,
                                          depth[leaf_id])
                opts["mono_penalty_mult"] = torch.where(
                    mono_t != 0, torch.full((), factor, dtype=hdt,
                                            device=device),
                    torch.ones((), dtype=hdt, device=device))
            if params.monotone_constraints_method != "basic":
                lo_b, hi_b = bounds.get(leaf_id, (-np.inf, np.inf))
                if np.isfinite(lo_b) or np.isfinite(hi_b):
                    opts.update(mono_lo=lo_b, mono_hi=hi_b, use_bounds=True)
        if mds > 0.0:
            # outputs clamped to +-max_delta_step in the gains (GetSplitGains
            # USE_MAX_OUTPUT), inside any monotone bounds already set
            opts.update(mono_lo=max(opts.get("mono_lo", -np.inf), -mds),
                        mono_hi=min(opts.get("mono_hi", np.inf), mds),
                        use_bounds=True)
        if ps > 0.0:
            opts.update(path_smooth=ps,
                        parent_output=parent_out.get(leaf_id, 0.0),
                        use_smoothing=True)
        with timed("grow_tree: split scan + host read", sync=True):
            hist_f = hist if efb is None else expand_bundle_hist(
                hist, efb.src_col, efb.src_bin, efb.default_bin,
                efb.fix_mask)
            penalty = (None if cegb is None
                       else cegb.penalty_vector(leaf_mask(leaf_id), hdt))
            parts = [hist.sum(dim=(1, 2)),
                     _split_scan(hist_f, num_bins_leaf, l1, l2, min_data,
                                 min_hess, nan_mask_t, penalty=penalty,
                                 **opts)]
            if has_cat:
                parts.append(_cat_scan(
                    hist_f[:, cat_idx_t], num_bins_cat[cat_idx_t], l1, l2,
                    min_data, min_hess, max_cat_threshold,
                    None if penalty is None else penalty[cat_idx_t],
                    params.cat_l2, params.cat_smooth,
                    params.min_data_per_group, params.max_cat_to_onehot))
            # every row lands in one bin per column, so the all-column sum
            # is cols * (per-leaf total) — normalized to the leaf totals
            vals = torch.cat(parts).to(torch.float64).tolist()
        grow_tree.host_reads += 1
        cols = hist.shape[1]
        stats_cache[leaf_id] = (vals[0] / cols, vals[1] / cols,
                                vals[2] / cols)
        flat, gain, raw, gl, hl, cl, dl = vals[3:10]
        flat = int(flat)
        ok = raw > min_gain and (penalty is None or gain > 0.0)
        best = ("num", flat // max_num_bins, flat % max_num_bins, gain, ok,
                gl, hl, cl, None, dl > 0)
        if has_cat:
            cflat, cgain, craw, cgl, chl, ccl = vals[10:16]
            cflat = int(cflat)
            k = cflat % max_num_bins
            okc = craw > min_gain and (penalty is None or cgain > 0.0)
            if okc and (not best[4] or cgain > best[3]):
                f_c = int(cat_idx[(cflat // max_num_bins) % len(cat_idx)])
                left_cats = np.asarray(vals[16:16 + k + 1], np.int64)
                best = ("cat", f_c, k, cgain, True, cgl, chl, ccl,
                        left_cats, True)
        best_cache[leaf_id] = best

    compute_leaf(0)
    num_leaves = 1
    next_node = 1
    max_depth_used = 1

    def apply_numeric_split(leaf_id, f_b, b_b):
        """Split ``leaf_id`` at (feature, bin) unconditionally: a forced
        split (``forcedsplits_filename``, config.h:512), both children's
        histograms built, as the JAX package builds them."""
        nonlocal num_leaves, next_node, max_depth_used, row_leaf
        if cegb is not None:
            cegb.mark_split(leaf_mask(leaf_id), f_b)
        left_id, right_id = next_node, next_node + 1
        next_node += 2
        with timed("grow_tree: partition", sync=True):
            row_leaf = partition_rows(part_src, row_leaf, leaf_id, f_b, b_b,
                                      left_id, right_id)
        is_leaf[leaf_id] = False
        feature[leaf_id] = f_b
        threshold_bin[leaf_id] = b_b
        left[leaf_id] = left_id
        right[leaf_id] = right_id
        is_leaf[left_id] = is_leaf[right_id] = True
        bounds[left_id] = bounds[right_id] = bounds.get(
            leaf_id, (-np.inf, np.inf))
        parent_out[left_id] = parent_out[right_id] = parent_out.get(
            leaf_id, 0.0)
        path_feats[left_id] = path_feats[right_id] = \
            path_feats.get(leaf_id, frozenset()) | {int(f_b)}
        depth[left_id] = depth[right_id] = depth[leaf_id] + 1
        max_depth_used = max(max_depth_used, int(depth[left_id]))
        num_leaves += 1
        hist_cache.pop(leaf_id, None)
        best_cache.pop(leaf_id, None)
        hist_left, hist_right = leaf_hist(left_id), leaf_hist(right_id)
        compute_leaf(left_id, hist_left)
        compute_leaf(right_id, hist_right)
        return left_id, right_id

    def apply_forced(node_json, leaf_id):
        if num_leaves >= params.num_leaves:
            return
        lid, rid = apply_numeric_split(leaf_id, int(node_json["feature"]),
                                       int(node_json["threshold_bin"]))
        if isinstance(node_json.get("left"), dict):
            apply_forced(node_json["left"], lid)
        if isinstance(node_json.get("right"), dict):
            apply_forced(node_json["right"], rid)

    if forced_splits:
        apply_forced(forced_splits, 0)

    while num_leaves < params.num_leaves:
        # pick splittable leaf with max gain
        best_leaf, best = None, None
        for leaf_id, b in best_cache.items():
            if not b[4]:
                continue
            if params.max_depth > 0 and depth[leaf_id] >= params.max_depth:
                continue
            if best is None or b[3] > best[3]:
                best_leaf, best = leaf_id, b
        if best_leaf is None:
            break
        kind, f_b, b_b, gain, _, gl, hl, cl, left_cats, dflt_left = best
        cnt = stats_cache[best_leaf][2]
        if cegb is not None:
            # usage marked on ALL the parent's rows (UpdateLeafBestSplits
            # runs before the partition, serial_tree_learner.cpp:571-575)
            if cegb.mark_split(leaf_mask(best_leaf), f_b):
                # the coupled penalty of f_b went: every other leaf's best
                # split re-ranked from its cached histogram (the JAX
                # package's replacement of the per-(leaf, feature) refund)
                for other in [k for k in list(best_cache)
                              if k != best_leaf and k in hist_cache]:
                    compute_leaf(other, hist_cache[other])
        left_id = next_node
        right_id = next_node + 1
        next_node += 2
        with timed("grow_tree: partition", sync=True):
            if kind == "cat":
                mask_b = np.zeros(max_num_bins, bool)
                mask_b[left_cats] = True
                row_leaf = partition_rows_categorical(
                    part_src, row_leaf, best_leaf, f_b,
                    torch.as_tensor(mask_b, device=device), left_id,
                    right_id)
                is_categorical[best_leaf] = True
                cat_masks[best_leaf] = mask_b
            else:
                miss_right = bool(nan_mask is not None and nan_mask[f_b]
                                  and not dflt_left)
                row_leaf = partition_rows(part_src, row_leaf, best_leaf,
                                          f_b, b_b, left_id, right_id,
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
        lo, hi = bounds.get(best_leaf, (-np.inf, np.inf))
        bounds[left_id] = bounds[right_id] = (lo, hi)
        g_sum_p, h_sum_p, cnt_p = stats_cache[best_leaf]
        p_out = parent_out.get(best_leaf, 0.0)
        l_out = leaf_output(gl, hl, cl, p_out)
        r_out = leaf_output(g_sum_p - gl, h_sum_p - hl, cnt_p - cl, p_out)
        parent_out[left_id] = min(max(l_out, lo), hi)
        parent_out[right_id] = min(max(r_out, lo), hi)
        path_feats[left_id] = path_feats[right_id] = \
            path_feats.get(best_leaf, frozenset()) | {int(f_b)}
        if (monotone_constraints is not None and kind == "num"
                and monotone_constraints[f_b] != 0):
            l_c = min(max(l_out, lo), hi)
            r_c = min(max(r_out, lo), hi)
            inc = monotone_constraints[f_b] > 0
            if params.monotone_constraints_method in ("intermediate",
                                                      "advanced"):
                # IntermediateLeafConstraints::UpdateConstraintsWithOutputs:
                # the children bounded by the sibling's actual output
                # ('advanced' re-tightens other leaves too; the JAX package
                # approximates it by the same bounds)
                if inc:
                    bounds[left_id] = (lo, min(hi, r_c))
                    bounds[right_id] = (max(lo, l_c), hi)
                else:
                    bounds[left_id] = (max(lo, r_c), hi)
                    bounds[right_id] = (lo, min(hi, l_c))
            else:
                mid = 0.5 * (l_c + r_c)
                if inc:
                    bounds[left_id] = (lo, min(hi, mid))
                    bounds[right_id] = (max(lo, mid), hi)
                else:
                    bounds[left_id] = (max(lo, mid), hi)
                    bounds[right_id] = (lo, min(hi, mid))
        depth[left_id] = depth[right_id] = depth[best_leaf] + 1
        max_depth_used = max(max_depth_used, int(depth[left_id]))
        num_leaves += 1
        # child histograms: smaller side direct, sibling by subtraction
        parent_hist = hist_cache.pop(best_leaf)
        best_cache.pop(best_leaf)
        if cl <= cnt / 2:
            hist_left = leaf_hist(left_id)
            hist_right = parent_hist - hist_left
        else:
            hist_right = leaf_hist(right_id)
            hist_left = parent_hist - hist_right
        compute_leaf(left_id, hist_left)
        compute_leaf(right_id, hist_right)

    # leaf values (path-smoothed, clipped to the monotone bounds)
    node_count = np.zeros(max_nodes, np.float64)
    for node_id, (g_sum, h_sum, cnt) in stats_cache.items():
        node_count[node_id] = cnt
        if not is_leaf[node_id]:
            continue
        if ps > 0.0 and node_id != 0:
            v = parent_out.get(node_id, leaf_output(g_sum, h_sum))
        else:
            v = leaf_output(g_sum, h_sum, cnt if ps > 0.0 else None, 0.0)
        if monotone_constraints is not None:
            lo, hi = bounds.get(node_id, (-np.inf, np.inf))
            v = min(max(v, lo), hi)
        leaf_value[node_id] = v
    tree = Tree(split_feature=feature, threshold=np.zeros(max_nodes),
                threshold_bin=threshold_bin, left=left, right=right,
                leaf_value=leaf_value, is_leaf=is_leaf, node_count=node_count,
                is_categorical=is_categorical, cat_mask=cat_masks,
                split_gain=split_gain_arr, default_left=default_left_arr,
                num_leaves=num_leaves, max_depth_used=max_depth_used)
    return tree, row_leaf


grow_tree.host_reads = 0


# ---------------------------------------------------------------------------
# the fixed-shape grower: one tree with no host read
# ---------------------------------------------------------------------------

# the options the fixed-shape grower does not take yet (ROADMAP.md Queue A,
# item 10b); the host grower serves them
_FIXED_TODO = "ROADMAP.md Queue A, item 10b"


def fixed_grower_gaps(params: GrowerParams, cegb=None) -> list:
    """The options of a tree that the fixed-shape grower does not cover:
    CEGB, extra trees, ``feature_fraction_bynode``. Empty when
    :func:`grow_tree_fast` grows the tree (categorical features, monotone
    and interaction constraints and forced splits included)."""
    gaps = []
    if cegb is not None:
        gaps.append("CEGB")
    if params.extra_trees:
        gaps.append("extra_trees")
    if params.feature_fraction_bynode < 1.0:
        gaps.append("feature_fraction_bynode")
    return gaps


def flatten_forced_splits(forced: Optional[dict], num_leaves: int) -> tuple:
    """A forced-splits tree (bin-resolved, ``Booster._resolve_forced``) as
    the fixed-shape grower's static prefix of (leaf id, feature, bin), root
    first, in the host grower's order (``apply_forced``): the leaf ids are
    the node ids its splits create, and the prefix stops where the tree
    would reach ``num_leaves`` (the JAX package's
    ``flatten_forced_splits``)."""
    if not forced:
        return ()
    ops = []
    counter = [1]

    def walk(node, leaf_id):
        if len(ops) + 1 >= num_leaves:
            return
        lid, rid = counter[0], counter[0] + 1
        counter[0] += 2
        ops.append((int(leaf_id), int(node["feature"]),
                    int(node["threshold_bin"])))
        if isinstance(node.get("left"), dict):
            walk(node["left"], lid)
        if isinstance(node.get("right"), dict):
            walk(node["right"], rid)

    walk(forced, 0)
    return tuple(ops)


def _grow_tree_fixed(grad, hess, row_mask, num_bins_per_feat, c):
    """Grow one tree leaf-wise at fixed shapes, every step on the device of
    ``grad``, no value read into Python: the port of the JAX package's
    ``tree._grow_tree_jit`` (its ``lax.while_loop`` becomes exactly
    ``num_leaves - 1`` steps, a step with no admissible split leaving every
    array as it was).

    ``c`` (:class:`FixedGrower`) holds the Dataset's tensors and the static
    options. Node arrays are ``[M]``, M = 2 num_leaves - 1; node ids are
    those of the host grower (step k creates nodes 2k + 1 and 2k + 2, since
    steps that split come first). The forced splits (``c.forced_ops``) are
    the first steps, unconditionally, as the host grower's
    ``apply_numeric_split``: both children's histograms built, their
    outputs and bounds the parent's, split gain 0, missing values left.
    Every other step takes the leaf with the largest admissible gain (the
    first on ties, as the host grower's scan of its leaves in creation
    order), partitions every row of it (also rows outside ``row_mask``, as
    the host grower; a categorical split through its left set), builds the
    smaller child's histogram and subtracts it from the parent's, and scores
    both children with the host grower's ``_split_scan`` and ``_cat_scan``
    (categorical when it is admissible and the numeric split is not or
    gains more, as ``compute_leaf``); the totals, the children's outputs,
    the monotone bounds (per node, float64) and the leaf values are the host
    grower's float64 formulas. So on the same gradients both growers give
    the same tree to the last bit, on the card too. Histogram launches: one
    for the root, two a forced split and one a step, whether the step
    splits or not (its child is then empty).

    Returns a dict of tensors: feature, thresh, left, right (int32 [M]),
    leaf_value, cnt, sgain (float64 [M]), is_leaf, dleft, iscat (bool [M]),
    catmask (bool [M, B]), depth (int32 [M]), num_leaves (int32 []),
    row_leaf (int32 [n]).
    """
    dev, dt = grad.device, grad.dtype
    f64, i32 = torch.float64, torch.int32
    L = c.num_leaves
    M = 2 * L - 1
    B = c.max_num_bins
    has_cat = c.cat_idx is not None
    mono = c.mono is not None
    scales = (fixed_point_scales_device(grad, hess) if c.on_kernel
              else None)

    def hist_of(mask):
        return torch.stack(build_histogram(
            c.hist_binned, grad, hess, mask, c.hist_B, binned_t=c.hist_panel,
            scales=scales))

    def out_of(g, h, cnt, parent):
        # the host grower's leaf_output, in float64 on the device
        t = torch.sign(g) * torch.clamp(torch.abs(g) - c.l1, min=0.0)
        raw = -t / (h + c.l2 + 1e-15)
        if c.ps > 0.0 and cnt is not None:
            w = cnt / (cnt + c.ps)
            raw = raw * w + (1.0 - w) * parent
        if c.mds > 0.0:
            raw = torch.clamp(raw, min=-c.mds, max=c.mds)
        return raw

    nb_num = (torch.where(c.cat_mask, torch.zeros_like(num_bins_per_feat),
                          num_bins_per_feat) if has_cat
              else num_bins_per_feat)
    zero_nb = torch.zeros_like(num_bins_per_feat)
    one_dt = torch.ones((), dtype=dt, device=dev)
    bin_ids = torch.arange(B, device=dev)

    def eval_leaf(hist, parent_out, lo, hi, depth, used):
        """(totals float64 [3], best split [7] in the histograms' dtype,
        (categorical flag, left set [B]) or None) of a leaf, as the host
        grower's compute_leaf."""
        hist_f = hist if c.efb_maps is None else expand_bundle_hist(
            hist, *c.efb_maps)
        nb_n, nb_c = nb_num, num_bins_per_feat
        if c.ic_groups is not None:
            # the union of the groups that hold every feature of the path
            sub = (c.ic_groups | ~used[None, :]).all(dim=1)
            allowed = (c.ic_groups & sub[:, None]).any(dim=0)
            nb_n = torch.where(allowed, nb_n, zero_nb)
            nb_c = torch.where(allowed, nb_c, zero_nb)
        opts = {}
        if c.contri is not None:
            opts["gain_mult"] = c.contri
        lo_e = hi_e = bounded = None
        if mono:
            opts["monotone"] = c.mono
            if c.mono_factor is not None:
                opts["mono_penalty_mult"] = torch.where(
                    c.mono != 0,
                    c.mono_factor.index_select(0, depth.view(1).long()),
                    one_dt)
            if c.mono_bounds:
                # the host grower passes the bounds only when one is finite
                lo_e, hi_e = lo, hi
                bounded = torch.isfinite(lo) | torch.isfinite(hi)
        if c.mds > 0.0:
            if lo_e is None:
                lo_e, hi_e = -c.mds, c.mds
            else:
                lo_e = torch.clamp(lo_e, min=-c.mds)
                hi_e = torch.clamp(hi_e, max=c.mds)
                bounded = None
        if lo_e is not None:
            if torch.is_tensor(lo_e):
                # the host grower's Python floats, cast where they are used
                lo_e, hi_e = lo_e.to(dt), hi_e.to(dt)
            opts.update(mono_lo=lo_e, mono_hi=hi_e, use_bounds=True,
                        bounded=bounded)
        if c.ps > 0.0:
            opts.update(path_smooth=c.ps, parent_output=parent_out.to(dt),
                        use_smoothing=True)
        # divided by a tensor: a CUDA division by a Python number multiplies
        # by its reciprocal, which rounds differently from the host grower's
        # division
        totals = hist.sum(dim=(1, 2)).to(f64) / cols
        best = _split_scan(hist_f, nb_n, c.l1, c.l2, c.min_data, c.min_hess,
                           c.nan_mask, **opts)
        if not has_cat:
            return totals, best, None
        cat = _cat_scan(hist_f.index_select(1, c.cat_idx),
                        nb_c.index_select(0, c.cat_idx), c.l1, c.l2,
                        c.min_data, c.min_hess, c.max_cat_threshold, None,
                        c.cat_l2, c.cat_smooth, c.min_data_per_group,
                        c.max_cat_to_onehot)
        use_cat = (cat[2].to(f64) > c.min_gain) & (
            ~(best[2].to(f64) > c.min_gain) | (cat[1] > best[1]))
        cflat = cat[0].to(torch.int64)
        k = cflat % B
        f_c = c.cat_idx.index_select(0, ((cflat // B) % c.cat_idx.shape[0])
                                     .view(1))[0]
        cat_row = torch.cat([(f_c * B + k).to(dt).view(1), cat[1:6],
                             one_dt.view(1)])
        # the left set: the first k + 1 categories of the winning order
        order = cat[6:6 + B].to(torch.int64)
        left_set = ((order[None, :] == bin_ids[:, None])
                    & (bin_ids <= k)[None, :]).any(dim=1) & use_cat
        return totals, torch.where(use_cat, cat_row, best), (use_cat,
                                                              left_set)

    node = torch.arange(M, device=dev)
    zero64 = torch.zeros((), dtype=f64, device=dev)
    cols = torch.full((), c.hist_binned.shape[1], dtype=f64, device=dev)
    neg_inf = torch.full((), -torch.inf, dtype=dt, device=dev)
    inf64 = torch.full((M,), torch.inf, dtype=f64, device=dev)
    F = c.part_rows.shape[0]
    lo = -inf64
    hi = inf64
    used = (torch.zeros((M, F), dtype=torch.bool, device=dev)
            if c.ic_groups is not None else None)
    depth = (node == 0).to(i32)
    hist0 = hist_of(row_mask)
    st0, b0, cat0 = eval_leaf(hist0, zero64, lo[0], hi[0], depth[0],
                              None if used is None else used[0])
    hist = torch.zeros((M,) + tuple(hist0.shape), dtype=dt, device=dev)
    hist[0] = hist0
    best = torch.zeros((M, b0.shape[0]), dtype=dt, device=dev)
    best[0] = b0
    stats = torch.zeros((M, 3), dtype=f64, device=dev)
    stats[0] = st0
    pout = torch.zeros(M, dtype=f64, device=dev)
    row_leaf = torch.zeros(grad.shape[0], dtype=i32, device=dev)
    feature = torch.zeros(M, dtype=i32, device=dev)
    thresh = torch.zeros(M, dtype=i32, device=dev)
    left = node.to(i32)
    right = node.to(i32)
    is_leaf = node == 0
    dleft = torch.ones(M, dtype=torch.bool, device=dev)
    sgain = torch.zeros(M, dtype=f64, device=dev)
    # the best candidate's categorical flag and left set a node, and those
    # of the split made
    bcat = torch.zeros(M, dtype=torch.bool, device=dev)
    bmask = torch.zeros((M, B), dtype=torch.bool, device=dev)
    iscat = torch.zeros(M, dtype=torch.bool, device=dev)
    catmask = torch.zeros((M, B), dtype=torch.bool, device=dev)
    if has_cat:
        bcat[0], bmask[0] = cat0

    def children(leaf, lid, rid, f_b, hist_l, hist_r, po_l, po_r, lims,
                 proceed):
        """Score both children of a split of ``leaf`` on ``f_b`` and write
        them into the node arrays where ``proceed``."""
        d_child = depth.index_select(0, leaf)[0] + 1
        uc = None
        if used is not None:
            uc = used.index_select(0, leaf)[0] | (c.feat_ids == f_b)
        for nid, h_c, po_c, (lo_c, hi_c) in ((lid, hist_l, po_l, lims[0]),
                                              (rid, hist_r, po_r, lims[1])):
            st_c, b_c, cat_c = eval_leaf(h_c, po_c, lo_c, hi_c, d_child, uc)
            is_leaf[nid] = proceed
            depth[nid] = torch.where(proceed, d_child, depth[nid])
            hist[nid] = torch.where(proceed, h_c, hist[nid])
            stats[nid] = torch.where(proceed, st_c, stats[nid])
            best[nid] = torch.where(proceed, b_c, best[nid])
            pout[nid] = torch.where(proceed, po_c, pout[nid])
            if mono:
                lo[nid] = torch.where(proceed, lo_c, lo[nid])
                hi[nid] = torch.where(proceed, hi_c, hi[nid])
            if used is not None:
                used[nid] = torch.where(proceed, uc, used[nid])
            if has_cat:
                bcat[nid] = cat_c[0] & proceed
                bmask[nid] = cat_c[1] & proceed

    # the forced splits: static (leaf, feature, bin), both children built
    true = torch.ones((), dtype=torch.bool, device=dev)
    for k, (lf, f, b) in enumerate(c.forced_ops):
        lid, rid = 2 * k + 1, 2 * k + 2
        lid_t = torch.full((), lid, dtype=i32, device=dev)
        rid_t = torch.full((), rid, dtype=i32, device=dev)
        row_leaf = torch.where(row_leaf == lf, torch.where(
            c.part_rows[f] <= b, lid_t, rid_t), row_leaf)
        hist_l = hist_of((row_leaf == lid) & row_mask)
        hist_r = hist_of((row_leaf == rid) & row_mask)
        # written by torch.where: assigning a Python number copies it from
        # the host, which a capture refuses
        at = node == lf
        feature = torch.where(at, torch.full((), f, dtype=i32, device=dev),
                              feature)
        thresh = torch.where(at, torch.full((), b, dtype=i32, device=dev),
                             thresh)
        left = torch.where(at, lid_t, left)
        right = torch.where(at, rid_t, right)
        is_leaf = is_leaf & ~at
        children(node[lf:lf + 1], lid, rid, f, hist_l, hist_r, pout[lf],
                 pout[lf], ((lo[lf], hi[lf]), (lo[lf], hi[lf])), true)

    for k in range(len(c.forced_ops), L - 1):
        lid, rid = 2 * k + 1, 2 * k + 2
        ok = is_leaf & (best[:, 2].to(f64) > c.min_gain)
        if c.max_depth > 0:
            ok = ok & (depth < c.max_depth)
        leaf = torch.argmax(torch.where(ok, best[:, 1], neg_inf)).view(1)
        proceed = ok.any()
        b = best.index_select(0, leaf)[0]
        flat = b[0].to(torch.int64)
        f_b, b_b = flat // B, flat % B
        gain, gl, hl, cl, dl_b = b[1], b[3], b[4], b[5], b[6] > 0
        g_p, h_p, cnt_p = stats.index_select(0, leaf)[0].unbind()
        # the partition: every row of the leaf (the host grower's)
        col = c.part_rows.index_select(0, f_b.view(1))[0]
        go_left = col <= b_b
        if c.nan_mask is not None:
            miss_right = c.nan_mask.index_select(0, f_b.view(1))[0] & ~dl_b
            go_left = go_left & ~(miss_right & (col == 0))
        if has_cat:
            cat_flag = bcat.index_select(0, leaf)[0]
            left_set = bmask.index_select(0, leaf)[0]
            go_left = torch.where(cat_flag, left_set.index_select(
                0, col.long()), go_left)
        in_leaf = (row_leaf == leaf) & proceed
        lid_t = torch.full((), lid, dtype=i32, device=dev)
        rid_t = torch.full((), rid, dtype=i32, device=dev)
        row_leaf = torch.where(in_leaf, torch.where(go_left, lid_t, rid_t),
                               row_leaf)
        # the smaller child's histogram, the sibling's by subtraction
        small_left = cl.to(f64) <= cnt_p / 2
        small = torch.where(small_left, lid_t, rid_t)
        h_small = hist_of((row_leaf == small) & row_mask)
        h_big = hist.index_select(0, leaf)[0] - h_small
        hist_l = torch.where(small_left, h_small, h_big)
        hist_r = torch.where(small_left, h_big, h_small)
        parent = pout.index_select(0, leaf)[0]
        lo_p = lo.index_select(0, leaf)[0]
        hi_p = hi.index_select(0, leaf)[0]
        lims = ((lo_p, hi_p), (lo_p, hi_p))
        if c.ps > 0.0 or mono:
            # the children's outputs, clipped to the parent's bounds
            po_l = torch.clamp(out_of(gl.to(f64), hl.to(f64), cl.to(f64),
                                      parent), lo_p, hi_p)
            po_r = torch.clamp(out_of(g_p - gl.to(f64), h_p - hl.to(f64),
                                      cnt_p - cl.to(f64), parent), lo_p, hi_p)
        else:
            po_l = po_r = zero64
        if mono:
            # a numeric split on a monotone feature tightens the children's
            # bounds: at the midpoint of the two outputs (basic) or at the
            # sibling's output (intermediate, advanced)
            dirn = c.mono.index_select(0, f_b.view(1))[0]
            tight = dirn != 0
            if has_cat:
                tight = tight & ~cat_flag
            inc, dec = tight & (dirn > 0), tight & (dirn < 0)
            if c.mono_bounds:
                ref_l, ref_r = po_r, po_l
            else:
                ref_l = ref_r = 0.5 * (po_l + po_r)
            lims = ((torch.where(dec, torch.maximum(lo_p, ref_l), lo_p),
                     torch.where(inc, torch.minimum(hi_p, ref_l), hi_p)),
                    (torch.where(inc, torch.maximum(lo_p, ref_r), lo_p),
                     torch.where(dec, torch.minimum(hi_p, ref_r), hi_p)))
        # the split leaf's record, then the two new leaves (unused slots
        # until now, so a step that does not split leaves them as they were)
        at = (node == leaf) & proceed
        feature = torch.where(at, f_b.to(i32), feature)
        thresh = torch.where(at, b_b.to(i32), thresh)
        sgain = torch.where(at, gain.to(f64), sgain)
        dleft = torch.where(at, dl_b, dleft)
        left = torch.where(at, lid_t, left)
        right = torch.where(at, rid_t, right)
        if has_cat:
            iscat = torch.where(at, cat_flag, iscat)
            catmask = torch.where(at[:, None], left_set[None, :], catmask)
        is_leaf = is_leaf & ~at
        children(leaf, lid, rid, f_b, hist_l, hist_r, po_l, po_r, lims,
                 proceed)

    g_s, h_s, cnt = stats.unbind(1)
    if c.ps > 0.0:
        # the root smooths toward 0, every other leaf keeps the output it
        # took at its creation (the host grower's parent_out)
        value = torch.where(node == 0, out_of(g_s, h_s, cnt, zero64), pout)
    else:
        value = out_of(g_s, h_s, None, zero64)
    if mono:
        value = torch.clamp(value, lo, hi)
    return dict(feature=feature, thresh=thresh, left=left, right=right,
                leaf_value=torch.where(is_leaf, value, zero64),
                cnt=cnt, sgain=sgain, is_leaf=is_leaf, dleft=dleft,
                iscat=iscat, catmask=catmask, depth=depth,
                num_leaves=is_leaf.sum().to(i32), row_leaf=row_leaf)


class FixedGrower:
    """The fixed-shape grower for one Dataset and one set of options: the
    Dataset's tensors, the static options, and on a CUDA device the tree's
    growth captured as one ``torch.cuda.CUDAGraph``.

    The options are the host grower's: ``params`` (:class:`GrowerParams`:
    the split rules, path smoothing, ``max_delta_step``,
    ``feature_contri``, the categorical and monotone parameters),
    ``nan_mask``, the EFB panel ``efb``, ``categorical_mask`` [F] with
    ``max_cat_threshold``, ``monotone_constraints`` [F],
    ``interaction_constraints`` (lists of features) and ``forced_splits``
    (a bin-resolved tree, :func:`flatten_forced_splits`). Not CEGB, extra
    trees or ``feature_fraction_bynode`` (:func:`fixed_grower_gaps`).

    :meth:`grow` takes a tree's gradients, hessians, row mask and bins a
    feature. On the CPU it runs :func:`_grow_tree_fixed` eagerly. On CUDA
    its first call runs it eagerly and then captures it (the launches
    counted once, at their real launch); every later call copies its inputs
    into the graph's static tensors and replays it. A capture that fails
    raises: there is no eager fallback on the card. The returned tensors
    are the graph's own outputs on CUDA: read them (or clone them) before
    the next call.
    """

    def __init__(self, binned, max_num_bins: int, params: GrowerParams,
                 dtype, nan_mask=None, binned_t=None, efb=None,
                 categorical_mask=None, max_cat_threshold: int = 32,
                 monotone_constraints=None, interaction_constraints=None,
                 forced_splits=None):
        gaps = fixed_grower_gaps(params)
        if gaps:
            raise NotImplementedError(
                f"FixedGrower: {', '.join(gaps)} not covered by the "
                f"fixed-shape grower yet ({_FIXED_TODO}); grow_tree takes "
                "them")
        dev = self.device = binned.device
        F = binned.shape[1]
        self.num_leaves = int(params.num_leaves)
        self.max_depth = int(params.max_depth)
        self.l1 = float(params.lambda_l1)
        self.l2 = float(params.lambda_l2)
        self.min_data = float(params.min_data_in_leaf)
        self.min_hess = float(params.min_sum_hessian_in_leaf)
        self.min_gain = float(params.min_gain_to_split)
        self.ps = float(params.path_smooth)
        self.mds = float(params.max_delta_step)
        self.max_num_bins = int(max_num_bins)
        self.nan_mask = (None if nan_mask is None
                         or not bool(np.any(nan_mask)) else
                         torch.as_tensor(np.asarray(nan_mask, bool),
                                         device=dev))
        self.contri = (None if params.feature_contri is None else
                       torch.as_tensor(np.asarray(params.feature_contri,
                                                  np.float64), dtype=dtype,
                                       device=dev))
        self.feat_ids = torch.arange(F, device=dev)
        # categorical features: their ids, and the scan's parameters
        self.cat_idx = self.cat_mask = None
        if categorical_mask is not None and bool(np.any(categorical_mask)):
            cm = np.asarray(categorical_mask, bool)
            self.cat_mask = torch.as_tensor(cm, device=dev)
            self.cat_idx = torch.as_tensor(np.flatnonzero(cm), device=dev)
        self.max_cat_threshold = int(max_cat_threshold)
        self.cat_l2 = float(params.cat_l2)
        self.cat_smooth = float(params.cat_smooth)
        self.min_data_per_group = float(params.min_data_per_group)
        self.max_cat_to_onehot = int(params.max_cat_to_onehot)
        # monotone constraints: the directions, the method, and the gain
        # penalty a depth (the host grower's Python floats, cast once)
        self.mono = self.mono_factor = None
        self.mono_bounds = False
        if monotone_constraints is not None and bool(
                np.any(np.asarray(monotone_constraints) != 0)):
            self.mono = torch.as_tensor(
                np.asarray(monotone_constraints, np.int32), device=dev)
            self.mono_bounds = (params.monotone_constraints_method
                                in ("intermediate", "advanced"))
            if params.monotone_penalty > 0.0:
                self.mono_factor = torch.tensor(
                    [_monotone_factor(params.monotone_penalty, d)
                     for d in range(self.num_leaves + 2)], dtype=dtype,
                    device=dev)
        # interaction constraints: the groups as a [G, F] matrix
        self.ic_groups = None
        if interaction_constraints:
            groups = np.zeros((len(interaction_constraints), F), bool)
            for i, g in enumerate(interaction_constraints):
                for f in g:
                    if int(f) < F:
                        groups[i, int(f)] = True
            self.ic_groups = torch.as_tensor(groups, device=dev)
        self.forced_ops = flatten_forced_splits(forced_splits,
                                                self.num_leaves)
        # a partition reads one feature's bins: a row of the features-major
        # panel
        self.part_rows = binned.t() if binned_t is None else binned_t
        # held, so that the tensors whose identities key the cache
        # (fixed_grower_key) live as long as the entry
        self.binned, self.binned_t, self.efb = binned, binned_t, efb
        if efb is not None:
            self.hist_binned, self.hist_panel = (efb.binned_hist,
                                                 efb.binned_hist_t)
            self.hist_B = int(efb.max_bins_hist)
            self.efb_maps = (efb.src_col, efb.src_bin, efb.default_bin,
                             efb.fix_mask)
        else:
            self.hist_binned, self.hist_panel = binned, binned_t
            self.hist_B = self.max_num_bins
            self.efb_maps = None
        self.on_kernel = (dev.type == "cuda"
                          and dtype == torch.float32
                          and self.hist_B <= MAX_BINS)
        self._graph = None
        self._static = None
        self._out = None
        self._launches_per_replay = {}
        self.captures = 0

    def _run(self, grad, hess, row_mask, num_bins):
        return _grow_tree_fixed(grad, hess, row_mask, num_bins, self)

    def grow(self, grad, hess, row_mask, num_bins) -> dict:
        """One tree (see :func:`_grow_tree_fixed` for the outputs)."""
        if self.device.type != "cuda":
            return self._run(grad, hess, row_mask, num_bins)
        from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
        from gpboost_tpu_torch.ops.kernels import histogram as hk
        counted = (hk.histogram, gk.group_boundaries)
        if self._graph is None:
            out = self._run(grad, hess, row_mask, num_bins)
            static = [t.clone() for t in (grad, hess, row_mask, num_bins)]
            before = [fn.launches for fn in counted]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._out = self._run(*static)
            # capturing launches nothing: each replay does
            for fn, b in zip(counted, before):
                self._launches_per_replay[fn] = fn.launches - b
                fn.launches = b
            self._graph, self._static = graph, static
            self.captures += 1
            return out
        for dst, src in zip(self._static, (grad, hess, row_mask, num_bins)):
            dst.copy_(src)
        self._graph.replay()
        for fn, k in self._launches_per_replay.items():
            fn.launches += k
        return self._out


# fixed-shape growers by Dataset and options: repeated trainings on the
# same Dataset (retraining, cv, tuning) replay their captured graphs. A
# bounded LRU, the counterpart of the JAX package's _FUSED_RUNNERS: each
# entry pins its Dataset's tensors and its graph's memory
_FIXED_GROWERS: "OrderedDict" = OrderedDict()
_FIXED_GROWERS_MAX = 8


def _frozen(x):
    """A hashable copy of an option (nested lists, dicts and arrays)."""
    if isinstance(x, dict):
        return tuple(sorted((k, _frozen(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_frozen(v) for v in list(x))
    return x.item() if isinstance(x, np.generic) else x


def fixed_grower_key(binned, max_num_bins: int, params: GrowerParams,
                     dtype, nan_mask=None, binned_t=None, efb=None,
                     **options) -> tuple:
    """The cache key of :func:`fixed_grower`: the tensors' identities, the
    shapes, the dtype, every parameter the grower reads and the options of
    :class:`FixedGrower` (``options``: categorical mask, monotone
    constraints, interaction constraints, forced splits,
    ``max_cat_threshold``)."""
    nm = (None if nan_mask is None or not bool(np.any(nan_mask))
          else tuple(np.asarray(nan_mask, bool).tolist()))
    return (id(binned), id(binned_t), id(efb), tuple(binned.shape),
            str(binned.device), int(max_num_bins), str(dtype),
            int(params.num_leaves), int(params.max_depth),
            float(params.lambda_l1), float(params.lambda_l2),
            float(params.min_data_in_leaf),
            float(params.min_sum_hessian_in_leaf),
            float(params.min_gain_to_split), float(params.path_smooth),
            float(params.max_delta_step),
            None if params.feature_contri is None else tuple(
                np.asarray(params.feature_contri, np.float64).tolist()), nm,
            float(params.cat_l2), float(params.cat_smooth),
            float(params.min_data_per_group), int(params.max_cat_to_onehot),
            str(params.monotone_constraints_method),
            float(params.monotone_penalty),
            _frozen(sorted(options.items())))


def fixed_grower(binned, max_num_bins: int, params: GrowerParams, dtype,
                 nan_mask=None, binned_t=None, efb=None,
                 **options) -> FixedGrower:
    """The cached :class:`FixedGrower` of a Dataset's tensors and options
    (:func:`fixed_grower_key`; ``options`` as :class:`FixedGrower` takes
    them)."""
    key = fixed_grower_key(binned, max_num_bins, params, dtype, nan_mask,
                           binned_t, efb, **options)
    g = _FIXED_GROWERS.get(key)
    if g is not None:
        _FIXED_GROWERS.move_to_end(key)
        return g
    g = FixedGrower(binned, max_num_bins, params, dtype, nan_mask=nan_mask,
                    binned_t=binned_t, efb=efb, **options)
    _FIXED_GROWERS[key] = g
    while len(_FIXED_GROWERS) > _FIXED_GROWERS_MAX:
        _FIXED_GROWERS.popitem(last=False)
    return g


def _fixed_tree(host: dict, M: int) -> Tree:
    """A :class:`Tree` from the fixed-shape grower's arrays (numpy;
    ``catmask`` flat [M * B])."""
    return Tree(split_feature=host["feature"].astype(np.int32),
                threshold=np.zeros(M),
                threshold_bin=host["thresh"].astype(np.int32),
                left=host["left"].astype(np.int32),
                right=host["right"].astype(np.int32),
                leaf_value=host["leaf_value"].astype(np.float64),
                is_leaf=host["is_leaf"].astype(bool),
                node_count=host["cnt"].astype(np.float64),
                is_categorical=host["iscat"].astype(bool),
                cat_mask=host["catmask"].reshape(M, host["B"]).astype(bool),
                split_gain=host["sgain"].astype(np.float64),
                default_left=host["dleft"].astype(bool),
                num_leaves=int(host["num_leaves"]),
                max_depth_used=int(max(host["depth"].max(initial=1), 1)))


def check_finite_leaves(leaf_value, is_leaf, where: str) -> None:
    """Raise the host route's ``ValueError`` when a fetched leaf value is not
    finite. On the device the fixed-point scales of a gradient or hessian
    that is not finite are NaN (``fixed_point_scales_device``), and so are
    the histograms and the leaves; the host route raises on its scales."""
    vals = np.asarray(leaf_value)[np.asarray(is_leaf) > 0]
    if not np.all(np.isfinite(vals)):
        raise ValueError(f"{where}: a leaf value is not finite: a gradient "
                         "or hessian is not finite")


# the fixed-shape grower's per-node arrays, in the order of one packed fetch
# (then its categorical left sets, [M, B])
FIXED_NODE_FIELDS = ("feature", "thresh", "left", "right", "leaf_value",
                     "is_leaf", "cnt", "sgain", "dleft", "iscat", "depth")


def grow_tree_fast(binned: torch.Tensor, num_bins_per_feat: torch.Tensor,
                   grad: torch.Tensor, hess: torch.Tensor, max_num_bins: int,
                   params: GrowerParams,
                   row_mask: Optional[torch.Tensor] = None,
                   nan_mask: Optional[np.ndarray] = None,
                   binned_t: Optional[torch.Tensor] = None, efb=None,
                   categorical_mask=None, max_cat_threshold: int = 32,
                   monotone_constraints=None, interaction_constraints=None,
                   forced_splits=None, cegb=None, **host_only):
    """Grow one tree with the fixed-shape grower (the JAX package's
    ``grow_tree_fast``): the whole tree on the device with no host read
    (:func:`_grow_tree_fixed`; on CUDA one captured graph, replayed for
    every later tree of the same Dataset and options), then ONE fetch of
    the tree's arrays and ``row_leaf`` packed together. Returns (Tree,
    row_leaf [n] int32 on the device), as :func:`grow_tree`; the host copy
    of ``row_leaf`` from the same fetch is ``tree.row_leaf_host``, for the
    caller's score update (it takes it off the tree).

    Covers numeric and categorical splits, missing values (``nan_mask``,
    ``default_left``), the EFB bundle panel, ``row_mask``, ``path_smooth``,
    ``max_delta_step``, ``feature_contri``, ``max_depth``, the min-data /
    min-hessian / min-gain and L1 / L2 rules, the three monotone methods
    with their penalty, interaction constraints and forced splits. CEGB,
    extra trees and ``feature_fraction_bynode`` raise
    ``NotImplementedError`` (ROADMAP.md Queue A, item 10b). The host
    grower's other keywords (``rng``, ``num_bins_host``: ``host_only``) are
    taken and not read, so that a caller passes both growers the same
    arguments. ``grow_tree.host_reads`` counts the fetches (one a tree), as
    it counts the host grower's reads. A leaf value that is not finite (a
    gradient or hessian that is not) raises ``ValueError`` after the fetch
    (:func:`check_finite_leaves`)."""
    gaps = fixed_grower_gaps(params, cegb)
    if gaps:
        raise NotImplementedError(
            f"grow_tree_fast: {', '.join(gaps)} not covered by the "
            f"fixed-shape grower yet ({_FIXED_TODO}); grow_tree takes them")
    n = binned.shape[0]
    if row_mask is None:
        row_mask = torch.ones(n, dtype=torch.bool, device=binned.device)
    g = fixed_grower(binned, max_num_bins, params, grad.dtype,
                     nan_mask=nan_mask, binned_t=binned_t, efb=efb,
                     categorical_mask=categorical_mask,
                     max_cat_threshold=max_cat_threshold,
                     monotone_constraints=monotone_constraints,
                     interaction_constraints=interaction_constraints,
                     forced_splits=forced_splits)
    out = g.grow(grad, hess, row_mask, num_bins_per_feat)
    M = 2 * g.num_leaves - 1
    packed = torch.cat([out[k].to(torch.float64).reshape(-1)
                        for k in FIXED_NODE_FIELDS + ("catmask",)]
                       + [out["num_leaves"].to(torch.float64).view(1),
                          out["row_leaf"].to(torch.float64)])
    row_leaf = out["row_leaf"].clone()
    host = packed.cpu().numpy()                           # the one fetch
    grow_tree.host_reads += 1
    nf = len(FIXED_NODE_FIELDS)
    arrays = {k: host[i * M:(i + 1) * M]
              for i, k in enumerate(FIXED_NODE_FIELDS)}
    B = int(max_num_bins)
    arrays["catmask"] = host[nf * M:nf * M + M * B]
    arrays["num_leaves"] = host[nf * M + M * B]
    arrays["B"] = B
    check_finite_leaves(arrays["leaf_value"], arrays["is_leaf"],
                        "grow_tree_fast")
    tree = _fixed_tree(arrays, M)
    tree.fixed_shape = True
    tree.row_leaf_host = host[nf * M + M * B + 1:].astype(np.int64)
    return tree, row_leaf


def histogram_launches(trees, num_leaves: int, forced_splits: int = 0) -> int:
    """The histogram launches that growing ``trees`` took on the kernel
    route: a tree of the fixed-shape grower (``tree.fixed_shape``) launches
    ``num_leaves``, the grower's setting (the root and every step, whether
    it split or not), one of the host grower one a leaf
    (``Tree.num_leaves``); each of the ``forced_splits`` splits of a tree
    (``len(flatten_forced_splits(...))``) adds one on either grower: both
    its children are built."""
    return sum((num_leaves if getattr(t, "fixed_shape", False)
                else t.num_leaves) + forced_splits for t in trees)


def _traverse(node, max_depth, go_left_of, left, right):
    left, right = left.long(), right.long()
    for _ in range(max_depth):
        node = torch.where(go_left_of(node), left[node], right[node])
    return node


def predict_tree_binned(binned, feature, threshold_bin, left, right,
                        max_depth: int, leaf_value, default_left=None):
    """Evaluate one tree on binned data by a traversal of ``max_depth``
    steps (leaves point to themselves). All arguments but ``max_depth`` are
    tensors on one device; returns (values [n], node ids [n]).

    ``default_left`` [M]: False sends the NA bin (bin 0 of a feature with
    missing values — the grower only clears the flag on such nodes) right.
    """
    feature = feature.long()

    def go_left_of(node):
        vals = binned.gather(1, feature[node][:, None])[:, 0]
        go = vals <= threshold_bin[node]
        if default_left is not None:
            go = go & (default_left[node] | (vals != 0))
        return go

    node = _traverse(torch.zeros(binned.shape[0], dtype=torch.int64,
                                 device=binned.device), max_depth,
                     go_left_of, left, right)
    return leaf_value[node], node


def _raw_left(X, feature, threshold, default_left, node):
    vals = X.gather(1, feature[node][:, None])[:, 0]
    go = vals <= threshold[node]
    if default_left is not None:
        go = torch.where(torch.isnan(vals), default_left[node], go)
    return go


def _cat_left(cat_bins, feature, cat_mask, node):
    # an id past the mask's width takes its last column (the JAX package's
    # gather clamps an out-of-range index the same way)
    b = cat_bins.gather(1, feature[node][:, None])[:, 0].long()
    return cat_mask[node, b.clamp(max=cat_mask.shape[1] - 1)]


def predict_tree_raw(X, feature, threshold, left, right, leaf_value,
                     max_depth: int, default_left=None):
    """Evaluate one tree on raw feature values (value <= threshold -> left);
    NaN routes by the node's learned ``default_left`` direction."""
    feature = feature.long()
    node = _traverse(torch.zeros(X.shape[0], dtype=torch.int64,
                                 device=X.device), max_depth,
                     lambda nd: _raw_left(X, feature, threshold,
                                          default_left, nd), left, right)
    return leaf_value[node], node


def predict_tree_mixed(X_num, cat_bins, feature, threshold, is_cat, cat_mask,
                       left, right, max_depth: int, leaf_value,
                       default_left=None):
    """Tree evaluation with numerical and categorical splits on raw values:
    ``cat_bins`` [n, F] holds the category bins of the categorical columns
    (0 elsewhere); numerical columns compare against real thresholds."""
    feature = feature.long()

    def go_left_of(nd):
        return torch.where(is_cat[nd], _cat_left(cat_bins, feature,
                                                 cat_mask, nd),
                           _raw_left(X_num, feature, threshold,
                                     default_left, nd))

    node = _traverse(torch.zeros(X_num.shape[0], dtype=torch.int64,
                                 device=X_num.device), max_depth,
                     go_left_of, left, right)
    return leaf_value[node], node


def predict_tree_binned_mixed(binned, feature, threshold_bin, is_cat,
                              cat_mask, left, right, max_depth: int,
                              leaf_value, default_left=None):
    """Binned-data evaluation with categorical splits."""
    feature = feature.long()

    def go_left_of(nd):
        b = binned.gather(1, feature[nd][:, None])[:, 0]
        num_left = b <= threshold_bin[nd]
        if default_left is not None:
            num_left = num_left & (default_left[nd] | (b != 0))
        return torch.where(is_cat[nd], cat_mask[nd, b.long()], num_left)

    node = _traverse(torch.zeros(binned.shape[0], dtype=torch.int64,
                                 device=binned.device), max_depth,
                     go_left_of, left, right)
    return leaf_value[node], node


def predict_tree_linear(X_num, cat_bins, feature, threshold, is_cat,
                        cat_mask, left, right, max_depth: int, leaf_value,
                        lin_features, lin_coefs, default_left=None):
    """Traverse as :func:`predict_tree_mixed`, then add the leaf's linear
    model ``sum_k coef[k] x[feature[k]]`` (features -1 pad)."""
    vals, node = predict_tree_mixed(X_num, cat_bins, feature, threshold,
                                    is_cat, cat_mask, left, right, max_depth,
                                    leaf_value, default_left)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for k in range(lin_features.shape[1]):
        f = lin_features[node, k].long()
        x = X_num.gather(1, f.clamp(min=0)[:, None])[:, 0]
        vals = vals + torch.where(f >= 0, lin_coefs[node, k] * x, zero)
    return vals, node


def fit_linear_leaves(tree: Tree, X: torch.Tensor, row_leaf: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      linear_lambda: float = 0.0):
    """Ridge linear models in the leaves (reference ``LinearTreeLearner``):
    per leaf, minimize sum_i [g_i v(x_i) + 1/2 h_i v(x_i)^2] over
    v(x) = c + w'x_path, the path's numerical split features standardized.

    ``X`` [n, F], ``grad`` / ``hess`` [n] float64 and ``row_leaf`` [n] on
    one device. Each leaf's rows are taken in increasing order (one stable
    sort), its system built by matrix products and solved by
    ``torch.linalg.solve_ex``: no atomics, the same bits on every run. A
    leaf with fewer than K + 2 rows keeps its constant, one whose system is
    singular too (the JAX package skips it on ``LinAlgError``). Two host
    reads: the leaves' row counts, and every leaf's solution together.
    Mutates the tree (``leaf_value`` takes the constants, ``lin_*`` the
    linear parts) and returns it.
    """
    M = len(tree.is_leaf)
    parents = {}
    for node in range(M):
        if not tree.is_leaf[node]:
            parents[tree.left[node]] = node
            parents[tree.right[node]] = node
    leaf_nodes = np.flatnonzero(tree.is_leaf)
    path_feats = {}
    for leaf in leaf_nodes:
        feats = []
        node = leaf
        while node in parents:
            node = parents[node]
            f = int(tree.split_feature[node])
            if (tree.is_categorical is None
                    or not tree.is_categorical[node]) and f not in feats:
                feats.append(f)
        path_feats[leaf] = feats
    max_k = max((len(v) for v in path_feats.values()), default=0)
    if max_k == 0:
        return tree
    rl = row_leaf.long()
    order = torch.argsort(rl, stable=True)
    counts = torch.bincount(rl, minlength=M).tolist()
    offsets = np.concatenate([[0], np.cumsum(counts)])
    solved = []
    for leaf in leaf_nodes:
        feats = path_feats[leaf]
        cnt = counts[leaf]
        if len(feats) == 0 or cnt < len(feats) + 2:
            continue
        rows = order[offsets[leaf]:offsets[leaf] + cnt]
        Xl = X[rows][:, torch.as_tensor(feats, device=X.device)]
        mu = Xl.mean(dim=0)
        sd = Xl.std(dim=0, correction=0) + 1e-12
        Xs = torch.cat([torch.ones_like(Xl[:, :1]), (Xl - mu) / sd], dim=1)
        h, g = hess[rows], grad[rows]
        A = Xs.T @ (Xs * h[:, None]) + (linear_lambda + 1e-6) * torch.eye(
            Xs.shape[1], dtype=X.dtype, device=X.device)
        beta, info = torch.linalg.solve_ex(A, -Xs.T @ g)
        coefs = beta[1:] / sd
        const = beta[0] - torch.dot(coefs, mu)
        solved.append((leaf, feats, torch.cat([
            const[None], coefs, info[None].to(coefs.dtype)])))
    lin_features = np.full((M, max_k), -1, dtype=np.int32)
    lin_coefs = np.zeros((M, max_k), dtype=np.float64)
    if solved:
        host = torch.cat([s[2] for s in solved]).cpu().numpy()
        pos = 0
        for leaf, feats, _ in solved:
            k = len(feats)
            const, coefs, info = host[pos], host[pos + 1:pos + 1 + k], \
                host[pos + 1 + k]
            pos += k + 2
            if info != 0:
                continue          # singular: the constant leaf stays
            lin_features[leaf, :k] = feats
            lin_coefs[leaf, :k] = coefs
            tree.leaf_value[leaf] = const
    tree.lin_features = lin_features
    tree.lin_coefs = lin_coefs
    return tree
