"""Dataset: binned feature store for histogram-based tree boosting.

The equivalent of the reference's ``Dataset``/``BinMapper`` stack
(``src/LightGBM/io/bin.cpp`` quantile binning, ``dataset.h:283``): features
are binned once on the host, and the bins live on the device in two
layouts:

- ``binned`` ``[n, F]`` int32, rows-major — the reference layout, read by
  ``predict_tree_binned`` and the plain histogram;
- ``binned_t`` ``[F, n]`` uint8, features-major — the panel the CUDA
  histogram kernel streams and ``partition_rows`` reads a row of; present
  when ``max_num_bins <= 256`` (a feature with missing values has up to 256
  bins: 255 value bins and the NA bin; uint8 holds 0...255).

Binning is host numpy and follows the JAX package line for line, so that bin
edges are identical, not merely close: quantile bins with a minimum count a
bin (``min_data_in_bin``), ``max_bin_by_feature``, forced bin edges
(``forcedbins_filename``), the exclusive NA bin, the missing-value policy
(``use_missing`` / ``zero_as_missing``, applied to the raw matrix), and
categorical features, whose bins are category ids (``cat_maps``; unseen
values and NaN go to bin 0, ids past ``max_bin - 1`` share the last bin).
pandas DataFrames and scipy.sparse matrices go through ``compat_data``.

Exclusive Feature Bundling (EFB, ``dataset.cpp:53-297``
``GetConflictCount`` / ``FindGroups``), on by default as in the JAX
package: features that are never away from their most frequent bin on the
same row (one-hot columns, sparse indicators) share one histogram column,
and the grower rebuilds the exact per-feature histograms from the bundle
histograms (``tree.expand_bundle_hist``). The bundles have their own two
layouts (``EFBInfo.binned_hist`` and the uint8 panel ``binned_hist_t``,
at most 256 bins a bundle); ``binned`` stays what partitions and predicts.

``save_binary`` writes the JAX package's ``.bin`` (an ``.npz``), which both
packages load. A text file path raises: the native file reader is ROADMAP.md
Queue A, item 19. ``group`` (the query sizes of the ranking objectives and
metrics) is a field like ``label``: given, set, saved and loaded.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.boosting.compat_data import (_resolve_cat,
                                                    marshal_label,
                                                    marshal_matrix)
from gpboost_tpu_torch.ops.kernels.histogram import MAX_BINS
from gpboost_tpu_torch.utils import resolve_device

MAX_BIN_DEFAULT = 255


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"Dataset: {what} is not ported to gpboost_tpu_torch yet "
        f"(ROADMAP.md Queue A, {queue})")


def _panel(binned: np.ndarray, max_bins: int, device):
    """The features-major uint8 copy ``[cols, n]`` of ``binned`` for the
    histogram kernel, or None when a column has more than 256 bins."""
    if max_bins > MAX_BINS:          # uint8 holds bins 0...255
        return None
    return torch.as_tensor(np.ascontiguousarray(binned.T.astype(np.uint8)),
                           device=device)


class EFBInfo:
    """Exclusive-feature-bundle layout (lossless; ``dataset.cpp:53-297``).

    ``binned_hist`` ``[n, G]`` int32 (and its uint8 panel ``binned_hist_t``
    ``[G, n]``) feeds the histogram builds; the per-feature ``[F, B]``
    histograms come back exactly through the ``src_col`` / ``src_bin``
    gathers and the default-bin correction (``fix_mask`` features get the
    leaf total minus their non-default mass in their ``default_bin`` slot).
    The tensors lie on ``device``; ``num_bins_hist`` is host numpy.
    """

    def __init__(self, binned_hist, num_bins_hist, src_col, src_bin,
                 default_bin, fix_mask, n_multi_bundles, device):
        self.num_bins_hist = np.asarray(num_bins_hist)
        self.max_bins_hist = int(self.num_bins_hist.max())
        self.binned_hist = torch.as_tensor(binned_hist, device=device)
        self.binned_hist_t = _panel(binned_hist, self.max_bins_hist, device)
        self.src_col = torch.as_tensor(src_col, dtype=torch.int64,
                                       device=device)
        self.src_bin = torch.as_tensor(src_bin, dtype=torch.int64,
                                       device=device)
        self.default_bin = torch.as_tensor(default_bin, dtype=torch.int64,
                                           device=device)
        self.fix_mask = torch.as_tensor(fix_mask, device=device)
        self.n_multi_bundles = n_multi_bundles


def build_efb(binned, num_bins, categorical, max_bin, device,
              max_bundle_bins=MAX_BINS, min_saving=0.2):
    """Greedy lossless bundling (``FindGroups`` / ``GetConflictCount`` with
    ``max_conflict_rate=0``): two features bundle iff no row has both away
    from their most frequent ('default') bin; conflicts are tested on packed
    bitsets, a bundle holds at most ``max_bundle_bins`` bins. None when
    bundling would save less than ``min_saving`` of the histogram columns
    (dense data keeps the per-feature path). Host numpy, the JAX package's
    ``build_efb`` line for line; the layout goes to ``device``."""
    n, F = binned.shape
    default_bin = np.zeros(F, np.int32)
    for f in range(F):
        bc = np.bincount(binned[:, f], minlength=int(num_bins[f]))
        default_bin[f] = int(np.argmax(bc))
    act = binned != default_bin[None, :]
    act_cnt = act.sum(axis=0)
    bits = np.packbits(act, axis=0)             # [ceil(n/8), F]
    eligible = np.ones(F, bool)
    for f in categorical:
        eligible[f] = False
    # sparse features only are worth bundling (dense ones conflict anyway)
    eligible &= act_cnt <= 0.5 * n
    order = np.argsort(-act_cnt)
    bundles = []                                # (members, bits, bins_used)
    for f in order:
        if not eligible[f]:
            continue
        extra = int(num_bins[f]) - 1
        placed = False
        for b in bundles:
            if (b[2] + extra <= max_bundle_bins
                    and not np.any(b[1] & bits[:, f])):
                b[0].append(int(f))
                b[1] |= bits[:, f]
                b[2] += extra
                placed = True
                break
        if not placed:
            bundles.append([[int(f)], bits[:, f].copy(), 1 + extra])
    multi = [b for b in bundles if len(b[0]) > 1]
    n_saved = sum(len(b[0]) - 1 for b in multi)
    if n_saved < min_saving * F:
        return None
    # layout: multi-member bundles first, then singletons (identity columns)
    in_multi = np.zeros(F, bool)
    for b in multi:
        in_multi[b[0]] = True
    B = int(num_bins.max())
    G = len(multi) + int((~in_multi).sum())
    src_col = np.zeros(F, np.int32)
    src_bin = np.full((F, B), -1, np.int32)
    fix_mask = np.zeros(F, bool)
    num_bins_hist = np.zeros(G, np.int64)
    binned_hist = np.zeros((n, G), np.int32)
    g = 0
    for members, _, bins_used in multi:
        off = 1
        col = np.zeros(n, np.int32)
        for f in members:
            nb = int(num_bins[f])
            df = int(default_bin[f])
            ranks = np.arange(nb) - (np.arange(nb) > df)
            pos = off + ranks                   # per-original-bin position
            src_col[f] = g
            src_bin[f, :nb] = pos
            src_bin[f, df] = -1                 # default slot reconstructed
            fix_mask[f] = True
            col = np.where(act[:, f], pos[binned[:, f]], col)
            off += nb - 1
        num_bins_hist[g] = bins_used
        binned_hist[:, g] = col
        g += 1
    for f in np.flatnonzero(~in_multi):
        nb = int(num_bins[f])
        src_col[f] = g
        src_bin[f, :nb] = np.arange(nb)
        num_bins_hist[g] = nb
        binned_hist[:, g] = binned[:, f]
        g += 1
    return EFBInfo(binned_hist, num_bins_hist, src_col, src_bin,
                   default_bin, fix_mask, len(multi), device)


def _parse_categorical_param(cf):
    """The params form of ``categorical_feature`` (reference config.h:631):
    ``"0,1,2"`` (indices) or ``"name:a,b"`` (column names)."""
    if isinstance(cf, str):
        if cf.startswith("name:"):
            return [s.strip() for s in cf[5:].split(",") if s.strip()]
        return [int(s) for s in cf.split(",") if s.strip()]
    return cf


def cat_bins(col: np.ndarray, lookup: dict) -> np.ndarray:
    """The category bins of raw values ``col`` through ``lookup`` (value ->
    bin): an exact match gives its bin, anything else (an unseen value, NaN,
    +-inf) bin 0 — the JAX package's ``lookup.get(v, 0)`` a value, as one
    ``searchsorted`` over the sorted levels."""
    if not lookup:
        return np.zeros(len(col), np.int32)
    keys = np.asarray(list(lookup.keys()), dtype=np.float64)
    vals = np.asarray(list(lookup.values()), dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    idx = np.minimum(np.searchsorted(keys, col, side="left"), len(keys) - 1)
    hit = keys[idx] == col
    return np.where(hit, vals[idx], 0).astype(np.int32)


class Dataset:
    """Training data container (mirrors ``gpboost.Dataset``, ``basic.py:1180``).

    Parameters
    ----------
    data : array-like [n, F] (NaN / Inf mark missing values), a pandas
        DataFrame (``category`` columns become categorical features), a
        scipy.sparse matrix, or the path of a file written by ``save_binary``
    label : array-like [n] or a pandas Series
    reference : a Dataset whose bin mapping is adopted (validation or
        prediction data binned like the training data)
    max_bin : number of histogram bins per feature
    categorical_feature : indices or column names of categorical features
        (bin = category id); ``params["categorical_feature"]`` in the
        reference's string form when not given
    group : the sizes of the consecutive queries of the ranking objectives
        and metrics (``lambdarank``, ``rank_xendcg``, ``ndcg``, ``map``)
    device : where the binned matrices live (default the GPU; a missing GPU
        raises, ``device="cpu"`` keeps them on the host)
    """

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, init_score=None, max_bin: int = MAX_BIN_DEFAULT,
                 categorical_feature=None, feature_name=None,
                 free_raw_data: bool = False, params=None, group=None,
                 device="cuda"):
        p = cfg_mod.resolve_params(params)
        max_bin = int(p.get("max_bin", max_bin))
        self.device = resolve_device(device)
        self.tree_learner = p.get("tree_learner", "data")
        self.pandas_categorical = None
        self._enable_bundle = bool(p.get("enable_bundle", True))
        if categorical_feature is None and p.get("categorical_feature"):
            categorical_feature = _parse_categorical_param(
                p["categorical_feature"])
        if isinstance(data, str):
            if data.endswith(".bin") or data.endswith(".npz"):
                self._load_binary(data, label, weight, init_score, group)
                return
            raise _not_ported("reading a text data file (the native reader)",
                              "item 19")
        data, fn_m, cat_m, self.pandas_categorical = marshal_matrix(
            data,
            feature_name if feature_name is not None else "auto",
            categorical_feature if categorical_feature is not None
            else "auto",
            pandas_categorical=(getattr(reference, "pandas_categorical",
                                        None)
                                if reference is not None else None))
        if feature_name is None and fn_m is not None:
            feature_name = fn_m
        if cat_m is not None:
            categorical_feature = cat_m
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        # the missing-value policy (config.h use_missing / zero_as_missing),
        # on the raw matrix so that binning, partitioning and the training
        # prediction see the same values; Booster.predict applies it again
        self.use_missing = bool(p.get("use_missing", True))
        self.zero_as_missing = bool(p.get("zero_as_missing", False))
        if not self.use_missing:
            data = np.where(np.isfinite(data), data, 0.0)
        elif self.zero_as_missing:
            data = np.where(data == 0.0, np.nan, data)
        self.num_data, self.num_features = data.shape
        self.raw_data = data
        label = marshal_label(label)
        self.label = None if label is None else np.asarray(
            label, dtype=np.float64).ravel()
        self.weight = None if weight is None else np.asarray(
            weight, dtype=np.float64).ravel()
        self.init_score = None if init_score is None else np.asarray(
            init_score, dtype=np.float64).ravel()
        self.group = None if group is None else np.asarray(group)
        self.max_bin = max_bin
        mbf = p.get("max_bin_by_feature")
        self.max_bin_by_feature = (None if not mbf else
                                   np.asarray(mbf, dtype=np.int64))
        self.min_data_in_bin = int(p.get("min_data_in_bin", 3))
        # forced bin edges (config.h:596 forcedbins_filename; JSON
        # [{"feature": i, "bin_upper_bound": [...]}, ...]): the listed
        # bounds are kept, the quantile bins fill the rest
        self.forced_bins = {}
        fb = p.get("forcedbins_filename", "")
        if fb:
            with open(fb) as fh:
                for ent in json.load(fh):
                    self.forced_bins[int(ent["feature"])] = np.asarray(
                        ent["bin_upper_bound"], dtype=np.float64)
        self.feature_name = (list(feature_name) if feature_name is not None
                             else [f"Column_{i}"
                                   for i in range(self.num_features)])
        self.categorical_feature = sorted(set(categorical_feature or []))

        if reference is not None:
            self.bin_upper_bounds = reference.bin_upper_bounds
            self.num_bins = reference.num_bins
            self.categorical_feature = reference.categorical_feature
            self.cat_maps = reference.cat_maps
            self.has_nan = reference.has_nan
        else:
            self._find_bins()
        self._bin_data()

    # ------------------------------------------------------------------
    def _find_bins(self):
        """Bin boundaries per feature (``BinMapper::FindBin``).

        Features containing missing values get an EXCLUSIVE NA bin at index 0
        (LightGBM ``MissingType::NaN`` semantics, ``io/bin.cpp``): real-value
        bins shift up by one and the split finder learns a per-node default
        direction for the NA bin. A categorical feature's bins are its
        sorted distinct values (``cat_maps``), at most its ``max_bin``.
        """
        self.bin_upper_bounds = []
        self.num_bins = np.zeros(self.num_features, dtype=np.int32)
        self.cat_maps = {}
        self.has_nan = np.zeros(self.num_features, dtype=bool)
        mbf = getattr(self, "max_bin_by_feature", None)
        for f in range(self.num_features):
            # the per-feature bin count (max_bin_by_feature, config.h:591;
            # entries <= 1 fall back to max_bin)
            max_bin = self.max_bin
            if mbf is not None and f < len(mbf) and int(mbf[f]) > 1:
                max_bin = int(mbf[f])
            col = self.raw_data[:, f]
            finite = col[np.isfinite(col)]
            if f in self.categorical_feature:
                cats = np.unique(finite)
                self.cat_maps[f] = {v: i for i, v in enumerate(cats)}
                self.bin_upper_bounds.append(cats)  # the category values
                self.num_bins[f] = min(len(cats), max_bin)
                continue
            self.has_nan[f] = len(finite) < len(col)
            uniq = np.unique(finite)
            if len(uniq) <= max_bin - 1:
                # one bin per distinct value; boundaries between values
                ub = ((uniq[:-1] + uniq[1:]) / 2.0 if len(uniq) > 1
                      else np.array([]))
                ub = np.append(ub, np.inf)
            else:
                qs = np.quantile(finite, np.linspace(0, 1, max_bin),
                                 method="linear")
                ub = np.unique(qs[1:-1])
                ub = np.append(ub, np.inf)
            ub = self._merge_small_bins(ub, finite)
            forced = getattr(self, "forced_bins", {}).get(f)
            if forced is not None and len(forced):
                # forced edges always present; quantile edges fill the
                # remaining budget (the smallest dropped first on overflow)
                ub = np.unique(np.concatenate([forced, ub]))
                over = len(ub) - (max_bin - 1)
                if over > 0:
                    keep = np.isin(ub, forced) | np.isinf(ub)
                    ub = np.delete(ub, np.flatnonzero(~keep)[:over])
            self.bin_upper_bounds.append(ub.astype(np.float64))
            self.num_bins[f] = len(ub) + (1 if self.has_nan[f] else 0)

    def _merge_small_bins(self, ub, finite):
        """Merge adjacent bins holding fewer than ``min_data_in_bin``
        samples (LightGBM ``GreedyFindBin``'s per-bin minimum,
        config.h min_data_in_bin, io/bin.cpp): left-to-right accumulation,
        the tail bin merges backward if underfull."""
        mdb = getattr(self, "min_data_in_bin", 3)
        if mdb <= 1 or len(ub) <= 1:
            return ub
        idx = np.searchsorted(ub, finite, side="left")
        counts = np.bincount(idx, minlength=len(ub))
        merged = []
        acc = 0
        for i, c in enumerate(counts[:len(ub)]):
            acc += int(c)
            if acc >= mdb or i == len(ub) - 1:
                merged.append(ub[i])
                last_cnt = acc
                acc = 0
        if len(merged) > 1 and last_cnt < mdb:
            merged.pop(-2)  # fold the underfull tail into its neighbor
        return np.asarray(merged, dtype=np.float64)

    def _bin_data(self):
        """Map raw values to bin indices and put the bins (and the EFB
        layout) on the device. Features whose TRAINING data had missing
        values use bin 0 exclusively for NaN and shift the real-value bins
        by one (LightGBM NA-bin semantics, ``io/bin.cpp``). NaN in a feature
        without a training-time NA bin maps to the lowest bin (LightGBM
        converts missing to 0.0 when the train data had none). A categorical
        value maps to its category id, capped at ``max_bin - 1``.
        """
        n, F = self.raw_data.shape
        binned = np.zeros((n, F), dtype=np.int32)
        for f in range(F):
            col = self.raw_data[:, f]
            nan_mask = ~np.isfinite(col)
            if f in self.categorical_feature:
                binned[:, f] = np.clip(cat_bins(col, self.cat_maps[f]), 0,
                                       self.max_bin - 1)
            elif self.has_nan[f]:
                nb_real = int(self.num_bins[f]) - 1
                idx = np.searchsorted(self.bin_upper_bounds[f], col,
                                      side="left")
                idx = np.clip(idx, 0, nb_real - 1) + 1
                idx[nan_mask] = 0  # exclusive NA bin
                binned[:, f] = idx
            else:
                idx = np.searchsorted(self.bin_upper_bounds[f], col,
                                      side="left")
                idx = np.clip(idx, 0, self.num_bins[f] - 1)
                binned[:, f] = np.where(nan_mask, 0, idx)
        self._put_on_device(binned)

    def _put_on_device(self, binned: np.ndarray):
        F = binned.shape[1]
        self.max_num_bins = int(self.num_bins.max()) if F > 0 else 1
        self.binned = torch.as_tensor(binned, device=self.device)
        self.binned_t = _panel(binned, self.max_num_bins, self.device)
        # Exclusive Feature Bundling (lossless; see the module docstring)
        self.efb = None
        if self._enable_bundle and F >= 2:
            self.efb = build_efb(binned, np.asarray(self.num_bins),
                                 sorted(self.categorical_feature),
                                 self.max_bin, self.device)

    # ------------------------------------------------------------------
    def save_binary(self, filename: str):
        """Write the binned Dataset, its bin mapping and its fields
        (reference ``Dataset::SaveBinaryFile``; the JAX package's ``.bin``
        layout, an ``.npz``). Reload with ``Dataset(filename)``."""
        payload = dict(
            binned=self.binned.cpu().numpy(),
            raw_data=self.raw_data,
            num_bins=self.num_bins,
            has_nan=self.has_nan,
            max_bin=np.asarray(self.max_bin),
            feature_name=np.asarray(self.feature_name, dtype=object),
            categorical_feature=np.asarray(self.categorical_feature,
                                           dtype=np.int64),
        )
        for f, ub in enumerate(self.bin_upper_bounds):
            payload[f"ub_{f}"] = np.asarray(ub, dtype=np.float64)
        for f, mp in (self.cat_maps or {}).items():
            keys = np.asarray(list(mp.keys()), dtype=np.float64)
            vals = np.asarray(list(mp.values()), dtype=np.int64)
            payload[f"cat_{f}"] = np.stack([keys, vals.astype(np.float64)])
        for key in ("label", "weight", "init_score", "group"):
            if getattr(self, key) is not None:
                payload[key] = np.asarray(getattr(self, key))
        with open(filename, "wb") as fh:
            np.savez_compressed(fh, **payload)
        return self

    def _load_binary(self, filename, label, weight, init_score, group):
        z = np.load(filename, allow_pickle=True)
        binned = z["binned"]
        self.num_data, self.num_features = binned.shape
        self.raw_data = z["raw_data"]
        self.num_bins = z["num_bins"]
        self.has_nan = z["has_nan"]
        self.max_bin = int(z["max_bin"])
        self.min_data_in_bin = 3
        self.max_bin_by_feature = None
        self.forced_bins = {}
        self.use_missing, self.zero_as_missing = True, False
        self.feature_name = [str(x) for x in z["feature_name"]]
        self.categorical_feature = [int(x)
                                    for x in z["categorical_feature"]]
        self.bin_upper_bounds = [z[f"ub_{f}"]
                                 for f in range(self.num_features)]
        self.cat_maps = {}
        for f in self.categorical_feature:
            if f"cat_{f}" in z:
                keys, vals = z[f"cat_{f}"]
                self.cat_maps[f] = {k: int(v) for k, v in zip(keys, vals)}

        def field(given, key):
            if given is not None:
                return np.asarray(given, np.float64).ravel()
            return z[key] if key in z else None

        self.label = field(label, "label")
        self.weight = field(weight, "weight")
        self.init_score = field(init_score, "init_score")
        self.group = (np.asarray(group) if group is not None
                      else (z["group"] if "group" in z else None))
        # the EFB layout is derived: rebuilt from the loaded bins
        self._put_on_device(np.asarray(binned, dtype=np.int32))

    # ------------------------------------------------------------------
    # generic field access (reference Dataset.get_field/set_field)
    _FIELDS = ("label", "weight", "init_score", "group")

    def set_field(self, field_name: str, data):
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown dataset field '{field_name}'")
        if data is None or field_name != "group":
            setattr(self, field_name, None if data is None else
                    np.asarray(data, dtype=np.float64).ravel())
        else:
            self.group = np.asarray(data)
        return self

    def get_field(self, field_name: str):
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown dataset field '{field_name}'")
        return getattr(self, field_name)

    def set_init_score(self, init_score):
        return self.set_field("init_score", init_score)

    def get_init_score(self):
        return self.init_score

    def set_group(self, group):
        """The query sizes of the ranking objectives and metrics."""
        return self.set_field("group", group)

    def get_group(self):
        return self.group

    def set_label(self, label):
        return self.set_field("label", marshal_label(label))

    def get_label(self):
        return self.label

    def set_weight(self, weight):
        return self.set_field("weight", weight)

    def get_weight(self):
        return self.weight

    def num_data_rows(self):
        return self.num_data

    def num_feature(self):
        return self.num_features

    def construct(self):
        return self

    def create_valid(self, data, label=None, weight=None, init_score=None,
                     params=None):
        """Validation data binned with this Dataset's bin edges, on its
        device, with its own ``weight`` and ``init_score``."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       init_score=init_score, device=self.device)

    def get_data(self):
        return self.raw_data

    def get_feature_name(self):
        return list(self.feature_name)

    def get_params(self):
        return {"max_bin": self.max_bin,
                "categorical_feature": list(self.categorical_feature),
                "tree_learner": self.tree_learner}

    def get_ref_chain(self, ref_limit=100):
        """This Dataset and the ones it took its bin mapping from
        (``set_reference``, ``subset``), at most ``ref_limit``."""
        chain = [self]
        ref = getattr(self, "_reference", None)
        while ref is not None and len(chain) < ref_limit:
            chain.append(ref)
            ref = getattr(ref, "_reference", None)
        return set(chain)

    def set_feature_name(self, feature_name):
        if len(feature_name) != self.num_features:
            raise ValueError("feature_name length must equal num_features")
        self.feature_name = list(feature_name)
        return self

    def set_categorical_feature(self, categorical_feature):
        """Bin again with another set of categorical features
        (``Dataset.set_categorical_feature``; names or indices)."""
        new = _resolve_cat(categorical_feature or [], self.feature_name)
        if new == self.categorical_feature:
            return self
        self.categorical_feature = new
        self._find_bins()
        self._bin_data()
        return self

    def set_reference(self, reference):
        """Adopt another Dataset's bin mapping (``Dataset.set_reference``)."""
        self.bin_upper_bounds = reference.bin_upper_bounds
        self.num_bins = reference.num_bins
        self.categorical_feature = reference.categorical_feature
        self.cat_maps = reference.cat_maps
        self.has_nan = reference.has_nan
        self._reference = reference
        self._bin_data()
        return self

    def subset(self, used_indices, params=None):
        """Row-subset Dataset sharing this Dataset's bin mapping and device
        (``Dataset.subset``)."""
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = Dataset(self.raw_data[idx],
                       label=None if self.label is None else self.label[idx],
                       reference=self,
                       weight=None if self.weight is None
                       else self.weight[idx],
                       init_score=None if self.init_score is None
                       else self.init_score[idx],
                       feature_name=self.feature_name, params=params,
                       device=self.device)
        sub._reference = self
        return sub

    def add_features_from(self, other: "Dataset"):
        """Stack another Dataset's features beside this one's and bin again
        (``Dataset.add_features_from``)."""
        if other.num_data != self.num_data:
            raise ValueError("Datasets must have the same number of rows")
        self.raw_data = np.concatenate([self.raw_data, other.raw_data],
                                       axis=1)
        self.categorical_feature = sorted(
            set(self.categorical_feature)
            | {f + self.num_features for f in other.categorical_feature})
        self.feature_name = (list(self.feature_name)
                             + list(other.feature_name))
        self.num_features = self.raw_data.shape[1]
        self._find_bins()
        self._bin_data()
        return self

    # ------------------------------------------------------------------
    def bin_for_threshold(self, feature: int, value: float) -> int:
        """Largest bin whose upper bound is <= value (forced splits resolve
        a raw threshold to the binned split the grower uses)."""
        ub = np.asarray(self.bin_upper_bounds[feature], dtype=np.float64)
        shift = 1 if self.has_nan[feature] else 0
        return shift + int(np.clip(np.searchsorted(ub, value, side="left"),
                                   0, len(ub) - 1))

    def threshold_value(self, feature: int, bin_idx: int) -> float:
        """Real-valued threshold for splitting feature at bin boundary
        ``bin_idx`` (rows with bin <= bin_idx go left)."""
        ub = self.bin_upper_bounds[feature]
        if self.has_nan[feature]:
            if bin_idx <= 0:
                return float(-np.inf)  # NA-only split: no finite value left
            bin_idx -= 1
        if bin_idx >= len(ub) - 1:
            return float(np.inf)
        return float(ub[bin_idx])
