"""Dataset: binned feature store for histogram-based tree boosting.

The equivalent of the reference's ``Dataset``/``BinMapper`` stack
(``src/LightGBM/io/bin.cpp`` quantile binning, ``dataset.h:283``): features
are quantile-binned once on the host, and the bins live on the device in two
layouts:

- ``binned`` ``[n, F]`` int32, rows-major — the reference layout, read by
  ``predict_tree_binned`` and the plain histogram;
- ``binned_t`` ``[F, n]`` uint8, features-major — the panel the CUDA
  histogram kernel streams and ``partition_rows`` reads a row of; present
  when ``max_num_bins <= 256`` (a feature with missing values has up to 256
  bins: 255 value bins and the NA bin; uint8 holds 0...255).

Binning is host numpy and follows the JAX package line for line, so that bin
edges are identical, not merely close.

Not ported (ROADMAP.md Queue A, item 18b): categorical features, pandas /
sparse / file input, ``save_binary``, forced bins and per-feature
``max_bin``. Exclusive Feature Bundling is left out as well: it is lossless
and finds nothing to bundle in dense data, so the trees are the same without
it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.utils import resolve_device

MAX_BIN_DEFAULT = 255
_TAIL = "Queue A, item 18b"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"Dataset: {what} is not ported to gpboost_tpu_torch yet "
        f"(ROADMAP.md {_TAIL}); ported: a dense numeric array")


class Dataset:
    """Training data container (mirrors ``gpboost.Dataset``, ``basic.py:1180``).

    Parameters
    ----------
    data : array-like [n, F], numeric; NaN / Inf mark missing values
    label : array-like [n]
    reference : a Dataset whose bin mapping is adopted (validation or
        prediction data binned like the training data)
    max_bin : number of histogram bins per feature
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
        if categorical_feature is not None and len(categorical_feature):
            raise _not_ported("categorical_feature")
        if group is not None:
            raise _not_ported("group (ranking)")
        if isinstance(data, str):
            raise _not_ported("reading data from a file")
        if hasattr(data, "iloc") or hasattr(data, "tocsr"):
            raise _not_ported("pandas / scipy.sparse input")
        self.device = resolve_device(device)
        self.tree_learner = p.get("tree_learner", "data")
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        self.num_data, self.num_features = data.shape
        self.raw_data = data
        self.label = None if label is None else np.asarray(
            label, dtype=np.float64).ravel()
        self.weight = None if weight is None else np.asarray(
            weight, dtype=np.float64).ravel()
        self.init_score = None if init_score is None else np.asarray(
            init_score, dtype=np.float64).ravel()
        self.group = None
        self.max_bin = max_bin
        self.min_data_in_bin = int(p.get("min_data_in_bin", 3))
        self.feature_name = (list(feature_name) if feature_name is not None
                             else [f"Column_{i}"
                                   for i in range(self.num_features)])
        self.categorical_feature = []
        self.cat_maps = {}

        if reference is not None:
            self.bin_upper_bounds = reference.bin_upper_bounds
            self.num_bins = reference.num_bins
            self.has_nan = reference.has_nan
        else:
            self._find_bins()
        self._bin_data()

    # ------------------------------------------------------------------
    def _find_bins(self):
        """Quantile bin boundaries per feature (``BinMapper::FindBin``).

        Features containing missing values get an EXCLUSIVE NA bin at index 0
        (LightGBM ``MissingType::NaN`` semantics, ``io/bin.cpp``): real-value
        bins shift up by one and the split finder learns a per-node default
        direction for the NA bin.
        """
        self.bin_upper_bounds = []
        self.num_bins = np.zeros(self.num_features, dtype=np.int32)
        self.has_nan = np.zeros(self.num_features, dtype=bool)
        max_bin = self.max_bin
        for f in range(self.num_features):
            col = self.raw_data[:, f]
            finite = col[np.isfinite(col)]
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
            self.bin_upper_bounds.append(ub.astype(np.float64))
            self.num_bins[f] = len(ub) + (1 if self.has_nan[f] else 0)

    def _merge_small_bins(self, ub, finite):
        """Merge adjacent bins holding fewer than ``min_data_in_bin``
        samples (LightGBM ``GreedyFindBin``'s per-bin minimum,
        config.h min_data_in_bin, io/bin.cpp): left-to-right accumulation,
        the tail bin merges backward if underfull."""
        mdb = self.min_data_in_bin
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
        """Map raw values to bin indices. Features whose TRAINING data had
        missing values use bin 0 exclusively for NaN and shift the real-value
        bins by one (LightGBM NA-bin semantics, ``io/bin.cpp``). NaN in a
        feature without a training-time NA bin maps to the lowest bin
        (LightGBM converts missing to 0.0 when the train data had none).
        """
        n, F = self.raw_data.shape
        binned = np.zeros((n, F), dtype=np.int32)
        for f in range(F):
            col = self.raw_data[:, f]
            nan_mask = ~np.isfinite(col)
            if self.has_nan[f]:
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
        self.max_num_bins = int(self.num_bins.max()) if F > 0 else 1
        self.binned = torch.as_tensor(binned, device=self.device)
        self.binned_t = None
        if self.max_num_bins <= 256:
            self.binned_t = torch.as_tensor(
                np.ascontiguousarray(binned.T.astype(np.uint8)),
                device=self.device)

    # ------------------------------------------------------------------
    # generic field access (reference Dataset.get_field/set_field)
    _FIELDS = ("label", "weight", "init_score")

    def set_field(self, field_name: str, data):
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown dataset field '{field_name}'")
        setattr(self, field_name, None if data is None else
                np.asarray(data, dtype=np.float64).ravel())
        return self

    def get_field(self, field_name: str):
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown dataset field '{field_name}'")
        return getattr(self, field_name)

    def set_init_score(self, init_score):
        return self.set_field("init_score", init_score)

    def get_init_score(self):
        return self.init_score

    def set_label(self, label):
        return self.set_field("label", label)

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

    def save_binary(self, filename: str):
        raise _not_ported("save_binary")

    def subset(self, used_indices, params=None):
        """Row-subset Dataset sharing this Dataset's bin mapping and device
        (``Dataset.subset``)."""
        idx = np.asarray(used_indices, dtype=np.int64)
        return Dataset(self.raw_data[idx],
                       label=None if self.label is None else self.label[idx],
                       reference=self,
                       weight=None if self.weight is None
                       else self.weight[idx],
                       init_score=None if self.init_score is None
                       else self.init_score[idx],
                       feature_name=self.feature_name, params=params,
                       device=self.device)

    # ------------------------------------------------------------------
    def bin_for_threshold(self, feature: int, value: float) -> int:
        """Largest bin whose upper bound is <= value (resolves a raw
        threshold to the binned split the grower uses)."""
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
