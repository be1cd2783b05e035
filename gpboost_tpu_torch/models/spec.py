"""Model specification of grouped random-effects models (PyTorch port).

The grouped half of the JAX package's ``gpboost_tpu/models/spec.py``: the
model is split into

- :class:`ModelSpec` — static structure (the components, the likelihood,
  the number of data points), hashable;
- :class:`ModelData` — a dataclass of tensors (level codes, slope
  covariates) on the model's device;
- a flat covariance-parameter vector laid out like the reference's
  ``cov_pars`` (``basic.py:4054-4095``): for the gaussian likelihood
  ``[sigma2_error, var(comp_0), var(comp_1), ...]``, for the others the
  component variances alone.

The Gaussian-process component of the JAX package (``GPRESpec``) has no
counterpart here: the Vecchia model keeps its own structure
(``models/vecchia_model.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class GroupedRESpec:
    """A grouped random effect (random intercept or random slope), as
    ``RECompGroup`` (``include/GPBoost/re_comp.h:219``). ``code_col`` is the
    column of :attr:`ModelData.group_codes` that holds its level codes
    (slopes share their base intercept's column, which is what lets
    ``drop_intercept_group_rand_effect`` drop an intercept and keep its
    slope, ``re_model_template.h:69,242-266``); ``slope_data_idx`` the
    column of :attr:`ModelData.slope_data` that multiplies a slope."""
    num_groups: int
    is_slope: bool = False
    slope_data_idx: int = -1
    num_cov_par: int = 1
    code_col: int = 0


@dataclass(frozen=True)
class ModelSpec:
    """Static model structure."""
    components: Tuple[GroupedRESpec, ...]
    likelihood: str = "gaussian"
    num_data: int = 0

    @property
    def is_gaussian(self) -> bool:
        return self.likelihood == "gaussian"

    @property
    def num_cov_par(self) -> int:
        return (1 if self.is_gaussian else 0) + sum(
            c.num_cov_par for c in self.components)

    def cov_par_slices(self):
        """(component, start, stop) into the flat cov_par vector."""
        off = 1 if self.is_gaussian else 0
        out = []
        for c in self.components:
            out.append((c, off, off + c.num_cov_par))
            off += c.num_cov_par
        return out


@dataclass
class ModelData:
    """Tensors of one grouped model: level codes [n, n_code_cols] (int64)
    and slope covariates [n, n_slopes] (or None)."""
    group_codes: torch.Tensor
    slope_data: Optional[torch.Tensor] = None


def _as_columns(a, dtype=None) -> np.ndarray:
    arr = np.asarray(a) if dtype is None else np.asarray(a, dtype=dtype)
    return arr[:, None] if arr.ndim == 1 else arr


def make_model_data(group_data, group_rand_coef_data=None,
                    ind_effect_group_rand_coef=None,
                    drop_intercept_group_rand_effect=None,
                    dtype=torch.float64, device="cpu"):
    """(components, data, info) of a grouped model from the user's inputs,
    as the JAX package's ``make_model_data`` marshals them (``basic.py``
    ``GPModel.__init__``): level codes are the indices of the sorted unique
    labels (compared as strings), one intercept per column of
    ``group_data``, one slope per column of ``group_rand_coef_data`` on the
    (1-based) column ``ind_effect_group_rand_coef`` names; a dropped
    intercept keeps its code column for its slopes. ``info`` holds
    ``num_data`` and ``group_maps`` (the sorted labels of each column, which
    prediction needs to code new data and to tell unseen levels)."""
    gd = _as_columns(group_data)
    n = gd.shape[0]
    codes = np.empty(gd.shape, dtype=np.int64)
    components, group_maps, base_num_groups = [], [], []
    for j in range(gd.shape[1]):
        uniq, inv = np.unique(gd[:, j].astype(str), return_inverse=True)
        codes[:, j] = inv.reshape(-1)
        group_maps.append(uniq)
        base_num_groups.append(len(uniq))
        components.append(GroupedRESpec(num_groups=len(uniq), code_col=j))
    slope = None
    slope_base_cols = []
    if group_rand_coef_data is not None:
        rc = _as_columns(group_rand_coef_data, np.float64)
        if rc.shape[0] != n:
            raise ValueError(
                f"group_rand_coef_data has {rc.shape[0]} rows, group_data "
                f"{n}")
        if ind_effect_group_rand_coef is None:
            raise ValueError("'ind_effect_group_rand_coef' is required with "
                             "'group_rand_coef_data'")
        inds = np.atleast_1d(np.asarray(ind_effect_group_rand_coef)).astype(
            int)
        if len(inds) != rc.shape[1]:
            raise ValueError(
                f"ind_effect_group_rand_coef has {len(inds)} entries for "
                f"{rc.shape[1]} columns of group_rand_coef_data")
        for j in range(rc.shape[1]):
            base = int(inds[j]) - 1         # the reference's 1-based index
            if not 0 <= base < gd.shape[1]:
                raise ValueError(
                    f"ind_effect_group_rand_coef[{j}] = {inds[j]}: group_data "
                    f"has {gd.shape[1]} column(s)")
            components.append(GroupedRESpec(
                num_groups=base_num_groups[base], is_slope=True,
                slope_data_idx=j, code_col=base))
            slope_base_cols.append(base)
        slope = torch.as_tensor(rc, dtype=dtype, device=device)
    if drop_intercept_group_rand_effect is not None:
        drop = np.atleast_1d(
            np.asarray(drop_intercept_group_rand_effect)).astype(bool)
        for k in range(gd.shape[1]):
            if k < len(drop) and drop[k] and k not in slope_base_cols:
                raise ValueError(
                    f"Cannot drop intercept random effect number {k} as this "
                    "random effect has no corresponding random coefficients")
        components = [c for c in components
                      if c.is_slope or not (c.code_col < len(drop)
                                            and drop[c.code_col])]
    data = ModelData(
        group_codes=torch.as_tensor(codes, device=device), slope_data=slope)
    return components, data, {"num_data": n, "group_maps": group_maps}
