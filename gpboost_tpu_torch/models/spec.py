"""Model specification of grouped and exact-GP random-effects models
(PyTorch port of ``gpboost_tpu/models/spec.py``). The model is split into

- :class:`ModelSpec` — static structure (the components, the likelihood,
  the number of data points), hashable;
- :class:`ModelData` — a dataclass of tensors (level codes, slope
  covariates, GP coordinates and their distances, GP random-coefficient
  covariates, cluster codes) on the model's device;
- a flat covariance-parameter vector laid out like the reference's
  ``cov_pars`` (``basic.py:4054-4095``): for the gaussian likelihood
  ``[sigma2_error, pars(comp_0), pars(comp_1), ...]``, for the others the
  components' parameters alone; a grouped component has one (its
  variance), a GP component ``CovFunction.num_cov_par``.

The Vecchia model keeps its own structure (``models/vecchia_model.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gpboost_tpu_torch.ops.cov_fns import CovFunction, euclidean_distance


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
class GPRESpec:
    """A Gaussian-process random effect (``RECompGP``, ``re_comp.h:778``);
    with ``is_random_coef`` a GP random coefficient whose covariance is
    multiplied by column ``rand_coef_data_idx`` of
    :attr:`ModelData.gp_rand_coef_data` on both sides."""
    cov_fn: CovFunction
    is_random_coef: bool = False
    rand_coef_data_idx: int = -1

    @property
    def num_cov_par(self) -> int:
        return self.cov_fn.num_cov_par


@dataclass(frozen=True)
class ModelSpec:
    """Static model structure: grouped components first, then the GP ones
    (the JAX package's order)."""
    components: Tuple[object, ...]
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
    """Tensors of one model, each None where the structure has none: level
    codes [n, n_code_cols] (int64), slope covariates [n, n_slopes], GP
    coordinates [n, d] and (isotropic exact GP) their distances [n, n], GP
    random-coefficient covariates [n, n_rc], cluster codes [n] (int64),
    observation weights [n] (the reference's ``weights``: they divide the
    gaussian error variance, multiply a non-Gaussian log-likelihood, and
    are the trial counts of the binomial-type families)."""
    group_codes: Optional[torch.Tensor] = None
    slope_data: Optional[torch.Tensor] = None
    coords: Optional[torch.Tensor] = None
    dists: Optional[torch.Tensor] = None
    gp_rand_coef_data: Optional[torch.Tensor] = None
    cluster_codes: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None


def _as_columns(a, dtype=None) -> np.ndarray:
    arr = np.asarray(a) if dtype is None else np.asarray(a, dtype=dtype)
    return arr[:, None] if arr.ndim == 1 else arr


def make_model_data(group_data=None, group_rand_coef_data=None,
                    ind_effect_group_rand_coef=None,
                    drop_intercept_group_rand_effect=None,
                    dtype=torch.float64, device="cpu", gp_coords=None,
                    cov_fn: Optional[CovFunction] = None,
                    gp_rand_coef_data=None, cluster_ids=None,
                    dense_dists: bool = False, weights=None):
    """(components, data, info) of a model from the user's inputs, as the
    JAX package's ``make_model_data`` and ``GPModel.__init__`` marshal them
    (``basic.py`` ``GPModel.__init__``).

    Grouped part: level codes are the indices of the sorted unique labels
    (compared as strings), one intercept per column of ``group_data``, one
    slope per column of ``group_rand_coef_data`` on the (1-based) column
    ``ind_effect_group_rand_coef`` names; a dropped intercept keeps its
    code column for its slopes. GP part (``gp_coords`` with ``cov_fn``): one
    GP component, then one GP random coefficient per column of
    ``gp_rand_coef_data``; with ``dense_dists`` and an isotropic
    covariance the [n, n] distances are computed once (JAX
    ``gp_model.py:165-166``). ``cluster_ids``: dense codes, the indices of
    the sorted unique ids (JAX ``gp_model.py:143-147``). ``weights``: the
    observation weights [n]. ``info`` holds
    ``num_data``, ``group_maps`` (the sorted labels of each column, which
    prediction needs to code new data and to tell unseen levels) and
    ``cluster_map`` (the sorted cluster ids, or None)."""
    components, group_maps = [], []
    n = None
    codes_t = slope = None
    if group_data is not None:
        codes_t, slope, components, group_maps = _grouped_part(
            group_data, group_rand_coef_data, ind_effect_group_rand_coef,
            drop_intercept_group_rand_effect, dtype, device)
        n = codes_t.shape[0]
    data = ModelData(group_codes=codes_t, slope_data=slope)
    if gp_coords is not None:
        coords = _as_columns(gp_coords, np.float64)
        if n is not None and coords.shape[0] != n:
            raise ValueError(f"gp_coords has {coords.shape[0]} rows, "
                             f"group_data {n}")
        n = coords.shape[0]
        data.coords = torch.as_tensor(coords, dtype=dtype, device=device)
        components.append(GPRESpec(cov_fn=cov_fn))
        if gp_rand_coef_data is not None:
            rc = _as_columns(gp_rand_coef_data, np.float64)
            if rc.shape[0] != n:
                raise ValueError(f"gp_rand_coef_data has {rc.shape[0]} "
                                 f"rows, gp_coords {n}")
            data.gp_rand_coef_data = torch.as_tensor(rc, dtype=dtype,
                                                     device=device)
            components += [GPRESpec(cov_fn=cov_fn, is_random_coef=True,
                                    rand_coef_data_idx=j)
                           for j in range(rc.shape[1])]
        if dense_dists and cov_fn.is_isotropic:
            data.dists = euclidean_distance(data.coords, data.coords)
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64).ravel()
        if w.shape[0] != n:
            raise ValueError(f"weights has {w.shape[0]} entries for {n} "
                             "data points")
        data.weights = torch.as_tensor(w, dtype=dtype, device=device)
    cluster_map = None
    if cluster_ids is not None:
        cid = np.asarray(cluster_ids).ravel()
        if cid.shape[0] != n:
            raise ValueError(f"cluster_ids has {cid.shape[0]} entries for "
                             f"{n} data points")
        cluster_map, inv = np.unique(cid, return_inverse=True)
        data.cluster_codes = torch.as_tensor(inv.reshape(-1), device=device)
    return components, data, {"num_data": n, "group_maps": group_maps,
                              "cluster_map": cluster_map}


def map_cluster_ids(cluster_map: np.ndarray, cluster_ids_pred) -> np.ndarray:
    """Codes of prediction cluster ids: a training id's code, an unseen id a
    fresh code >= the number of training clusters, one per distinct unseen
    id in order of first appearance (so it has no observed points and the
    prediction there is the prior; JAX ``gp_model.py:415-433``)."""
    vals = np.asarray(cluster_ids_pred).ravel()
    lookup = {(v.item() if hasattr(v, "item") else v): i
              for i, v in enumerate(cluster_map)}
    new_codes = {}
    out = np.empty(len(vals), dtype=np.int64)
    for i, v in enumerate(vals):
        key = v.item() if hasattr(v, "item") else v
        if key in lookup:
            out[i] = lookup[key]
        else:
            out[i] = new_codes.setdefault(key, len(lookup) + len(new_codes))
    return out


def _grouped_part(group_data, group_rand_coef_data,
                  ind_effect_group_rand_coef,
                  drop_intercept_group_rand_effect, dtype, device):
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
    return (torch.as_tensor(codes, device=device), slope, components,
            group_maps)
