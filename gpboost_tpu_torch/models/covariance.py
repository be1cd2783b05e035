"""Covariance assembly of grouped and exact-GP random-effects models
(PyTorch port of ``gpboost_tpu/models/covariance.py``).

The total random-effects covariance Sigma_total = sum_c Z_c Sigma_c Z_c' of
the components (``RECompGroup::AddSigma`` / ``RECompGP``,
``include/GPBoost/re_comp.h:219,778``), dense: a grouped component is an
equality mask of its level codes (times the slope covariates), a GP
component its covariance function on the coordinates' distances (times the
random-coefficient covariates). ``cluster_ids`` zero the entries between
clusters. Every piece is differentiable in the parameters by autograd.
The grouped-only models never build these [n, n] matrices (the Woodbury
route of ``models/grouped.py``); they use :func:`split_cov_pars` and
:func:`_grouped_cross_cov` for the levels that training never saw.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from gpboost_tpu_torch.models.spec import (GroupedRESpec, ModelData,
                                           ModelSpec)
from gpboost_tpu_torch.ops.cov_fns import euclidean_distance


def _grouped_cross_cov(codes1: torch.Tensor, codes2: torch.Tensor,
                       z1: Optional[torch.Tensor] = None,
                       z2: Optional[torch.Tensor] = None,
                       dtype=torch.float64) -> torch.Tensor:
    """[n1, n2] covariance of a unit-variance grouped effect: 1 where the
    codes are equal (times z1_i z2_j for a slope), else 0."""
    eq = (codes1[:, None] == codes2[None, :]).to(dtype)
    if z1 is not None:
        eq = eq * (z1[:, None] * z2[None, :])
    return eq


def component_cov(comp, pars: torch.Tensor, data: ModelData,
                  data2: Optional[ModelData] = None,
                  cross_dists: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Covariance of one component: [n, n] on ``data``, or with ``data2``
    (e.g. prediction points) the cross-covariance [n2, n] of its rows with
    ``data``'s. Isotropic GPs use ``data.dists`` / ``cross_dists`` where
    given."""
    d2 = data if data2 is None else data2
    if isinstance(comp, GroupedRESpec):
        z1 = z2 = None
        if comp.is_slope:
            z1 = d2.slope_data[:, comp.slope_data_idx]
            z2 = data.slope_data[:, comp.slope_data_idx]
        return pars[0] * _grouped_cross_cov(
            d2.group_codes[:, comp.code_col],
            data.group_codes[:, comp.code_col], z1, z2, dtype=pars.dtype)
    cf = comp.cov_fn
    if cf.is_isotropic:
        if data2 is None:
            dist = (data.dists if data.dists is not None
                    else euclidean_distance(data.coords, data.coords))
        else:
            dist = (cross_dists if cross_dists is not None
                    else euclidean_distance(d2.coords, data.coords))
        cov = cf.cov_matrix(pars, dist=dist)
    else:
        cov = cf.cov_matrix(pars, coords1=d2.coords, coords2=data.coords)
    if comp.is_random_coef:
        z1 = d2.gp_rand_coef_data[:, comp.rand_coef_data_idx]
        z2 = data.gp_rand_coef_data[:, comp.rand_coef_data_idx]
        cov = cov * (z1[:, None] * z2[None, :])
    return cov


def cluster_mask(data: ModelData, data2: Optional[ModelData] = None):
    """[n2, n] 0/1 mask of equal cluster codes, or None without clusters."""
    if data.cluster_codes is None:
        return None
    c2 = data.cluster_codes
    c1 = c2 if data2 is None else data2.cluster_codes
    return c1[:, None] == c2[None, :]


def total_re_cov(spec: ModelSpec, data: ModelData,
                 cov_pars_comps: Sequence[torch.Tensor],
                 data2: Optional[ModelData] = None,
                 cross_dists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of the components' covariances (no error term), zero between
    clusters (the reference holds one block per cluster,
    ``re_model_template.h:5020-5144``). ``cov_pars_comps`` is the
    per-component list of :func:`split_cov_pars`."""
    total = None
    for comp, pars in zip(spec.components, cov_pars_comps):
        cov = component_cov(comp, pars, data, data2, cross_dists)
        total = cov if total is None else total + cov
    mask = cluster_mask(data, data2)
    if mask is not None:
        total = torch.where(mask, total, 0.0)
    return total


def split_cov_pars(spec: ModelSpec, cov_pars: torch.Tensor):
    """(sigma2_error or None, [per-component parameters]) of the flat
    vector: the error variance first for the gaussian likelihood, then the
    components' blocks in declaration order (``re_model_template.h``)."""
    comps = [cov_pars[a:b] for _, a, b in spec.cov_par_slices()]
    return (cov_pars[0] if spec.is_gaussian else None), comps
