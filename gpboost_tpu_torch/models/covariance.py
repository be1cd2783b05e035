"""Covariance pieces of grouped random-effects models (PyTorch port).

What the grouped model needs of the JAX package's
``gpboost_tpu/models/covariance.py``: the split of the flat parameter vector
(:func:`split_cov_pars`) and the covariance of one grouped component
between two sets of rows (:func:`_grouped_cross_cov`: equal level codes,
times the slope covariates), which the grouped predictor uses for the
levels that training never saw. The dense total covariance of the exact
models (``total_re_cov``) serves ROADMAP.md Queue A, item 16's exact GP and
is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from gpboost_tpu_torch.models.spec import ModelSpec


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


def split_cov_pars(spec: ModelSpec, cov_pars: torch.Tensor):
    """(sigma2_error or None, [per-component parameters]) of the flat
    vector: the error variance first for the gaussian likelihood, then the
    components' blocks in declaration order (``re_model_template.h``)."""
    comps = [cov_pars[a:b] for _, a, b in spec.cov_par_slices()]
    return (cov_pars[0] if spec.is_gaussian else None), comps
