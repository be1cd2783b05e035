"""Simulated Gaussian predictive variances (``nsim_var_pred``; PyTorch port of
``gpboost_tpu/models/predvar.py``).

The reference draws ``nsim_var_pred`` vectors for the variances of
full-scale tapering (``re_model_template.h:10839``); like the JAX package
this uses the Bekas et al. (2007) diagonal estimator the reference documents
as its alternative (``re_model_template.h:10880``):

    diag(C Psi^-1 C')_i  ~=  mean_k  v_k[i] (C Psi^-1 C' v_k)[i]

with Rademacher probes v: ``nsim`` solves with Psi instead of one a
prediction point. The cross-covariance C is built in chunks of prediction
points (never [n_p, n]); the probes come from a ``torch.Generator`` seeded
with ``seed`` on the model's device (the JAX package's own stream cannot be
reproduced, so the two packages' simulated variances agree in distribution,
not in their bits).
"""
from __future__ import annotations

from typing import Callable

import torch

from gpboost_tpu_torch.ops import cg as cgops

CHUNK = 2048


def sim_pred_mean_var(cross_of: Callable, coords_pred: torch.Tensor,
                      psi_inv_mul: Callable, psi_inv_r: torch.Tensor,
                      nsim: int, seed: int = 1, chunk: int = CHUNK):
    """(mean [n_p], quad [n_p]) with quad ~ diag(C Psi^-1 C'):
    ``cross_of(coords_chunk)`` gives the cross-covariance rows [c, n] of a
    chunk of prediction points, ``psi_inv_mul`` applies Psi^-1 to [n, q].
    The caller forms var = prior - quad (+ nugget)."""
    n_p = coords_pred.shape[0]
    n = psi_inv_r.shape[0]
    gen = torch.Generator(device=psi_inv_r.device).manual_seed(int(seed))
    V = cgops.rademacher_probes(gen, n_p, int(nsim)).to(psi_inv_r.dtype)
    starts = range(0, n_p, chunk)
    # pass 1: W = C' V over the chunks, then nsim solves in one batch
    W = torch.zeros((n, int(nsim)), dtype=psi_inv_r.dtype,
                    device=psi_inv_r.device)
    for s in starts:
        W = W + cross_of(coords_pred[s:s + chunk]).T @ V[s:s + chunk]
    Z = psi_inv_mul(W)
    # pass 2: the means and the Bekas diagonal chunk by chunk
    means, quads = [], []
    for s in starts:
        cr = cross_of(coords_pred[s:s + chunk])
        means.append(cr @ psi_inv_r)
        quads.append(torch.mean(V[s:s + chunk] * (cr @ Z), dim=1))
    return torch.cat(means), torch.cat(quads)
