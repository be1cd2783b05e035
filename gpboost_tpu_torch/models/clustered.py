"""Batched per-cluster solves of ``cluster_ids`` models (PyTorch port of
``gpboost_tpu/models/clustered.py``).

The reference keeps the independent realisations of ``cluster_ids`` as
separate blocks and loops over them (``re_model_template.h:5020-5144``).
Here the clusters are padded to a common size m and batched into
[C, m, m] blocks: one batched Cholesky instead of C factorisations, and
no [n, n] matrix. Padding rows and columns are the identity, with a zero
residual, so they add nothing to the log-determinant or the quadratic form.

Scope, as in the JAX package (``gp_model.py:340-345``): the gaussian
likelihood, one isotropic GP component, ``gp_approx="none"``. Every other
``cluster_ids`` model takes the dense route with the block-diagonal mask
(``covariance.total_re_cov``).

Determinism on the GPU: the blocks are filled by gathers from the data
(each row's position in the blocks is fixed at construction) and a
solution goes back to the row order by the inverse gather, not by a
scatter; the residual and the coordinates need no gradient, so no backward
scatters either. This module also predicts (the JAX package predicts
``cluster_ids`` models densely): a prediction point sees only its own
cluster's block, and a point in a cluster training never saw gets the
prior.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch.ops.cov_fns import euclidean_distance

LOG_2PI = math.log(2.0 * math.pi)
# prediction points handled at once (bounds the gathered [k, m, m] factors)
_PRED_CHUNK = 4096


class ClusterBlocks(NamedTuple):
    """Static padded layout of the clusters."""
    idx: torch.Tensor       # [C, m] row indices into the data (pad: 0)
    valid: torch.Tensor     # [C, m] bool
    coords: torch.Tensor    # [C, m, d] padded coordinates (pad: 0)
    pos: torch.Tensor       # [n] flat position of each row in [C * m]
    num_data: int


def prepare_blocks(cluster_codes: np.ndarray, coords: np.ndarray,
                   dtype=torch.float64, device="cpu") -> ClusterBlocks:
    """Blocks of the dense cluster codes 0..C-1, rows in their data order
    within a cluster."""
    codes = np.asarray(cluster_codes).ravel()
    order = np.argsort(codes, kind="stable")
    counts = np.bincount(codes)
    C, m = len(counts), int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(codes)) - np.repeat(starts, counts)
    flat = np.empty(len(codes), dtype=np.int64)
    flat[order] = codes[order] * m + rank
    idx = np.zeros(C * m, dtype=np.int64)
    valid = np.zeros(C * m, dtype=bool)
    idx[flat] = np.arange(len(codes))
    valid[flat] = True
    coords = np.asarray(coords, np.float64)
    coords_pad = np.where(valid[:, None], coords[idx], 0.0)
    return ClusterBlocks(
        torch.as_tensor(idx.reshape(C, m), device=device),
        torch.as_tensor(valid.reshape(C, m), device=device),
        torch.as_tensor(coords_pad.reshape(C, m, -1), dtype=dtype,
                        device=device),
        torch.as_tensor(flat, device=device), num_data=len(codes))


def _gather_blocks(blocks: ClusterBlocks, v: torch.Tensor) -> torch.Tensor:
    """[n] or [n, k] -> [C, m] or [C, m, k], zeros at the padding."""
    g = v[blocks.idx]
    mask = blocks.valid if v.dim() == 1 else blocks.valid[..., None]
    return torch.where(mask, g, 0.0)


def _block_dists(blocks: ClusterBlocks) -> torch.Tensor:
    diff = blocks.coords[:, :, None, :] - blocks.coords[:, None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=0.0))


def _psi_blocks(cov_fn, gp_pars: torch.Tensor, noise,
                blocks: ClusterBlocks) -> torch.Tensor:
    """[C, m, m] per-cluster covariance plus ``noise`` I (sigma2, or 1 for
    the tilde form), the identity at the padding."""
    cov = cov_fn.cov_matrix(gp_pars, dist=_block_dists(blocks))
    m = blocks.idx.shape[1]
    eye = torch.eye(m, dtype=cov.dtype, device=cov.device)
    psi = cov + noise * eye
    pair = blocks.valid[:, :, None] & blocks.valid[:, None, :]
    return torch.where(pair, psi, eye)


def _quad_logdet(psi: torch.Tensor, rb: torch.Tensor):
    chol = torch.linalg.cholesky(psi)
    alpha = torch.linalg.solve_triangular(chol, rb[..., None],
                                          upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1,
                                                      dim2=2)))
    return torch.sum(alpha * alpha), logdet


def nll_gaussian(cov_fn, cov_pars: torch.Tensor, blocks: ClusterBlocks,
                 r: torch.Tensor) -> torch.Tensor:
    """Exact Gaussian NLL of the residual r at cov_pars = [nugget, GP
    pars...], by the batched Cholesky."""
    psi = _psi_blocks(cov_fn, cov_pars[1:], cov_pars[0], blocks)
    quad, logdet = _quad_logdet(psi, _gather_blocks(blocks, r))
    return 0.5 * (quad + logdet + blocks.num_data * LOG_2PI)


def nll_profiled(cov_fn, ratio_pars: torch.Tensor, blocks: ClusterBlocks,
                 r: torch.Tensor):
    """Profiled-nugget NLL, (nll, sigma2_hat); ratio_pars the GP
    parameters with the variance relative to the nugget."""
    psi = _psi_blocks(cov_fn, ratio_pars, 1.0, blocks)
    quad, logdet = _quad_logdet(psi, _gather_blocks(blocks, r))
    n = blocks.num_data
    sigma2_hat = quad / n
    nll = 0.5 * n * (torch.log(sigma2_hat) + LOG_2PI + 1.0) + 0.5 * logdet
    return nll, sigma2_hat


def psi_inv_blocks_mul(cov_fn, cov_pars: torch.Tensor, blocks: ClusterBlocks,
                       V: torch.Tensor) -> torch.Tensor:
    """Psi^-1 V for V [n] or [n, k], by the batched block solves; the
    solution returns to the row order by a gather."""
    chol = torch.linalg.cholesky(
        _psi_blocks(cov_fn, cov_pars[1:], cov_pars[0], blocks))
    single = V.dim() == 1
    Vb = _gather_blocks(blocks, V[:, None] if single else V)
    sol = torch.cholesky_solve(Vb, chol)
    out = sol.reshape(-1, sol.shape[-1])[blocks.pos]
    return out[:, 0] if single else out


def wls_coefficients(cov_fn, cov_pars: torch.Tensor, blocks: ClusterBlocks,
                     y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """GLS coefficients by the block solves (one factorisation)."""
    w = psi_inv_blocks_mul(cov_fn, cov_pars, blocks,
                           torch.cat([X, y[:, None]], 1))
    return torch.linalg.solve(X.T @ w[:, :-1], X.T @ w[:, -1])


def nll_profiled_value_and_grad(cov_fn, log_ratio_pars: torch.Tensor,
                                blocks: ClusterBlocks, r: torch.Tensor):
    """(nll, d nll / d log_ratio_pars, sigma2_hat), by autograd."""
    th = log_ratio_pars.detach().requires_grad_(True)
    with torch.enable_grad():
        nll, s2 = nll_profiled(cov_fn, torch.exp(th), blocks, r.detach())
        (g,) = ag.grad(nll, th)
    return nll.detach(), g, s2.detach()


def predict(cov_fn, cov_pars: torch.Tensor, blocks: ClusterBlocks,
            r: torch.Tensor, coords_pred: torch.Tensor,
            codes_pred: torch.Tensor, predict_var: bool,
            predict_cov_mat: bool, predict_response: bool):
    """Posterior prediction at ``coords_pred`` in clusters ``codes_pred``
    (a code >= C: a cluster training never saw): the exact predictor of
    ``gaussian.predict`` on the block-diagonal covariance, per cluster.
    Returns (mean, var or None, cov or None)."""
    sigma2, gp = cov_pars[0], cov_pars[1:]
    C = blocks.idx.shape[0]
    chol = torch.linalg.cholesky(_psi_blocks(cov_fn, gp, sigma2, blocks))
    alpha = torch.cholesky_solve(_gather_blocks(blocks, r)[..., None],
                                 chol)[..., 0]                    # [C, m]
    seen = codes_pred < C
    cc = torch.where(seen, codes_pred, 0)
    n_p = coords_pred.shape[0]
    mean = torch.zeros(n_p, dtype=r.dtype, device=r.device)
    want = predict_var or predict_cov_mat
    vs = []
    for s in range(0, n_p, _PRED_CHUNK):
        sl = slice(s, s + _PRED_CHUNK)
        c = cc[sl]
        d = torch.sqrt(torch.clamp(torch.sum(
            (coords_pred[sl, None, :] - blocks.coords[c]) ** 2, -1), min=0.0))
        cross = torch.where(blocks.valid[c] & seen[sl, None],
                            cov_fn.cov_matrix(gp, dist=d), 0.0)   # [k, m]
        mean[sl] = torch.sum(cross * alpha[c], dim=1)
        if want:
            vs.append(torch.linalg.solve_triangular(
                chol[c], cross[..., None], upper=False)[..., 0])
    if not want:
        return mean, None, None
    v = torch.cat(vs)                                             # [n_p, m]
    prior_var = gp[0]
    if predict_cov_mat:
        same = codes_pred[:, None] == codes_pred[None, :]
        prior = cov_fn.cov_matrix(
            gp, dist=euclidean_distance(coords_pred, coords_pred))
        cov = torch.where(same, prior - v @ v.T, 0.0)
        if predict_response:
            cov.diagonal().add_(sigma2)
        return mean, torch.diagonal(cov).clone(), cov
    var = prior_var - torch.sum(v * v, dim=1)
    if predict_response:
        var = var + sigma2
    return mean, var, None
