"""Inducing-point selection for the low-rank approximations (PyTorch port of
``gpboost_tpu/ops/inducing.py``; reference ``GP_utils.cpp:269-449``).

- ``random``: a subsample of the unique coordinates;
- ``kmeans++``: kmeans++ seeding, then Lloyd steps;
- ``cover_tree``: a greedy radius cover — every point ends up within
  ``cover_tree_radius`` of a center (at most ``num_ind_points`` centers).

The random draws are numpy's ``default_rng(seed)``, in the same order as the
JAX package's, so that both packages start from the same points. The Lloyd
steps run in PyTorch on the model's device: the distances are one matmul, the
new centers one-hot matmul sums (a fixed order, no float atomics).
"""
from __future__ import annotations

import numpy as np
import torch

MAX_LLOYD_ITER = 20


def _lloyd(X: torch.Tensor, C: torch.Tensor, num_iter: int) -> torch.Tensor:
    """``num_iter`` Lloyd steps from the centers C [k, d] over X [n, d]; a
    center that owns no point stays where it is."""
    sq_x = torch.sum(X * X, dim=1)[:, None]
    for _ in range(num_iter):
        d2 = sq_x + torch.sum(C * C, dim=1)[None, :] - 2.0 * (X @ C.T)
        assign = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(assign, C.shape[0]).to(X.dtype)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ X
        C = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], C)
    return C


def select_inducing_points(coords: np.ndarray, num_ind_points: int,
                           method: str = "kmeans++", seed: int = 0,
                           max_lloyd_iter: int = MAX_LLOYD_ITER,
                           cover_tree_radius: float = 1.0,
                           device="cpu") -> torch.Tensor:
    """[k, d] float64 inducing-point locations on ``device`` for the
    coordinates ``coords`` [n, d] (numpy)."""
    uniq = np.unique(np.asarray(coords, dtype=np.float64), axis=0)
    k = min(int(num_ind_points), uniq.shape[0])
    rng = np.random.default_rng(seed)

    def out(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    if method == "cover_tree":
        order = rng.permutation(uniq.shape[0])
        centers = [uniq[order[0]]]
        r2 = float(cover_tree_radius) ** 2
        for i in order[1:]:
            d2 = np.sum((np.asarray(centers) - uniq[i]) ** 2, axis=1)
            if np.min(d2) > r2:
                centers.append(uniq[i])
                if len(centers) >= num_ind_points:
                    break
        return out(np.asarray(centers))
    if method == "random" or k == uniq.shape[0]:
        return out(uniq[rng.choice(uniq.shape[0], size=k, replace=False)])
    if method != "kmeans++":
        raise ValueError(f"ind_points_selection '{method}' not supported")
    centers = np.empty((k, uniq.shape[1]))
    centers[0] = uniq[rng.integers(uniq.shape[0])]
    d2 = np.sum((uniq - centers[0]) ** 2, axis=1)
    for j in range(1, k):
        probs = d2 / max(d2.sum(), 1e-300)
        centers[j] = uniq[rng.choice(uniq.shape[0], p=probs)]
        d2 = np.minimum(d2, np.sum((uniq - centers[j]) ** 2, axis=1))
    return _lloyd(out(uniq), out(centers), int(max_lloyd_iter))
