"""TreeSHAP feature contributions (``pred_contrib``).

The port's own copy of the JAX package's ``boosting/shap.py``: the
polynomial-time TreeSHAP algorithm (Lundberg et al. 2018), the role of the
reference's ``Tree::PredictContrib`` / SHAP support in ``predictor.hpp``.
It runs on the host, in numpy and Python, as in the JAX package and the
reference (whose SHAP is CPU code too): a recursion over each row's paths
that needs no kernel. Its cost grows with rows x trees x leaves x depth^2
(PERF.md §5).
"""
from __future__ import annotations

import numpy as np


class _PathElem:
    __slots__ = ("d", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, d, zero_fraction, one_fraction, pweight):
        self.d = d
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight


def _extend(path, zero_fraction, one_fraction, feature_index):
    path.append(_PathElem(feature_index, zero_fraction, one_fraction,
                          1.0 if len(path) == 0 else 0.0))
    length = len(path)
    for i in range(length - 2, -1, -1):
        path[i + 1].pweight += (one_fraction * path[i].pweight * (i + 1)
                                / length)
        path[i].pweight = (zero_fraction * path[i].pweight
                           * (length - i - 1) / length)


def _unwind(path, path_index):
    length = len(path)
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[-1].pweight
    for i in range(length - 2, -1, -1):
        if one_fraction != 0.0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * length / ((i + 1)
                                                           * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction * (
                length - i - 1) / length
        else:
            path[i].pweight = path[i].pweight * length / (
                zero_fraction * (length - i - 1))
    for i in range(path_index, length - 1):
        path[i].d = path[i + 1].d
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_sum(path, path_index):
    length = len(path)
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[-1].pweight
    total = 0.0
    for i in range(length - 2, -1, -1):
        if one_fraction != 0.0:
            tmp = next_one_portion * length / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * (
                (length - i - 1) / length)
        else:
            total += path[i].pweight / (zero_fraction
                                        * ((length - i - 1) / length))
    return total


def tree_shap(tree, x: np.ndarray, phi: np.ndarray):
    """Accumulate SHAP values of one tree for one row into phi
    [n_features + 1] (last = expected value / bias)."""
    cover = tree.node_count
    if cover is None:
        raise ValueError("tree has no node_count (cover) — SHAP unavailable "
                         "for models from older files")

    def recurse(node, path, zero_fraction, one_fraction, feature_index):
        path = [
            _PathElem(p.d, p.zero_fraction, p.one_fraction, p.pweight)
            for p in path]
        _extend(path, zero_fraction, one_fraction, feature_index)
        if tree.is_leaf[node]:
            for i in range(1, len(path)):
                w = _unwound_sum(path, i)
                phi[path[i].d] += w * (path[i].one_fraction
                                       - path[i].zero_fraction) \
                    * tree.leaf_value[node]
            return
        f = int(tree.split_feature[node])
        hot, cold = ((tree.left[node], tree.right[node])
                     if x[f] <= tree.threshold[node]
                     else (tree.right[node], tree.left[node]))
        hot_frac = cover[hot] / cover[node] if cover[node] > 0 else 0.0
        cold_frac = cover[cold] / cover[node] if cover[node] > 0 else 0.0
        incoming_zero = 1.0
        incoming_one = 1.0
        path_index = next((i for i in range(len(path)) if path[i].d == f),
                          -1)
        if path_index >= 0:
            incoming_zero = path[path_index].zero_fraction
            incoming_one = path[path_index].one_fraction
            _unwind(path, path_index)
        recurse(int(hot), path, incoming_zero * hot_frac, incoming_one, f)
        recurse(int(cold), path, incoming_zero * cold_frac, 0.0, f)

    recurse(0, [], 1.0, 1.0, -1)
    # bias: expected value of the tree
    leaf_nodes = np.flatnonzero(tree.is_leaf)
    total = cover[0]
    if total > 0:
        phi[-1] += float(np.sum(tree.leaf_value[leaf_nodes]
                                * cover[leaf_nodes]) / total)


def predict_contrib(trees, X: np.ndarray, init_score: float) -> np.ndarray:
    """SHAP contributions [n, F+1]; row sums equal raw predictions."""
    n, F = X.shape
    out = np.zeros((n, F + 1))
    out[:, -1] += init_score
    for tree in trees:
        for i in range(n):
            phi = np.zeros(F + 1)
            tree_shap(tree, X[i], phi)
            out[i] += phi
    return out
