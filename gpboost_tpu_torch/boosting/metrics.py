"""Evaluation metrics (reference ``src/LightGBM/metric/*``).

The port's own copy of the JAX package's ``boosting/metrics.py``: host
numpy on the labels and the (converted) scores, as there, the ranking
metrics (``ndcg`` and ``map`` at the ``eval_at`` positions, a loop over
the queries) too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def l2(y, pred, weight=None):
    d = (y - pred) ** 2
    return float(np.average(d, weights=weight))


def rmse(y, pred, weight=None):
    return float(np.sqrt(l2(y, pred, weight)))


def l1(y, pred, weight=None):
    return float(np.average(np.abs(y - pred), weights=weight))


def mape(y, pred, weight=None):
    denom = np.maximum(np.abs(y), 1.0)
    return float(np.average(np.abs(y - pred) / denom, weights=weight))


def quantile(y, pred, weight=None, alpha=0.9):
    r = y - pred
    v = np.where(r >= 0, alpha * r, (alpha - 1.0) * r)
    return float(np.average(v, weights=weight))


def huber(y, pred, weight=None, alpha=0.9):
    r = np.abs(y - pred)
    v = np.where(r <= alpha, 0.5 * r * r, alpha * (r - 0.5 * alpha))
    return float(np.average(v, weights=weight))


def poisson_deviance(y, pred, weight=None):
    eps = 1e-10
    pred = np.maximum(pred, eps)
    v = pred - y * np.log(pred)
    return float(np.average(v, weights=weight))


def gamma_deviance(y, pred, weight=None):
    eps = 1e-10
    pred = np.maximum(pred, eps)
    v = np.log(pred) + y / pred
    return float(np.average(v, weights=weight))


def tweedie_metric(y, pred, weight=None, rho=1.5):
    eps = 1e-10
    pred = np.maximum(pred, eps)
    v = -y * np.power(pred, 1 - rho) / (1 - rho) + np.power(pred, 2 - rho) / (2 - rho)
    return float(np.average(v, weights=weight))


def binary_logloss(y, prob, weight=None):
    p = np.clip(prob, 1e-15, 1 - 1e-15)
    v = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return float(np.average(v, weights=weight))


def _xent_loss(y, prob):
    """Pointwise cross-entropy with the reference's one-sided 1e-12 log-arg
    floor (``xentropy_metric.hpp`` XentLoss)."""
    eps = 1e-12
    a = y * np.log(np.maximum(prob, eps))
    b = (1.0 - y) * np.log(np.maximum(1.0 - prob, eps))
    return -(a + b)


def cross_entropy(y, prob, weight=None):
    """Cross-entropy for continuous labels in [0, 1]
    (``CrossEntropyMetric``, xentropy_metric.hpp)."""
    return float(np.average(_xent_loss(y, prob), weights=weight))


def cross_entropy_lambda(y, hhat, weight=None):
    """Intensity-weighted cross-entropy (``CrossEntropyLambdaMetric``,
    xentropy_metric.hpp): ``hhat`` is the objective-converted score
    (softplus); prob = 1 - exp(-w * hhat). NOTE: the reference divides by
    num_data, not sum-of-weights — weights act through the probability."""
    w = 1.0 if weight is None else np.asarray(weight, np.float64)
    z = 1.0 - np.exp(-w * np.asarray(hhat, np.float64))
    return float(np.mean(_xent_loss(y, z)))


def kullback_leibler(y, prob, weight=None):
    """KL divergence = cross-entropy + (negative) label entropy offset
    (``KullbackLeiblerDivergence``, xentropy_metric.hpp YentLoss)."""
    yv = np.asarray(y, np.float64)
    inner = (yv > 0) & (yv < 1)
    ys = np.where(inner, yv, 0.5)
    yent = np.where(inner, ys * np.log(ys) + (1 - ys) * np.log(1 - ys), 0.0)
    return float(np.average(_xent_loss(yv, prob) + yent, weights=weight))


def binary_error(y, prob, weight=None):
    return float(np.average((prob > 0.5) != (y > 0.5), weights=weight))


def _weighted_auc(d, w, pos):
    """Weighted AUC of discriminant ``d`` (positives should score high) with
    0.5 credit for cross-class ties."""
    order = np.argsort(d, kind="mergesort")
    dp, wp, pp = d[order], w[order], pos[order]
    cum_neg = np.cumsum(np.where(~pp, wp, 0.0))
    auc_num = 0.0
    k = 0
    while k < len(dp):
        k2 = k
        while k2 < len(dp) and dp[k2] == dp[k]:
            k2 += 1
        neg_before = cum_neg[k - 1] if k > 0 else 0.0
        neg_tied = cum_neg[k2 - 1] - neg_before
        w_pos_tied = np.sum(np.where(pp[k:k2], wp[k:k2], 0.0))
        auc_num += w_pos_tied * (neg_before + 0.5 * neg_tied)
        k = k2
    w_pos = np.sum(np.where(pp, wp, 0.0))
    w_neg = np.sum(np.where(~pp, wp, 0.0))
    if w_pos == 0 or w_neg == 0:
        return 0.5
    return float(auc_num / (w_pos * w_neg))


def auc(y, score, weight=None):
    pos = y > 0
    if weight is None:
        # rank-based with average-rank tie handling
        from scipy.stats import rankdata
        n_pos = pos.sum()
        n_neg = (~pos).sum()
        if n_pos == 0 or n_neg == 0:
            return 0.5
        r = rankdata(score)
        return float((np.sum(r[pos]) - n_pos * (n_pos + 1) / 2)
                     / (n_pos * n_neg))
    return _weighted_auc(np.asarray(score), np.asarray(weight), pos)


def multi_logloss(y, prob_flat, weight=None, num_class=2):
    n = len(y)
    p = prob_flat.reshape(num_class, n)
    pc = np.clip(p[y.astype(int), np.arange(n)], 1e-15, 1.0)
    return float(np.average(-np.log(pc), weights=weight))


def multi_error(y, prob_flat, weight=None, num_class=2, top_k=1):
    """Multiclass error; a row counts as correct when the true class is
    within the ``top_k`` highest scores (``multi_error_top_k``,
    config.h:1002, multiclass_metric.hpp)."""
    n = len(y)
    p = prob_flat.reshape(num_class, n)
    yi = y.astype(int)
    if top_k <= 1:
        wrong = p.argmax(axis=0) != yi
    else:
        # rank of the true class among the scores (ties count as within
        # top_k like the reference's ">= threshold" comparison)
        true_p = p[yi, np.arange(n)]
        rank = np.sum(p > true_p[None, :], axis=0)
        wrong = rank >= top_k
    return float(np.average(wrong, weights=weight))


def auc_mu(y, score_flat, weight=None, num_class=2, class_weights=None):
    """Multiclass AUC-mu (Kleiman & Page 2019; reference ``AucMuMetric``,
    multiclass_metric.hpp:183): mean over class pairs (i, j) of the AUC of
    the weighted-score discriminant t1 * (W_i - W_j)' s(x), ties 0.5."""
    n = len(y)
    S = score_flat[:num_class * n].reshape(num_class, n)
    yi = y.astype(int)
    if class_weights is None:
        W = np.ones((num_class, num_class)) - np.eye(num_class)
    else:
        W = np.asarray(class_weights, dtype=np.float64).reshape(num_class,
                                                                num_class)
    w = np.ones(n) if weight is None else np.asarray(weight)
    total = 0.0
    for i in range(num_class):
        for j in range(i + 1, num_class):
            v = W[i] - W[j]
            t1 = v[i] - v[j]
            sel = (yi == i) | (yi == j)
            if not np.any(yi == i) or not np.any(yi == j):
                continue
            d = t1 * (v @ S[:, sel])
            total += _weighted_auc(d, w[sel], yi[sel] == i)
    return float(2.0 * total / num_class / (num_class - 1))


def crps_gaussian(y, mean, var, weight=None):
    """Continuous ranked probability score for Gaussian predictive
    distributions (``random_effects_metric.hpp`` crps_gaussian)."""
    from scipy.stats import norm
    sd = np.sqrt(np.maximum(var, 1e-300))
    z = (y - mean) / sd
    v = sd * (z * (2 * norm.cdf(z) - 1) + 2 * norm.pdf(z)
              - 1.0 / np.sqrt(np.pi))
    return float(np.average(v, weights=weight))


def _query_starts(group):
    return np.concatenate([[0], np.cumsum(group)]).astype(int)


def _gains(rel, label_gain):
    if label_gain is not None:
        return np.asarray(label_gain, np.float64)[np.asarray(rel, int)]
    return 2.0 ** rel - 1.0


def ndcg_at_ks(y, score, group, ks, query_weights=None, label_gain=None):
    """NDCG at every position in ``ks``, averaged over queries
    (``NDCGMetric``, rank_metric.hpp; ``dcg_calculator.cpp``). A query with
    all-zero gains counts as NDCG = 1 at every position; score ties are
    broken by original index (stable sort, like the reference)."""
    starts = _query_starts(group)
    nq = len(starts) - 1
    qw = np.ones(nq) if query_weights is None else np.asarray(query_weights)
    acc = np.zeros(len(ks))
    for q in range(nq):
        a, b = starts[q], starts[q + 1]
        rel = np.asarray(y[a:b], np.float64)
        order = np.argsort(-np.asarray(score[a:b]), kind="stable")
        gains = _gains(rel[order], label_gain)
        igains = np.sort(_gains(rel, label_gain))[::-1]
        disc = 1.0 / np.log2(np.arange(2, len(rel) + 2))
        cdcg = np.cumsum(gains * disc)
        cidcg = np.cumsum(igains * disc)
        for j, k in enumerate(ks):
            kk = min(int(k), len(rel))
            idcg = cidcg[kk - 1] if kk > 0 else 0.0
            if cidcg[-1] <= 0.0:
                acc[j] += qw[q]  # all-negative query -> NDCG = 1
            elif idcg > 0.0:
                acc[j] += (cdcg[kk - 1] / idcg) * qw[q]
    return [float(v / qw.sum()) for v in acc]


def ndcg_at_k(y, score, group, k=5):
    """NDCG@k averaged over queries (single-position convenience)."""
    return ndcg_at_ks(y, score, group, [k])[0]


def map_at_ks(y, score, group, ks, query_weights=None):
    """Mean average precision at every position in ``ks``
    (``MapMetric::CalMapAtK``, map_metric.hpp:78): labels > 0.5 are hits,
    AP@k = sum over hit ranks j<k of num_hits/(j+1), divided by
    min(npos, k); queries without positives count 1.0."""
    starts = _query_starts(group)
    nq = len(starts) - 1
    qw = np.ones(nq) if query_weights is None else np.asarray(query_weights)
    acc = np.zeros(len(ks))
    for q in range(nq):
        a, b = starts[q], starts[q + 1]
        hits = np.asarray(y[a:b]) > 0.5
        npos = int(hits.sum())
        order = np.argsort(-np.asarray(score[a:b]), kind="stable")
        hit_sorted = hits[order]
        cum_hits = np.cumsum(hit_sorted)
        prec = np.where(hit_sorted, cum_hits / np.arange(1, len(hits) + 1),
                        0.0)
        cum_ap = np.cumsum(prec)
        for j, k in enumerate(ks):
            kk = min(int(k), len(hits))
            if npos == 0:
                acc[j] += qw[q]
            else:
                acc[j] += (cum_ap[kk - 1] / min(npos, kk)) * qw[q]
    return [float(v / qw.sum()) for v in acc]


# GP-model-aware metrics: need the attached GPModel / predictive variances
# and are dispatched specially in ``Booster._eval`` (reference
# ``random_effects_metric.hpp:25,69``; ``regression_metric.hpp:373,499``).
# The first two are training-data-only, the last two validation-only.
GP_METRICS = ("neg_log_likelihood", "approx_neg_marginal_log_likelihood",
              "test_neg_log_likelihood", "crps_gaussian")

class MetricSpec(NamedTuple):
    """Registry entry. ``kind``:

    - ``converted``: fn(label, objective-converted prediction, weight)
    - ``raw``: fn(label, raw score, weight, ...) — e.g. auc_mu discriminants
    - ``rank``: fn(label, raw score, group, ks, query_weights) -> [val@k]
    """
    fn: object
    higher_better: bool
    kind: str = "converted"


# metric registry (reference ``metric.cpp CreateMetric``); every metric,
# the ranking family too, resolves through here
METRICS = {
    "l2": MetricSpec(l2, False), "mse": MetricSpec(l2, False),
    "rmse": MetricSpec(rmse, False),
    "l1": MetricSpec(l1, False), "mae": MetricSpec(l1, False),
    "mape": MetricSpec(mape, False),
    "quantile": MetricSpec(quantile, False),
    "huber": MetricSpec(huber, False),
    "poisson": MetricSpec(poisson_deviance, False),
    "gamma": MetricSpec(gamma_deviance, False),
    "gamma_deviance": MetricSpec(gamma_deviance, False),
    "tweedie": MetricSpec(tweedie_metric, False),
    "binary_logloss": MetricSpec(binary_logloss, False),
    "binary_error": MetricSpec(binary_error, False),
    "auc": MetricSpec(auc, True),
    "multi_logloss": MetricSpec(multi_logloss, False),
    "multi_error": MetricSpec(multi_error, False),
    "cross_entropy": MetricSpec(cross_entropy, False),
    "cross_entropy_lambda": MetricSpec(cross_entropy_lambda, False),
    "kullback_leibler": MetricSpec(kullback_leibler, False),
    "auc_mu": MetricSpec(auc_mu, True, "raw"),
    "ndcg": MetricSpec(ndcg_at_ks, True, "rank"),
    "map": MetricSpec(map_at_ks, True, "rank"),
}

# reference ``config.h ParseMetricAlias`` (:1260-1290)
METRIC_ALIASES = {
    "mean_squared_error": "l2", "regression": "l2", "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "mean_absolute_error": "l1", "regression_l1": "l1",
    "mean_absolute_percentage_error": "mape",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "multiclass_ova": "multi_logloss",
    "ova": "multi_logloss", "ovr": "multi_logloss",
    "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "kldiv": "kullback_leibler",
    "mean_average_precision": "map",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
}


def resolve_metric_name(name: str):
    """Resolve ``name[@k[,k...]]`` to (registry key, ks or None)."""
    base, ks = name, None
    if "@" in name:
        base, pos = name.split("@", 1)
        ks = [int(p) for p in pos.split(",")]
    return METRIC_ALIASES.get(base, base), ks


_DEFAULT_METRIC = {
    "multiclassova": "multi_logloss",
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "l1", "poisson": "poisson", "gamma": "gamma",
    "tweedie": "tweedie", "quantile": "quantile", "mape": "mape",
    "binary": "binary_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "multiclass": "multi_logloss", "regression_gp": "l2",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def default_metric_for(objective_name: str) -> str:
    return _DEFAULT_METRIC.get(objective_name, "l2")
