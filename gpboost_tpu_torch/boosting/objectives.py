"""Boosting objective functions (gradients/hessians per data point).

Mirrors the reference's ``src/LightGBM/objective/*.hpp`` families without a
GP (the regression losses, ``binary_objective.hpp``, the cross-entropies,
Tobit, the two-ensemble mean-scale regression, softmax and one-vs-all
multiclass) and the coupling with a ``GPModel`` of
``regression_objective.hpp:153-186``:

- the GPBoost algorithm (gaussian likelihood): gradients ``Psi^-1 (F - y)``
  (generalized residuals), the covariance parameters re-optimized,
  warm-started, in every iteration;
- the LaGaBoost algorithm (other likelihoods): gradients d NLL_Laplace / dF
  at the current score, hessians 1, the covariance and auxiliary parameters
  re-optimized (warm-started) at the current score in every iteration.

Scores, labels and gradients are host float64 arrays, as in the reference's
host loop; the covariance refit, the ``Psi^-1`` solve (Vecchia, Woodbury
for grouped random effects, or a dense Cholesky for an exact GP) and the
Laplace gradient run on the model's device. The ranking objectives read
the Dataset's ``group``: ``lambdarank``'s pairwise lambdas run on the
training Dataset's device, ``rank_xendcg``'s per-query draws on the host.
As in the JAX package, leaf outputs are never renewed from residual
quantiles (``regression_l1``, ``quantile`` and ``mape`` keep the Newton
leaf values of their constant hessians).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm

from gpboost_tpu_torch.boosting.metrics import _query_starts


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class Objective:
    """Base objective (reference ``ObjectiveFunction``,
    ``objective_function.h:24``)."""

    name = "custom"
    is_constant_hessian = False
    num_model_per_iteration = 1

    def init(self, label, weight, group=None):
        self.label = label
        self.weight = weight
        self.group = group

    def boost_from_average(self) -> float:
        return 0.0

    def init_scores(self) -> np.ndarray:
        """Initial score (``BoostFromScore``), one entry per tree of an
        iteration."""
        if self.num_model_per_iteration == 1:
            return np.array([self.boost_from_average()])
        return np.zeros(self.num_model_per_iteration)

    def get_gradients(self, score: np.ndarray):
        raise NotImplementedError

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        return score

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad, hess


class RegressionL2(Objective):
    name = "regression"
    is_constant_hessian = True

    def __init__(self, reg_sqrt=False):
        # reg_sqrt (config.h:849): fit on sign(y)*sqrt(|y|), square
        # predictions back (RegressionL2loss sqrt_ handling)
        self.reg_sqrt = bool(reg_sqrt)

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if self.reg_sqrt and label is not None:
            self.label = np.sign(label) * np.sqrt(np.abs(label))

    def boost_from_average(self):
        if self.weight is not None:
            return float(np.average(self.label, weights=self.weight))
        return float(np.mean(self.label))

    def get_gradients(self, score):
        return self._apply_weight(score - self.label, np.ones_like(score))

    def convert_output(self, score):
        if self.reg_sqrt:
            return np.sign(score) * score * score
        return score


class RegressionL1(Objective):
    name = "regression_l1"

    def boost_from_average(self):
        return float(np.median(self.label))

    def get_gradients(self, score):
        g = np.sign(score - self.label)
        return self._apply_weight(g, np.ones_like(score))


class Huber(Objective):
    name = "huber"

    def __init__(self, alpha=0.9):
        self.alpha = alpha

    def boost_from_average(self):
        return float(np.mean(self.label))

    def get_gradients(self, score):
        r = score - self.label
        g = np.where(np.abs(r) <= self.alpha, r, self.alpha * np.sign(r))
        return self._apply_weight(g, np.ones_like(score))


class Fair(Objective):
    name = "fair"

    def __init__(self, c=1.0):
        self.c = c

    def get_gradients(self, score):
        r = score - self.label
        g = self.c * r / (np.abs(r) + self.c)
        h = self.c * self.c / (np.abs(r) + self.c) ** 2
        return self._apply_weight(g, h)


class Poisson(Objective):
    name = "poisson"

    def __init__(self, max_delta_step=0.7):
        # poisson_max_delta_step (config.h:868): hessian safeguard
        # exp(score + step) (poisson_objective.hpp GetGradients)
        self.max_delta_step = float(max_delta_step)

    def boost_from_average(self):
        return float(np.log(np.maximum(np.mean(self.label), 1e-20)))

    def get_gradients(self, score):
        mu = np.exp(score)
        return self._apply_weight(mu - self.label,
                                  np.exp(score + self.max_delta_step))

    def convert_output(self, score):
        return np.exp(score)


class Gamma(Objective):
    name = "gamma"

    def boost_from_average(self):
        return float(np.log(np.maximum(np.mean(self.label), 1e-20)))

    def get_gradients(self, score):
        # -dloglik: 1 - y*exp(-F);  hess: y*exp(-F)
        e = self.label * np.exp(-score)
        return self._apply_weight(1.0 - e, e)

    def convert_output(self, score):
        return np.exp(score)


class Tweedie(Objective):
    name = "tweedie"

    def __init__(self, rho=1.5):
        self.rho = rho

    def boost_from_average(self):
        return float(np.log(np.maximum(np.mean(self.label), 1e-20)))

    def get_gradients(self, score):
        p = self.rho
        g = -self.label * np.exp((1 - p) * score) + np.exp((2 - p) * score)
        h = (-self.label * (1 - p) * np.exp((1 - p) * score)
             + (2 - p) * np.exp((2 - p) * score))
        return self._apply_weight(g, h)

    def convert_output(self, score):
        return np.exp(score)


class Quantile(Objective):
    name = "quantile"

    def __init__(self, alpha=0.9):
        self.alpha = alpha

    def boost_from_average(self):
        return float(np.quantile(self.label, self.alpha))

    def get_gradients(self, score):
        r = score - self.label
        g = np.where(r >= 0, 1.0 - self.alpha, -self.alpha)
        return self._apply_weight(g, np.ones_like(score))


class Mape(Objective):
    name = "mape"

    def get_gradients(self, score):
        label_safe = np.where(np.abs(self.label) > 1e-10, self.label, 1e-10)
        g = np.sign(score - self.label) / np.abs(label_safe)
        return self._apply_weight(g, np.ones_like(score))


class Tobit(Objective):
    """Censored-normal Tobit / Grabit objective
    (``regression_objective.hpp:872``, Sigrist & Hirnschall 2019)."""
    name = "tobit"

    def __init__(self, sigma=1.0, yl=0.0, yu=1.0):
        if sigma <= 0:
            raise ValueError("'sigma' must be greater than zero")
        if yu <= yl:
            raise ValueError("'yl' must be smaller than 'yu'")
        self.sigma = sigma
        self.yl = yl
        self.yu = yu

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if np.any(label < self.yl - 1e-6 * abs(self.yl)) or \
                np.any(label > self.yu + 1e-6 * abs(self.yu)):
            raise ValueError("Labels must lie in [yl, yu] for tobit")

    def get_gradients(self, score):
        s = self.sigma
        s2i = 1.0 / (s * s)
        diff = (self.label - score) / s
        logpdf = norm.logpdf(diff)
        logcdf_lo = norm.logcdf(diff)
        logcdf_hi = norm.logcdf(-diff)
        lower = self.label <= self.yl
        upper = self.label >= self.yu
        g = -diff / s
        h = np.full_like(score, s2i)
        r_lo = np.exp(logpdf - logcdf_lo)
        g = np.where(lower, r_lo / s, g)
        h = np.where(lower, r_lo * s2i * diff + r_lo * r_lo * s2i, h)
        r_hi = np.exp(logpdf - logcdf_hi)
        g = np.where(upper, -r_hi / s, g)
        h = np.where(upper, -r_hi * s2i * diff + r_hi * r_hi * s2i, h)
        return self._apply_weight(g, h)


class Binary(Objective):
    """Binary log-loss with logit link (``binary_objective.hpp``).

    ``is_unbalance`` weights the positive class by cnt_neg / cnt_pos
    (binary_objective.hpp:70-79); ``scale_pos_weight`` sets the positive
    weight explicitly (they are mutually exclusive in the reference).
    """
    name = "binary"

    def __init__(self, sigmoid=1.0, is_unbalance=False, scale_pos_weight=1.0):
        self.sigmoid = float(sigmoid)
        self.is_unbalance = bool(is_unbalance)
        self.scale_pos_weight = float(scale_pos_weight)

    def _pos_weight(self):
        if self.is_unbalance:
            pos = max(float(np.sum(self.label > 0)), 1.0)
            neg = float(np.sum(self.label <= 0))
            return neg / pos
        return self.scale_pos_weight

    def boost_from_average(self):
        w_pos = self._pos_weight()
        suml = float(np.sum(np.where(self.label > 0, w_pos, 1.0)
                            * self.label))
        sumw = float(np.sum(np.where(self.label > 0, w_pos, 1.0)))
        p = np.clip(suml / sumw, 1e-12, 1 - 1e-12)
        return float(np.log(p / (1 - p)) / self.sigmoid)

    def get_gradients(self, score):
        p = _sigmoid(self.sigmoid * score)
        lw = np.where(self.label > 0, self._pos_weight(), 1.0)
        grad = self.sigmoid * (p - self.label) * lw
        hess = self.sigmoid ** 2 * p * (1 - p) * lw
        return self._apply_weight(grad, hess)

    def convert_output(self, score):
        return _sigmoid(self.sigmoid * score)


class CrossEntropy(Objective):
    name = "cross_entropy"

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if np.any(label < 0) or np.any(label > 1):
            raise ValueError("cross_entropy labels must lie in [0, 1]")

    def boost_from_average(self):
        if self.weight is not None:
            p = float(np.average(self.label, weights=self.weight))
        else:
            p = float(np.mean(self.label))
        p = np.clip(p, 1e-12, 1 - 1e-12)
        return float(np.log(p / (1 - p)))

    def get_gradients(self, score):
        p = _sigmoid(score)
        return self._apply_weight(p - self.label, p * (1 - p))

    def convert_output(self, score):
        return _sigmoid(score)


class CrossEntropyLambda(Objective):
    """Alternative ("intensity-weighted") parameterization of cross-entropy
    (``CrossEntropyLambda``, ``xentropy_objective.hpp:153``): with sample
    weight w, prob = 1 - (1 - sigmoid(f))^w = 1 - exp(-w * hhat) where
    hhat = log(1 + exp(f)). ConvertOutput returns hhat (the "normalized
    exponential parameter" lambda), NOT a probability — matching the
    reference's explicit warning."""
    name = "cross_entropy_lambda"

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if np.any(label < 0) or np.any(label > 1):
            raise ValueError("cross_entropy_lambda labels must lie in [0, 1]")
        if weight is not None and np.any(weight <= 0):
            raise ValueError("cross_entropy_lambda requires strictly "
                             "positive weights")

    def boost_from_average(self):
        # BoostFromScore: havg = weighted mean label; f0 = log(e^havg - 1)
        # (xentropy_objective.hpp:246-266)
        if self.weight is not None:
            havg = float(np.average(self.label, weights=self.weight))
        else:
            havg = float(np.mean(self.label))
        return float(np.log(np.expm1(max(havg, 1e-12))))

    def get_gradients(self, score):
        if self.weight is None:
            # unit weights: identical to plain CrossEntropy
            z = _sigmoid(score)
            return z - self.label, z * (1.0 - z)
        w = self.weight
        y = self.label
        f = np.clip(score, -500.0, 500.0)
        epf = np.exp(f)
        hhat = np.log1p(epf)
        z = -np.expm1(-w * hhat)  # 1 - exp(-w*hhat)
        sig = 1.0 / (1.0 + np.exp(-f))
        grad = (1.0 - y / z) * w * sig
        c = 1.0 / (1.0 - z)  # = exp(w*hhat)
        a = w * sig * (1.0 - sig)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def convert_output(self, score):
        return np.log1p(np.exp(np.minimum(score, 500.0)))


class Multiclass(Objective):
    """Softmax multiclass (``multiclass_objective.hpp``). Scores are
    [n * num_class] stacked class-major like the reference."""
    name = "multiclass"

    def __init__(self, num_class):
        self.num_class = int(num_class)
        self.num_model_per_iteration = self.num_class

    def get_gradients(self, score):
        n = len(self.label)
        s = score.reshape(self.num_class, n)
        s = s - s.max(axis=0, keepdims=True)
        e = np.exp(s)
        p = e / e.sum(axis=0, keepdims=True)
        onehot = np.zeros_like(p)
        onehot[self.label.astype(int), np.arange(n)] = 1.0
        g = (p - onehot).reshape(-1)
        h = (2.0 * p * (1.0 - p)).reshape(-1)
        if self.weight is not None:
            w = np.tile(self.weight, self.num_class)
            g, h = g * w, h * w
        return g, h

    def convert_output(self, score):
        n = score.shape[0] // self.num_class
        s = score.reshape(self.num_class, n)
        s = s - s.max(axis=0, keepdims=True)
        e = np.exp(s)
        return (e / e.sum(axis=0, keepdims=True)).reshape(-1)


class MeanScaleRegression(Objective):
    """Heteroscedastic two-ensemble regression: y ~ N(F1(x), exp(F2(x)))
    (``MeanScaleLoss``, ``regression_objective.hpp:986``). One tree per
    iteration for the mean and one for the log-variance; the log-variance
    tree uses Fisher-type hessian exp(-F2) (y-F1)^2 / 2."""
    name = "mean_scale_regression"
    num_model_per_iteration = 2

    def init_scores(self):
        # BoostFromScore: tree 0 = weighted mean, tree 1 = log sample variance
        if self.weight is not None:
            sw = np.sum(self.weight)
            mean = np.sum(self.label * self.weight) / sw
            var = np.sum(self.label ** 2 * self.weight) / sw - mean ** 2
        else:
            mean = np.mean(self.label)
            var = np.mean(self.label ** 2) - mean ** 2
        return np.array([mean, np.log(max(var, 1e-20))])

    def get_gradients(self, score):
        n = len(self.label)
        F1, F2 = score[:n], score[n:]
        inv_var = np.exp(-F2)
        neg_resid = F1 - self.label
        g1 = inv_var * neg_resid
        h1 = inv_var
        h2 = inv_var * neg_resid * neg_resid / 2.0
        g2 = 0.5 - h2
        if self.weight is not None:
            g1, h1 = g1 * self.weight, h1 * self.weight
            g2, h2 = g2 * self.weight, h2 * self.weight
        return np.concatenate([g1, g2]), np.concatenate([h1, h2])

    def convert_output(self, score):
        # metric evaluation sees the mean ensemble (ConvertOutput,
        # regression_objective.hpp:1040); the full (mean, var) pair is
        # returned by Booster.predict as a dict
        n = score.shape[0] // 2
        return score[:n]


class MulticlassOVA(Objective):
    """One-vs-all multiclass: num_class independent binary-logit ensembles
    (``MulticlassOVA``, ``multiclass_objective.hpp:187``)."""
    name = "multiclassova"

    def __init__(self, num_class, sigmoid=1.0):
        self.num_class = int(num_class)
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(sigmoid)

    def get_gradients(self, score):
        n = len(self.label)
        s = score.reshape(self.num_class, n)
        onehot = np.zeros_like(s)
        onehot[self.label.astype(int), np.arange(n)] = 1.0
        p = 1.0 / (1.0 + np.exp(-self.sigmoid * s))
        g = (self.sigmoid * (p - onehot)).reshape(-1)
        h = (self.sigmoid ** 2 * p * (1.0 - p)).reshape(-1)
        if self.weight is not None:
            w = np.tile(self.weight, self.num_class)
            g, h = g * w, h * w
        return g, np.maximum(h, 1e-15)

    def convert_output(self, score):
        n = score.shape[0] // self.num_class
        s = score.reshape(self.num_class, n)
        return (1.0 / (1.0 + np.exp(-self.sigmoid * s))).reshape(-1)


# pairs [queries, L, L] of one LambdaRank block: the queries go through in
# blocks of at most this many pair entries (a block's temporaries are a few
# times its size in float64)
RANK_BLOCK_PAIRS = 1 << 24


def rank_pad_length(size: int) -> int:
    """The length a LambdaRank query of ``size`` rows is padded to: the size
    itself up to 8, above it the next multiple of a quarter of its power of
    two (9 -> 10, 100 -> 112, 1 250 -> 1 280), so that a padded query holds
    at most 1.25^2 of its pairs whatever the other queries' sizes."""
    if size <= 8:
        return int(size)
    step = 1 << (int(size).bit_length() - 3)
    return -(-int(size) // step) * step


class LambdaRank(Objective):
    """LambdaMART / LambdaRank pairwise objective with |delta NDCG|
    weighting (``rank_objective.hpp``; the JAX package's ``LambdaRank``).

    The JAX package loops over every pair of every query on the host. The
    port computes the same lambdas on ``device`` for a block of queries at
    once: the queries sorted by their padded length (:func:`rank_pad_length`)
    and each block padded to its own (``[queries, L, L]`` pairs), so that a
    mix of short and long queries costs about its real pairs. The same
    pairs (the first label above the second, one of the two ranked above
    ``truncation_level``), the same ``|delta NDCG|`` weights and the same
    per-query normalisation (``lambdarank_norm``). A query without a pair
    (one row, or all labels equal) has zero lambdas and is left out. Ranks
    come from the host, one ``np.argsort`` a query as there, so that tied
    scores rank alike; only the order of the sums over a row's pairs
    differs (1e-15 relative). A query's padded length depends on its size
    alone, so its lambdas have the same bits in any block."""
    name = "lambdarank"

    def __init__(self, sigmoid=1.0, truncation_level=30, norm=True,
                 label_gain=None, device="cpu"):
        self.sigmoid = float(sigmoid)
        self.truncation_level = int(truncation_level)
        # lambdarank_norm (config.h:891) and label_gain (config.h:895,
        # default 2^i - 1) as in rank_objective.hpp
        self.norm = bool(norm)
        self.label_gain = (None if label_gain is None
                           else np.asarray(label_gain, np.float64))
        self.device = torch.device(device)

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if group is None:
            raise ValueError("lambdarank requires query 'group' information")
        self.query_starts = st = _query_starts(group)
        sizes = np.diff(st)
        inv = np.zeros(len(sizes))
        has_pair = np.zeros(len(sizes), dtype=bool)
        for q, (a, b) in enumerate(zip(st[:-1], st[1:])):
            if b - a >= 2:
                inv[q] = self._inverse_max_dcg(self.label[a:b],
                                               self.truncation_level)
                has_pair[q] = np.ptp(self.label[a:b]) > 0
        # the blocks: queries with a pair, by padded length (query order
        # within a length), at most RANK_BLOCK_PAIRS pair entries each;
        # padded row indices (pads repeat the query's first row and are
        # masked), the gains and labels, the inverse ideal DCGs
        qs_all = np.flatnonzero(has_pair)
        pad = np.array([rank_pad_length(k) for k in sizes[qs_all]], int)
        dev, f64 = self.device, torch.float64
        gain = self._gain_of(self.label)
        self._blocks = []
        for L in np.unique(pad):
            qs_L = qs_all[pad == L]
            per = max(1, RANK_BLOCK_PAIRS // (int(L) * int(L)))
            for q0 in range(0, len(qs_L), per):
                qs = qs_L[q0:q0 + per]
                pos = np.arange(L)[None, :]
                valid = pos < sizes[qs][:, None]
                rows = st[qs][:, None] + np.where(valid, pos, 0)
                self._blocks.append(dict(
                    rows_t=torch.as_tensor(rows, device=dev),
                    valid_t=torch.as_tensor(valid, device=dev),
                    rel=torch.as_tensor(self.label[rows], dtype=f64,
                                        device=dev),
                    gain=torch.as_tensor(gain[rows], dtype=f64, device=dev),
                    inv_idcg=torch.as_tensor(inv[qs], dtype=f64,
                                             device=dev)))

    def padded_pairs(self) -> tuple[int, int]:
        """(pair entries the blocks compute, pair entries of the queries
        they hold): what the padding costs."""
        padded = real = 0
        for blk in self._blocks:
            Q, L = blk["valid_t"].shape
            padded += Q * L * L
            real += int((blk["valid_t"].sum(dim=1) ** 2).sum())
        return padded, real

    def _gain_of(self, rel):
        if self.label_gain is not None:
            return self.label_gain[np.asarray(rel, int)]
        return 2.0 ** rel - 1.0

    def _inverse_max_dcg(self, rel, k):
        order = np.argsort(-rel)
        gains = self._gain_of(rel[order[:k]])
        discounts = 1.0 / np.log2(np.arange(2, min(k, len(rel)) + 2))
        idcg = np.sum(gains * discounts[:len(gains)])
        return 1.0 / idcg if idcg > 0 else 0.0

    def _ranks(self, score) -> np.ndarray:
        """Each row's rank in its query by descending score: the JAX
        package's ``np.argsort`` a query, so that ties rank alike."""
        rank = np.zeros(len(self.label), dtype=np.int64)
        st = self.query_starts
        for a, b in zip(st[:-1], st[1:]):
            rank[a + np.argsort(-score[a:b])] = np.arange(b - a)
        return rank

    def get_gradients(self, score):
        score = np.asarray(score, np.float64)
        rank = self._ranks(score)
        dev, f64 = self.device, torch.float64
        # one upload a round; the blocks gather on the device
        score_t = torch.as_tensor(score, dtype=f64, device=dev)
        disc_t = torch.as_tensor(1.0 / np.log2(rank + 2.0), dtype=f64,
                                 device=dev)
        top_t = torch.as_tensor(rank < self.truncation_level, device=dev)
        grad = torch.zeros(len(self.label), dtype=f64, device=dev)
        hess = torch.zeros_like(grad)
        sig = self.sigmoid
        zero = torch.zeros((), dtype=f64, device=dev)
        for blk in self._blocks:
            rows, valid = blk["rows_t"], blk["valid_t"]
            sc, ds, top = score_t[rows], disc_t[rows], top_t[rows]
            rel, gain = blk["rel"], blk["gain"]
            pair = ((rel[:, :, None] > rel[:, None, :])
                    & valid[:, :, None] & valid[:, None, :]
                    & (top[:, :, None] | top[:, None, :]))
            d_ndcg = (torch.abs((gain[:, :, None] - gain[:, None, :])
                                * (ds[:, :, None] - ds[:, None, :]))
                      * blk["inv_idcg"][:, None, None])
            rho = 1.0 / (1.0 + torch.exp(sig * (sc[:, :, None]
                                                - sc[:, None, :])))
            lam = torch.where(pair, rho * d_ndcg * sig, zero)
            h = torch.where(pair, rho * (1 - rho) * d_ndcg * sig ** 2, zero)
            g_q = lam.sum(dim=1) - lam.sum(dim=2)
            h_q = h.sum(dim=2) + h.sum(dim=1)
            if self.norm:
                # lambdarank_norm: per-query normalisation for an unbiased
                # treatment of queries of different sizes
                # (rank_objective.hpp:188)
                s = 2.0 * lam.sum(dim=(1, 2))
                f = torch.where(s > 0, torch.log2(1.0 + s)
                                / torch.where(s > 0, s, 1.0), 1.0)
                g_q, h_q = g_q * f[:, None], h_q * f[:, None]
            grad[rows[valid]] = g_q[valid]
            hess[rows[valid]] = h_q[valid]
        return (grad.cpu().numpy(),
                np.maximum(hess.cpu().numpy(), 1e-10))


class RankXENDCG(Objective):
    """Cross-entropy-NDCG ranking objective (``RankXENDCG``,
    ``rank_objective.hpp:284``): per query, the score softmax rho is matched
    against the stochastic ground-truth distribution
    phi_i = 2^l_i - g_i (g ~ U(0,1)), with the second/third-order
    lambda corrections of the reference. Host numpy, as in the JAX
    package: one ``np.random.default_rng(seed + q)`` a query, drawn in query
    order every round."""
    name = "rank_xendcg"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def init(self, label, weight, group=None):
        super().init(label, weight, group)
        if group is None:
            raise ValueError("rank_xendcg requires query 'group' information")
        self.query_starts = _query_starts(group)
        self._rngs = [np.random.default_rng(self.seed + q)
                      for q in range(len(self.query_starts) - 1)]

    def get_gradients(self, score):
        n = len(self.label)
        grad = np.zeros(n)
        hess = np.zeros(n)
        for q in range(len(self.query_starts) - 1):
            a, b = self.query_starts[q], self.query_starts[q + 1]
            cnt = b - a
            if cnt <= 1:
                continue
            sc = score[a:b]
            rho = np.exp(sc - sc.max())
            rho /= rho.sum()
            g = self._rngs[q].random(cnt)
            phi = 2.0 ** self.label[a:b].astype(int) - g
            phi_norm = phi / max(phi.sum(), 1e-15)
            # first-order terms
            term1 = rho - phi_norm
            lam = term1.copy()
            p1 = term1 / (1.0 - rho)
            s1 = p1.sum()
            # second-order terms
            term2 = rho * (s1 - p1)
            lam += term2
            p2 = term2 / (1.0 - rho)
            s2 = p2.sum()
            # third-order terms
            lam += rho * (s2 - p2)
            grad[a:b] = lam
            hess[a:b] = rho * (1.0 - rho)
        return grad, hess


class GPBoostObjective(Objective):
    """Objective coupling boosting with a GPModel — the GPBoost and LaGaBoost
    algorithms (``regression_objective.hpp:153-186``).

    Gaussian: gradients = Psi^-1 (F - y), hessians = 1; covariance
    parameters re-optimized (warm-started from the previous iteration's)
    inside ``get_gradients`` each boosting iteration. Other likelihoods
    (LaGaBoost): gradients = d NLL_Laplace / dF at the current score,
    hessians = 1, the GP re-fitted at the current score (as fixed effects)
    each iteration. ``fits`` records every refit: its final NLL, its
    number of objective evaluations, the learning rate gradient descent
    started from (``lr_start``) and the one it reached after its first
    iteration (``lr_after_first``).

    With ``reuse_learning_rates_gp_model`` (the reference's optimizer-state
    reuse, ``re_model_template.h:841-883``, :7463-7488) the refits from the
    second on carry state from the first: gradient descent starts at the
    first refit's ``lr_after_first`` (kept in ``self.lr_after_first``),
    L-BFGS keeps its curvature memory on the host route.
    """
    name = "regression_gp"
    is_constant_hessian = True

    def __init__(self, gp_model, train_gp_model_cov_pars=True,
                 reuse_learning_rates_gp_model=True):
        self.gp_model = gp_model
        self.train_gp_model_cov_pars = train_gp_model_cov_pars
        self.reuse_learning_rates_gp_model = reuse_learning_rates_gp_model
        self.lr_after_first = None
        self.fits = []
        self._grad_cache = None

    @property
    def num_fits(self) -> int:
        return len(self.fits)

    def boost_from_average(self):
        if self.gp_model.is_gaussian:
            return float(np.mean(self.label))
        # LaGaBoost: the reference's FindInitialValueBoosting, by likelihood
        lik = self.gp_model.likelihood
        m = np.mean(self.label)
        if lik == "bernoulli_probit":
            return float(norm.ppf(np.clip(m, 1e-12, 1 - 1e-12)))
        if lik == "bernoulli_logit":
            p = np.clip(m, 1e-12, 1 - 1e-12)
            return float(np.log(p / (1 - p)))
        if lik in ("poisson", "gamma", "negative_binomial",
                   "negative_binomial_1", "lognormal"):
            return float(np.log(max(m, 1e-20)))
        return 0.0

    def get_gradients(self, score):
        # the end-of-iteration refit (Booster.update tail, mirroring
        # gbdt.cpp:536-542) runs at the SAME score the next iteration sees —
        # reuse its refit + gradient instead of fitting twice per round
        cache = self._grad_cache
        if cache is not None and np.array_equal(cache[0], score):
            g, h = cache[1]
            return g.copy(), h.copy()
        out = self._get_gradients_impl(score)
        self._grad_cache = (np.array(score, copy=True),
                            (out[0].copy(), out[1].copy()))
        return out

    def _get_gradients_impl(self, score):
        gp = self.gp_model
        if not gp.is_gaussian:
            # LaGaBoost
            if self.train_gp_model_cov_pars:
                self._optim_cov_pars_laplace(score)
            return self._laplace_grad_F(score), np.ones_like(score)
        resid = self.label - score
        if self.train_gp_model_cov_pars:
            self._optim_cov_pars_gaussian(resid)
            # on the kernel route the fit evaluates Psi^-1 resid at its
            # final parameters itself (the device loops' final_fn)
            aux = gp._fit_result.aux
            if aux is not None and aux.shape == resid.shape:
                return -np.asarray(aux, np.float64), np.ones_like(score)
        grad = self._gaussian_psi_inv_resid(resid)
        return -grad, np.ones_like(score)

    def _inner_fit_params(self):
        """Per-refit optimizer adjustments: inits warm-started from the
        current parameters, plus the reference's learning-rate / L-BFGS
        memory reuse from the second refit on. The user's own optimizer
        settings (maxit etc.) are honored as configured."""
        gp = self.gp_model
        params = {}
        if gp.cov_pars_ is not None:
            params["init_cov_pars"] = np.asarray(gp.cov_pars_)
        cfg = gp.optim_cfg
        if self.reuse_learning_rates_gp_model and self.num_fits > 0:
            if (cfg.optimizer_cov == "gradient_descent"
                    and self.lr_after_first is not None):
                cfg._reuse_lr_start = self.lr_after_first
            elif cfg.optimizer_cov in ("lbfgs",
                                       "lbfgs_linesearch_nocedal_wright"):
                cfg.lbfgs_reuse_mem = True
        return params

    def _optim_cov_pars_gaussian(self, resid):
        self._refit(y=resid)

    def _optim_cov_pars_laplace(self, score):
        self._refit(y=self.label,
                    fixed_effects=np.asarray(score, dtype=np.float64))

    def _laplace_grad_F(self, score):
        """d NLL / dF at the current score (the model's LaGaBoost gradient:
        Vecchia with ``grad_F_laplace``'s defaults, as the JAX package's
        objective calls it; dense for an exact GP; in b-space for grouped
        effects)."""
        gp = self.gp_model
        if gp.cov_pars_ is None:
            raise ValueError(
                "train_gp_model_cov_pars=False needs covariance parameters: "
                "fit the gp_model first")
        g = gp._grad_F_laplace(self.label, score)
        return g.detach().cpu().numpy().astype(np.float64)

    def _refit(self, **fit_args):
        gp = self.gp_model
        gp.fit(params=self._inner_fit_params(), **fit_args)
        res = gp._fit_result
        if (self.num_fits == 0 and self.reuse_learning_rates_gp_model
                and res.lr_after_first is not None):
            self.lr_after_first = float(res.lr_after_first)
        self.fits.append({"nll": gp.current_nll_,
                          "num_evals": res.num_evals,
                          "lr_start": gp.optim_cfg._reuse_lr_start,
                          "lr_after_first": res.lr_after_first})

    def _gaussian_psi_inv_resid(self, resid):
        gp = self.gp_model
        if gp.cov_pars_ is None:
            raise ValueError(
                "train_gp_model_cov_pars=False needs covariance parameters: "
                "fit the gp_model first")
        out = gp._psi_solve(gp.cov_pars_, resid)
        return out.detach().cpu().numpy().astype(np.float64)


_ALIASES = {
    "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "rmse": "regression",
    "l1": "regression_l1", "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "binary_logloss": "binary",
    "softmax": "multiclass", "ova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
}
# the names an objective may have beside a gp_model: the response
# distribution is then the GPModel's likelihood (JAX
# objectives.py:776-787)
GP_OBJECTIVES = ("regression", "binary", "regression_gp", "poisson", "gamma",
                 "cross_entropy")


def create_objective(name: str, params: dict, gp_model=None,
                     device="cpu") -> Objective:
    """Objective factory (``objective_function.cpp:17-129``; the JAX
    package's names and aliases). With a ``gp_model`` any of
    ``GP_OBJECTIVES`` (and their aliases) gives the GPBoost / LaGaBoost
    objective — the response distribution is the GPModel's likelihood —
    and any other name is a ``ValueError``, as in the JAX package.
    ``device`` is where ``lambdarank`` computes its lambdas."""
    name = _ALIASES.get(name, name)
    if gp_model is not None:
        if name not in GP_OBJECTIVES:
            raise ValueError(
                f"objective '{name}' cannot be combined with a gp_model; the "
                "response distribution is specified via the GPModel "
                "likelihood")
        return GPBoostObjective(
            gp_model,
            train_gp_model_cov_pars=params.get("train_gp_model_cov_pars",
                                               True),
            reuse_learning_rates_gp_model=params.get(
                "reuse_learning_rates_gp_model", True))
    if name == "regression_gp":
        raise ValueError("objective 'regression_gp' needs a gp_model")
    if name == "regression":
        return RegressionL2(reg_sqrt=bool(params.get("reg_sqrt", False)))
    if name == "regression_l1":
        return RegressionL1()
    if name == "huber":
        return Huber(alpha=params.get("alpha", 0.9))
    if name == "fair":
        return Fair(c=params.get("fair_c", 1.0))
    if name == "poisson":
        return Poisson(max_delta_step=float(
            params.get("poisson_max_delta_step", 0.7)))
    if name == "gamma":
        return Gamma()
    if name == "tweedie":
        return Tweedie(rho=params.get("tweedie_variance_power", 1.5))
    if name == "quantile":
        return Quantile(alpha=params.get("alpha", 0.9))
    if name == "mape":
        return Mape()
    if name == "binary":
        if params.get("is_unbalance", False) and float(
                params.get("scale_pos_weight", 1.0)) != 1.0:
            raise ValueError("Cannot set is_unbalance and scale_pos_weight "
                             "at the same time")
        return Binary(sigmoid=float(params.get("sigmoid", 1.0)),
                      is_unbalance=bool(params.get("is_unbalance", False)),
                      scale_pos_weight=float(
                          params.get("scale_pos_weight", 1.0)))
    if name == "cross_entropy":
        return CrossEntropy()
    if name == "cross_entropy_lambda":
        return CrossEntropyLambda()
    if name == "mean_scale_regression":
        return MeanScaleRegression()
    if name == "tobit":
        return Tobit(sigma=params.get("sigma", 1.0),
                     yl=params.get("yl", 0.0), yu=params.get("yu", 1.0))
    if name == "multiclass":
        return Multiclass(num_class=params.get("num_class", 2))
    if name == "multiclassova":
        return MulticlassOVA(num_class=params.get("num_class", 2),
                             sigmoid=params.get("sigmoid", 1.0))
    if name == "lambdarank":
        return LambdaRank(sigmoid=params.get("sigmoid", 1.0),
                          truncation_level=params.get(
                              "lambdarank_truncation_level", 30),
                          norm=bool(params.get("lambdarank_norm", True)),
                          label_gain=params.get("label_gain"), device=device)
    if name == "rank_xendcg":
        return RankXENDCG(seed=params.get("objective_seed",
                                          params.get("seed", 0)))
    raise ValueError(f"Unknown objective: {name}")
