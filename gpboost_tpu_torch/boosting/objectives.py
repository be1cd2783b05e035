"""Boosting objective functions (gradients/hessians per data point).

Mirrors the reference's ``src/LightGBM/objective/*.hpp`` for what is ported:
the L2 regression objective, the binary log-loss (``binary_objective.hpp``)
and the coupling with a ``GPModel`` of ``regression_objective.hpp:153-186``:

- the GPBoost algorithm (gaussian likelihood): gradients ``Psi^-1 (F - y)``
  (generalized residuals), the covariance parameters re-optimized,
  warm-started, in every iteration;
- the LaGaBoost algorithm (other likelihoods): gradients d NLL_Laplace / dF
  at the current score, hessians 1, the covariance and auxiliary parameters
  re-optimized (warm-started) at the current score in every iteration.

Scores, labels and gradients are host float64 arrays, as in the reference's
host loop; the covariance refit, the ``Psi^-1`` solve (Vecchia, Woodbury
for grouped random effects, or a dense Cholesky for an exact GP) and the
Laplace gradient run on the model's device. Other objectives are not ported (ROADMAP.md Queue A,
item 18).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm


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
        return np.array([self.boost_from_average()])

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

    def boost_from_average(self):
        if self.weight is not None:
            return float(np.average(self.label, weights=self.weight))
        return float(np.mean(self.label))

    def get_gradients(self, score):
        return self._apply_weight(score - self.label, np.ones_like(score))


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
    "rmse": "regression", "binary_logloss": "binary",
    "xentropy": "cross_entropy",
}
# the names an objective may have beside a gp_model: the response
# distribution is then the GPModel's likelihood (JAX
# objectives.py:776-787)
GP_OBJECTIVES = ("regression", "binary", "regression_gp", "poisson", "gamma",
                 "cross_entropy")


def create_objective(name: str, params: dict, gp_model=None) -> Objective:
    """Objective factory (``objective_function.cpp:17-129``). With a
    ``gp_model`` any of ``GP_OBJECTIVES`` (and their aliases) gives the
    GPBoost / LaGaBoost objective — the response distribution is the
    GPModel's likelihood — and any other name is a ``ValueError``, as in
    the JAX package. Without one: ``regression`` and ``binary``."""
    name = _ALIASES.get(name, name)
    if gp_model is not None and name not in GP_OBJECTIVES:
        raise ValueError(
            f"objective '{name}' cannot be combined with a gp_model; the "
            "response distribution is specified via the GPModel likelihood")
    if gp_model is None and name not in ("regression", "regression_gp",
                                         "binary"):
        raise NotImplementedError(
            f"objective '{name}' is not ported to gpboost_tpu_torch yet "
            "(ROADMAP.md Queue A, item 18); ported: 'regression', 'binary' "
            f"and, with a gp_model, {', '.join(GP_OBJECTIVES)}")
    if gp_model is not None:
        return GPBoostObjective(
            gp_model,
            train_gp_model_cov_pars=params.get("train_gp_model_cov_pars",
                                               True),
            reuse_learning_rates_gp_model=params.get(
                "reuse_learning_rates_gp_model", True))
    if name == "regression_gp":
        raise ValueError("objective 'regression_gp' needs a gp_model")
    if name == "binary":
        if params.get("is_unbalance", False) and float(
                params.get("scale_pos_weight", 1.0)) != 1.0:
            raise ValueError("Cannot set is_unbalance and scale_pos_weight "
                             "at the same time")
        return Binary(sigmoid=float(params.get("sigmoid", 1.0)),
                      is_unbalance=bool(params.get("is_unbalance", False)),
                      scale_pos_weight=float(
                          params.get("scale_pos_weight", 1.0)))
    return RegressionL2()
