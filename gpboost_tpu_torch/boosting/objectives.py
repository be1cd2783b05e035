"""Boosting objective functions (gradients/hessians per data point).

Mirrors the reference's ``src/LightGBM/objective/*.hpp`` for what is ported:
the L2 regression objective and the GPBoost coupling of
``regression_objective.hpp:153-186`` — with an attached Gaussian ``GPModel``
the gradients are ``Psi^-1 (F - y)`` (generalized residuals) and the
covariance parameters are re-optimized, warm-started, in every iteration.

Scores, labels and gradients are host float64 arrays, as in the reference's
host loop; the covariance refit and the ``Psi^-1`` solve run on the model's
device. Other objectives and the non-Gaussian (LaGaBoost) branch are not
ported (ROADMAP.md Queue A, items 11, 13 and 18).
"""
from __future__ import annotations

import numpy as np


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


class GPBoostObjective(Objective):
    """Objective coupling boosting with a GPModel — the GPBoost algorithm
    (``regression_objective.hpp:153-186``), Gaussian likelihood.

    Gradients = Psi^-1 (F - y), hessians = 1; covariance parameters
    re-optimized (warm-started from the previous iteration's) inside
    ``get_gradients`` each boosting iteration. ``fits`` records every refit:
    its final NLL, its number of objective evaluations, the learning rate
    gradient descent started from (``lr_start``) and the one it reached
    after its first iteration (``lr_after_first``).

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
        if not gp_model.is_gaussian:
            raise NotImplementedError(
                f"gp_model with likelihood '{gp_model.likelihood}': the "
                "LaGaBoost algorithm is not ported to gpboost_tpu_torch yet "
                "(ROADMAP.md Queue A, items 11 and 13)")
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
        return float(np.mean(self.label))

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
        gp = self.gp_model
        gp.fit(y=resid, params=self._inner_fit_params())
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
}


def create_objective(name: str, params: dict, gp_model=None) -> Objective:
    """Objective factory (``objective_function.cpp:17-129``): ``regression``
    (and its aliases), with or without a ``gp_model``."""
    name = _ALIASES.get(name, name)
    if name not in ("regression", "regression_gp"):
        raise NotImplementedError(
            f"objective '{name}' is not ported to gpboost_tpu_torch yet "
            "(ROADMAP.md Queue A, item 18); ported: 'regression'")
    if gp_model is not None:
        return GPBoostObjective(
            gp_model,
            train_gp_model_cov_pars=params.get("train_gp_model_cov_pars",
                                               True),
            reuse_learning_rates_gp_model=params.get(
                "reuse_learning_rates_gp_model", True))
    if name == "regression_gp":
        raise ValueError("objective 'regression_gp' needs a gp_model")
    return RegressionL2()
