"""User-facing ``GPModel`` — Gaussian process model facade (PyTorch port).

API mirrors the reference Python package's ``gpboost.GPModel``
(``python-package/gpboost/basic.py:4054-6600``): same constructor argument
names, ``fit`` / ``neg_log_likelihood`` / ``predict`` / ``set_optim_params``
/ ``model_to_dict`` methods, same covariance parameter layout
(``[nugget, variance, range...]`` for the gaussian likelihood,
``[variance, range...]`` for the others).

Ported so far: a single GP with ``gp_approx="vecchia"``. Gaussian
likelihood — construct (every keyword of the reference's constructor is
accepted: a value that needs a structure that is not ported raises), NLL,
fit with optional linear predictor by every optimizer of the reference's
Gaussian Vecchia route (gradient descent, the default, L-BFGS, Nelder-Mead;
``models/vecchia_fit.py``), std errors of covariance parameters and
coefficients, local-kriging prediction, the ``Psi^-1 r`` solve of the
GPBoost algorithm. Non-Gaussian likelihoods (the families of
``likelihoods/``) — the Vecchia-Laplace approximation: NLL (dense, or
``matrix_inversion_method="iterative"``: CG + stochastic Lanczos), fit of
covariance and auxiliary parameters and coefficients (L-BFGS, the default
for them, Nelder-Mead, gradient descent), prediction of the latent or
response mean and variance (simulated variances above 20 000 points or with
``nsim_var_pred``), the LaGaBoost gradient d NLL / dF. Every other
structure — exact GPs, grouped random effects, other approximations, GP
random coefficients, ``cluster_ids``, weights — raises
``NotImplementedError`` naming its ROADMAP.md item.

Models run on the GPU (``device="cuda"``, the default; a missing GPU
raises) unless ``device="cpu"`` is passed. Inputs and outputs are numpy
arrays; tensors stay on the model's device in between.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch import config
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models import optimizers, vecchia_fit
from gpboost_tpu_torch.models.vecchia_model import VecchiaGP
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.timer import timed

_OPTIM_PARAMS = ("optimizer_cov", "maxit", "delta_rel_conv", "init_cov_pars",
                 "init_coef", "trace", "std_dev", "convergence_criterion",
                 "lr_cov", "use_nesterov_acc", "acc_rate_cov",
                 "momentum_offset", "armijo_condition",
                 "estimate_cov_par_index", "estimate_aux_pars",
                 "init_aux_pars", "cg_max_num_it", "cg_max_num_it_tridiag",
                 "cg_delta_conv", "num_rand_vec_trace",
                 "reuse_rand_vec_trace", "seed_rand_vec_trace",
                 "cg_preconditioner_type", "piv_chol_rank")
_CRITERIA = ("relative_change_in_log_likelihood",
             "relative_change_in_parameters")
# above this many data points the std errors of the covariance parameters
# come from finite differences of the NLL gradient, below it from the dense
# expected Fisher information (the reference package's switch)
_DENSE_FISHER_MAX_N = 8192
# above this many data points the Vecchia-Laplace prediction simulates its
# variances (the reference package's switch to predict_laplace_sim)
_SIM_PRED_MIN_N = 20000
_FD_EPS = 1e-4
# reference optimizer-name aliases (re_model_template.h:718-750, :948-952)
_OPT_ALIASES = {
    "gradient_descent_constant_change": "gradient_descent",
    "gradient_descent_increase_lr": "gradient_descent",
    "gradient_descent_reset_lr": "gradient_descent",
    "lbfgs_not_profile_out_nugget": "lbfgs",
}


# response checks per likelihood (the JAX package's ``_validate_y``)
_Y_RULES = (
    (("bernoulli_probit", "bernoulli_logit"),
     lambda y: np.all((y == 0) | (y == 1)), "0 or 1"),
    (("poisson", "negative_binomial", "negative_binomial_1"),
     lambda y: not (np.any(y < 0) or np.any(y != np.floor(y))),
     "a non-negative integer"),
    (("gamma", "lognormal"), lambda y: not np.any(y <= 0),
     "strictly positive"),
    (("zero_inflated_gamma", "zero_censored_power_transformed_normal"),
     lambda y: not np.any(y < 0), "non-negative"),
    (("beta",), lambda y: not np.any((y <= 0) | (y >= 1)), "in (0, 1)"),
    (("zoctn", "beta_binomial", "binomial_logit", "binomial_probit"),
     lambda y: not (np.any(y < 0) or np.any(y > 1)), "in [0, 1]"),
)


def _not_ported(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported to gpboost_tpu_torch yet (ROADMAP.md "
        f"{queue}); ported: gp_coords with gp_approx='vecchia'")


def _canonical_likelihood(lik: str) -> str:
    """The family name behind a likelihood string (approximation suffixes
    stripped, aliases resolved); raises for what the port cannot run."""
    base, approx = lk.parse_likelihood_variants(lik)
    if approx == "lss_laplace":
        raise NotImplementedError(
            f"approximation_type 'lss_laplace' (likelihood '{lik}') is not "
            "supported")
    if approx == "fisher_laplace" and base not in (
            "gaussian_heteroscedastic", "t", "gaussian"):
        raise NotImplementedError(
            f"approximation_type 'fisher_laplace' is not implemented for "
            f"likelihood '{base}'")
    lk.get_family(base)                  # unknown names raise ValueError
    if base in lk.NOT_PORTED:
        raise NotImplementedError(
            f"likelihood='{lik}' is not ported to gpboost_tpu_torch yet "
            f"({lk.NOT_PORTED[base]})")
    return base


class GPModel:
    """Gaussian process model (Vecchia approximation).

    Parameters follow ``gpboost.GPModel`` (``basic.py:4054``); ``dtype`` and
    ``device`` say where and in which precision the model computes.
    ``dtype=torch.float32`` on a CUDA device routes the model through the
    hand-written Vecchia kernels.
    """

    def __init__(self, group_data=None, group_rand_coef_data=None,
                 ind_effect_group_rand_coef=None,
                 drop_intercept_group_rand_effect=None,
                 gp_coords=None, gp_rand_coef_data=None,
                 cov_function="matern", cov_fct_shape=1.5,
                 gp_approx="none", cov_fct_taper_range=1.0,
                 cov_fct_taper_shape=1.0, num_neighbors=None,
                 vecchia_ordering="random", ind_points_selection="kmeans++",
                 num_ind_points=500, cover_tree_radius=1.0,
                 matrix_inversion_method="cholesky", seed=0,
                 cluster_ids=None, likelihood="gaussian",
                 likelihood_additional_param=None, weights=None,
                 free_raw_data=False, vecchia_approx=None,
                 num_parallel_threads=None, num_data=None,
                 dtype=torch.float64, device="cuda"):
        # free_raw_data and num_parallel_threads have no effect here: the
        # data stay on the device, and the host work is PyTorch's
        if vecchia_approx:
            gp_approx = "vecchia"      # the reference's deprecated switch
        if (group_data is not None or group_rand_coef_data is not None
                or ind_effect_group_rand_coef is not None
                or drop_intercept_group_rand_effect is not None):
            raise _not_ported("grouped random effects (group_data, "
                              "group_rand_coef_data, "
                              "ind_effect_group_rand_coef, "
                              "drop_intercept_group_rand_effect)",
                              "Queue A, item 16")
        if num_data is not None:
            raise _not_ported("the iid model (num_data)", "Queue A, item 16")
        if gp_rand_coef_data is not None:
            raise _not_ported("GP random coefficients (gp_rand_coef_data)",
                              "Queue A, item 15")
        if cluster_ids is not None:
            raise _not_ported("cluster_ids", "Queue A, item 15")
        if weights is not None:
            raise _not_ported("weights", "Queue A, item 11")
        likelihood = _canonical_likelihood(likelihood)
        if likelihood == "gaussian" and likelihood_additional_param is not None:
            raise _not_ported(
                "likelihood_additional_param with likelihood='gaussian' (the "
                "latent-process parametrisation with the nugget as an "
                "auxiliary parameter)", "Queue A, item 15")
        for key, value, default in (
                ("cov_fct_taper_range", cov_fct_taper_range, 1.0),
                ("cov_fct_taper_shape", cov_fct_taper_shape, 1.0),
                ("ind_points_selection", ind_points_selection, "kmeans++"),
                ("num_ind_points", num_ind_points, 500),
                ("cover_tree_radius", cover_tree_radius, 1.0)):
            if value != default:
                raise _not_ported(f"{key}={value!r} (tapering and inducing "
                                  "points)", "Queue A, items 14 and 17")
        if matrix_inversion_method not in ("cholesky", "iterative"):
            raise ValueError("matrix_inversion_method: 'cholesky' or "
                             f"'iterative', got {matrix_inversion_method!r}")
        if matrix_inversion_method == "iterative" and likelihood == "gaussian":
            raise _not_ported(
                "matrix_inversion_method='iterative' with "
                "likelihood='gaussian' (the iterative Gaussian Vecchia "
                "route)", "Queue A, item 12")
        if gp_coords is None:
            raise ValueError("GPModel: 'gp_coords' is required")
        if gp_approx != "vecchia":
            raise _not_ported(f"gp_approx='{gp_approx}'",
                              "Queue A, items 16-17")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.likelihood = likelihood
        self.likelihood_additional_param = likelihood_additional_param
        self.gp_approx = gp_approx
        self.matrix_inversion_method = matrix_inversion_method
        self.num_neighbors = num_neighbors
        self.vecchia_ordering = vecchia_ordering
        self.seed = seed
        self.cov_function_name = cov_function
        self.cov_fct_shape = cov_fct_shape
        self._fit_result = None
        self.cov_pars_ = None
        self.coefs_ = None
        self.std_dev_cov_pars_ = None
        self.std_dev_coefs_ = None
        self.num_it_ = 0
        self.current_nll_ = None
        self.aux_pars_ = None
        self.nsim_var_pred = None
        self._train_fixed_effects = None

        coords = np.asarray(gp_coords, dtype=np.float64)
        coords = coords.reshape(len(coords), -1)
        self.num_data = coords.shape[0]
        self.coords_np = coords
        cf = CovFunction.create(cov_function, shape=cov_fct_shape,
                                dim_coords=coords.shape[1])
        self.cov_fn = cf
        with timed("GPModel: ordering + neighbor search", sync=True):
            self._approx = VecchiaGP(
                coords, cf, num_neighbors=(num_neighbors or 20),
                ordering=vecchia_ordering, seed=seed, likelihood=likelihood,
                dtype=dtype, device=self.device)
        self.y = None
        self.X = None
        self.optim_cfg = optimizers.OptimConfig()
        if not self.is_gaussian:
            # the reference's default for non-Gaussian likelihoods
            self.optim_cfg.optimizer_cov = "lbfgs"
        self.num_cov_pars = cf.num_cov_par + (1 if self.is_gaussian else 0)

    # ------------------------------------------------------------------
    def _tensor(self, x, ravel=False) -> torch.Tensor:
        arr = np.asarray(x, dtype=np.float64)
        if ravel:
            arr = arr.ravel()
        return torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    def _y_tensor(self, y) -> torch.Tensor:
        y_np = np.asarray(y, dtype=np.float64).ravel()
        if y_np.shape[0] != self.num_data:
            raise ValueError(
                f"y has {y_np.shape[0]} entries but the model was built for "
                f"{self.num_data} data points")
        if np.any(~np.isfinite(y_np)):
            raise ValueError("NaN or Inf in response variable / label")
        for names, ok, what in _Y_RULES:
            if self.likelihood in names and not ok(y_np):
                raise ValueError(f"Response must be {what} for likelihood "
                                 f"'{self.likelihood}'")
        return self._tensor(y_np)

    def set_optim_params(self, params: Optional[dict] = None):
        """Set optimization parameters (``basic.py:5347``); aliases resolve
        through ``config.ALIAS_TABLE``. Ported: ``optimizer_cov``,
        ``maxit``, ``delta_rel_conv``, ``init_cov_pars``, ``init_coef``,
        ``trace``, ``std_dev``, ``convergence_criterion``, ``lr_cov``,
        ``use_nesterov_acc``, ``acc_rate_cov``, ``momentum_offset``,
        ``armijo_condition``, ``estimate_cov_par_index``. ``std_dev`` has no
        effect of its own: the std errors are computed when
        ``get_cov_pars(std_err=True)`` asks for them."""
        if not params:
            return self
        params = config.resolve_aliases(params)
        unknown = [k for k in params if k not in _OPTIM_PARAMS]
        if unknown:
            raise NotImplementedError(
                f"optimization parameters {unknown} are not ported to "
                f"gpboost_tpu_torch yet; ported: {list(_OPTIM_PARAMS)}")
        if params.get("convergence_criterion", _CRITERIA[0]) not in _CRITERIA:
            raise ValueError(f"convergence_criterion: one of {_CRITERIA}, "
                             f"got {params['convergence_criterion']!r}")
        if not params.get("reuse_rand_vec_trace", True):
            raise NotImplementedError(
                "reuse_rand_vec_trace=False (new probe vectors in every "
                "evaluation) is not ported to gpboost_tpu_torch yet "
                "(ROADMAP.md Queue A, item 12)")
        cfg = self.optim_cfg
        for k, v in params.items():
            if k == "optimizer_cov":
                cfg.optimizer_cov = _OPT_ALIASES.get(v, v)
            elif k == "init_cov_pars":
                cfg.init_cov_pars = np.asarray(v, dtype=np.float64)
            elif k == "init_coef":
                cfg.init_coef = np.asarray(v, dtype=np.float64)
                # init_coef also becomes the current coefficient state used
                # by predict() (reference: set_optim_params then predict uses
                # the new coefficients without re-fitting)
                self.coefs_ = cfg.init_coef
            elif k == "estimate_cov_par_index":
                cfg.estimate_cov_par_index = np.asarray(v, dtype=np.int32)
            elif k == "init_aux_pars":
                self.aux_pars_ = np.atleast_1d(np.asarray(v, np.float64))
            else:
                setattr(cfg, k, v)
        return self

    def set_prediction_data(self, vecchia_pred_type=None,
                            num_neighbors_pred=None, nsim_var_pred=None,
                            **kwargs):
        """Prediction-time settings (``GPModel.set_prediction_data``).
        Ported: ``nsim_var_pred`` (simulated predictive variances of the
        Vecchia-Laplace prediction, with that many draws). The other
        settings and the validation prediction data raise (ROADMAP.md
        Queue A, items 15 and 18)."""
        given = dict(kwargs, vecchia_pred_type=vecchia_pred_type,
                     num_neighbors_pred=num_neighbors_pred)
        unported = sorted(k for k, v in given.items() if v is not None)
        if unported:
            raise _not_ported(f"set_prediction_data({', '.join(unported)})",
                              "Queue A, items 15 and 18")
        if nsim_var_pred is not None:
            self.nsim_var_pred = int(nsim_var_pred)
        return self

    @property
    def is_gaussian(self) -> bool:
        """Whether the likelihood is gaussian (what the boosting objective
        asks before it takes the ``Psi^-1 r`` route)."""
        return self.likelihood == "gaussian"

    def get_aux_pars(self):
        """Auxiliary parameters of the likelihood (user scale), or None."""
        return self.aux_pars_

    def _aux_tensor(self, aux_pars=None):
        """The likelihood's aux parameters as a tensor: given, fitted, or
        the family's defaults; None for a family without any."""
        fam = lk.get_family(self.likelihood)
        if fam.num_aux_pars == 0:
            return None
        if aux_pars is None:
            aux_pars = (self.aux_pars_ if self.aux_pars_ is not None
                        else fam.default_aux_pars(
                            self.likelihood_additional_param))
        return self._tensor(np.atleast_1d(np.asarray(aux_pars, np.float64)))

    def _iter_kwargs(self, fit: bool) -> dict:
        """Settings of the iterative Laplace NLL: a fit's (at least 200
        probes, ``vecchia_fit.ng_iter_kwargs``) or a single evaluation's
        (the configured number of probes), as in the JAX package."""
        cfg = self.optim_cfg
        kw = vecchia_fit.ng_iter_kwargs(cfg, self.num_data)
        if not fit:
            kw["num_rand_vec_trace"] = int(cfg.num_rand_vec_trace)
        return kw

    def _psi_solve(self, cov_pars, r) -> torch.Tensor:
        """Psi^-1 r for a vector ``r`` [n] in the original row order, at
        ``cov_pars`` = [nugget, variance, range...] — matrix-free through the
        Vecchia precision. Used by the GPBoost objective. Returns a tensor on
        the model's device."""
        cov_pars_np = np.asarray(cov_pars, dtype=np.float64)
        self._approx.ensure_neighbors(cov_pars_np)
        with torch.no_grad():
            return self._approx.psi_inv_resid(self._tensor(cov_pars_np),
                                              self._tensor(r, ravel=True))

    # ------------------------------------------------------------------
    def neg_log_likelihood(self, cov_pars, y, fixed_effects=None,
                           aux_pars=None) -> float:
        """Negative log-marginal-likelihood of the Vecchia approximation at
        given parameters (``GPB_EvalNegLogLikelihood``; ``basic.py:5284``):
        the Laplace-approximate one for non-Gaussian likelihoods (iterative
        with ``matrix_inversion_method="iterative"``, with the configured
        ``num_rand_vec_trace`` probes)."""
        cov_pars_np = np.asarray(cov_pars, dtype=np.float64)
        y_t = self._y_tensor(y)
        fe = None if fixed_effects is None else self._tensor(fixed_effects)
        if not self.is_gaussian:
            cp, ap = self._tensor(cov_pars_np), self._aux_tensor(aux_pars)
            with torch.no_grad():
                if self.matrix_inversion_method == "iterative":
                    return float(self._approx.nll_laplace_iterative(
                        cp, y_t, ap, fe, **self._iter_kwargs(fit=False)))
                return float(self._approx.nll_laplace(cp, y_t, ap, fe))
        self._approx.ensure_neighbors(cov_pars_np)
        return float(self._approx.nll_gaussian_value(
            self._tensor(cov_pars_np), y_t, fe))

    def _default_init_cov_pars(self, y: np.ndarray) -> np.ndarray:
        """Data-driven inits (``REModelTemplate::FindInitCovPar``, :4388):
        gaussian: nugget and variance var(y)/2; other likelihoods: variance
        var(y) (1 for the Bernoulli families); GP ranges mean(dist)/3."""
        var_y = float(np.var(y, ddof=1))
        if self.is_gaussian:
            pars = [var_y / 2.0, var_y / 2.0]
        else:
            pars = [1.0 if self.likelihood in ("bernoulli_probit",
                                               "bernoulli_logit") else var_y]
        extra = self.cov_fn.num_cov_par - 1
        m = min(self.coords_np.shape[0], 500)
        sub = self.coords_np[:m]
        d = np.sqrt(((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1))
        mean_dist = float(d[np.triu_indices(m, 1)].mean())
        pars.extend([mean_dist / 3.0] * extra)
        return np.asarray(pars, dtype=np.float64)

    def fit(self, y, X=None, params=None, offset=None, fixed_effects=None):
        """Estimate covariance (and regression) parameters
        (``GPModel.fit``, ``basic.py:5067`` -> ``GPB_OptimLinRegrCoefCovPar``).
        """
        if params:
            self.set_optim_params(params)
        # keep training data (incl. X) so predict() can rebuild residuals
        self.y = self._y_tensor(y)
        self.X = None if X is None else self._tensor(X)
        fe = fixed_effects if fixed_effects is not None else offset
        # the offset is part of the model state for later predictions
        self._train_fixed_effects = None if fe is None else self._tensor(fe)
        self.std_dev_cov_pars_ = None
        self.std_dev_coefs_ = None
        with timed("GPModel: fit", sync=True):
            return vecchia_fit.fit(self, self.y, self.X,
                                   self._train_fixed_effects)

    # ------------------------------------------------------------------
    def predict(self, y=None, gp_coords_pred=None, X_pred=None,
                predict_cov_mat=False, predict_var=False, cov_pars=None,
                predict_response=True, fixed_effects=None,
                fixed_effects_pred=None):
        """Posterior prediction (``GPModel.predict``, ``basic.py:5778``) by
        local kriging on the observed neighbors of each prediction point
        (``vecchia_pred_type='order_obs_first_cond_obs_only'``). For a
        non-Gaussian likelihood: kriging on the posterior mode, the latent
        variance dense up to 20 000 points, simulated above or with
        ``set_prediction_data(nsim_var_pred=...)``, the response moments by
        quadrature (``predict_response``).

        Returns dict with 'mu', 'var', 'cov' (numpy) like the reference.
        """
        if gp_coords_pred is None:
            raise ValueError("predict: 'gp_coords_pred' is required")
        cp_src = cov_pars if cov_pars is not None else self.cov_pars_
        if cp_src is None:
            raise ValueError("predict: the model is not fitted; pass "
                             "'cov_pars' or call fit() first")
        cov_pars_np = np.asarray(cp_src, dtype=np.float64)
        y_t = self._y_tensor(y) if y is not None else self.y
        if y_t is None:
            raise ValueError("predict: no response data; pass 'y' or call "
                             "fit() first")
        fe = (self._train_fixed_effects if fixed_effects is None
              else self._tensor(fixed_effects))
        fep = (None if fixed_effects_pred is None
               else self._tensor(fixed_effects_pred))
        if self.coefs_ is not None:
            beta = self._tensor(self.coefs_)
            if X_pred is not None:
                xbp = self._tensor(X_pred) @ beta
                fep = xbp if fep is None else fep + xbp
            if self.X is not None:
                xb = self.X @ beta
                fe = xb if fe is None else fe + xb
        cp = np.asarray(gp_coords_pred, dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        want_var = bool(predict_var or predict_cov_mat)
        with torch.no_grad(), timed("GPModel: predict", sync=True):
            if self.is_gaussian:
                self._approx.ensure_neighbors(cov_pars_np)
                mean, var = self._approx.predict_gaussian(
                    self._tensor(cov_pars_np), y_t, self._tensor(cp), fe,
                    bool(predict_response), want_var)
                if fep is not None:
                    mean = mean + fep
            elif (self.nsim_var_pred is not None
                  or self.num_data > _SIM_PRED_MIN_N):
                # simulated predictive variances, matrix-free
                # (Sample_Posterior_LaplaceApprox_Vecchia, likelihoods.h:6818)
                mean, var = self._approx.predict_laplace_sim(
                    self._tensor(cov_pars_np), y_t, self._aux_tensor(),
                    self._tensor(cp), fe, fep, bool(predict_response),
                    want_var, nsim=int(self.nsim_var_pred or 1000),
                    seed=self.optim_cfg.seed_rand_vec_trace)
            else:
                mean, var = self._approx.predict_laplace(
                    self._tensor(cov_pars_np), y_t, self._aux_tensor(),
                    self._tensor(cp), fe, fep, bool(predict_response),
                    want_var)
        mu_np = mean.cpu().numpy()
        var_np = None if var is None else var.cpu().numpy()
        # cond-obs-only Vecchia predictions are conditionally independent
        # given their neighbor sets -> the prediction covariance is diagonal
        cov = (None if (not predict_cov_mat or var_np is None)
               else np.diag(var_np))
        return {"mu": mu_np, "var": var_np, "cov": cov}

    # ------------------------------------------------------------------
    def get_cov_pars(self, format_pandas=False, std_err=False):
        """Estimated covariance parameters; with ``std_err=True`` a [2, p]
        stack of (estimate, asymptotic std dev), as the reference's
        ``get_cov_pars(std_err=TRUE)``. A numpy array either way (the JAX
        package likewise ignores ``format_pandas``)."""
        if self.cov_pars_ is None:
            return None
        if not std_err:
            return np.asarray(self.cov_pars_)
        if self.std_dev_cov_pars_ is None:
            self.std_dev_cov_pars_ = self._calc_std_dev_cov_pars()
        return np.vstack([np.asarray(self.cov_pars_),
                          np.asarray(self.std_dev_cov_pars_)])

    def get_coef(self, std_err=False):
        """Regression coefficients; with ``std_err=True`` a [2, k] stack of
        (estimate, std dev) — NaN std devs when the model holds no ``X``."""
        if self.coefs_ is None:
            return None
        if not std_err:
            return np.asarray(self.coefs_)
        if self.std_dev_coefs_ is None:
            self.std_dev_coefs_ = self._calc_std_dev_coefs()
        sd = self.std_dev_coefs_
        if sd is None:
            sd = np.full(len(np.asarray(self.coefs_)), np.nan)
        return np.vstack([np.asarray(self.coefs_), np.asarray(sd)])

    def _fitted_fixed_part(self):
        """Offset plus X beta of the training data (tensor or None)."""
        fe = self._train_fixed_effects
        if self.coefs_ is not None and self.X is not None:
            xb = self.X @ self._tensor(self.coefs_)
            fe = xb if fe is None else fe + xb
        return fe

    def _calc_std_dev_cov_pars(self) -> np.ndarray:
        """Asymptotic std devs from the inverse Fisher information
        (``CalcStdDevCovPar``, ``re_model_template.h:9775``), by the delta
        method on the log scale.

        Up to n = 8192 the dense expected Fisher information of the exact
        covariance; beyond, the observed information by forward differences
        (eps = 1e-4) of the NLL gradient — p + 1 gradient evaluations (on
        the kernel route, p + 1 launches of the NLL kernel), no [n, n]
        matrix."""
        if self.y is None:
            raise ValueError("std errors need the training data: call fit() "
                             "first")
        if not self.is_gaussian:
            raise _not_ported(
                "std errors of a non-Gaussian model (the JAX package has "
                "none for the Laplace approximation; its Fisher information "
                "is the Gaussian one of models/gaussian.py)",
                "Queue A, items 11 and 16")
        cov_pars = np.asarray(self.cov_pars_, np.float64)
        lp = np.log(cov_pars)
        if self.num_data > _DENSE_FISHER_MAX_N:
            fe = self._fitted_fixed_part()
            self._approx.ensure_neighbors(cov_pars)

            def grad(t):
                _, g = self._approx._vg_gaussian(
                    torch.as_tensor(t, dtype=self.dtype, device=self.device),
                    self.y, fe)
                return g.detach().cpu().numpy().astype(np.float64)

            p = len(lp)
            g0 = grad(lp)
            fi = np.empty((p, p))
            for j in range(p):
                t = lp.copy()
                t[j] += _FD_EPS
                fi[:, j] = (grad(t) - g0) / _FD_EPS
            fi = 0.5 * (fi + fi.T)
        else:
            fi = _dense_fisher_information(
                self.cov_fn, torch.as_tensor(self.coords_np,
                                             device=self.device), lp)
        return np.sqrt(np.maximum(np.diagonal(_inverse(fi)), 0.0)) * cov_pars

    def _calc_std_dev_coefs(self):
        """Std devs of the regression coefficients. Gaussian: from the GLS
        covariance (X' Psi^-1 X)^-1 (``CalcStdDevCoef``), Psi^-1 applied
        column by column through the Vecchia precision. Other likelihoods:
        the square root of the diagonal of the inverse Hessian of the dense
        Laplace NLL w.r.t. the coefficients (``CalcStdDevCoefNonGaussian``,
        ``re_model_template.h:9825``), by central differences of its
        autograd gradient, as the JAX package."""
        if self.X is None or self.coefs_ is None:
            return None
        if not self.is_gaussian:
            return self._calc_std_dev_coefs_laplace()
        X_np = self.X.detach().cpu().numpy().astype(np.float64)
        pix = torch.stack([self._psi_solve(self.cov_pars_, X_np[:, j])
                           for j in range(X_np.shape[1])], dim=1)
        xtpix = (self.X.T @ pix.to(self.X.dtype)).detach().cpu().numpy()
        return np.sqrt(np.maximum(np.diagonal(
            _inverse(xtpix.astype(np.float64))), 0.0))

    def _calc_std_dev_coefs_laplace(self):
        cp, aux = self._tensor(self.cov_pars_), self._aux_tensor()
        fe0 = self._train_fixed_effects

        def grad(b):
            bt = self._tensor(b).requires_grad_(True)
            with torch.enable_grad():
                fe = self.X @ bt if fe0 is None else self.X @ bt + fe0
                nll = self._approx.nll_laplace(cp, self.y, aux, fe)
                (g,) = torch.autograd.grad(nll, bt)
            return g.detach().cpu().numpy().astype(np.float64)

        beta = np.asarray(self.coefs_, np.float64)
        p = len(beta)
        eps = float(np.finfo(np.float64).eps) ** (1.0 / 3.0)
        H = np.zeros((p, p))
        for i in range(p):
            step = eps * max(abs(beta[i]), 1.0)
            b1, b2 = beta.copy(), beta.copy()
            b1[i] += step
            b2[i] -= step
            H[i] = (grad(b1) - grad(b2)) / (2 * step)
        return np.sqrt(np.maximum(np.diagonal(_inverse((H + H.T) / 2.0)),
                                  0.0))

    def get_num_optim_iter(self):
        return self.num_it_

    def get_current_neg_log_likelihood(self):
        return self.current_nll_

    def model_to_dict(self, include_data: bool = True):
        """Serialize (``GPModel.model_to_dict``, ``basic.py:6445``).

        Like the reference, the training data needed to re-create predictions
        (coordinates / y / X) is embedded. The keys are those of the JAX
        package's ``GPModel.model_to_dict`` (likelihood, aux parameters
        included), plus ``matrix_inversion_method``, so either package reads
        the other's output for the models both support."""
        d = {
            "likelihood": self.likelihood,
            "cov_function": self.cov_function_name,
            "cov_fct_shape": self.cov_fct_shape,
            "gp_approx": self.gp_approx,
            "num_neighbors": self.num_neighbors,
            "vecchia_ordering": self.vecchia_ordering,
            "seed": self.seed,
            "cov_pars": None if self.cov_pars_ is None else list(
                np.asarray(self.cov_pars_, dtype=np.float64)),
            "coefs": None if self.coefs_ is None else list(
                np.asarray(self.coefs_, dtype=np.float64)),
            "aux_pars": None if self.aux_pars_ is None else list(
                np.asarray(self.aux_pars_, dtype=np.float64)),
            "num_data": self.num_data,
            "iid_model": False,
            "matrix_inversion_method": self.matrix_inversion_method,
        }
        if include_data:
            d["gp_coords"] = self.coords_np.tolist()
            if self.y is not None:
                d["y"] = self.y.cpu().numpy().astype(np.float64).tolist()
            if self.X is not None:
                d["X"] = self.X.cpu().numpy().astype(np.float64).tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict, device="cuda",
                  dtype=torch.float64) -> "GPModel":
        """Rebuild a GPModel from ``model_to_dict`` output — this package's
        or the JAX package's (``GPModel(model_dict=...)`` in the reference).
        Keys of structures that are not ported raise
        ``NotImplementedError``."""
        for key in ("group_data", "group_rand_coef_data",
                    "gp_rand_coef_data", "cluster_ids"):
            if d.get(key) is not None:
                raise _not_ported(f"a saved model with '{key}'",
                                  "Queue A, items 15-16")
        if d.get("iid_model"):
            raise _not_ported("a saved iid model", "Queue A, item 16")
        if d.get("gp_coords") is None:
            raise ValueError("from_dict: the saved model holds no "
                             "'gp_coords' (saved without data?)")
        model = cls(
            gp_coords=np.asarray(d["gp_coords"], dtype=np.float64),
            likelihood=d.get("likelihood", "gaussian"),
            cov_function=d.get("cov_function", "matern"),
            cov_fct_shape=d.get("cov_fct_shape", 1.5),
            gp_approx=d.get("gp_approx", "none"),
            num_neighbors=d.get("num_neighbors"),
            vecchia_ordering=d.get("vecchia_ordering", "random"),
            matrix_inversion_method=d.get("matrix_inversion_method",
                                          "cholesky"),
            seed=d.get("seed", 0), dtype=dtype, device=device)
        if d.get("aux_pars") is not None:
            model.aux_pars_ = np.asarray(d["aux_pars"], dtype=np.float64)
        if d.get("cov_pars") is not None:
            model.cov_pars_ = np.asarray(d["cov_pars"], dtype=np.float64)
        if d.get("coefs") is not None:
            model.coefs_ = np.asarray(d["coefs"], dtype=np.float64)
        if d.get("y") is not None:
            model.y = model._y_tensor(d["y"])
            if d.get("X") is not None:
                model.X = model._tensor(d["X"])
        return model

    def save_model(self, filename):
        with open(filename, "w") as f:
            json.dump(self.model_to_dict(), f)
        return self

    @classmethod
    def load_model(cls, filename, device="cuda",
                   dtype=torch.float64) -> "GPModel":
        with open(filename) as f:
            return cls.from_dict(json.load(f), device=device, dtype=dtype)


def _inverse(a: np.ndarray) -> np.ndarray:
    try:
        return np.linalg.inv(a)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(a)


def _dense_fisher_information(cov_fn: CovFunction, coords: torch.Tensor,
                              log_cov_pars: np.ndarray) -> np.ndarray:
    """Expected Fisher information of the log-scale parameters
    [nugget, variance, range...] of the exact Gaussian model on ``coords``:
    FI_jk = 0.5 tr(Psi^-1 dPsi_j Psi^-1 dPsi_k), dPsi by forward-mode
    autodiff of the covariance build (``CalcFisherInformation``,
    ``re_model_template.h:9144``). Float64; [n, n, p] of memory."""
    coords = coords.to(torch.float64)
    n = coords.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=coords.device)

    def psi(lp):
        pars = torch.exp(lp)
        return cov_fn.cov_between(pars[1:], coords, coords) + pars[0] * eye

    lp = torch.as_tensor(log_cov_pars, dtype=torch.float64,
                         device=coords.device)
    dpsi = torch.func.jacfwd(psi)(lp)                         # [n, n, p]
    p = dpsi.shape[2]
    chol = torch.linalg.cholesky(psi(lp))
    s = torch.cholesky_solve(dpsi.reshape(n, n * p), chol).reshape(n, n, p)
    fi = 0.5 * torch.einsum("ilj,lik->jk", s, s)
    return fi.cpu().numpy()
