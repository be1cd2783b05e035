"""User-facing ``GPModel`` — Gaussian process model facade (PyTorch port).

API mirrors the reference Python package's ``gpboost.GPModel``
(``python-package/gpboost/basic.py:4054-6600``): same constructor argument
names, ``fit`` / ``neg_log_likelihood`` / ``predict`` / ``set_optim_params``
/ ``model_to_dict`` methods, same covariance parameter layout
(``[nugget, variance, range...]``).

Ported so far: a single GP with ``gp_approx="vecchia"`` and the gaussian
likelihood (construct, NLL, L-BFGS fit with optional linear predictor,
local-kriging prediction, the ``Psi^-1 r`` solve of the GPBoost algorithm). Every other structure — exact GPs, grouped
random effects, non-gaussian likelihoods, other approximations, GP random
coefficients, ``cluster_ids`` — raises ``NotImplementedError`` and is queued
in ROADMAP.md.

Models run on the GPU (``device="cuda"``, the default; a missing GPU
raises) unless ``device="cpu"`` is passed. Inputs and outputs are numpy
arrays; tensors stay on the model's device in between.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.models import optimizers, vecchia_fit
from gpboost_tpu_torch.models.vecchia_model import VecchiaGP
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.timer import timed

_OPTIM_PARAMS = ("optimizer_cov", "maxit", "delta_rel_conv", "init_cov_pars",
                 "init_coef")
# reference optimizer-name aliases (re_model_template.h:718-750, :948-952)
_OPT_ALIASES = {
    "gradient_descent_constant_change": "gradient_descent",
    "gradient_descent_increase_lr": "gradient_descent",
    "gradient_descent_reset_lr": "gradient_descent",
    "lbfgs_not_profile_out_nugget": "lbfgs",
}


def _not_ported(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported to gpboost_tpu_torch yet (ROADMAP.md "
        f"{queue}); ported: gp_coords with gp_approx='vecchia' and "
        "likelihood='gaussian'")


class GPModel:
    """Gaussian process model (Vecchia approximation, gaussian likelihood).

    Parameters follow ``gpboost.GPModel`` (``basic.py:4054``); ``dtype`` and
    ``device`` say where and in which precision the model computes.
    ``dtype=torch.float32`` on a CUDA device routes the model through the
    hand-written Vecchia kernels.
    """

    def __init__(self, group_data=None, group_rand_coef_data=None,
                 gp_coords=None, gp_rand_coef_data=None,
                 cov_function="matern", cov_fct_shape=1.5,
                 gp_approx="none", num_neighbors=None,
                 vecchia_ordering="random", seed=0, cluster_ids=None,
                 likelihood="gaussian", weights=None,
                 dtype=torch.float64, device="cuda"):
        if group_data is not None or group_rand_coef_data is not None:
            raise _not_ported("grouped random effects (group_data)",
                              "Queue A, item 16")
        if gp_rand_coef_data is not None:
            raise _not_ported("GP random coefficients (gp_rand_coef_data)",
                              "Queue A, item 15")
        if cluster_ids is not None:
            raise _not_ported("cluster_ids", "Queue A, item 15")
        if weights is not None:
            raise _not_ported("weights", "Queue A, item 11")
        if likelihood != "gaussian":
            raise _not_ported(f"likelihood='{likelihood}'",
                              "Queue A, items 11 and 13")
        if gp_coords is None:
            raise ValueError("GPModel: 'gp_coords' is required")
        if gp_approx != "vecchia":
            raise _not_ported(f"gp_approx='{gp_approx}'",
                              "Queue A, items 16-17")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.likelihood = likelihood
        self.gp_approx = gp_approx
        self.num_neighbors = num_neighbors
        self.vecchia_ordering = vecchia_ordering
        self.seed = seed
        self.cov_function_name = cov_function
        self.cov_fct_shape = cov_fct_shape
        self._fit_result = None
        self.cov_pars_ = None
        self.coefs_ = None
        self.num_it_ = 0
        self.current_nll_ = None
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
        self.num_cov_pars = 1 + cf.num_cov_par

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
        return self._tensor(y_np)

    def set_optim_params(self, params: Optional[dict] = None):
        """Set optimization parameters (``basic.py:5347``). Ported:
        ``optimizer_cov``, ``maxit``, ``delta_rel_conv``, ``init_cov_pars``,
        ``init_coef``."""
        if not params:
            return self
        unknown = [k for k in params if k not in _OPTIM_PARAMS]
        if unknown:
            raise NotImplementedError(
                f"optimization parameters {unknown} are not ported to "
                f"gpboost_tpu_torch yet; ported: {list(_OPTIM_PARAMS)}")
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
            else:
                setattr(cfg, k, v)
        return self

    @property
    def is_gaussian(self) -> bool:
        """Whether the likelihood is gaussian (what the boosting objective
        asks before it takes the ``Psi^-1 r`` route)."""
        return self.likelihood == "gaussian"

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
    def neg_log_likelihood(self, cov_pars, y, fixed_effects=None) -> float:
        """Negative log-marginal-likelihood of the Vecchia approximation at
        given parameters (``GPB_EvalNegLogLikelihood``; ``basic.py:5284``)."""
        cov_pars_np = np.asarray(cov_pars, dtype=np.float64)
        y_t = self._y_tensor(y)
        fe = None if fixed_effects is None else self._tensor(fixed_effects)
        self._approx.ensure_neighbors(cov_pars_np)
        return float(self._approx.nll_gaussian_value(
            self._tensor(cov_pars_np), y_t, fe))

    def _default_init_cov_pars(self, y: np.ndarray) -> np.ndarray:
        """Data-driven inits (``REModelTemplate::FindInitCovPar``, :4388):
        variances var(y)/2, GP ranges mean(dist)/3 heuristic."""
        var_y = float(np.var(y, ddof=1))
        pars = [var_y / 2.0, var_y / 2.0]
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
        (``vecchia_pred_type='order_obs_first_cond_obs_only'``).

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
        self._approx.ensure_neighbors(cov_pars_np)
        with torch.no_grad(), timed("GPModel: predict", sync=True):
            mean, var = self._approx.predict_gaussian(
                self._tensor(cov_pars_np), y_t, self._tensor(cp), fe,
                bool(predict_response), bool(predict_var or predict_cov_mat))
            if fep is not None:
                mean = mean + fep
        mu_np = mean.cpu().numpy()
        var_np = None if var is None else var.cpu().numpy()
        # cond-obs-only Vecchia predictions are conditionally independent
        # given their neighbor sets -> the prediction covariance is diagonal
        cov = (None if (not predict_cov_mat or var_np is None)
               else np.diag(var_np))
        return {"mu": mu_np, "var": var_np, "cov": cov}

    # ------------------------------------------------------------------
    def get_cov_pars(self):
        return None if self.cov_pars_ is None else np.asarray(self.cov_pars_)

    def get_coef(self):
        return None if self.coefs_ is None else np.asarray(self.coefs_)

    def get_num_optim_iter(self):
        return self.num_it_

    def get_current_neg_log_likelihood(self):
        return self.current_nll_

    def model_to_dict(self, include_data: bool = True):
        """Serialize (``GPModel.model_to_dict``, ``basic.py:6445``).

        Like the reference, the training data needed to re-create predictions
        (coordinates / y / X) is embedded. The keys are those of the JAX
        package's ``GPModel.model_to_dict``, so either package reads the
        other's output for the models both support."""
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
            "aux_pars": None,
            "num_data": self.num_data,
            "iid_model": False,
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
        if d.get("iid_model") or d.get("aux_pars") is not None:
            raise _not_ported("a saved iid or non-gaussian model",
                              "Queue A, items 11 and 16")
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
            seed=d.get("seed", 0), dtype=dtype, device=device)
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
