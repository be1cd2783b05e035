"""User-facing ``GPModel`` — the GP / mixed-effects model facade (PyTorch
port).

API mirrors the reference Python package's ``gpboost.GPModel``
(``python-package/gpboost/basic.py:4054-6600``): same constructor argument
names, ``fit`` / ``neg_log_likelihood`` / ``predict`` /
``predict_training_data_random_effects`` / ``set_optim_params`` /
``get_cov_pars`` / ``summary`` / ``model_to_dict`` methods, same covariance
parameter layout (the error variance first for the gaussian likelihood,
then each component's parameters). One class, three model structures, as
the JAX package dispatches them (``gpboost_tpu/models/gp_model.py:65-345``):

- **grouped random effects** (``group_data``, with random slopes
  ``group_rand_coef_data`` / ``ind_effect_group_rand_coef`` and
  ``drop_intercept_group_rand_effect``; ``num_data`` alone gives the iid
  model, a single-group dummy whose variance is pinned at 1e-20 after the
  fit): the Woodbury route of ``models/grouped.py`` (``_grouped_only``).
  Gaussian likelihood — NLL, the profiled fit by gradient descent (the
  default), L-BFGS, Nelder-Mead or Adam with GLS coefficient updates,
  Fisher scoring, Newton, held parameters, std errors from the Fisher
  information in q-space, prediction with unseen levels and the full
  covariance, the ``Psi^-1 r`` solve of the GPBoost algorithm. Other
  likelihoods — the Laplace approximation in b-space
  (``models/laplace_fit.py``), the LaGaBoost gradient there.
- **an exact GP** (``gp_coords`` with ``gp_approx="none"``, the default;
  ``_exact``), alone or with grouped effects, GP random coefficients and
  ``cluster_ids`` (a Gaussian GP alone with ``cluster_ids`` on the batched
  blocks of ``models/clustered.py``): the dense routes of
  ``models/gaussian.py`` (the same fits as the grouped models, std errors,
  prediction, training-data effects) and of ``models/laplace.py``.
- **a Vecchia GP** (``gp_coords`` with ``gp_approx="vecchia"``,
  ``models/vecchia_model.py``): gaussian likelihood — NLL, fit by every
  optimizer of the reference's Gaussian Vecchia route
  (``models/vecchia_fit.py``), std errors, local-kriging prediction, the
  ``Psi^-1 r`` solve; other likelihoods — the Vecchia-Laplace
  approximation (dense, or ``matrix_inversion_method="iterative"``: CG +
  stochastic Lanczos), its fit and prediction, the LaGaBoost gradient.
  With ``cluster_ids`` (searches within a cluster), GP random coefficients
  (the covariate-weighted build), every ``vecchia_pred_type`` of
  :meth:`GPModel.set_prediction_data`, grouped effects beside the GP
  (``models/vecchia_combined.py``, gaussian), the heteroscedastic two-set
  model (``models/heteroscedastic.py``) and ``gp_approx="vecchia_latent"``
  (the nugget as the gaussian likelihood's aux parameter).
- **a low-rank or full-scale GP** (``gp_approx="fitc"``,
  ``"full_scale_tapering"``, ``"full_scale_vecchia"``,
  ``"full_scale_vecchia_correlation_based"``; ``models/fitc_model.py``,
  ``models/fsva_model.py``), alone or with ``cluster_ids``
  (``models/clustered_approx.py``): the same routes as the Vecchia GP
  (the fits of ``models/vecchia_fit.py``, std errors, prediction with exact
  or simulated variances, the Laplace approximation, GPBoost and
  LaGaBoost).

``matrix_inversion_method="iterative"`` (CG and stochastic Lanczos, the
reference fork's iterative methods) runs the matrix-free routes where the
JAX package has them: grouped random effects in b-space (fit, prediction
with simulated variances), the non-Gaussian Vecchia GP (with the Jacobi or
a low-rank preconditioner), full-scale tapering and full-scale Vecchia;
the exact GP, the Gaussian Vecchia GP and FITC take their Cholesky route,
as in the JAX package. ``get_num_cg_steps`` reads the conditioning.

``gp_approx="tapering"`` is the exact route with the Wendland taper on the
covariance (dense, as in the JAX package). Observation ``weights`` are read
by grouped random effects and the exact GP; elsewhere (where the JAX
package accepts them and never reads them) they raise. Every other
structure — grouped effects or GP random coefficients with a low-rank GP —
raises ``NotImplementedError``, and so do the combinations the JAX package
refuses.

Models run on the GPU (``device="cuda"``, the default; a missing GPU
raises) unless ``device="cpu"`` is passed. Inputs and outputs are numpy
arrays; tensors stay on the model's device in between.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import config
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models import (clustered, gaussian, grouped, laplace,
                                      laplace_fit, optimizers, vecchia_fit)
from gpboost_tpu_torch.models.laplace import _response_moments
from gpboost_tpu_torch.models.covariance import (cluster_mask, component_cov,
                                                 split_cov_pars, total_re_cov)
from gpboost_tpu_torch.models.spec import (GroupedRESpec, ModelData,
                                           ModelSpec, make_model_data,
                                           map_cluster_ids)
from gpboost_tpu_torch.models.clustered_approx import ClusteredApprox
from gpboost_tpu_torch.models.fitc_model import FITCGP
from gpboost_tpu_torch.models.fsva_model import FSVAGP
from gpboost_tpu_torch.models.vecchia_combined import VecchiaGroupedGP
from gpboost_tpu_torch.models.vecchia_model import (DENSE_LAPLACE_MAX_N,
                                                    VecchiaGP)
from gpboost_tpu_torch.ops.cov_fns import CovFunction, euclidean_distance
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.timer import timed

_OPTIM_PARAMS = ("optimizer_cov", "optimizer_coef", "maxit", "delta_rel_conv", "init_cov_pars",
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
    "newton_constant_change": "newton",
    "newt_constant_change": "newton",
    "fisher_scoring_constant_change": "fisher_scoring",
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
    (("zero_one_censored_transformed_beta",
      "zero_one_censored_shifted_gamma", "zoctn", "beta_binomial",
      "binomial_logit", "binomial_probit"),
     lambda y: not (np.any(y < 0) or np.any(y > 1)), "in [0, 1]"),
)


# the optimizers of the grouped Gaussian fit (the profiled route)
_PROFILED = ("gradient_descent", "lbfgs", "lbfgs_linesearch_nocedal_wright",
             "nelder_mead", "adam")


# the reference's vecchia_pred_type values (Vecchia_utils.cpp:1634, 2018,
# 2241); the first is the default
VECCHIA_PRED_TYPES = ("order_obs_first_cond_obs_only",
                      "order_obs_first_cond_all", "order_pred_first",
                      "latent_order_obs_first_cond_obs_only",
                      "latent_order_obs_first_cond_all")


# the low-rank and full-scale approximations (fitc_model.py, fsva_model.py)
LOWRANK_APPROX = ("fitc", "full_scale_tapering", "full_scale_vecchia",
                  "full_scale_vecchia_correlation_based")
_LOWRANK_KEYWORDS = (("cov_fct_taper_range", 1.0),
                     ("cov_fct_taper_shape", 1.0),
                     ("ind_points_selection", "kmeans++"),
                     ("num_ind_points", 500), ("cover_tree_radius", 1.0))


def _not_ported(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported to gpboost_tpu_torch yet (ROADMAP.md "
        f"{queue}); ported: gp_coords with gp_approx='none' (the exact GP, "
        "with group_data, gp_rand_coef_data or cluster_ids), 'vecchia', "
        f"{', '.join(repr(a) for a in LOWRANK_APPROX)} (with cluster_ids), "
        "and group_data (grouped random effects) or num_data (the iid "
        "model) without gp_coords")


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
    return base


class GPModel:
    """Gaussian process and grouped random-effects model: grouped random
    intercepts and slopes (the Woodbury route), an exact GP (with or without
    grouped effects, GP random coefficients and ``cluster_ids``) or a
    Vecchia-approximated GP, gaussian or non-Gaussian likelihood (module
    docstring).

    Parameters follow ``gpboost.GPModel`` (``basic.py:4054``); ``dtype`` and
    ``device`` say where and in which precision the model computes.
    ``dtype=torch.float32`` on a CUDA device routes a Gaussian Vecchia model
    through the hand-written Vecchia kernels.
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
        group_keys = {"group_data": group_data,
                      "group_rand_coef_data": group_rand_coef_data,
                      "ind_effect_group_rand_coef": ind_effect_group_rand_coef,
                      "drop_intercept_group_rand_effect":
                          drop_intercept_group_rand_effect,
                      "num_data": num_data}
        given = [k for k, v in group_keys.items() if v is not None]
        self._iid_model = False
        likelihood = _canonical_likelihood(likelihood)
        self.gp_approx_user = gp_approx
        if (likelihood == "gaussian_heteroscedastic" and gp_approx == "none"
                and gp_coords is not None):
            # the dense heteroscedastic model: a Vecchia approximation that
            # conditions on ALL earlier points is exact (JAX
            # gp_model.py:94-111)
            n_het = len(np.asarray(gp_coords))
            if n_het > 1000:
                raise ValueError(
                    "likelihood='gaussian_heteroscedastic' with "
                    f"gp_approx='none' is only supported for n <= 1000 "
                    f"(have n={n_het}); use gp_approx='vecchia'")
            gp_approx, num_neighbors, vecchia_ordering = (
                "vecchia", n_het - 1, "none")
        is_vecchia = (gp_coords is not None
                      and gp_approx in ("vecchia", "vecchia_latent"))
        self._lowrank = gp_coords is not None and gp_approx in LOWRANK_APPROX
        if self._lowrank and (given or gp_rand_coef_data is not None):
            raise NotImplementedError(
                f"gp_approx='{gp_approx}' supports a single GP component "
                "(as the JAX package): no grouped random effects, iid model "
                "or GP random coefficients beside it")
        if is_vecchia:
            # the JAX package's refusals (gp_model.py:171-191)
            for msg, bad in (
                    ("gp_approx='vecchia' with GP random coefficients does "
                     "not support additional grouped random effects",
                     gp_rand_coef_data is not None and group_data is not None),
                    ("gp_approx='vecchia' with cluster_ids does not support "
                     "additional grouped random effects",
                     cluster_ids is not None and group_data is not None),
                    ("gp_approx='vecchia_latent' does not support GP random "
                     "coefficients", gp_rand_coef_data is not None
                     and gp_approx == "vecchia_latent"),
                    ("Vecchia with grouped random effects currently supports "
                     "the gaussian likelihood", group_data is not None and (
                         likelihood != "gaussian" or gp_approx != "vecchia"))):
                if bad:
                    raise NotImplementedError(msg)
        if gp_coords is None and group_data is None:
            if num_data is None:
                raise ValueError(
                    "GPModel: Both 'group_data' and 'gp_coords' are None. "
                    "Provide at least one of them or provide 'num_data' if "
                    "you want an iid model")
            # the reference's single-group dummy (R GPModel.R:553-560)
            group_data = np.zeros(int(num_data))
            self._iid_model = True
        if gp_coords is None and gp_rand_coef_data is not None:
            raise ValueError("'gp_rand_coef_data' needs 'gp_coords'")
        # the Woodbury route serves grouped effects alone; everything else
        # but a Vecchia or a low-rank GP is an exact (dense) model
        self._grouped_only = gp_coords is None and cluster_ids is None
        self._exact = not (self._grouped_only or is_vecchia or self._lowrank)
        if weights is not None and not (self._grouped_only or self._exact):
            # the JAX package accepts them there and never reads them
            raise NotImplementedError(
                f"weights with gp_approx='{gp_approx}': the JAX package "
                "accepts them and does not read them on this route (ROADMAP."
                "md, Queue C, \"Not faults\"); they are read by grouped "
                "random effects and the exact GP (gp_approx='none' or "
                "'tapering')")
        # gaussian_heteroscedastic: two latent sets (mean and log-variance),
        # each with its own covariance parameters (num_sets_re_ = 2)
        self.num_sets_re = 2 if likelihood == "gaussian_heteroscedastic" else 1
        if self.num_sets_re == 2 and not is_vecchia:
            raise NotImplementedError(
                "likelihood='gaussian_heteroscedastic' currently requires "
                "gp_approx='vecchia' (like the reference's test coverage)")
        values = dict(cov_fct_taper_range=cov_fct_taper_range,
                      cov_fct_taper_shape=cov_fct_taper_shape,
                      ind_points_selection=ind_points_selection,
                      num_ind_points=num_ind_points,
                      cover_tree_radius=cover_tree_radius)
        # the taper keywords are read by full-scale tapering, by
        # gp_approx="tapering" and by the wendland covariance
        tapered = gp_approx == "tapering" or cov_function == "wendland"
        for key, default in _LOWRANK_KEYWORDS:
            if (values[key] != default and not self._lowrank
                    and not (tapered and key.startswith("cov_fct_taper"))):
                raise NotImplementedError(
                    f"{key}={values[key]!r} with gp_approx='{gp_approx}': "
                    "the keyword is read by the low-rank approximations "
                    f"({', '.join(LOWRANK_APPROX)}; ROADMAP.md item 17), the "
                    "taper keywords also by gp_approx='tapering' and the "
                    "wendland covariance (item 14)")
        if matrix_inversion_method not in ("cholesky", "iterative"):
            raise ValueError("matrix_inversion_method: 'cholesky' or "
                             f"'iterative', got {matrix_inversion_method!r}")
        # "iterative" has its own route for grouped-only models, the
        # non-Gaussian Vecchia GP, full-scale tapering and full-scale
        # Vecchia; elsewhere (the exact GP, the Gaussian Vecchia GP, FITC)
        # the JAX package computes the Cholesky result, and so does the port
        # gp_approx="tapering": the exact route with the Wendland taper on
        # the covariance, formed dense as in the JAX package
        # (gpboost_tpu/models/gp_model.py:155-166)
        if gp_coords is not None and not (
                is_vecchia or gp_approx in ("none", "tapering")
                or self._lowrank):
            raise ValueError(f"gp_approx '{gp_approx}' is not supported")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.likelihood = likelihood
        self.likelihood_additional_param = likelihood_additional_param
        self.gp_approx = gp_approx
        self.matrix_inversion_method = matrix_inversion_method
        self.num_neighbors = num_neighbors
        self.num_ind_points = num_ind_points
        self.ind_points_selection = ind_points_selection
        self.cover_tree_radius = cover_tree_radius
        self.cov_fct_taper_range = cov_fct_taper_range
        self.cov_fct_taper_shape = cov_fct_taper_shape
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
        self.vecchia_pred_type = None
        # the validation prediction data of set_prediction_data
        self._valid_pred_data = None
        self._train_fixed_effects = None
        self.y = None
        self.X = None
        self.optim_cfg = optimizers.OptimConfig()
        if not self.is_gaussian:
            # the reference's default for non-Gaussian likelihoods
            self.optim_cfg.optimizer_cov = "lbfgs"
        self._approx = None
        self._Z = None
        self.spec = None
        self.cov_fn = None
        self.coords_np = None
        self._drop_intercept_group_rand_effect = (
            None if drop_intercept_group_rand_effect is None
            else [int(v) for v in np.atleast_1d(np.asarray(
                drop_intercept_group_rand_effect)).astype(int)])
        self._cluster_map = None
        self._approx_codes = None
        self._gp_rand_coef_np = None
        self._combined = False
        self._clustered_batched = False
        self._blocks = None
        if not (is_vecchia or self._lowrank):
            if gp_coords is not None:
                coords = np.asarray(gp_coords, dtype=np.float64)
                self.coords_np = coords.reshape(len(coords), -1)
                self.cov_fn = self._cov_function(self.coords_np.shape[1])
                # the batched per-cluster blocks (JAX gp_model.py:340-345)
                # (with weights the dense route: the JAX package's blocks
                # drop them)
                self._clustered_batched = (
                    cluster_ids is not None and group_data is None
                    and gp_rand_coef_data is None and self.is_gaussian
                    and self.cov_fn.is_isotropic and weights is None)
                if (dtype == torch.float32 and self.device.type == "cuda"
                        and torch.backends.cuda.matmul.allow_tf32):
                    raise RuntimeError(
                        "a float32 exact GP needs TF32 off for its distance "
                        "products (a reduced-precision cross term makes Psi "
                        "non-positive-definite): set "
                        "torch.backends.cuda.matmul.allow_tf32 = False")
            with timed("GPModel: model data", sync=True):
                components, self.data, info = make_model_data(
                    group_data, group_rand_coef_data,
                    ind_effect_group_rand_coef,
                    drop_intercept_group_rand_effect, dtype=dtype,
                    device=self.device, gp_coords=gp_coords,
                    cov_fn=self.cov_fn, gp_rand_coef_data=gp_rand_coef_data,
                    cluster_ids=cluster_ids,
                    dense_dists=not self._clustered_batched, weights=weights)
                self.num_data = info["num_data"]
                self._group_maps = info["group_maps"]
                self._cluster_map = info["cluster_map"]
                self.spec = ModelSpec(components=tuple(components),
                                      likelihood=likelihood,
                                      num_data=self.num_data)
                if self._clustered_batched:
                    self._blocks = clustered.prepare_blocks(
                        self.data.cluster_codes.cpu().numpy(),
                        self.coords_np, dtype=dtype, device=self.device)
                if self._grouped_only:
                    # on the card every sum over rows goes through a plan
                    # with a fixed order (no float atomics); on the CPU
                    # index_add_
                    self._Z = grouped.GroupedZ(
                        self.spec, self.data,
                        deterministic=self.device.type == "cuda",
                        dtype=dtype)
                    # what depends on the data only, built once: Z'Z for the
                    # gaussian likelihood, the pair plan of Z'WZ for others
                    if self.is_gaussian:
                        self._Z.ztz()
                    elif self._Z.deterministic:
                        self._Z.pair_plan()
            self.num_cov_pars = self.spec.num_cov_par
            return
        coords = np.asarray(gp_coords, dtype=np.float64)
        coords = coords.reshape(len(coords), -1)
        self.num_data = coords.shape[0]
        self.coords_np = coords
        cf = self._cov_function(coords.shape[1])
        self.cov_fn = cf
        # the parameter counts of the GP's components (the base GP and each
        # random coefficient) and of the grouped ones (one each)
        self._approx_comps = [cf.num_cov_par]
        if self._lowrank:
            self._approx = self._make_lowrank(coords, cluster_ids)
        elif group_data is not None:
            self._approx = self._make_combined(
                coords, group_data, group_rand_coef_data,
                ind_effect_group_rand_coef, drop_intercept_group_rand_effect)
        else:
            if gp_rand_coef_data is not None:
                rc = np.asarray(gp_rand_coef_data, np.float64).reshape(
                    self.num_data, -1)
                self._gp_rand_coef_np = rc
                self._approx_comps = [cf.num_cov_par] * (1 + rc.shape[1])
            if cluster_ids is not None:
                self._set_cluster_codes(cluster_ids)
            with timed("GPModel: ordering + neighbor search", sync=True):
                self._approx = VecchiaGP(
                    coords, cf, num_neighbors=(num_neighbors or 20),
                    ordering=vecchia_ordering, seed=seed,
                    likelihood=likelihood,
                    nugget_in_pars=(likelihood == "gaussian"
                                    and gp_approx == "vecchia"),
                    rand_coef_data=self._gp_rand_coef_np,
                    cluster_codes=self._approx_codes, dtype=dtype,
                    device=self.device)
        self.num_cov_pars = (sum(self._approx_comps)
                             + (1 if self.is_gaussian else 0)
                             ) * self.num_sets_re

    def _cov_function(self, dim: int) -> CovFunction:
        """The GP's covariance function (JAX ``gp_model.py:156-159``):
        the taper keywords reach the wendland covariance and
        ``gp_approx="tapering"``."""
        return CovFunction.create(
            self.cov_function_name, shape=self.cov_fct_shape,
            taper_range=self.cov_fct_taper_range,
            taper_shape=self.cov_fct_taper_shape,
            apply_tapering=self.gp_approx == "tapering", dim_coords=dim)

    def _set_cluster_codes(self, cluster_ids) -> None:
        cid = np.asarray(cluster_ids).ravel()
        if cid.shape[0] != self.num_data:
            raise ValueError(f"cluster_ids has {cid.shape[0]} entries "
                             f"for {self.num_data} data points")
        self._cluster_map, codes = np.unique(cid, return_inverse=True)
        self._approx_codes = codes.reshape(-1)

    def _make_combined(self, coords, group_data, group_rand_coef_data,
                       ind_effect_group_rand_coef,
                       drop_intercept_group_rand_effect):
        """The Vecchia GP with grouped random effects
        (``models/vecchia_combined.py``; JAX ``gp_model.py:186-214``)."""
        components, self.data, info = make_model_data(
            group_data, group_rand_coef_data, ind_effect_group_rand_coef,
            drop_intercept_group_rand_effect, dtype=self.dtype,
            device=self.device)
        if info["num_data"] != self.num_data:
            raise ValueError(f"group_data has {info['num_data']} rows, "
                             f"gp_coords {self.num_data}")
        self._group_maps = info["group_maps"]
        self._combined = True
        self.spec = ModelSpec(components=tuple(components),
                              likelihood=self.likelihood,
                              num_data=self.num_data)
        self._approx_comps = [1] * len(components) + self._approx_comps
        with timed("GPModel: ordering + neighbor search", sync=True):
            return VecchiaGroupedGP(
                coords, self.cov_fn, self.spec, self.data,
                num_neighbors=(self.num_neighbors or 20),
                ordering=self.vecchia_ordering, seed=self.seed,
                matrix_inversion_method=self.matrix_inversion_method,
                dtype=self.dtype, device=self.device)

    def _make_lowrank(self, coords: np.ndarray, cluster_ids):
        """The FITC / full-scale-tapering or full-scale-Vecchia model of
        ``self.gp_approx`` (JAX ``gp_model.py:230-301``), one a cluster
        with ``cluster_ids``."""
        fsva = self.gp_approx.startswith("full_scale_vecchia")

        def make_sub(cc):
            if fsva:
                return FSVAGP(
                    cc, self.cov_fn, num_neighbors=(self.num_neighbors or 30),
                    num_ind_points=self.num_ind_points,
                    ind_points_selection=self.ind_points_selection,
                    ordering=self.vecchia_ordering, seed=self.seed,
                    cover_tree_radius=self.cover_tree_radius,
                    likelihood=self.likelihood,
                    neighbor_selection=(
                        "residual_correlation"
                        if self.gp_approx.endswith("correlation_based")
                        else "nearest"),
                    dtype=self.dtype, device=self.device)
            return FITCGP(
                cc, self.cov_fn, num_ind_points=self.num_ind_points,
                ind_points_selection=self.ind_points_selection,
                seed=self.seed, cover_tree_radius=self.cover_tree_radius,
                likelihood=self.likelihood, gp_approx=self.gp_approx,
                cov_fct_taper_range=self.cov_fct_taper_range,
                cov_fct_taper_shape=self.cov_fct_taper_shape,
                matrix_inversion_method=self.matrix_inversion_method,
                dtype=self.dtype, device=self.device)

        with timed("GPModel: inducing points + structure", sync=True):
            if cluster_ids is None:
                return make_sub(coords)
            cid = np.asarray(cluster_ids).ravel()
            if cid.shape[0] != coords.shape[0]:
                raise ValueError(f"cluster_ids has {cid.shape[0]} entries "
                                 f"for {coords.shape[0]} data points")
            self._set_cluster_codes(cid)
            return ClusteredApprox(coords, self._approx_codes, make_sub,
                                   likelihood=self.likelihood,
                                   dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        arr = np.asarray(x, dtype=np.float64)
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

    def set_likelihood(self, likelihood: str):
        """Switch the response likelihood (``GPModel.set_likelihood``, JAX
        ``gp_model.py:578-595``; the R tests switch e.g. gamma -> gaussian
        before fitting): the covariance and auxiliary parameters are reset,
        the optimizer goes back to the likelihood's default, and the
        approximation takes the new likelihood (a Vecchia GP's nugget is
        among its parameters for the gaussian one)."""
        new_lik = _canonical_likelihood(likelihood)
        if new_lik == self.likelihood:
            return self
        if "gaussian_heteroscedastic" in (new_lik, self.likelihood):
            raise NotImplementedError(
                "set_likelihood to or from 'gaussian_heteroscedastic' (a "
                "model of two latent sets): build a new GPModel")
        self.likelihood = new_lik
        if self.spec is not None:
            self.spec = ModelSpec(components=self.spec.components,
                                  likelihood=new_lik,
                                  num_data=self.spec.num_data)
        if self._approx is not None:
            self._approx.likelihood = new_lik
            if isinstance(self._approx, VecchiaGP):
                self._approx.nugget_in_pars = (new_lik == "gaussian" and
                                               self.gp_approx == "vecchia")
                self._approx._kernel_shape = (
                    self._approx._kernel_shape_code())
        self.optim_cfg.optimizer_cov = ("gradient_descent" if self.is_gaussian
                                        else "lbfgs")
        if self._approx is None:
            self.num_cov_pars = self.spec.num_cov_par
        else:
            self.num_cov_pars = (sum(self._approx_comps)
                                 + (1 if self.is_gaussian else 0))
        self.cov_pars_ = None
        self.aux_pars_ = None
        return self

    def set_optim_params(self, params: Optional[dict] = None):
        """Set optimization parameters (``basic.py:5347``); aliases resolve
        through ``config.ALIAS_TABLE``. Ported: ``optimizer_cov``,
        ``optimizer_coef`` ("wls"), ``maxit``, ``delta_rel_conv``,
        ``init_cov_pars``, ``init_coef``, ``trace``, ``std_dev``,
        ``convergence_criterion``, ``lr_cov``, ``use_nesterov_acc``,
        ``acc_rate_cov``, ``momentum_offset``, ``armijo_condition``,
        ``estimate_cov_par_index`` and the settings of the iterative
        method. ``std_dev`` has no effect of its own: the std errors are
        computed when ``get_cov_pars(std_err=True)`` asks for them."""
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
        if params.get("optimizer_coef", "wls") not in ("wls",
                                                       "gradient_descent"):
            raise ValueError("optimizer_coef: 'wls' or 'gradient_descent', "
                             f"got {params['optimizer_coef']!r}")
        if not params.get("reuse_rand_vec_trace", True):
            raise NotImplementedError(
                "reuse_rand_vec_trace=False (new probe vectors in every "
                "evaluation) is not supported: the JAX package accepts the "
                "keyword and draws the same probes all the same (ROADMAP.md, "
                "Queue C, \"Not faults\")")
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
                            cg_delta_conv_pred=None, group_data_pred=None,
                            group_rand_coef_data_pred=None,
                            gp_coords_pred=None, gp_rand_coef_data_pred=None,
                            cluster_ids_pred=None, X_pred=None, **kwargs):
        """Prediction-time settings and validation prediction data
        (``GPModel.set_prediction_data``, JAX ``gp_model.py:435-468``):
        ``vecchia_pred_type`` (one of :data:`VECCHIA_PRED_TYPES`; the
        Gaussian Vecchia GP's prediction route), ``num_neighbors_pred`` (the
        prediction's conditioning-set size, at most the number of data
        points; default 2 m) and ``nsim_var_pred`` (simulated predictive
        variances of the Vecchia-Laplace prediction, with that many draws;
        the grouped models' Cholesky route computes its variances exactly
        and does not read it). The ``*_pred`` arrays are stored in
        ``_valid_pred_data`` for the boosting's validation prediction
        (``use_gp_model_for_validation``) and its GP metrics.
        ``cg_delta_conv_pred`` and other keywords are accepted and not
        read, as in the JAX package."""
        if vecchia_pred_type is not None:
            if vecchia_pred_type not in VECCHIA_PRED_TYPES:
                raise ValueError(
                    f"vecchia_pred_type {vecchia_pred_type!r}: one of "
                    f"{VECCHIA_PRED_TYPES}")
            self.vecchia_pred_type = vecchia_pred_type
        if num_neighbors_pred is not None and self._approx is not None:
            self._approx.num_neighbors_pred = min(int(num_neighbors_pred),
                                                  self.num_data)
        if nsim_var_pred is not None:
            self.nsim_var_pred = int(nsim_var_pred)
        pd = {k: v for k, v in (
            ("group_data_pred", group_data_pred),
            ("group_rand_coef_data_pred", group_rand_coef_data_pred),
            ("gp_coords_pred", gp_coords_pred),
            ("gp_rand_coef_data_pred", gp_rand_coef_data_pred),
            ("cluster_ids_pred", cluster_ids_pred),
            ("X_pred", X_pred)) if v is not None}
        if pd:
            self._valid_pred_data = pd
        return self

    def use_mesh(self, mesh=None, halo=None):
        """Row sharding over several devices (the JAX package's
        ``use_mesh``): not ported."""
        raise _not_ported("use_mesh (row sharding over several GPUs)",
                          "Queue A, item 20")

    @property
    def is_gaussian(self) -> bool:
        """Whether the likelihood is gaussian (what the boosting objective
        asks before it takes the ``Psi^-1 r`` route)."""
        return self.likelihood == "gaussian"

    @property
    def _latent_gaussian(self) -> bool:
        """``gp_approx="vecchia_latent"`` with the gaussian likelihood: the
        latent-process Vecchia GP with the nugget as the likelihood's
        auxiliary parameter, through the Laplace route (JAX
        ``gp_model.py:681-688``)."""
        return self.is_gaussian and self.gp_approx == "vecchia_latent"

    @property
    def _laplace_route(self) -> bool:
        return not self.is_gaussian or self._latent_gaussian

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
        """Psi^-1 r for ``r`` [n] or [n, k] (a numpy array or a tensor) in
        the original row order, at the Gaussian ``cov_pars`` — matrix-free
        through the Vecchia precision (the k columns in one precision
        product after one factor build), by Woodbury in q-space, by the
        cluster blocks, by the low-rank Woodbury solves, or by a dense
        Cholesky. Used by the GPBoost objective ([n]) and the Newton leaf
        re-solve ([n, leaves], JAX ``gp_model.py:394``). Returns a tensor on
        the model's device."""
        cov_pars_np = np.asarray(cov_pars, dtype=np.float64)
        cp = self._tensor(cov_pars_np)
        r = (r.to(device=self.device, dtype=self.dtype) if torch.is_tensor(r)
             else self._tensor(r))
        if self._latent_gaussian:
            raise NotImplementedError(
                "Psi^-1 r of gp_approx='vecchia_latent' (the GPBoost "
                "algorithm with it): the JAX package densifies Psi there; "
                "use gp_approx='vecchia'")
        if self._approx is None:
            with torch.no_grad():
                return self._gauss_ops().psi_solve(cp, r)
        self._approx.ensure_neighbors(cov_pars_np)
        with torch.no_grad():
            return self._approx.psi_inv_resid(cp, r)

    def _gauss_ops(self) -> "_GaussOps":
        """The Gaussian NLL's pieces of this model's structure: grouped
        (Woodbury in q-space), the cluster blocks, or dense."""
        if self._grouped_only:
            Z = self._Z
            vg = (lambda th, r: grouped.nll_profiled_value_and_grad(Z, th, r))
            if self.matrix_inversion_method == "iterative":
                # the profiled fit by CG and stochastic Lanczos (JAX
                # gp_model.py:1003-1015); the GLS coefficients and the
                # Psi^-1 solves keep the Cholesky route, as there
                kw = laplace_fit.grouped_iter_kwargs(self.optim_cfg)
                vg = (lambda th, r: grouped
                      .nll_profiled_iterative_value_and_grad(Z, th, r, **kw))
            return _GaussOps(
                nll=lambda cp, r: grouped.nll_gaussian(Z, cp, r),
                nll_twice=lambda cp, r: grouped.nll_gaussian_twice(Z, cp, r),
                vg_profiled=vg,
                fisher=lambda cp: grouped.fisher_information(Z, cp),
                psi_solve=lambda cp, R: grouped.psi_inv_mul(Z, cp, R))
        spec, data = self.spec, self.data
        ops = _GaussOps(
            nll=lambda cp, r: gaussian.neg_log_likelihood(spec, data, cp, r),
            nll_twice=lambda cp, r: gaussian.neg_log_likelihood_twice(
                spec, data, cp, r),
            vg_profiled=lambda th, r: gaussian.nll_profiled_value_and_grad(
                spec, data, th, r),
            fisher=lambda cp: gaussian.fisher_information(
                spec, data, torch.log(cp)),
            psi_solve=lambda cp, R: gaussian.psi_inv_mul(spec, data, cp, R))
        if self._clustered_batched:
            cf, blocks = self.cov_fn, self._blocks
            ops.nll = lambda cp, r: clustered.nll_gaussian(cf, cp, blocks, r)
            ops.vg_profiled = (lambda th, r: clustered
                               .nll_profiled_value_and_grad(cf, th, blocks,
                                                            r))
            ops.psi_solve = (lambda cp, R: clustered.psi_inv_blocks_mul(
                cf, cp, blocks, R))
        return ops

    # ------------------------------------------------------------------
    def neg_log_likelihood(self, cov_pars, y, fixed_effects=None,
                           aux_pars=None) -> float:
        """Negative log-marginal-likelihood at given parameters
        (``GPB_EvalNegLogLikelihood``; ``basic.py:5284``): exact for a
        grouped Gaussian model (Woodbury), the Laplace-approximate one for
        non-Gaussian likelihoods (iterative for a Vecchia model with
        ``matrix_inversion_method="iterative"``, with the configured
        ``num_rand_vec_trace`` probes)."""
        cov_pars_np = np.asarray(cov_pars, dtype=np.float64)
        y_t = self._y_tensor(y)
        fe = None if fixed_effects is None else self._tensor(fixed_effects)
        if self._approx is None:
            cp = self._tensor(cov_pars_np)
            with torch.no_grad():
                if self.is_gaussian:
                    r = y_t if fe is None else y_t - fe
                    return float(self._gauss_ops().nll(cp, r))
                return float(self._nll_laplace(cp, self._aux_tensor(aux_pars),
                                               fe, y_t))
        if self._latent_gaussian:
            # latent-process Vecchia + iid noise: cov_pars = GP parameters,
            # the nugget an aux parameter (default 1, as the JAX package)
            ap = (self._tensor(np.atleast_1d(np.asarray(aux_pars,
                                                        np.float64)))
                  if aux_pars is not None else torch.ones(
                      1, dtype=self.dtype, device=self.device))
            self._approx.ensure_neighbors(cov_pars_np)
            with torch.no_grad():
                return float(self._approx.nll_laplace(
                    self._tensor(cov_pars_np), y_t, ap, fe))
        if not self.is_gaussian:
            cp, ap = self._tensor(cov_pars_np), self._aux_tensor(aux_pars)
            if self._lowrank or self.num_sets_re == 2:
                self._approx.ensure_neighbors(cov_pars_np)
            with torch.no_grad():
                if (self.matrix_inversion_method == "iterative"
                        and hasattr(self._approx, "nll_laplace_iterative")):
                    return float(self._approx.nll_laplace_iterative(
                        cp, y_t, ap, fe, **self._iter_kwargs(fit=False)))
                return float(self._approx.nll_laplace(cp, y_t, ap, fe))
        self._approx.ensure_neighbors(cov_pars_np)
        if hasattr(self._approx, "sync_iter_cfg"):
            self._approx.sync_iter_cfg(self.optim_cfg)
        return float(self._approx.nll_gaussian_value(
            self._tensor(cov_pars_np), y_t, fe))

    def _nll_laplace(self, cov_pars, aux, fixed_part, y=None):
        """The dense Laplace NLL of any structure (a tensor, differentiable
        in all three) at the response ``y`` (default: the training one)."""
        y = self.y if y is None else y
        if self._grouped_only:
            return grouped.nll_laplace(self._Z, self.likelihood, cov_pars,
                                       aux, y, fixed_part)
        if self._exact:
            return laplace.neg_log_marginal_likelihood(
                self.spec, self.data, cov_pars, aux, y, fixed_part)
        return self._approx.nll_laplace(cov_pars, y, aux, fixed_part)

    def _grad_F_laplace(self, y, F) -> torch.Tensor:
        """d NLL / dF at the fitted parameters and the fixed effects F (the
        LaGaBoost gradient): b-space for grouped effects, the dense Laplace
        route of an exact model, the Vecchia-Laplace one."""
        cp, aux = self._tensor(self.cov_pars_), self._aux_tensor()
        y_t, F_t = self._y_tensor(y), self._tensor(F)
        if self._grouped_only:
            return grouped.gradient_wrt_F(self._Z, self.likelihood, cp, aux,
                                          y_t, F_t)
        if self._exact:
            return laplace.gradient_wrt_F(self.spec, self.data, cp, aux, y_t,
                                          F_t)
        return self._approx.grad_F_laplace(cp, y_t, aux, F_t)

    def _default_init_cov_pars(self, y: np.ndarray) -> np.ndarray:
        """Data-driven inits (``REModelTemplate::FindInitCovPar``, :4388):
        gaussian: error variance var(y)/2, each component's variance
        var(y)/2 / (number of components); other likelihoods: each
        component's variance var(y) / (number of components), 1 for the
        Bernoulli families; GP ranges mean(dist)/3 over the first 500
        coordinates."""
        var_y = float(np.var(y, ddof=1))
        bernoulli = self.likelihood in ("bernoulli_probit", "bernoulli_logit")
        if self._approx is not None:
            comps = list(self._approx_comps)
        else:
            comps = [c.num_cov_par for c in self.spec.components]
        ncomp = max(len(comps), 1)
        if self.is_gaussian:
            pars, var_each = [var_y / 2.0], var_y / 2.0 / ncomp
        else:
            pars, var_each = [], (1.0 if bernoulli else var_y / ncomp)
        mean_dist = None
        for num_par in comps:
            pars.append(var_each)
            if num_par > 1:
                if mean_dist is None:
                    m = min(self.coords_np.shape[0], 500)
                    sub = self.coords_np[:m]
                    d = np.sqrt(((sub[:, None, :] - sub[None, :, :]) ** 2
                                 ).sum(-1))
                    mean_dist = float(d[np.triu_indices(m, 1)].mean())
                pars.extend([mean_dist / 3.0] * (num_par - 1))
        out = np.asarray(pars, dtype=np.float64)
        # a second latent set starts from the same values
        # (re_model_template.h:4486-4503)
        return np.concatenate([out] * self.num_sets_re)

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
            if self._approx is not None:
                return vecchia_fit.fit(self, self.y, self.X,
                                       self._train_fixed_effects)
            if self.is_gaussian:
                self._fit_gaussian()
            else:
                nll = self._nll_laplace
                if (self._grouped_only
                        and self.matrix_inversion_method == "iterative"):
                    nll = laplace_fit.grouped_iterative_nll(self)
                laplace_fit.fit(self, self.y, self.X,
                                self._train_fixed_effects, nll,
                                with_adam=True)
            self._pin_iid_dummy()
        return self

    def _pin_iid_dummy(self):
        """iid models: the dummy single-group variance collapses during
        fitting; pin it at the reference's 1e-20 lower bound and refresh the
        reported NLL there (the R goldens are quoted at the bound)."""
        if not self._iid_model or self.cov_pars_ is None:
            return
        cp = np.asarray(self.cov_pars_, dtype=np.float64).copy()
        idx = 1 if self.is_gaussian else 0
        if cp[idx] >= 1e-6:
            return      # did not collapse: keep the fitted value
        cp[idx] = 1e-20
        self.cov_pars_ = cp
        fe = self._fitted_fixed_part()
        self.current_nll_ = float(self.neg_log_likelihood(
            cp, self.y.cpu().numpy(), aux_pars=self.aux_pars_,
            fixed_effects=None if fe is None else fe.cpu().numpy()))

    def _fit_gaussian(self):
        """The Gaussian fit of a grouped or exact model (JAX
        ``gp_model.py:910-925``): with a parameter held fixed the masked
        fit, Fisher scoring and Newton's method in the full
        parametrisation, every other optimizer profiled."""
        cfg = self.optim_cfg
        X, fe = self.X, self._train_fixed_effects
        y_fe = self.y if fe is None else self.y - fe
        y_np = self.y.cpu().numpy().astype(np.float64)
        init = np.asarray(cfg.init_cov_pars if cfg.init_cov_pars is not None
                          else self._default_init_cov_pars(y_np), np.float64)
        beta = None
        if X is not None:
            beta = self._tensor(
                cfg.init_coef if cfg.init_coef is not None
                else np.linalg.lstsq(X.cpu().numpy().astype(np.float64),
                                     y_np, rcond=None)[0])
        state = {"beta": beta, "version": 0}
        ops = self._gauss_ops()

        def residual():
            return y_fe if state["beta"] is None else y_fe - X @ state["beta"]

        def coef_update(full):
            """GLS coefficients at the full parameters (numpy): Psi^-1 [X,
            y] by one factorisation."""
            if X is None:
                return
            with torch.no_grad():
                w = ops.psi_solve(self._tensor(full),
                                  torch.cat([X, y_fe[:, None]], 1))
                state["beta"] = torch.linalg.solve(X.T @ w[:, :-1],
                                                   X.T @ w[:, -1])
            state["version"] += 1

        if cfg.estimate_cov_par_index is not None and np.any(
                np.asarray(cfg.estimate_cov_par_index) == 0):
            result = self._fit_gaussian_masked(ops, init, residual,
                                               coef_update)
        elif cfg.optimizer_cov in _PROFILED:
            result = self._fit_gaussian_profiled(ops, init, residual,
                                                 coef_update, state)
        elif cfg.optimizer_cov in ("fisher_scoring", "newton"):
            result = self._fit_gaussian_full(ops, init, residual,
                                             coef_update)
        else:
            raise ValueError(f"unknown optimizer_cov '{cfg.optimizer_cov}'")
        self.coefs_ = (None if state["beta"] is None else
                       state["beta"].cpu().numpy().astype(np.float64))
        self.num_it_ = result.num_it
        self._fit_result = result
        return result

    def _variance_index(self) -> np.ndarray:
        """Positions in cov_pars[1:] of the components' variances (the
        entries the profiled parametrisation divides by the nugget)."""
        return np.asarray([a - 1 for _, a, _ in self.spec.cov_par_slices()])

    def _fit_gaussian_profiled(self, ops, init, residual, coef_update,
                               state):
        """The profiled-nugget fit (JAX ``gp_model.py:971-1110``): log
        ratios of the variances to sigma2 (ranges as they are), sigma2 at
        its optimum; with ``X``, GLS coefficient updates (after every
        gradient-descent step, between three L-BFGS rounds, after
        Nelder-Mead and Adam)."""
        cfg = self.optim_cfg
        vidx = self._variance_index()
        has_coef = self.X is not None
        cache = {}
        evals = {"n": 0}

        def vg(theta):
            """(nll, gradient, sigma2_hat) on the host; the last point is
            kept, so gradient descent's value and gradient at one point
            cost one evaluation."""
            theta = np.asarray(theta, np.float64)
            key = (theta.tobytes(), state["version"])
            if cache.get("key") != key:
                evals["n"] += 1
                v, g, s2 = ops.vg_profiled(self._tensor(theta), residual())
                row = torch.cat([v.reshape(1), g, s2.reshape(1)]).cpu(
                    ).numpy().astype(np.float64)           # the one read
                if self._grouped_only:
                    grouped.GROUPED_COUNTS["evaluations"] += 1
                    grouped.GROUPED_COUNTS["host_reads"] += 1
                cache.update(key=key, out=(row[0], row[1:-1], row[-1]))
            return cache["out"]

        def full_from_ratio(ratio, sigma2):
            full = np.concatenate([[sigma2], np.asarray(ratio, np.float64)])
            full[vidx + 1] *= sigma2
            return full

        def coef_update_theta(theta):
            if has_coef:
                coef_update(full_from_ratio(np.exp(theta), vg(theta)[2]))

        ratio0 = np.asarray(init[1:], np.float64).copy()
        ratio0[vidx] = ratio0[vidx] / init[0]
        theta0 = np.log(np.maximum(ratio0, 1e-300))
        coef_update_theta(theta0)
        opt = cfg.optimizer_cov
        if opt == "gradient_descent":
            result = optimizers.gradient_descent(
                lambda t: vg(t)[0], lambda t: vg(t)[1], theta0, cfg,
                callback=(lambda it, theta, nll: coef_update_theta(theta))
                if has_coef else None)
        elif opt in laplace_fit.LBFGS_NAMES:
            theta = theta0
            for _ in range(3 if has_coef else 1):
                result = optimizers.lbfgs(lambda t: vg(t)[:2], theta, cfg)
                theta = np.log(result.params)
                coef_update_theta(theta)
        elif opt == "nelder_mead":
            result = optimizers.nelder_mead(lambda t: vg(t)[0], theta0, cfg)
            coef_update_theta(np.log(result.params))
        else:
            result = optimizers.adam(lambda t: vg(t)[:2], theta0, cfg)
            coef_update_theta(np.log(result.params))
        nll, _, sigma2 = vg(np.log(result.params))
        self.cov_pars_ = full_from_ratio(result.params, sigma2)
        result.nll = nll
        result.params = self.cov_pars_
        result.num_evals = evals["n"]
        self.current_nll_ = nll
        return result

    def _vg_full(self, ops, theta, r):
        """(nll, d nll / d log cov_pars) in the full parametrisation."""
        th = self._tensor(theta).requires_grad_(True)
        with torch.enable_grad():
            v = ops.nll(torch.exp(th), r)
            (g,) = ag.grad(v, th)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    def _fit_gaussian_masked(self, ops, init, residual, coef_update):
        """The fit with covariance parameters held at their inits
        (``estimate_cov_par_index``; JAX ``gp_model.py:1112``): the full
        parametrisation, L-BFGS on the free log-parameters, three rounds
        with GLS coefficient updates when there is ``X``."""
        log_init = np.log(np.maximum(init, 1e-300))
        coef_update(np.exp(log_init))
        theta, num_it = optimizers.lbfgs_masked(
            lambda t: self._vg_full(ops, t, residual()), log_init,
            np.flatnonzero(np.asarray(self.optim_cfg.estimate_cov_par_index,
                                      dtype=bool)),
            self.optim_cfg, rounds=3 if self.X is not None else 1,
            after_round=lambda t: coef_update(np.exp(t)))
        self.cov_pars_ = np.exp(theta)
        with torch.no_grad():
            nll = float(ops.nll(self._tensor(self.cov_pars_), residual()))
        self.current_nll_ = nll
        return optimizers.OptimResult(params=self.cov_pars_, nll=nll,
                                      num_it=num_it, converged=True)

    def _fit_gaussian_full(self, ops, init, residual, coef_update):
        """Fisher scoring, or Newton's method with the Hessian of the NLL
        (``optimizer_cov="newton"``, JAX ``gp_model.py:1178-1227``), on the
        log parameters; the GLS coefficients after every step."""
        cfg = self.optim_cfg

        def value_fn(theta):
            with torch.no_grad():
                return float(ops.nll(torch.exp(self._tensor(theta)),
                                     residual()))

        def grad_fn(theta):
            return self._vg_full(ops, theta, residual())[1]

        if cfg.optimizer_cov == "newton":
            def fisher_fn(theta):
                r = residual().detach()
                with torch.enable_grad():
                    h = torch.autograd.functional.hessian(
                        lambda t: ops.nll_twice(torch.exp(t), r),
                        self._tensor(theta))
                return h.cpu().numpy().astype(np.float64)
        else:
            def fisher_fn(theta):
                with torch.no_grad():
                    return ops.fisher(torch.exp(self._tensor(theta))).cpu(
                        ).numpy().astype(np.float64)

        if self.X is not None:
            coef_update(init)
        result = optimizers.fisher_scoring(
            value_fn, grad_fn, fisher_fn, np.log(np.maximum(init, 1e-300)),
            cfg, callback=lambda it, theta, nll: coef_update(np.exp(theta)))
        self.cov_pars_ = result.params
        self.current_nll_ = float(result.nll)
        return result

    # ------------------------------------------------------------------
    def predict(self, y=None, group_data_pred=None,
                group_rand_coef_data_pred=None, gp_coords_pred=None,
                gp_rand_coef_data_pred=None, cluster_ids_pred=None,
                X_pred=None, predict_cov_mat=False, predict_var=False,
                cov_pars=None, predict_response=True, fixed_effects=None,
                fixed_effects_pred=None, **kwargs):
        """Posterior prediction (``GPModel.predict``, ``basic.py:5778``).
        Other keywords are taken and dropped, as in the JAX package.

        Grouped model (``group_data_pred``, ``group_rand_coef_data_pred``;
        for the iid model only ``X_pred`` or ``fixed_effects_pred``): the
        posterior of the random effects, a level training never saw at its
        prior (mean 0, its variance; correlated only with rows of the same
        new label), the full covariance with ``predict_cov_mat``; the
        response scale adds the error variance (gaussian) or takes the
        response moments (quadrature). Exact model (``gp_coords_pred`` and
        the structure's other prediction data: ``group_data_pred``,
        ``gp_rand_coef_data_pred``, ``cluster_ids_pred`` — an unseen cluster
        id is an independent cluster, cluster 0 when none are given): the
        exact posterior (dense, or by the cluster blocks), for a
        non-Gaussian likelihood the Laplace posterior. Vecchia model
        (``gp_coords_pred``):
        local kriging on the observed neighbors of each prediction point
        (``vecchia_pred_type='order_obs_first_cond_obs_only'``); for a
        non-Gaussian likelihood kriging on the posterior mode, the latent
        variance dense up to 20 000 points, simulated above or with
        ``set_prediction_data(nsim_var_pred=...)``. Low-rank model
        (``gp_coords_pred``, ``cluster_ids_pred`` with ``cluster_ids``):
        :meth:`_predict_lowrank`.

        Returns dict with 'mu', 'var', 'cov' (numpy) like the reference.
        """
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
        beta = None if self.coefs_ is None else self._tensor(self.coefs_)
        if self.num_sets_re == 2:
            with torch.no_grad(), timed("GPModel: predict", sync=True):
                mean, var = self._predict_het(
                    y_t, fe, fep, beta, X_pred, cov_pars_np, gp_coords_pred,
                    bool(predict_response),
                    bool(predict_var or predict_cov_mat))
            return {"mu": mean.cpu().numpy(),
                    "var": None if var is None else var.cpu().numpy(),
                    "cov": None}
        if beta is not None and X_pred is not None:
            xbp = self._tensor(X_pred) @ beta
            fep = xbp if fep is None else fep + xbp
        if self._grouped_only:
            for key, value in (("gp_coords_pred", gp_coords_pred),
                               ("gp_rand_coef_data_pred",
                                gp_rand_coef_data_pred),
                               ("cluster_ids_pred", cluster_ids_pred)):
                if value is not None:
                    raise ValueError(
                        f"predict: '{key}' given, but the model has no "
                        "Gaussian process and no cluster_ids")
            with torch.no_grad(), timed("GPModel: predict", sync=True):
                return self._predict_grouped(
                    y_t, group_data_pred, group_rand_coef_data_pred, X_pred,
                    self._tensor(cov_pars_np), beta, fe, fep, predict_var,
                    predict_cov_mat, predict_response)
        if beta is not None and self.X is not None:
            xb = self.X @ beta
            fe = xb if fe is None else fe + xb
        if self._exact:
            with torch.no_grad(), timed("GPModel: predict", sync=True):
                mean, var, cov = self._predict_exact(
                    y_t, fe, fep, self._tensor(cov_pars_np), group_data_pred,
                    group_rand_coef_data_pred, gp_coords_pred,
                    gp_rand_coef_data_pred, cluster_ids_pred,
                    bool(predict_var), bool(predict_cov_mat),
                    bool(predict_response))
            want_var = bool(predict_var or predict_cov_mat)
            return {"mu": mean.cpu().numpy(),
                    "var": var.cpu().numpy() if (want_var and var is not None)
                    else None,
                    "cov": None if cov is None else cov.cpu().numpy()}
        if not self._combined and (group_data_pred is not None
                                   or group_rand_coef_data_pred is not None):
            raise ValueError("predict: 'group_data_pred' given, but the "
                             "model has no grouped random effects")
        if gp_coords_pred is None:
            raise ValueError("predict: 'gp_coords_pred' is required")
        cp = np.asarray(gp_coords_pred, dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        want_var = bool(predict_var or predict_cov_mat)
        extra = {}
        if not self._lowrank and not self._combined:
            if self._approx.z is not None:
                extra["z_pred"] = gp_rand_coef_data_pred
            if self._approx.codes is not None:
                if cluster_ids_pred is None:
                    raise ValueError(
                        "cluster_ids_pred is required for predictions from "
                        "a model trained with cluster_ids")
                extra["codes_pred"] = map_cluster_ids(self._cluster_map,
                                                      cluster_ids_pred)
        with torch.no_grad(), timed("GPModel: predict", sync=True):
            if self._lowrank:
                mean, var = self._predict_lowrank(
                    y_t, fe, fep, cov_pars_np, self._tensor(cp),
                    cluster_ids_pred, bool(predict_response), want_var)
            elif self._combined:
                mean, var = self._predict_combined(
                    y_t, fe, cov_pars_np, self._tensor(cp), group_data_pred,
                    group_rand_coef_data_pred, bool(predict_response),
                    bool(predict_var))
                if fep is not None:
                    mean = mean + fep
            elif not self._laplace_route:
                self._approx.ensure_neighbors(cov_pars_np)
                mean, var, covm = self._predict_vecchia_gaussian(
                    y_t, fe, self._tensor(cov_pars_np), self._tensor(cp),
                    bool(predict_response), bool(predict_var), want_var,
                    extra)
                if fep is not None:
                    mean = mean + fep
                if covm is not None:
                    return {"mu": mean.cpu().numpy(),
                            "var": None if var is None else var.cpu().numpy(),
                            "cov": (covm.cpu().numpy() if predict_cov_mat
                                    else None)}
            elif extra:
                # random coefficients or clusters: the dense (or CG) route
                # with the exact cross-covariance, as the JAX package
                mean, var = self._approx.predict_laplace(
                    self._tensor(cov_pars_np), y_t, self._aux_tensor(),
                    self._tensor(cp), fe, fep, bool(predict_response),
                    want_var, **extra)
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

    def _predict_vecchia_gaussian(self, y_t, fe, cp, coords_pred,
                                  predict_response, predict_var, want_var,
                                  extra):
        """(mean, var, cov or None) of a Gaussian Vecchia GP by
        ``vecchia_pred_type`` (JAX ``gp_model.py:1389-1456``): the two
        orderings with the prediction points among the conditioning sets and
        the latent types give a full covariance, the default
        (``order_obs_first_cond_obs_only``) local kriging with variances
        only."""
        vec, kind = self._approx, self.vecchia_pred_type
        if kind == "order_pred_first":
            mean, covm = vec.predict_gaussian_pred_first(
                cp, y_t, coords_pred, fe, predict_response)
            return (mean, torch.diagonal(covm) if predict_var else None,
                    covm)
        if kind in ("latent_order_obs_first_cond_obs_only",
                    "latent_order_obs_first_cond_all"):
            mean, var, covm = vec.predict_gaussian_latent_vecchia(
                cp, y_t, coords_pred, fe, kind.endswith("cond_obs_only"),
                predict_response)
            return mean, var if predict_var else None, covm
        if kind == "order_obs_first_cond_all" and len(extra) < 2:
            mean, covm = vec.predict_gaussian_cond_all(
                cp, y_t, coords_pred, fe, predict_response, **extra)
            return (mean, torch.diagonal(covm) if predict_var else None,
                    covm)
        mean, var = vec.predict_gaussian(cp, y_t, coords_pred, fe,
                                         predict_response, want_var, **extra)
        return mean, var, None

    def _predict_combined(self, y_t, fe, cov_pars_np, coords_pred,
                          group_data_pred, group_rand_coef_data_pred,
                          predict_response, predict_var):
        """The Vecchia GP with grouped effects (JAX ``gp_model.py:
        1357-1388``): the prediction rows' incidence, an unseen level a
        zero row that keeps its prior variance."""
        if group_data_pred is None:
            raise ValueError("predict: 'group_data_pred' is required")
        codes, weights = self._pred_codes(group_data_pred,
                                          group_rand_coef_data_pred)
        vec = self._approx
        n_p = coords_pred.shape[0]
        Zp = torch.zeros((n_p, vec.q_total), dtype=self.dtype,
                         device=self.device)
        for j, comp in enumerate(self.spec.components):
            col = codes[:, comp.code_col]
            rows = torch.nonzero(col < comp.num_groups).reshape(-1)
            Zp[rows, vec._Z.offsets[j] + col[rows]] = weights[rows, j]
        return vec.predict_gaussian(self._tensor(cov_pars_np), y_t,
                                    coords_pred, fe, predict_response,
                                    predict_var, Zp, weights)

    def _predict_het(self, y_t, fe, fep, beta, X_pred, cov_pars_np,
                     gp_coords_pred, predict_response, want_var):
        """``gaussian_heteroscedastic`` (JAX ``gp_model.py:1311-1343``): the
        stacked [2n] / [2 n_p] fixed parts (a single-set input applies to
        set 0), a coefficient vector per set."""
        if gp_coords_pred is None:
            raise ValueError("predict: 'gp_coords_pred' is required")
        cp = np.asarray(gp_coords_pred, dtype=np.float64)
        cp = self._tensor(cp[:, None] if cp.ndim == 1 else cp)
        n, n_p = self.num_data, cp.shape[0]
        if fe is not None and fe.shape[0] != 2 * n:
            fe = torch.cat([fe, torch.zeros_like(fe)])
        if fep is not None and fep.shape[0] != 2 * n_p:
            fep = torch.cat([fep, torch.zeros_like(fep)])
        if beta is not None and self.X is not None:
            p = self.X.shape[1]
            b1, b2 = beta[:p], beta[p:]
            xb = torch.cat([self.X @ b1, self.X @ b2])
            fe = xb if fe is None else fe + xb
            Xp = (self._tensor(X_pred) if X_pred is not None else torch.zeros(
                (n_p, p), dtype=self.dtype, device=self.device))
            xbp = torch.cat([Xp @ b1, Xp @ b2])
            fep = xbp if fep is None else fep + xbp
        return self._approx.predict_het(self._tensor(cov_pars_np), y_t, cp,
                                        fe, fep, predict_response, want_var)

    def _predict_lowrank(self, y_t, fe, fep, cov_pars_np, coords_pred,
                         cluster_ids_pred, predict_response, want_var):
        """Prediction of a low-rank model (JAX ``gp_model.py:1440-1490``):
        Gaussian with exact or simulated variances (``nsim_var_pred``), the
        Laplace posterior otherwise — FSVA's iterative route above
        ``DENSE_LAPLACE_MAX_N`` points or with
        ``matrix_inversion_method="iterative"`` (the JAX package's dense
        one holds [n, n]). Returns (mean, var) tensors."""
        self._approx.ensure_neighbors(cov_pars_np)
        cp = self._tensor(cov_pars_np)
        extra = {}
        if isinstance(self._approx, ClusteredApprox):
            if cluster_ids_pred is None:
                raise ValueError("cluster_ids_pred is required for "
                                 "predictions from a model trained with "
                                 "cluster_ids")
            extra["codes_pred"] = map_cluster_ids(self._cluster_map,
                                                  cluster_ids_pred)
        elif cluster_ids_pred is not None:
            raise ValueError("predict: 'cluster_ids_pred' given, but the "
                             "model has no cluster_ids")
        if self.is_gaussian:
            mean, var = self._approx.predict_gaussian(
                cp, y_t, coords_pred, fe, predict_response, want_var,
                nsim_var_pred=self.nsim_var_pred, **extra)
            return (mean if fep is None else mean + fep), var
        if isinstance(self._approx, FSVAGP):
            extra["iterative"] = (self.matrix_inversion_method == "iterative"
                                  or self.num_data > DENSE_LAPLACE_MAX_N)
        return self._approx.predict_laplace(
            cp, y_t, self._aux_tensor(), coords_pred, fe, fep,
            predict_response, want_var, **extra)

    def _predict_exact(self, y_t, fe, fep, cp, group_data_pred,
                       group_rand_coef_data_pred, gp_coords_pred,
                       gp_rand_coef_data_pred, cluster_ids_pred, predict_var,
                       predict_cov_mat, predict_response):
        """Prediction of an exact model (JAX ``gp_model.py:1500-1533``):
        Gaussian by ``gaussian.predict`` (the cluster blocks for a batched
        ``cluster_ids`` model), other likelihoods by ``laplace.predict``.
        Returns (mean, var, cov) tensors (var / cov None where not
        asked)."""
        data_pred = self._build_pred_data(
            group_data_pred, group_rand_coef_data_pred, gp_coords_pred,
            gp_rand_coef_data_pred, cluster_ids_pred)
        cross_dists = pred_dists = None
        if data_pred.coords is not None and self.cov_fn.is_isotropic:
            cross_dists = euclidean_distance(data_pred.coords,
                                             self.data.coords)
            if predict_cov_mat:
                pred_dists = euclidean_distance(data_pred.coords,
                                                data_pred.coords)
        if not self.is_gaussian:
            return laplace.predict(
                self.spec, self.data, cp, self._aux_tensor(), y_t, fe,
                data_pred, cross_dists, predict_var, predict_cov_mat,
                pred_dists, fep, predict_response)
        r = y_t if fe is None else y_t - fe
        if self._clustered_batched:
            mean, var, cov = clustered.predict(
                self.cov_fn, cp, self._blocks, r, data_pred.coords,
                data_pred.cluster_codes, predict_var, predict_cov_mat,
                predict_response)
        else:
            mean, var, cov = gaussian.predict(
                self.spec, self.data, cp, r, data_pred, cross_dists,
                predict_var, predict_cov_mat, pred_dists, predict_response)
        return (mean if fep is None else mean + fep), var, cov

    def _build_pred_data(self, group_data_pred, group_rand_coef_data_pred,
                         gp_coords_pred, gp_rand_coef_data_pred,
                         cluster_ids_pred) -> ModelData:
        """The prediction points of an exact model as :class:`ModelData`
        (JAX ``_build_pred_data``, ``gp_model.py:1755``): level codes with
        fresh codes for unseen labels, coordinates, GP random-coefficient
        covariates, cluster codes (an unseen id a fresh code; cluster 0
        when the model has clusters and none are given, as in the JAX
        package)."""
        n_p = None
        data_pred = ModelData()
        if gp_coords_pred is not None:
            c = np.asarray(gp_coords_pred, dtype=np.float64)
            data_pred.coords = self._tensor(c[:, None] if c.ndim == 1 else c)
            n_p = data_pred.coords.shape[0]
        elif self.data.coords is not None:
            raise ValueError("predict: 'gp_coords_pred' is required")
        if self.data.group_codes is not None:
            if group_data_pred is None:
                raise ValueError("predict: 'group_data_pred' is required")
            data_pred.group_codes = torch.as_tensor(
                self._code_labels(group_data_pred), device=self.device)
            n_p = data_pred.group_codes.shape[0]
            if self.data.slope_data is not None:
                if group_rand_coef_data_pred is None:
                    raise ValueError(
                        "predict: 'group_rand_coef_data_pred' is required "
                        "for a model with random slopes")
                rc = np.asarray(group_rand_coef_data_pred, np.float64)
                data_pred.slope_data = self._tensor(
                    rc[:, None] if rc.ndim == 1 else rc)
        if self.data.gp_rand_coef_data is not None:
            if gp_rand_coef_data_pred is None:
                raise ValueError("predict: 'gp_rand_coef_data_pred' is "
                                 "required for a model with GP random "
                                 "coefficients")
            rc = np.asarray(gp_rand_coef_data_pred, np.float64)
            data_pred.gp_rand_coef_data = self._tensor(
                rc[:, None] if rc.ndim == 1 else rc)
        if self._cluster_map is not None:
            codes = (np.zeros(n_p, dtype=np.int64) if cluster_ids_pred is None
                     else map_cluster_ids(self._cluster_map,
                                          cluster_ids_pred))
            data_pred.cluster_codes = torch.as_tensor(codes,
                                                      device=self.device)
        return data_pred

    def _code_labels(self, group_data_pred) -> np.ndarray:
        """Level codes [n_p, n_code_cols] of prediction labels: a label
        training never saw gets a fresh code >= the number of levels, one
        per distinct new label, in order of first appearance."""
        gd = np.asarray(group_data_pred)
        if gd.ndim == 1:
            gd = gd[:, None]
        if gd.shape[1] != len(self._group_maps):
            raise ValueError(
                f"group_data_pred has {gd.shape[1]} column(s), the model "
                f"{len(self._group_maps)}")
        codes = np.empty(gd.shape, dtype=np.int64)
        for j, levels in enumerate(self._group_maps):
            lab = gd[:, j].astype(str)
            pos = np.minimum(np.searchsorted(levels, lab), len(levels) - 1)
            found = levels[pos] == lab
            codes[:, j] = pos
            if not np.all(found):
                _, first, inv = np.unique(lab[~found], return_index=True,
                                          return_inverse=True)
                rank = np.argsort(np.argsort(first))
                codes[~found, j] = len(levels) + rank[inv.reshape(-1)]
        return codes

    def _pred_codes(self, group_data_pred, group_rand_coef_data_pred):
        """Level codes of the prediction rows (:meth:`_code_labels`) and
        the multipliers [n_p, ncomp] (slope covariates, 1 for intercepts)
        of the grouped predictor (``_build_pred_data``, JAX
        ``gp_model.py:1755``)."""
        codes = self._code_labels(group_data_pred)
        n_p = codes.shape[0]
        weights = torch.ones((n_p, len(self.spec.components)),
                             dtype=self.dtype, device=self.device)
        if any(c.is_slope for c in self.spec.components):
            if group_rand_coef_data_pred is None:
                raise ValueError("predict: 'group_rand_coef_data_pred' is "
                                 "required for a model with random slopes")
            rc = self._tensor(group_rand_coef_data_pred)
            rc = rc[:, None] if rc.dim() == 1 else rc
            for j, comp in enumerate(self.spec.components):
                if comp.is_slope:
                    weights[:, j] = rc[:, comp.slope_data_idx]
        return torch.as_tensor(codes, device=self.device), weights

    def _predict_grouped(self, y_t, group_data_pred,
                         group_rand_coef_data_pred, X_pred, cp, beta, fe,
                         fep, predict_var, predict_cov_mat,
                         predict_response):
        """The Woodbury-route prediction (``_predict_grouped``, JAX
        ``gp_model.py:1535``)."""
        if group_data_pred is None:
            if not self._iid_model:
                raise ValueError("predict: 'group_data_pred' is required")
            for cand in (X_pred, fep):
                if cand is not None:
                    n_pred = np.asarray(
                        cand.cpu() if torch.is_tensor(cand) else cand
                    ).shape[0]
                    break
            else:
                raise ValueError(
                    "Need to provide at least one of 'X_pred', "
                    "'gp_coords_pred' or 'fixed_effects_pred' to determine "
                    "the number of prediction points for an iid model")
            group_data_pred = np.zeros(n_pred)
        codes, weights = self._pred_codes(group_data_pred,
                                          group_rand_coef_data_pred)
        fixed = fe
        if beta is not None and self.X is not None:
            xb = self.X @ beta
            fixed = xb if fixed is None else fixed + xb
        nugget, comps = split_cov_pars(self.spec, cp)
        # the iterative route: the posterior by CG and simulated variances
        # from nsim_var_pred draws (default 1000), no [q, q] covariance
        # (JAX gp_model.py:1546-1590); the full covariance keeps the
        # Cholesky route
        if self.matrix_inversion_method == "iterative" and not predict_cov_mat:
            nsim = int(self.nsim_var_pred or 1000)
            seed = int(self.optim_cfg.seed_rand_vec_trace)
            if self.is_gaussian:
                r = y_t if fixed is None else y_t - fixed
                b_mean, draws = grouped.posterior_b_gaussian_iterative(
                    self._Z, cp, r, nsim, seed)
            else:
                b_mean, draws = grouped.posterior_b_laplace_iterative(
                    self._Z, self.likelihood, cp, self._aux_tensor(), y_t,
                    fixed, nsim, seed)
            mean, var = grouped.predict_from_posterior_draws(
                self.spec, b_mean, draws, torch.cat(comps), codes, weights)
            cov = None
        else:
            if self.is_gaussian:
                r = y_t if fixed is None else y_t - fixed
                b_mean, postcov = grouped.posterior_b_gaussian(self._Z, cp, r)
            else:
                b_mean, postcov = grouped.posterior_b_laplace(
                    self._Z, self.likelihood, cp, self._aux_tensor(), y_t,
                    fixed)
            mean, var, cov = grouped.predict_from_posterior(
                self.spec, b_mean, postcov, torch.cat(comps),
                bool(predict_cov_mat), codes, weights)
            del postcov
        if fep is not None:
            mean = mean + fep
        if self.is_gaussian:
            if predict_response:
                var = var + nugget
                if cov is not None:
                    cov.diagonal().add_(nugget)
        elif predict_response:
            mean, var = _response_moments(self.likelihood, mean,
                                          torch.clamp(var, min=0.0),
                                          self._aux_tensor())
            cov = None
        want_var = bool(predict_var or predict_cov_mat)
        return {"mu": mean.cpu().numpy(),
                "var": var.cpu().numpy() if want_var else None,
                "cov": None if cov is None else cov.cpu().numpy()}

    def predict_training_data_random_effects(self, predict_var=False):
        """Posterior means (and variances) of the random effects at the
        training points (``GPB_PredictREModelTrainingDataRandomEffects``;
        ``basic.py:6319``). Grouped model: one column per component, its
        effect at each row's level without the slope covariate
        (re_model_template.h:4102-4115), then as many variance columns.
        Exact model: the same per component (its base covariance times the
        posterior's y_aux). Approximated GP (Vecchia, FITC, full-scale
        tapering or full-scale Vecchia): the latent prediction at the
        training coordinates, a column of means and one of variances."""
        if self.y is None or self.cov_pars_ is None:
            raise ValueError("fit() must be called first")
        if self._approx is not None:
            return self._training_effects_approx(predict_var)
        cp = self._tensor(self.cov_pars_)
        fixed = self._fitted_fixed_part()
        if self._exact:
            with torch.no_grad():
                cols = self._training_effects_exact(cp, fixed, predict_var)
            return np.column_stack([c.cpu().numpy() for c in cols])
        with torch.no_grad():
            if self.is_gaussian:
                r = self.y if fixed is None else self.y - fixed
                b_mean, postcov = grouped.posterior_b_gaussian(self._Z, cp, r)
            else:
                b_mean, postcov = grouped.posterior_b_laplace(
                    self._Z, self.likelihood, cp, self._aux_tensor(), self.y,
                    fixed)
            pcdiag = torch.diagonal(postcov)
            cols = [b_mean[idx] for idx in self._Z.idx]
            if predict_var:
                cols += [pcdiag[idx] for idx in self._Z.idx]
        return np.column_stack([c.cpu().numpy() for c in cols])

    def _training_effects_approx(self, predict_var):
        """:meth:`predict_training_data_random_effects` of an approximated
        GP (Vecchia, FITC, full-scale tapering or full-scale Vecchia; JAX
        ``gp_model.py:1742-1752``): the latent prediction at the training
        coordinates with zero covariates — one column of means, then the
        variances with ``predict_var``."""
        cid = None
        if self._cluster_map is not None and self._approx_codes is not None:
            cid = self._cluster_map[self._approx_codes]
        pred = self.predict(
            gp_coords_pred=self.coords_np, cluster_ids_pred=cid,
            predict_var=predict_var, predict_response=False,
            X_pred=None if self.X is None else np.zeros(tuple(self.X.shape)))
        if predict_var:
            return np.column_stack([pred["mu"], pred["var"]])
        return pred["mu"][:, None]

    def _training_effects_exact(self, cp, fixed, predict_var):
        """Columns of :meth:`predict_training_data_random_effects` of an
        exact model (JAX ``gp_model.py:1660-1741``): per component its
        posterior mean Sigma_c Z_c' y_aux, without the covariate multiplier
        at the output point — Gaussian y_aux = Psi^-1 r, Laplace y_aux = d1
        at the mode, its posterior solve through (Sigma + W^-1)^-1 =
        W (I + Sigma W)^-1 —, then as many variance columns."""
        spec, data = self.spec, self.data
        n = self.num_data
        sigma2, comp_pars = split_cov_pars(spec, cp)
        sigma = total_re_cov(spec, data, comp_pars)
        if self.is_gaussian:
            r = self.y if fixed is None else self.y - fixed
            chol = torch.linalg.cholesky(sigma + sigma2 * torch.eye(
                n, dtype=sigma.dtype, device=sigma.device))
            y_aux = torch.cholesky_solve(r[:, None], chol)[:, 0]

            def post_solve(cross):
                return torch.cholesky_solve(cross.T, chol)
        else:
            fam = lk.get_family(self.likelihood)
            aux = self._aux_tensor()
            F = torch.zeros_like(self.y) if fixed is None else fixed
            b = laplace.find_mode(self.likelihood, sigma, self.y, F, aux)
            loc = F + b
            y_aux = fam.d_loc(self.y, loc, aux)
            w = -fam.d2_loc(self.y, loc, aux)
            M = sigma * w[None, :]
            M.diagonal().add_(1.0)

            def post_solve(cross):
                return w[:, None] * torch.linalg.solve(M, cross.T)
        mean_cols, var_cols = [], []
        for comp, pars in zip(spec.components, comp_pars):
            # the base covariance, no covariate multipliers on either side
            if isinstance(comp, GroupedRESpec):
                base = dataclasses.replace(comp, is_slope=False,
                                           slope_data_idx=-1)
                z_out = (data.slope_data[:, comp.slope_data_idx]
                         if comp.is_slope else None)
            else:
                base = dataclasses.replace(comp, is_random_coef=False,
                                           rand_coef_data_idx=-1)
                z_out = (data.gp_rand_coef_data[:, comp.rand_coef_data_idx]
                         if comp.is_random_coef else None)
            cov_c = component_cov(base, pars, data)
            mask = cluster_mask(data)
            if mask is not None:
                cov_c = torch.where(mask, cov_c, 0.0)
            mean_cols.append(cov_c @ (y_aux if z_out is None
                                      else z_out * y_aux))
            if predict_var:
                cross = cov_c if z_out is None else cov_c * z_out[None, :]
                var_cols.append(torch.diagonal(cov_c) - torch.sum(
                    cross * post_solve(cross).T, dim=1))
        return mean_cols + var_cols

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

        Grouped model: the expected Fisher information in q-space
        (``grouped.fisher_information``: one [q, q] Cholesky and inverse,
        no [n, n] matrix). Exact model: the dense expected Fisher
        information (``gaussian.fisher_information``). Vecchia model: up to
        n = 8192 the dense expected
        Fisher information of the exact covariance; beyond, the observed
        information by forward differences (eps = 1e-4) of the NLL
        gradient — p + 1 gradient evaluations (on the kernel route, p + 1
        launches of the NLL kernel), no [n, n] matrix."""
        if self.y is None:
            raise ValueError("std errors need the training data: call fit() "
                             "first")
        if self._laplace_route:
            raise _not_ported(
                "std errors of a non-Gaussian model (the JAX package has "
                "none for the Laplace approximation; its Fisher information "
                "is the Gaussian one of models/gaussian.py)",
                "Queue A, items 11 and 16")
        cov_pars = np.asarray(self.cov_pars_, np.float64)
        lp = np.log(cov_pars)
        if self._approx is None:
            with torch.no_grad():
                fi = self._gauss_ops().fisher(self._tensor(cov_pars)).cpu(
                    ).numpy().astype(np.float64)
        elif self.num_data > _DENSE_FISHER_MAX_N:
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
            # the dense expected information of the exact model on the
            # same coordinates and structure (float64)
            comps, data, _ = make_model_data(
                gp_coords=self.coords_np, cov_fn=self.cov_fn,
                gp_rand_coef_data=self._gp_rand_coef_np,
                cluster_ids=self._approx_codes, device=self.device,
                dense_dists=True)
            if self._combined:
                comps = list(self.spec.components) + comps
                data.group_codes = self.data.group_codes.to(torch.float64)\
                    .long()
                data.slope_data = (None if self.data.slope_data is None
                                   else self.data.slope_data.double())
            with torch.no_grad():
                fi = gaussian.fisher_information(
                    ModelSpec(components=tuple(comps),
                              num_data=self.num_data), data,
                    torch.as_tensor(lp, device=self.device)).cpu().numpy()
        return np.sqrt(np.maximum(np.diagonal(_inverse(fi)), 0.0)) * cov_pars

    def _calc_std_dev_coefs(self):
        """Std devs of the regression coefficients. Gaussian: from the GLS
        covariance (X' Psi^-1 X)^-1 (``CalcStdDevCoef``), Psi^-1 X by
        Woodbury (grouped) or column by column through the Vecchia
        precision. Other likelihoods: the square root of the diagonal of
        the inverse Hessian of the dense Laplace NLL w.r.t. the
        coefficients (``CalcStdDevCoefNonGaussian``,
        ``re_model_template.h:9825``), by central differences of its
        autograd gradient, as the JAX package."""
        if self.X is None or self.coefs_ is None:
            return None
        if not self.is_gaussian:
            return self._calc_std_dev_coefs_laplace()
        if self._approx is None:
            pix = self._psi_solve(self.cov_pars_, self.X.cpu().numpy())
        else:
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
                nll = self._nll_laplace(cp, aux, fe)
                (g,) = ag.grad(nll, bt)
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

    def get_num_cg_steps(self) -> int:
        """CG iterations of one solve of the model's system at the fitted
        parameters under the live ``cg_preconditioner_type`` — the
        conditioning diagnostic the reference exposes as
        ``GPB_GetNumCGSteps`` (JAX ``gp_model.py:471``). Grouped model:
        (Z'WZ + diag(shift)) x = Z'y under the Jacobi diagonal (W = 1 and
        shift = sigma2 / Sigma_b for the gaussian likelihood, W at the
        Laplace mode and shift = Sigma_b^-1 otherwise). Vecchia GP: the
        latent precision Q x = y (permuted) under the Jacobi diagonal or
        the Nystrom preconditioner of rank ``piv_chol_rank``. Full-scale
        tapering: Psi x = y under the FITC preconditioner (the JAX package
        raises there). Needs ``matrix_inversion_method="iterative"`` and a
        fitted model."""
        if self.matrix_inversion_method != "iterative":
            raise ValueError("get_num_cg_steps requires "
                             "matrix_inversion_method='iterative'")
        if self.cov_pars_ is None or self.y is None:
            raise ValueError("fit() must be called first")
        cfg = self.optim_cfg
        tol, max_iter = float(cfg.cg_delta_conv), int(cfg.cg_max_num_it)
        cp = self._tensor(self.cov_pars_)
        if self._grouped_only:
            Z = self._Z
            with torch.no_grad():
                if self.is_gaussian:
                    w = None
                    shift = cp[0] / grouped._sigma_b_diag(Z, cp[1:])
                else:
                    _, w, db = grouped.laplace_mode_and_w(
                        Z, self.likelihood, cp, self._aux_tensor(), self.y,
                        self._train_fixed_effects)
                    shift = 1.0 / db
                return grouped.num_cg_steps(Z, w, shift, Z._zt(self.y), tol,
                                            max_iter)
        if isinstance(self._approx, VecchiaGP):
            return self._approx.num_cg_steps(
                cp[1:] if self.is_gaussian else cp, self.y,
                cfg.cg_preconditioner_type, int(cfg.piv_chol_rank),
                int(cfg.seed_rand_vec_trace), tol, max_iter)
        if isinstance(self._approx, FITCGP) and self._approx._use_iterative:
            return self._approx.num_cg_steps(cp, self.y, tol, max_iter)
        raise NotImplementedError(
            "get_num_cg_steps is implemented for grouped random effects, the "
            "Vecchia GP and full-scale tapering (as in the JAX package, "
            "which also has no count for the other structures)")

    def get_num_optim_iter(self):
        return self.num_it_

    def get_current_neg_log_likelihood(self):
        return self.current_nll_

    def _cov_par_names(self):
        """The reference's names of the covariance parameters
        (``Error_term``, ``Group_k`` / ``Group_k_rand_coef``, ``GP_var``,
        ``GP_range``)."""
        names = ["Error_term"] if self.is_gaussian else []
        if self._approx is None:
            k_group = 0
            for comp in self.spec.components:
                if isinstance(comp, GroupedRESpec):
                    k_group += 1
                    names.append(f"Group_{k_group}"
                                 + ("_rand_coef" if comp.is_slope else ""))
                    continue
                prefix = "GP" + ("_rand_coef" if comp.is_random_coef else "")
                names.append(f"{prefix}_var")
                extra = comp.num_cov_par - 1
                names += [f"{prefix}_range" + (f"_{i + 1}" if extra > 1
                                               else "")
                          for i in range(extra)]
            return names
        if self._combined:
            names += [f"Group_{k + 1}" for k in range(len(
                self.spec.components))]
        extra = self.cov_fn.num_cov_par - 1
        n_gp = len(self._approx_comps) - (len(self.spec.components)
                                          if self._combined else 0)
        for c in range(n_gp):
            prefix = "GP" + ("_rand_coef" if c else "")
            names.append(f"{prefix}_var")
            names += [f"{prefix}_range" + (f"_{i + 1}" if extra > 1 else "")
                      for i in range(extra)]
        if self.num_sets_re == 2:
            names = [f"{nm}_mean" for nm in names] + [f"{nm}_log_var"
                                                      for nm in names]
        return names

    def summary(self):
        """Print the estimates (and std devs once computed), as the JAX
        package's ``summary``; an iid model shows only the error variance
        (GPModel.R:2281-2292)."""
        names = list(self._cov_par_names())
        cps = [] if self.cov_pars_ is None else list(
            np.asarray(self.cov_pars_))
        sds = (None if self.std_dev_cov_pars_ is None
               else list(np.asarray(self.std_dev_cov_pars_)))
        if self._iid_model:
            keep = [i for i, nm in enumerate(names) if nm == "Error_term"]
            names = [names[i] for i in keep]
            cps = [cps[i] for i in keep if i < len(cps)]
            if sds is not None:
                sds = [sds[i] for i in keep]
        if names and cps:
            print("Covariance parameters:")
            if sds is not None:
                for name, est, sd in zip(names, cps, sds):
                    print(f"  {name}: {est:.6g} (std dev {sd:.6g})")
            else:
                print(dict(zip(names, cps)))
        if self.coefs_ is not None:
            print("Linear regression coefficients:")
            if self.std_dev_coefs_ is not None:
                for j, (est, s) in enumerate(zip(
                        np.asarray(self.coefs_),
                        np.asarray(self.std_dev_coefs_))):
                    print(f"  beta_{j}: {est:.6g} (std dev {s:.6g})")
            else:
                print(np.asarray(self.coefs_))
        if self.aux_pars_ is not None:
            print("Additional parameters:")
            print(np.asarray(self.aux_pars_))
        return self

    def model_to_dict(self, include_data: bool = True):
        """Serialize (``GPModel.model_to_dict``, ``basic.py:6445``).

        Like the reference, the training data needed to re-create predictions
        (raw group labels / coordinates / y / X) is embedded. The keys are
        those of the JAX package's ``GPModel.model_to_dict`` (likelihood, aux
        parameters included), plus ``matrix_inversion_method``, so either
        package reads the other's output for the models both support."""
        d = {
            "likelihood": self.likelihood,
            "cov_function": self.cov_function_name,
            "cov_fct_shape": self.cov_fct_shape,
            "gp_approx": self.gp_approx_user,
            "num_neighbors": self.num_neighbors,
            "vecchia_ordering": self.vecchia_ordering,
            "num_ind_points": self.num_ind_points,
            "ind_points_selection": self.ind_points_selection,
            "cover_tree_radius": self.cover_tree_radius,
            "cov_fct_taper_range": self.cov_fct_taper_range,
            "cov_fct_taper_shape": self.cov_fct_taper_shape,
            "seed": self.seed,
            "cov_pars": None if self.cov_pars_ is None else list(
                np.asarray(self.cov_pars_, dtype=np.float64)),
            "coefs": None if self.coefs_ is None else list(
                np.asarray(self.coefs_, dtype=np.float64)),
            "aux_pars": None if self.aux_pars_ is None else list(
                np.asarray(self.aux_pars_, dtype=np.float64)),
            "num_data": self.num_data,
            "iid_model": self._iid_model,
            "matrix_inversion_method": self.matrix_inversion_method,
        }
        if include_data:
            if ((self._approx is None or self._combined)
                    and self.data.group_codes is not None):
                codes = self.data.group_codes.cpu().numpy()
                gd = np.empty(codes.shape, dtype=object)
                for j, levels in enumerate(self._group_maps):
                    gd[:, j] = levels[codes[:, j]]
                d["group_data"] = gd.astype(str).tolist()
                if self.data.slope_data is not None:
                    d["group_rand_coef_data"] = self.data.slope_data.cpu(
                        ).numpy().astype(np.float64).tolist()
                    d["ind_effect_group_rand_coef"] = [
                        c.code_col + 1 for c in self.spec.components
                        if c.is_slope]
                    if self._drop_intercept_group_rand_effect is not None:
                        d["drop_intercept_group_rand_effect"] = (
                            self._drop_intercept_group_rand_effect)
            if self.coords_np is not None:
                d["gp_coords"] = self.coords_np.tolist()
            if self._approx is None:
                if self.data.gp_rand_coef_data is not None:
                    d["gp_rand_coef_data"] = self.data.gp_rand_coef_data.cpu(
                        ).numpy().astype(np.float64).tolist()
                if self._cluster_map is not None:
                    d["cluster_ids"] = self._cluster_map[
                        self.data.cluster_codes.cpu().numpy()].tolist()
            else:
                if self._approx_codes is not None:
                    d["cluster_ids"] = self._cluster_map[
                        self._approx_codes].tolist()
                if self._gp_rand_coef_np is not None:
                    d["gp_rand_coef_data"] = self._gp_rand_coef_np.tolist()
            if self.y is not None:
                d["y"] = self.y.cpu().numpy().astype(np.float64).tolist()
            if self.X is not None:
                d["X"] = self.X.cpu().numpy().astype(np.float64).tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict, device="cuda",
                  dtype=torch.float64) -> "GPModel":
        """Rebuild a GPModel from ``model_to_dict`` output — this package's
        or the JAX package's (``GPModel(model_dict=...)`` in the reference):
        a grouped model (its iid model included), an exact, Vecchia or
        low-rank GP (the JAX package's dict has no taper keys: they take
        their defaults). Keys of structures that are not ported raise
        ``NotImplementedError``."""
        kwargs = dict(
            likelihood=d.get("likelihood", "gaussian"),
            cov_function=d.get("cov_function", "matern"),
            cov_fct_shape=d.get("cov_fct_shape", 1.5),
            num_neighbors=d.get("num_neighbors"),
            vecchia_ordering=d.get("vecchia_ordering", "random"),
            matrix_inversion_method=d.get("matrix_inversion_method",
                                          "cholesky"),
            **{key: d.get(key, default) for key, default in _LOWRANK_KEYWORDS
               if d.get("gp_approx") in LOWRANK_APPROX},
            seed=d.get("seed", 0), dtype=dtype, device=device)
        if d.get("group_data") is not None:
            kwargs["group_data"] = np.asarray(d["group_data"])
            if d.get("group_rand_coef_data") is not None:
                kwargs["group_rand_coef_data"] = np.asarray(
                    d["group_rand_coef_data"], dtype=np.float64)
                kwargs["ind_effect_group_rand_coef"] = d.get(
                    "ind_effect_group_rand_coef", [1])
                kwargs["drop_intercept_group_rand_effect"] = d.get(
                    "drop_intercept_group_rand_effect")
        if d.get("gp_coords") is not None:
            kwargs["gp_coords"] = np.asarray(d["gp_coords"], dtype=np.float64)
            kwargs["gp_approx"] = d.get("gp_approx", "none")
            if d.get("gp_rand_coef_data") is not None:
                kwargs["gp_rand_coef_data"] = np.asarray(
                    d["gp_rand_coef_data"], dtype=np.float64)
        if d.get("cluster_ids") is not None:
            kwargs["cluster_ids"] = np.asarray(d["cluster_ids"])
        if "group_data" not in kwargs and "gp_coords" not in kwargs:
            if d.get("num_data") is None:
                raise ValueError("from_dict: the saved model holds neither "
                                 "'group_data' nor 'gp_coords' (saved "
                                 "without data?)")
            kwargs["num_data"] = d["num_data"]
        model = cls(**kwargs)
        model._iid_model = bool(d.get("iid_model", False))
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


@dataclasses.dataclass
class _GaussOps:
    """The Gaussian NLL's pieces of one model structure, at full parameters
    ``cp`` (tensors) and the residual ``r``: ``nll`` (differentiable once,
    cheaply), ``nll_twice`` (differentiable twice), ``vg_profiled`` (the
    profiled value, gradient in the log ratios and sigma2_hat),
    ``fisher`` (the expected information of the log parameters),
    ``psi_solve`` (Psi^-1 R)."""
    nll: Callable
    nll_twice: Callable
    vg_profiled: Callable
    fisher: Callable
    psi_solve: Callable
