"""Fitting of Vecchia-approximated and low-rank models (Gaussian and
Laplace).

The dispatch of the reference package's Vecchia fit
(``gpboost_tpu/models/vecchia_fit.py``), with its accelerator route read as
"a CUDA model":

Gaussian likelihood ("a CUDA model that the fused kernels serve
(``_kernel_shape``), isotropic"):

- L-BFGS: :func:`optimizers.lbfgs_device` on that route, else scipy's
  L-BFGS-B (:func:`optimizers.lbfgs`; :func:`optimizers.lbfgs_host` with
  carried curvature memory once the boosting objective asks for it);
- Nelder-Mead: :func:`optimizers.nelder_mead`;
- gradient descent, the default (and ``fisher_scoring`` / ``newton`` /
  ``adam``, which fall through to it as in the reference package):
  :func:`optimizers.gd_device` on that route for ``gradient_descent`` when
  neither ``trace`` nor the parameter criterion is set, else the host loop
  with the coefficient update after every step.

Non-Gaussian likelihoods (:func:`fit_laplace`; the JAX package's
``vecchia_fit.py:235-390``): the parameters are [log covariance parameters,
auxiliary parameters on their optimisation scale, coefficients], the NLL is
the dense Laplace one (n <= 8192 and ``matrix_inversion_method="cholesky"``)
or the iterative one (:func:`ng_iter_kwargs`), differentiated by autograd.
L-BFGS is scipy's L-BFGS-B on the host over the value-and-gradient on the
card at every n (the JAX package's host-line-search route; its device loops
below 20 000 points exist for the TPU's watchdog, and on the GPU each
iterative evaluation already reads the host in every CG stop test);
Nelder-Mead and gradient descent as the JAX package routes them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.models import laplace_fit, optimizers
from gpboost_tpu_torch.models.vecchia_model import VecchiaGP

_LBFGS_NAMES = laplace_fit.LBFGS_NAMES
_KNOWN = _LBFGS_NAMES + ("gradient_descent", "nelder_mead",
                         "fisher_scoring", "newton", "adam")
_COEF_ROUNDS = 3
# the iterative Laplace NLL takes at least this many probes in a fit (the
# JAX package's GPBOOST_TPU_NG_MIN_PROBES default, a constant here)
NG_MIN_PROBES = 200


def device_loop_eligible(vec) -> bool:
    """Whether the whole-fit loops with their state on the device serve the
    model: a Vecchia GP that the fused NLL kernel serves (CUDA, inside the
    kernel gate) with an isotropic covariance (no neighbour redetermination
    mid-fit). The low-rank models (FITC, full-scale) have no fused kernel
    and always take the host route."""
    return (isinstance(vec, VecchiaGP) and vec.device.type == "cuda"
            and vec._kernel_shape is not None and vec.cov_fn.is_isotropic)


def redetermines_neighbors(vec) -> bool:
    """Whether a fit redetermines the model's neighbours at power-of-2
    evaluations: a Vecchia GP with a coordinate-scaled (ARD) covariance, a
    full-scale Vecchia GP with residual-correlation neighbours."""
    if isinstance(vec, VecchiaGP):
        return not vec.cov_fn.is_isotropic
    return getattr(vec, "redetermines_neighbors", False)


def _check_cfg(cfg):
    if cfg.optimizer_cov not in _KNOWN:
        raise ValueError(f"unknown optimizer_cov '{cfg.optimizer_cov}'")


def _held(cfg):
    """Indices of the free log-parameters when ``estimate_cov_par_index``
    holds some at their inits, else None."""
    if cfg.estimate_cov_par_index is None or not np.any(
            np.asarray(cfg.estimate_cov_par_index) == 0):
        return None
    return np.flatnonzero(np.asarray(cfg.estimate_cov_par_index, bool))


def fit(model, y: torch.Tensor, X: Optional[torch.Tensor],
        fixed_effects: Optional[torch.Tensor] = None):
    """Estimate the covariance parameters (and, with ``X``, the regression
    coefficients) of a Gaussian Vecchia model.

    Every call starts from ``cfg.init_cov_pars`` (the boosting objective
    warm-starts its per-iteration refits that way) on the neighbour
    structure built at construction. With ``X`` the device loops and
    L-BFGS alternate GLS coefficients and a covariance fit, three rounds;
    the host gradient descent updates the coefficients after every step."""
    if model._laplace_route:
        return fit_laplace(model, y, X, fixed_effects)
    cfg = model.optim_cfg
    vec = model._approx
    _check_cfg(cfg)
    if hasattr(vec, "sync_iter_cfg"):
        vec.sync_iter_cfg(cfg)
    y_np = y.detach().cpu().numpy().astype(np.float64)
    has_coef = X is not None
    init_cov = (cfg.init_cov_pars if cfg.init_cov_pars is not None
                else model._default_init_cov_pars(y_np))

    beta = None
    if has_coef:
        beta = torch.as_tensor(
            cfg.init_coef if cfg.init_coef is not None
            else np.linalg.lstsq(X.detach().cpu().numpy().astype(np.float64),
                                 y_np, rcond=None)[0],
            dtype=model.dtype, device=vec.device)

    def residual():
        fp = fixed_effects
        if beta is not None:
            xb = X @ beta
            fp = xb if fp is None else fp + xb
        return y if fp is None else y - fp

    def coef_update(theta):
        nonlocal beta
        if has_coef:
            cp = torch.exp(torch.as_tensor(theta, dtype=model.dtype,
                                           device=vec.device))
            beta = vec.wls_coef(cp, y, X, fixed_effects)

    eval_count = {"n": 0}

    def vg(theta):
        """Host objective: numpy log-parameters -> (NLL, gradient)."""
        if redetermines_neighbors(vec):
            # neighbour redetermination at power-of-2 evaluations
            # (re_model_template.h:4630-4656)
            c = eval_count["n"]
            if ((c + 1) & c) == 0:
                vec.ensure_neighbors(np.exp(np.asarray(theta)))
        eval_count["n"] += 1
        v, g = vec._vg_gaussian(
            torch.as_tensor(theta, dtype=model.dtype, device=vec.device),
            residual(), None)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    def alternate(run, theta0):
        """``run(theta)`` -> OptimResult; with coefficients, three rounds
        of covariance fit and GLS update."""
        if not has_coef:
            return run(theta0)
        theta, num_evals = theta0, 0
        for _ in range(_COEF_ROUNDS):
            result = run(theta)
            num_evals += result.num_evals
            theta = np.log(result.params)
            coef_update(theta)
        result.num_evals = num_evals
        return result

    theta0 = np.log(np.maximum(np.asarray(init_cov, np.float64), 1e-300))
    coef_update(theta0)
    opt = cfg.optimizer_cov
    on_device = device_loop_eligible(vec)
    gd_on_device = (on_device and not cfg.trace and cfg.convergence_criterion
                    == "relative_change_in_log_likelihood")
    free = _held(cfg)
    device_route = free is None and (
        (opt in _LBFGS_NAMES and on_device)
        or (opt == "gradient_descent" and gd_on_device))
    if free is not None:
        # parameters held at their inits: L-BFGS on the free ones, as the
        # exact models' masked fit (the JAX package's Vecchia fit does not
        # read estimate_cov_par_index)
        theta, num_it = optimizers.lbfgs_masked(
            vg, theta0, free, cfg, _COEF_ROUNDS if has_coef else 1,
            coef_update)
        result = optimizers.OptimResult(params=np.exp(theta),
                                        nll=vg(theta)[0], num_it=num_it,
                                        converged=True)
    elif device_route:
        # the whole fit on the device, in float32 like the kernels; without
        # coefficients the GPBoost pseudo-gradient solve Psi^-1 r at the
        # final parameters rides along as the fit's extra output
        loop = (optimizers.lbfgs_device if opt in _LBFGS_NAMES
                else optimizers.gd_device)
        final_fn = None if has_coef else vec._fit_psi_inv

        def run_device(theta):
            return loop(lambda th, r: vec._vg_gaussian(th, r, None), theta,
                        cfg, torch.float32, residual(), final_fn=final_fn,
                        device=vec.device)

        result = alternate(run_device, theta0)
    elif opt in _LBFGS_NAMES:
        result = alternate(lambda th: optimizers.lbfgs(vg, th, cfg), theta0)
    elif opt == "nelder_mead":
        result = optimizers.nelder_mead(lambda t: vg(t)[0], theta0, cfg)
        coef_update(np.log(result.params))
    else:
        result = optimizers.gradient_descent(
            lambda t: vg(t)[0], lambda t: vg(t)[1], theta0, cfg,
            callback=(lambda it, theta, nll: coef_update(theta))
            if has_coef else None)
    if not device_route:
        result.num_evals = eval_count["n"]
    model.cov_pars_ = result.params
    model.coefs_ = (None if beta is None
                    else beta.detach().cpu().numpy().astype(np.float64))
    model.num_it_ = result.num_it
    model.current_nll_ = float(result.nll)
    model._fit_result = result
    return model


def ng_iter_kwargs(cfg, n: int) -> dict:
    """Iterative Vecchia-Laplace settings of a fit, from the optimizer
    config: at least ``NG_MIN_PROBES`` probes, at most 100 Lanczos steps."""
    return dict(
        num_rand_vec_trace=max(int(cfg.num_rand_vec_trace), NG_MIN_PROBES),
        lanczos_steps=min(int(cfg.cg_max_num_it_tridiag), 100, n),
        cg_tol=cfg.cg_delta_conv, cg_max_iter=cfg.cg_max_num_it,
        seed_rand_vec_trace=cfg.seed_rand_vec_trace,
        preconditioner=cfg.cg_preconditioner_type,
        piv_chol_rank=cfg.piv_chol_rank)


def ng_device_vg(model, n_cov: int, n_aux: int, aux_fixed, fam):
    """The non-Gaussian Vecchia-Laplace objective of the device-resident
    boosting loop's refits (the JAX package's ``vecchia_fit.ng_device_vg``):
    ``vg(theta, y, fp) -> (nll, d nll / d theta)`` and ``grad_F(theta, y,
    fp) -> d nll / d fp``, the LaGaBoost gradient
    (``regression_objective.hpp:173-186``), both by autograd (on the calling
    thread) through the iterative Laplace NLL at the fit's settings
    (:func:`ng_iter_kwargs`), with ``y`` and the fixed effects ``fp`` as
    operands. Its CG stop tests read the host (``cg.pcg.host_reads``).
    Cached on the VecchiaGP, so that the functions' identities are stable.
    """
    from gpboost_tpu_torch import likelihoods as lk
    from gpboost_tpu_torch.utils.autograd import grad as ag_grad
    vec = model._approx
    cfg = model.optim_cfg
    kw = ng_iter_kwargs(cfg, vec.n)
    key = (n_cov, n_aux,
           None if aux_fixed is None
           else tuple(np.asarray(aux_fixed, np.float64).tolist()),
           tuple(sorted((k, str(v)) for k, v in kw.items())),
           str(model.dtype))
    cache = getattr(vec, "_ng_vg_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1], cache[2]
    aux_t = (None if aux_fixed is None else torch.as_tensor(
        np.asarray(aux_fixed, np.float64), dtype=model.dtype,
        device=vec.device))

    def _nll(theta, y_op, fp_op):
        cov = torch.exp(theta[:n_cov])
        aux = (lk.aux_from_optim_scale(fam, theta[n_cov:n_cov + n_aux])
               if n_aux else aux_t)
        return vec.nll_laplace_iterative(cov, y_op, aux, fp_op, **kw)

    def vg(theta, y_op, fp_op):
        th = theta.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = _nll(th, y_op, fp_op)
            (g,) = ag_grad(v, th)
        return v.detach(), g

    def grad_F(theta, y_op, fp_op):
        fe = fp_op.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = _nll(theta.detach(), y_op, fe)
            (g,) = ag_grad(v, fe)
        return g

    vec._ng_vg_cache = (key, vg, grad_F)
    return vg, grad_F


def ng_device_fit_eligible(model, cfg, is_het: bool, has_coef: bool,
                           use_iterative: bool) -> bool:
    """Whether the non-Gaussian Vecchia-Laplace refit can run as
    :func:`ng_device_vg` under :func:`optimizers.lbfgs_device_loop` (the
    JAX package's ``ng_device_fit_eligible``, without its backend switch):
    a Vecchia GP (not grouped effects, an exact or a low-rank GP), the
    matrix-free iterative objective with nothing host-interactive: no
    coefficient alternation, no heteroscedastic stacking, no random
    coefficients, no ARD neighbour redetermination, L-BFGS, every
    parameter free, no std errors."""
    vec = model._approx
    return (isinstance(vec, VecchiaGP) and not is_het and not has_coef
            and use_iterative and getattr(vec, "z", None) is None
            and vec.cov_fn.is_isotropic
            and hasattr(vec, "nll_laplace_iterative")
            and cfg.optimizer_cov in _LBFGS_NAMES
            and cfg.estimate_cov_par_index is None and not cfg.std_dev)


def uses_iterative(model) -> bool:
    """The iterative Laplace NLL: asked for, or too many points for the
    dense one without random coefficients (the JAX package's rule); never
    for the two-set heteroscedastic model (dense only)."""
    from gpboost_tpu_torch.models.vecchia_model import DENSE_LAPLACE_MAX_N
    if model.likelihood == "gaussian_heteroscedastic":
        return False
    return (model.matrix_inversion_method == "iterative"
            or (model.num_data > DENSE_LAPLACE_MAX_N
                and getattr(model._approx, "z", None) is None))


def fit_laplace(model, y: torch.Tensor, X: Optional[torch.Tensor],
                fixed_effects: Optional[torch.Tensor] = None):
    """Estimate the covariance parameters, the auxiliary parameters of the
    likelihood (``estimate_aux_pars``) and, with ``X``, the coefficients of
    a non-Gaussian Vecchia model by the Laplace-approximate NLL — dense, or
    iterative (:func:`uses_iterative`, at the fit's settings
    :func:`ng_iter_kwargs`) — through ``models/laplace_fit.py::fit``."""
    vec = model._approx
    _check_cfg(model.optim_cfg)
    # FITC's Woodbury NLL scales without the iterative route, full-scale
    # tapering and clustered low-rank models have none (as in the JAX
    # package)
    iterative = uses_iterative(model) and hasattr(vec,
                                                  "nll_laplace_iterative")
    kw = ng_iter_kwargs(model.optim_cfg, vec.n)
    if not isinstance(vec, VecchiaGP):
        # neighbours by residual correlation at the inits (JAX
        # vecchia_fit.py:292)
        cfg = model.optim_cfg
        vec.ensure_neighbors(
            cfg.init_cov_pars if cfg.init_cov_pars is not None
            else model._default_init_cov_pars(
                y.detach().cpu().numpy().astype(np.float64)))

    def nll(cov, aux, fp):
        if iterative:
            return vec.nll_laplace_iterative(cov, y, aux, fp, **kw)
        return vec.nll_laplace(cov, y, aux, fp)

    init_cov = None
    if model._latent_gaussian:
        # the latent parametrisation: the Gaussian inits' nugget moves to
        # the aux slot (JAX vecchia_fit.py:97-104)
        cfg = model.optim_cfg
        init_cov = np.asarray(
            cfg.init_cov_pars if cfg.init_cov_pars is not None
            else model._default_init_cov_pars(
                y.detach().cpu().numpy().astype(np.float64)), np.float64)
        if len(init_cov) == model.num_cov_pars:
            model.aux_pars_ = np.atleast_1d(init_cov[0])
            init_cov = init_cov[1:]
    return laplace_fit.fit(model, y, X, fixed_effects, nll,
                           init_cov=init_cov)
