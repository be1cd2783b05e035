"""Fitting of Vecchia-approximated models (Gaussian likelihood).

The dispatch of the reference package's Gaussian Vecchia fit
(``gpboost_tpu/models/vecchia_fit.py``), with its accelerator route read as
"a CUDA model that the fused kernels serve (``_kernel_shape``), isotropic":

- L-BFGS: :func:`optimizers.lbfgs_device` on that route, else scipy's
  L-BFGS-B (:func:`optimizers.lbfgs`; :func:`optimizers.lbfgs_host` with
  carried curvature memory once the boosting objective asks for it);
- Nelder-Mead: :func:`optimizers.nelder_mead`;
- gradient descent, the default (and ``fisher_scoring`` / ``newton`` /
  ``adam``, which fall through to it as in the reference package):
  :func:`optimizers.gd_device` on that route for ``gradient_descent`` when
  neither ``trace`` nor the parameter criterion is set, else the host loop
  with the coefficient update after every step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.models import optimizers

_LBFGS_NAMES = ("lbfgs", "lbfgs_linesearch_nocedal_wright")
_KNOWN = _LBFGS_NAMES + ("gradient_descent", "nelder_mead",
                         "fisher_scoring", "newton", "adam")
_COEF_ROUNDS = 3


def device_loop_eligible(vec) -> bool:
    """Whether the whole-fit loops with their state on the device serve the
    model: the fused NLL kernel does (CUDA, inside the kernel gate) and the
    covariance is isotropic (no neighbour redetermination mid-fit)."""
    return (vec.device.type == "cuda" and vec._kernel_shape is not None
            and vec.cov_fn.is_isotropic)


def fit(model, y: torch.Tensor, X: Optional[torch.Tensor],
        fixed_effects: Optional[torch.Tensor] = None):
    """Estimate the covariance parameters (and, with ``X``, the regression
    coefficients) of a Gaussian Vecchia model.

    Every call starts from ``cfg.init_cov_pars`` (the boosting objective
    warm-starts its per-iteration refits that way) on the neighbour
    structure built at construction. With ``X`` the device loops and
    L-BFGS alternate GLS coefficients and a covariance fit, three rounds;
    the host gradient descent updates the coefficients after every step."""
    cfg = model.optim_cfg
    vec = model._approx
    if cfg.optimizer_cov not in _KNOWN:
        raise ValueError(f"unknown optimizer_cov '{cfg.optimizer_cov}'")
    if cfg.estimate_cov_par_index is not None and np.any(
            np.asarray(cfg.estimate_cov_par_index) == 0):
        raise NotImplementedError(
            "estimate_cov_par_index with a parameter held fixed is not "
            "ported to gpboost_tpu_torch yet (the masked fit of the exact "
            "models: ROADMAP.md Queue A, item 16)")
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
        if not vec.cov_fn.is_isotropic:
            # correlation-based neighbour redetermination at power-of-2
            # evaluations (re_model_template.h:4630-4656)
            c = eval_count["n"]
            if ((c + 1) & c) == 0:
                vec.ensure_neighbors(np.exp(np.asarray(theta)))
        eval_count["n"] += 1
        v, g = vec._vg_gaussian(
            torch.as_tensor(theta, dtype=model.dtype, device=vec.device),
            residual(), None)
        return float(v), g.detach().cpu().numpy().astype(np.float64)

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
    device_route = ((opt in _LBFGS_NAMES and on_device)
                    or (opt == "gradient_descent" and gd_on_device))
    if device_route:
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
