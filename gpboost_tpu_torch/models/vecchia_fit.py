"""Fitting of Vecchia-approximated models (Gaussian likelihood)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.models import optimizers

_LBFGS_NAMES = ("lbfgs", "lbfgs_linesearch_nocedal_wright")
_QUEUED_OPTIMIZERS = ("gradient_descent", "nelder_mead", "fisher_scoring",
                      "newton", "adam")


def fit(model, y: torch.Tensor, X: Optional[torch.Tensor],
        fixed_effects: Optional[torch.Tensor] = None):
    """Estimate the covariance parameters (and, with ``X``, the regression
    coefficients) of a Gaussian Vecchia model with device-resident L-BFGS.

    Every call starts from ``cfg.init_cov_pars`` (the boosting objective
    warm-starts its per-iteration refits that way) on the neighbour
    structure built at construction; nothing is rebuilt between calls.

    With ``X`` the fit alternates: GLS coefficients at the current
    covariance parameters, then L-BFGS on the residual, three rounds."""
    cfg = model.optim_cfg
    vec = model._approx
    if cfg.optimizer_cov in _QUEUED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer_cov='{cfg.optimizer_cov}' is not ported yet "
            "(ROADMAP.md Queue A, item 9b); fit with "
            "params={'optimizer_cov': 'lbfgs'}")
    if cfg.optimizer_cov not in _LBFGS_NAMES:
        raise ValueError(f"unknown optimizer_cov '{cfg.optimizer_cov}'")
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

    def fixed_part():
        fp = fixed_effects
        if beta is not None:
            xb = X @ beta
            fp = xb if fp is None else fp + xb
        return fp

    eval_count = {"n": 0}
    redetermine = not vec.cov_fn.is_isotropic

    def vg(theta, r):
        if redetermine:
            # correlation-based neighbor redetermination at power-of-2
            # evaluations (re_model_template.h:4630-4656); reads theta back
            c = eval_count["n"]
            if ((c + 1) & c) == 0:
                vec.ensure_neighbors(np.exp(
                    theta.detach().cpu().numpy().astype(np.float64)))
            eval_count["n"] += 1
        return vec._vg_gaussian(theta, r, None)

    def coef_update(theta):
        cp = torch.exp(torch.as_tensor(theta, dtype=model.dtype,
                                       device=vec.device))
        return vec.wls_coef(cp, y, X, fixed_effects)

    # the fused kernels work in float32; so does the optimizer state then
    fit_dtype = (torch.float32 if vec._kernel_shape is not None
                 else model.dtype)
    # no coefficients: the GPBoost pseudo-gradient solve Psi^-1 r at the
    # final parameters rides along as the fit's extra output
    final_fn = (vec._fit_psi_inv
                if not has_coef and vec._kernel_shape is not None else None)

    def run(theta):
        fp = fixed_part()
        r = y if fp is None else y - fp
        return optimizers.lbfgs_device(vg, theta, cfg, fit_dtype, r,
                                       final_fn=final_fn, device=vec.device)

    theta0 = np.log(np.maximum(np.asarray(init_cov, np.float64), 1e-300))
    num_evals = 0
    if has_coef:
        beta = coef_update(theta0)
        theta = theta0
        for _ in range(3):
            result = run(theta)
            num_evals += result.num_evals
            theta = np.log(result.params)
            beta = coef_update(theta)
        result.num_evals = num_evals
    else:
        result = run(theta0)
    model.cov_pars_ = result.params
    model.coefs_ = (None if beta is None
                    else beta.detach().cpu().numpy().astype(np.float64))
    model.num_it_ = result.num_it
    model.current_nll_ = float(result.nll)
    model._fit_result = result
    return model
