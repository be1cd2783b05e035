"""Fit driver for non-Gaussian (Laplace-approximated) models (PyTorch port).

The JAX package's ``gpboost_tpu/models/laplace_fit.py``, the non-Gaussian
branches of ``REModelTemplate::OptimLinRegrCoefCovPar``
(``re_model_template.h:846``): the log covariance parameters, the
auxiliary parameters of the likelihood on their optimisation scale
(``estimate_aux_pars``) and the regression coefficients are optimised
jointly over the Laplace-approximate NLL, differentiated by autograd. The
model supplies the NLL (its Vecchia or grouped Laplace approximation);
this module owns the parameter vector and the optimizer dispatch:
L-BFGS (scipy's L-BFGS-B over the value-and-gradient on the model's
device, the default for non-Gaussian likelihoods), Nelder-Mead, Adam (the
grouped models) and gradient descent. A grouped model with
``matrix_inversion_method="iterative"`` fits its matrix-free NLL
(:func:`grouped_iterative_nll`).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models import grouped, optimizers

LBFGS_NAMES = ("lbfgs", "lbfgs_linesearch_nocedal_wright")
# the reference's preconditioner names for grouped random effects
# (basic.py:5416: ssor the default, incomplete_cholesky): both are served by
# the Jacobi diagonal of Z'WZ + Sigma_b^-1
GROUPED_PRECONDITIONERS = ("", "default", "ssor", "jacobi",
                           "incomplete_cholesky")


def grouped_iter_kwargs(cfg) -> dict:
    """Settings of a grouped model's iterative fit (the JAX package's
    ``laplace_fit.py:64-90``): at least 50 probes, 50 Lanczos steps, CG to
    min(``cg_delta_conv``, 1e-6). A preconditioner name the grouped route
    does not know raises."""
    pn = str(cfg.cg_preconditioner_type or "").lower()
    if pn not in GROUPED_PRECONDITIONERS:
        raise ValueError(
            f"unsupported cg_preconditioner_type {pn!r} for grouped random "
            "effects; options: ssor (default) or incomplete_cholesky (both "
            "served by the Jacobi diagonal)")
    return dict(num_rand_vec_trace=max(int(cfg.num_rand_vec_trace), 50),
                lanczos_steps=50, cg_tol=min(float(cfg.cg_delta_conv), 1e-6),
                cg_max_iter=int(cfg.cg_max_num_it),
                seed=int(cfg.seed_rand_vec_trace))


def grouped_iterative_nll(model) -> Callable:
    """``nll(cov, aux, fixed_part)`` of a grouped model's iterative
    Laplace fit: Newton-CG mode and stochastic log-determinant in b-space
    (``grouped.nll_laplace_iterative``, the reference's
    ``CGRandomEffectsVec`` route, CG_utils.h:979)."""
    kw = grouped_iter_kwargs(model.optim_cfg)
    return lambda cov, aux, fp: grouped.nll_laplace_iterative(
        model._Z, model.likelihood, cov, aux, model.y, fp, **kw)


def fit(model, y: torch.Tensor, X: Optional[torch.Tensor],
        fixed_effects: Optional[torch.Tensor], nll: Callable,
        with_adam: bool = False, init_cov=None):
    """Estimate the covariance parameters, the aux parameters and, with
    ``X``, the coefficients of a non-Gaussian model; ``nll(cov, aux,
    fixed_part)`` is the model's Laplace NLL (a tensor, differentiable in
    all three). Every call starts from ``cfg.init_cov_pars`` (or the
    data-driven inits), the model's current aux parameters (or the
    family's defaults) and ``cfg.init_coef`` (or zeros). Mutates ``model``
    like the Gaussian fits. ``adam`` runs Adam ``with_adam`` (the grouped
    models' route, as the JAX package's ``laplace_fit``), else gradient
    descent (its Vecchia route). ``init_cov`` overrides the covariance
    inits (the latent Vecchia parametrisation moves the nugget of the
    Gaussian inits to the aux slot). ``gaussian_heteroscedastic`` (two
    sets, ``model.num_sets_re``) has a coefficient vector per set and a
    stacked [2n] fixed part; its intercepts start at mean(y) and
    log(var(y) - the set-0 variance) (``FindInitialIntercept``,
    likelihoods.h:818-867, as the JAX package)."""
    cfg = model.optim_cfg
    if cfg.estimate_cov_par_index is not None and np.any(
            np.asarray(cfg.estimate_cov_par_index) == 0):
        raise NotImplementedError(
            "estimate_cov_par_index with a parameter held fixed is not "
            "ported for non-Gaussian likelihoods (the JAX package's Laplace "
            "fit does not read it; ROADMAP.md Queue A, item 11)")
    fam = lk.get_family(model.likelihood)
    y_np = y.detach().cpu().numpy().astype(np.float64)
    has_coef = X is not None
    if init_cov is None:
        init_cov = (cfg.init_cov_pars if cfg.init_cov_pars is not None
                    else model._default_init_cov_pars(y_np))
    n_cov = len(init_cov)
    is_het = model.likelihood == "gaussian_heteroscedastic"
    if model.aux_pars_ is not None:
        init_aux = np.atleast_1d(np.asarray(model.aux_pars_, np.float64))
    else:
        init_aux = fam.default_aux_pars(model.likelihood_additional_param)
    n_aux = (len(init_aux) if (init_aux is not None and cfg.estimate_aux_pars)
             else 0)
    aux_fixed = (None if init_aux is None else torch.as_tensor(
        init_aux, dtype=model.dtype, device=model.device))
    p = X.shape[1] if has_coef else 0
    n_coef = p * (2 if is_het else 1)
    init_beta = (np.asarray(cfg.init_coef, np.float64)
                 if has_coef and cfg.init_coef is not None
                 else np.zeros(n_coef))
    if is_het and has_coef and cfg.init_coef is None:
        init_beta[0] = float(np.mean(y_np))
        init_beta[p] = np.log(max(float(np.var(y_np, ddof=1))
                                  - float(init_cov[0]), 1e-6))
    theta0 = np.concatenate([
        np.log(np.maximum(np.asarray(init_cov, np.float64), 1e-300)),
        lk.aux_to_optim_scale(fam, init_aux[:n_aux]) if n_aux
        else np.zeros(0), init_beta])

    def unpack(theta: torch.Tensor):
        cov = torch.exp(theta[:n_cov])
        aux = (lk.aux_from_optim_scale(fam, theta[n_cov:n_cov + n_aux])
               if n_aux else aux_fixed)
        beta = theta[n_cov + n_aux:] if has_coef else None
        return cov, aux, beta

    def nll_of(theta: torch.Tensor):
        cov, aux, beta = unpack(theta)
        fp = fixed_effects
        if is_het:
            n = y.shape[0]
            fp_s = (torch.cat([X @ beta[:p], X @ beta[p:]]) if beta is not None
                    else torch.zeros(2 * n, dtype=y.dtype, device=y.device))
            if fp is not None:
                fp_s = (fp_s + fp if fp.shape[0] == 2 * n
                        else torch.cat([fp_s[:n] + fp, fp_s[n:]]))
            return nll(cov, aux, fp_s)
        if beta is not None:
            xb = X @ beta
            fp = xb if fp is None else fp + xb
        return nll(cov, aux, fp)

    eval_count = {"n": 0}

    def vg(theta):
        """Host objective: numpy optimisation-scale parameters -> (NLL,
        gradient) on the model's device."""
        eval_count["n"] += 1
        th = torch.as_tensor(theta, dtype=model.dtype,
                             device=model.device).requires_grad_(True)
        with torch.enable_grad():
            v = nll_of(th)
            (g,) = ag.grad(v, th)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    opt = cfg.optimizer_cov
    if opt in LBFGS_NAMES:
        result = optimizers.lbfgs(vg, theta0, cfg)
    elif opt == "nelder_mead":
        result = optimizers.nelder_mead(lambda t: vg(t)[0], theta0, cfg)
    elif opt == "adam" and with_adam:
        result = optimizers.adam(vg, theta0, cfg)
    else:
        result = optimizers.gradient_descent(
            lambda t: vg(t)[0], lambda t: vg(t)[1], theta0, cfg)
    result.num_evals = eval_count["n"]
    cov, aux, beta = unpack(torch.as_tensor(np.log(result.params),
                                            dtype=torch.float64))
    model.cov_pars_ = cov.numpy()
    model.aux_pars_ = None if aux is None else \
        aux.detach().cpu().numpy().astype(np.float64)
    model.coefs_ = None if beta is None else beta.numpy()
    model.num_it_ = result.num_it
    model.current_nll_ = float(result.nll)
    model._fit_result = result
    return model
