"""Covariance-parameter optimizers for the random-effects engine.

The equivalent of ``REModelTemplate::OptimLinRegrCoefCovPar``
(``re_model_template.h:846``, internal loop :1290-1330) and the external
optimizer bridge (``optim_utils.h:562``), on the log parameter scale:

- :func:`gradient_descent`: Nesterov-accelerated gradient descent (version 0,
  momentum offset 2), learning-rate halving under the Armijo condition
  (c = 1e-4, at most 30 halvings), permanent capping so that one step moves a
  parameter by at most a factor 100 (``AvoidTooLargeLearningRatesCovAuxPars``,
  :7539), both convergence criteria (:1708-1730) and the GPBoost
  learning-rate reuse mode (:7475, :7666); :func:`gd_device` is the same
  loop with its state on the device;
- :func:`lbfgs` (scipy's L-BFGS-B, the reference's LBFGSpp role) and
  :func:`lbfgs_host` (hand-rolled, with curvature memory carried from call
  to call); :func:`lbfgs_device` with its state on the device;
- :func:`nelder_mead` (scipy; the reference's OptimLib);
- :func:`adam` (the reference's OptimLib Adam, as optax's defaults in the
  JAX package);
- :func:`fisher_scoring` (and Newton's method, which is Fisher scoring
  with the Hessian of the NLL in the information's place).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.log import log_info

MAX_GRADIENT_UPDATE_LOG_SCALE = math.log(100.0)
LR_SHRINKAGE_FACTOR = 0.5
MAX_LR_SHRINKAGE_STEPS = 30
C_ARMIJO = 1e-4
_REL_LL = "relative_change_in_log_likelihood"


@dataclass
class OptimConfig:
    """Optimization settings (subset of ``GPB_SetOptimConfig`` /
    ``gpboost.GPModel.set_optim_params``, ``basic.py:5347-5544``)."""
    optimizer_cov: str = "gradient_descent"
    # coefficient update of the Gaussian fits: GLS ("wls"; the JAX
    # package's grouped route treats "gradient_descent" the same way)
    optimizer_coef: str = "wls"
    maxit: int = 1000
    lr_cov: float = 0.1
    use_nesterov_acc: bool = True
    acc_rate_cov: float = 0.5
    momentum_offset: int = 2
    delta_rel_conv: float = 1e-6
    convergence_criterion: str = _REL_LL
    armijo_condition: bool = True
    estimate_aux_pars: bool = True
    trace: bool = False
    # iterative-method settings (matrix_inversion_method="iterative")
    cg_max_num_it: int = 1000
    cg_max_num_it_tridiag: int = 1000
    cg_delta_conv: float = 1e-2
    num_rand_vec_trace: int = 50
    reuse_rand_vec_trace: bool = True
    seed_rand_vec_trace: int = 1
    cg_preconditioner_type: str = ""
    piv_chol_rank: int = 50
    init_cov_pars: Optional[np.ndarray] = None
    init_coef: Optional[np.ndarray] = None
    std_dev: bool = False
    estimate_cov_par_index: Optional[np.ndarray] = None
    # Set by the boosting objective from its second refit on, as in the
    # reference (re_model_template.h:880): L-BFGS on the host route runs
    # lbfgs_host with the (s, y) memory of the previous refit
    # (``_lbfgs_mem``); lbfgs_device, like the reference's accelerator
    # route, warm-starts from ``init_cov_pars`` and carries no memory.
    lbfgs_reuse_mem: bool = False
    # GPBoost learning-rate reuse (set by the boosting objective from its
    # second refit on): gradient descent starts at this learning rate, the
    # one the first refit reached after its first iteration
    _reuse_lr_start: Optional[float] = field(default=None, repr=False)
    _lbfgs_mem: Optional[list] = field(default=None, repr=False)


@dataclass
class OptimResult:
    params: np.ndarray          # final parameters on the original scale
    nll: float
    num_it: int
    converged: bool
    history: list = field(default_factory=list)
    final_lr: Optional[float] = None        # GD learning rate at exit
    lr_after_first: Optional[float] = None  # GD learning rate after the
    #   first iteration (what the boosting objective reuses)
    aux: Optional[np.ndarray] = None  # output of a device loop's final_fn
    #   (e.g. Psi^-1 r at the final parameters)
    num_evals: int = 0          # objective evaluations (= host reads of
    #   the device loops)


def nesterov_mu(it: int, acc_rate: float, offset: int) -> float:
    return 0.0 if it < offset else acc_rate


def _reuse_settings(cfg: OptimConfig):
    """(start lr, Armijo on, halvings) of gradient descent: the GPBoost
    reuse mode (``InitializeOptimSettings``, re_model_template.h:7475)
    starts at the carried learning rate, drops the Armijo constant to 0 and
    halves the shrinkage budget."""
    reuse = cfg._reuse_lr_start
    if reuse is None:
        return cfg.lr_cov, cfg.armijo_condition, MAX_LR_SHRINKAGE_STEPS
    return reuse, False, MAX_LR_SHRINKAGE_STEPS // 2


def _small_change(cfg, nll_new, nll, cand, theta_ag1):
    """The reference's convergence test of one accepted step: relative
    change in the NLL, or in the parameters on the original scale."""
    if cfg.convergence_criterion == _REL_LL:
        return abs(nll_new - nll) / max(abs(nll), 1e-300) < cfg.delta_rel_conv
    rel = np.linalg.norm(np.exp(cand) - np.exp(theta_ag1))
    return rel < cfg.delta_rel_conv * max(np.linalg.norm(np.exp(cand)),
                                          1e-300)


def _trace(it, nll, theta):
    log_info(f"GPModel trace: iter {it + 1}, nll = {nll:.6f}, "
             f"pars = {np.round(np.exp(theta), 6)}")


def gradient_descent(value_fn: Callable, grad_fn: Callable,
                     theta0: np.ndarray, cfg: OptimConfig,
                     callback: Optional[Callable] = None) -> OptimResult:
    """Nesterov-accelerated GD on log-scale parameters, on the host.

    ``value_fn(theta) -> nll`` and ``grad_fn(theta) -> dnll/dtheta`` take
    log-scale numpy parameters. Learning-rate capping is permanent; a
    rejected step halves the learning rate and the acceleration, and after
    two rejections the momentum is dropped (near an optimum it can oppose
    the gradient). A halved step counts as converged only on the second
    small change in a row. ``callback(it, theta, nll)`` runs after every
    accepted step.
    """
    theta = np.asarray(theta0, dtype=np.float64)
    theta_after_grad = theta.copy()
    theta_after_grad_lag1 = theta.copy()
    lr_init = cfg.lr_cov
    lr, use_armijo, max_shrink = _reuse_settings(cfg)
    reuse = cfg._reuse_lr_start is not None
    doubled_first = False
    lr_after_first = None
    acc_rate = cfg.acc_rate_cov
    nll = float(value_fn(theta))
    history = [nll]
    converged = False
    it = 0
    small_change_streak = 0
    for it in range(cfg.maxit):
        g = np.asarray(grad_fn(theta), dtype=np.float64)
        if not np.all(np.isfinite(g)):
            break
        gmax = np.max(np.abs(g))
        if gmax > 0 and lr > MAX_GRADIENT_UPDATE_LOG_SCALE / gmax:
            lr = MAX_GRADIENT_UPDATE_LOG_SCALE / gmax
        dir_deriv = -float(np.dot(g, g))  # directional derivative along -g
        if reuse:
            # recover from a carried learning rate that is too small
            # (PotentiallyIncreaseLearningRatesForGPBoostAlgorithm, :7666)
            if it == 0:
                if ((-dir_deriv * lr)
                        <= cfg.delta_rel_conv * max(abs(nll), 1.0)
                        and (-dir_deriv * lr_init) > max(abs(nll), 1.0)):
                    if 2.0 * lr <= lr_init:
                        lr *= 2.0
                        doubled_first = True
            elif it == 1 and not doubled_first:
                if 2.0 * lr <= lr_init:
                    lr *= 2.0
        lr_try = lr
        acc_try = acc_rate
        accepted = False
        halved = False
        nll_new = nll
        for k in range(max_shrink):
            cand_after_grad = theta - lr_try * g
            mu = (nesterov_mu(it, acc_try, cfg.momentum_offset)
                  if cfg.use_nesterov_acc else 0.0)
            if k >= 2:
                mu = 0.0
            cand = (1.0 + mu) * cand_after_grad - mu * theta_after_grad_lag1
            nll_new = float(value_fn(cand))
            if use_armijo:
                ok = np.isfinite(nll_new) and (
                    nll_new <= nll + C_ARMIJO * lr_try * dir_deriv)
            else:
                ok = np.isfinite(nll_new) and nll_new <= nll
            if ok:
                accepted = True
                break
            halved = True
            lr_try *= LR_SHRINKAGE_FACTOR
            acc_try *= 0.5
        if not accepted:
            break       # could not decrease: keep the parameters and stop
        lr = lr_try
        if it == 0:
            lr_after_first = lr
        theta_after_grad_lag1 = theta_after_grad
        theta_after_grad = cand_after_grad
        theta = cand
        history.append(nll_new)
        if cfg.trace:
            _trace(it, nll_new, theta)
        if callback is not None:
            callback(it, theta, nll_new)
        small = _small_change(cfg, nll_new, nll, cand, theta_after_grad_lag1)
        small_change_streak = small_change_streak + 1 if small else 0
        nll = nll_new
        if small and (not halved or small_change_streak >= 2):
            converged = True
            break
    return OptimResult(params=np.exp(theta), nll=nll, num_it=it + 1,
                       converged=converged, history=history, final_lr=lr,
                       lr_after_first=lr_after_first)


def gd_device(vg_fn: Callable, theta0: np.ndarray, cfg: OptimConfig,
              dtype=None, *op_args, final_fn: Optional[Callable] = None,
              device="cuda") -> OptimResult:
    """:func:`gradient_descent` with its state on the device.

    ``vg_fn(theta, *op_args) -> (value, grad)`` takes and returns tensors
    on ``device``. Parameters, gradient and learning rate stay device
    tensors; the loop is Python. Every objective evaluation costs exactly
    ONE host read, which carries the value, the acceptance test, whether
    the gradient is finite, the learning rate tried and the candidate's
    parameters before and after the momentum step (so that the trace, the
    parameter criterion and ``lr_after_first`` need no other read);
    ``OptimResult.num_evals`` counts them. An accepted candidate's gradient
    is the next iteration's, so an iteration evaluates the objective once
    per step it tries.

    Same algorithm, modes and result fields as the host loop — the GPBoost
    reuse mode (``cfg._reuse_lr_start``) and ``lr_after_first`` included —
    so in float64 the iterates agree with it (``final_lr`` is the rate of
    the last accepted step). ``gd_device.host_reads`` counts the reads.
    ``final_fn(theta, *op_args)`` is evaluated once at the final parameters
    and returned as ``aux``.
    """
    dev = resolve_device(device)
    dt = dtype or torch.float64
    p = len(theta0)
    lr_init = float(cfg.lr_cov)
    lr0, use_armijo, max_shrink = _reuse_settings(cfg)
    reuse = cfg._reuse_lr_start is not None

    def evaluate(theta, theta_ag, lr_try, bound):
        """(value, grad, host row) at ``theta``. The row is the one read:
        [value, value <= bound, grad finite, lr_try, theta, theta_ag]."""
        v, g = vg_fn(theta, *op_args)
        v = torch.as_tensor(v, dtype=dt, device=dev)
        g = torch.as_tensor(g, dtype=dt, device=dev)
        ok = torch.isfinite(v) & (v <= bound)
        head = torch.stack([v, ok.to(dt), torch.isfinite(g).all().to(dt),
                            torch.as_tensor(lr_try, dtype=dt, device=dev)])
        row = torch.cat([head, theta, theta_ag]).tolist()  # the one read
        gd_device.host_reads += 1
        return v, g, (row[0], row[1] > 0, row[2] > 0, row[3],
                      np.asarray(row[4:4 + p]), np.asarray(row[4 + p:]))

    t = torch.as_tensor(np.asarray(theta0, np.float64), dtype=dt, device=dev)
    _, g, (nll, _, g_ok, _, theta_np, _) = evaluate(t, t, lr0, math.inf)
    num_evals = 1
    t_ag1 = t_ag = t                  # theta after the gradient step, lag 1
    t_ag_np = theta_np
    lr = torch.as_tensor(lr0, dtype=dt, device=dev)
    lr_host = float(lr0)
    doubled_first = None
    lr_after_first = None
    history = [nll]
    converged = False
    it = 0
    streak = 0
    for it in range(cfg.maxit):
        if not g_ok:
            break
        cap = MAX_GRADIENT_UPDATE_LOG_SCALE / g.abs().max()
        lr = torch.where(lr > cap, cap, lr)
        dir_deriv = -torch.dot(g, g)
        if reuse:
            if it == 0:
                doubled_first = (
                    ((-dir_deriv * lr)
                     <= cfg.delta_rel_conv * max(abs(nll), 1.0))
                    & ((-dir_deriv * lr_init) > max(abs(nll), 1.0))
                    & (2.0 * lr <= lr_init))
                lr = torch.where(doubled_first, lr * 2.0, lr)
            elif it == 1:
                lr = torch.where(~doubled_first & (2.0 * lr <= lr_init),
                                 lr * 2.0, lr)
        lr_try = lr
        acc_try = cfg.acc_rate_cov
        accepted = False
        halved = False
        for k in range(max_shrink):
            cag = t - lr_try * g
            mu = (nesterov_mu(it, acc_try, cfg.momentum_offset)
                  if cfg.use_nesterov_acc else 0.0)
            if k >= 2:
                mu = 0.0
            cand = (1.0 + mu) * cag - mu * t_ag1
            bound = (nll + C_ARMIJO * lr_try * dir_deriv if use_armijo
                     else nll)
            _, g_new, row = evaluate(cand, cag, lr_try, bound)
            num_evals += 1
            if row[1]:
                accepted = True
                break
            halved = True
            lr_try = lr_try * LR_SHRINKAGE_FACTOR
            acc_try *= 0.5
        if not accepted:
            break
        nll_new, _, g_ok, lr_host, cand_np, cag_np = row
        lr = lr_try
        if it == 0:
            lr_after_first = lr_host
        t_ag1, t_ag = t_ag, cag
        t, g = cand, g_new
        theta_np = cand_np
        history.append(nll_new)
        if cfg.trace:
            _trace(it, nll_new, cand_np)
        # the parameter criterion compares with the previous step's
        # theta-after-gradient, as the host loop does
        small = _small_change(cfg, nll_new, nll, cand_np, t_ag_np)
        t_ag_np = cag_np
        streak = streak + 1 if small else 0
        nll = nll_new
        if small and (not halved or streak >= 2):
            converged = True
            break
    extra = None if final_fn is None else final_fn(t, *op_args)
    return OptimResult(
        params=np.exp(theta_np), nll=nll, num_it=it + 1,
        converged=converged, history=history, final_lr=lr_host,
        lr_after_first=lr_after_first,
        aux=None if extra is None else extra.detach().cpu().numpy(),
        num_evals=num_evals)


gd_device.host_reads = 0


def fisher_scoring(value_fn: Callable, grad_fn: Callable,
                   fisher_fn: Callable, theta0: np.ndarray, cfg: OptimConfig,
                   callback: Optional[Callable] = None) -> OptimResult:
    """Fisher scoring on the log scale: step = FI^-1 grad, each entry capped
    at log(100) (``UpdateCovAuxPars``, ``re_model_template.h:7584-7600``),
    halved until the NLL does not rise (at most 30 halvings); stops on the
    relative change of the NLL (the JAX package's rule: the other criterion
    runs to ``maxit`` or until no step is accepted)."""
    theta = np.asarray(theta0, dtype=np.float64)
    nll = float(value_fn(theta))
    history = [nll]
    converged = False
    it = 0
    for it in range(cfg.maxit):
        g = np.asarray(grad_fn(theta), dtype=np.float64)
        fi = np.asarray(fisher_fn(theta), dtype=np.float64)
        try:
            step = np.linalg.solve(fi, g)
        except np.linalg.LinAlgError:
            step = g
        step = np.clip(step, -MAX_GRADIENT_UPDATE_LOG_SCALE,
                       MAX_GRADIENT_UPDATE_LOG_SCALE)
        lr_try = 1.0
        accepted = False
        for _ in range(MAX_LR_SHRINKAGE_STEPS):
            cand = theta - lr_try * step
            nll_new = float(value_fn(cand))
            if np.isfinite(nll_new) and nll_new <= nll:
                accepted = True
                break
            lr_try *= LR_SHRINKAGE_FACTOR
        if not accepted:
            break
        theta = cand
        history.append(nll_new)
        if cfg.trace:
            _trace(it, nll_new, theta)
        if callback is not None:
            callback(it, theta, nll_new)
        if cfg.convergence_criterion == _REL_LL and abs(nll_new - nll) \
                / max(abs(nll), 1e-300) < cfg.delta_rel_conv:
            nll = nll_new
            converged = True
            break
        nll = nll_new
    return OptimResult(params=np.exp(theta), nll=nll, num_it=it + 1,
                       converged=converged, history=history)


def lbfgs_host(value_and_grad_fn: Callable, theta0: np.ndarray,
               cfg: OptimConfig, mem=None):
    """Hand-rolled L-BFGS (two-loop recursion + Armijo backtracking) with
    PERSISTENT curvature memory: ``mem`` is the (s, y, rho) history of a
    previous call, reused to warm-start the inverse-Hessian approximation —
    the reference's ``reuse_m_bfgs_from_previous_call`` for the GPBoost
    algorithm's per-iteration covariance refits (``re_model_template.h:880``,
    LBFGSpp ``BFGSMat`` kept across calls). Returns (OptimResult, mem)."""
    m_corr = 6
    theta = np.asarray(theta0, dtype=np.float64)
    v, g = value_and_grad_fn(theta)
    v = float(v)
    g = np.asarray(g, dtype=np.float64)
    mem = list(mem) if mem else []
    history = [v]
    converged = False
    it = 0
    for it in range(cfg.maxit):
        # two-loop recursion for d = -H g
        q = g.copy()
        alphas = []
        for s_i, y_i, rho_i in reversed(mem):
            a_i = rho_i * np.dot(s_i, q)
            alphas.append(a_i)
            q = q - a_i * y_i
        if mem:
            s_l, y_l, _ = mem[-1]
            gamma = np.dot(s_l, y_l) / max(np.dot(y_l, y_l), 1e-300)
            q = gamma * q
        for (s_i, y_i, rho_i), a_i in zip(mem, reversed(alphas)):
            b_i = rho_i * np.dot(y_i, q)
            q = q + (a_i - b_i) * s_i
        d = -q
        dg = float(np.dot(d, g))
        if dg >= 0:  # not a descent direction: reset to steepest descent
            d = -g
            dg = -float(np.dot(g, g))
            mem = []
        # first-iteration step scaling (LBFGSpp: 1 / ||d||)
        t = (1.0 / max(np.linalg.norm(d), 1e-300)) if not mem and it == 0 \
            else 1.0
        accepted = False
        for _ in range(MAX_LR_SHRINKAGE_STEPS):
            cand = theta + t * d
            v_new, g_new = value_and_grad_fn(cand)
            v_new = float(v_new)
            if np.isfinite(v_new) and v_new <= v + C_ARMIJO * t * dg:
                accepted = True
                break
            t *= LR_SHRINKAGE_FACTOR
        if not accepted:
            break
        g_new = np.asarray(g_new, dtype=np.float64)
        s_vec = cand - theta
        y_vec = g_new - g
        sy = float(np.dot(s_vec, y_vec))
        if sy > 1e-10 * np.linalg.norm(s_vec) * np.linalg.norm(y_vec):
            mem.append((s_vec, y_vec, 1.0 / sy))
            if len(mem) > m_corr:
                mem.pop(0)
        rel = abs(v_new - v) / max(abs(v), 1e-300)
        theta, g = cand, g_new
        history.append(v_new)
        v = v_new
        if rel < cfg.delta_rel_conv:
            converged = True
            break
    return (OptimResult(params=np.exp(theta), nll=v, num_it=it + 1,
                        converged=converged, history=history), mem)


def lbfgs(value_and_grad_fn: Callable, theta0: np.ndarray,
          cfg: OptimConfig) -> OptimResult:
    """L-BFGS on log-scale parameters via scipy's L-BFGS-B (reference:
    LBFGSpp, ``optim_utils.h:642-676``). With ``cfg.lbfgs_reuse_mem`` (the
    GPBoost refits from the second on) :func:`lbfgs_host` runs instead and
    its curvature memory carries from call to call in ``cfg._lbfgs_mem``."""
    if cfg.lbfgs_reuse_mem:
        result, cfg._lbfgs_mem = lbfgs_host(value_and_grad_fn, theta0, cfg,
                                            cfg._lbfgs_mem)
        return result
    from scipy.optimize import minimize

    def f(theta):
        v, g = value_and_grad_fn(theta)
        v = float(v)
        g = np.asarray(g, dtype=np.float64)
        if not np.isfinite(v):
            return 1e300, np.zeros_like(g)
        return v, g

    res = minimize(f, np.asarray(theta0, dtype=np.float64), jac=True,
                   method="L-BFGS-B",
                   options={"maxiter": cfg.maxit, "ftol": cfg.delta_rel_conv,
                            "gtol": 1e-10})
    return OptimResult(params=np.exp(res.x), nll=float(res.fun),
                       num_it=int(res.nit), converged=bool(res.success),
                       history=[float(res.fun)])


def lbfgs_masked(value_and_grad_fn: Callable, theta0: np.ndarray,
                 free: np.ndarray, cfg: OptimConfig, rounds: int = 1,
                 after_round: Optional[Callable] = None):
    """:func:`lbfgs` on the entries ``free`` of the log-parameters, the
    others held at ``theta0`` (``estimate_cov_par_index``; JAX
    ``gp_model.py:1112``). ``value_and_grad_fn`` takes and differentiates
    the full vector; ``rounds`` fits, each followed by
    ``after_round(theta)`` (the GLS coefficient update). Returns the full
    log-parameters and the last fit's iterations."""
    free = np.asarray(free)

    def full(theta_free):
        t = np.array(theta0, dtype=np.float64)
        t[free] = theta_free
        return t

    def vg(theta_free):
        v, g = value_and_grad_fn(full(theta_free))
        return v, np.asarray(g)[free]

    theta_free, num_it = np.asarray(theta0, np.float64)[free], 0
    if len(free):
        for _ in range(rounds):
            result = lbfgs(vg, theta_free, cfg)
            theta_free = np.log(result.params)
            if after_round is not None:
                after_round(full(theta_free))
        num_it = result.num_it
    return full(theta_free), num_it


def nelder_mead(value_fn: Callable, theta0: np.ndarray,
                cfg: OptimConfig) -> OptimResult:
    """Nelder-Mead on log-scale parameters via scipy (reference: OptimLib)."""
    from scipy.optimize import minimize

    def f(theta):
        v = float(value_fn(theta))
        return v if np.isfinite(v) else 1e300

    res = minimize(f, np.asarray(theta0, dtype=np.float64),
                   method="Nelder-Mead",
                   options={"maxiter": max(cfg.maxit, 1000), "xatol": 1e-8,
                            "fatol": cfg.delta_rel_conv})
    return OptimResult(params=np.exp(res.x), nll=float(res.fun),
                       num_it=int(res.nit), converged=bool(res.success),
                       history=[float(res.fun)])


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam(value_and_grad_fn: Callable, theta0: np.ndarray,
         cfg: OptimConfig) -> OptimResult:
    """Adam on log-scale parameters (reference: OptimLib adam), the JAX
    package's loop with optax's update written out: learning rate
    max(lr_cov, 1e-3), b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected moments; stops when the NLL changes by less than
    ``delta_rel_conv`` relative, or after ``maxit`` steps."""
    lr = max(float(cfg.lr_cov), 1e-3)
    theta = np.asarray(theta0, dtype=np.float64)
    mu = np.zeros_like(theta)
    nu = np.zeros_like(theta)
    nll_prev = np.inf
    history = []
    converged = False
    it = 0
    for it in range(cfg.maxit):
        v, g = value_and_grad_fn(theta)
        v = float(v)
        g = np.asarray(g, dtype=np.float64)
        history.append(v)
        mu = ADAM_B1 * mu + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * nu + (1.0 - ADAM_B2) * g * g
        mu_hat = mu / (1.0 - ADAM_B1 ** (it + 1))
        nu_hat = nu / (1.0 - ADAM_B2 ** (it + 1))
        theta = theta - lr * mu_hat / (np.sqrt(nu_hat) + ADAM_EPS)
        if abs(v - nll_prev) / max(abs(nll_prev), 1e-300) \
                < cfg.delta_rel_conv:
            converged = True
            break
        nll_prev = v
    return OptimResult(params=np.exp(theta),
                       nll=float(value_and_grad_fn(theta)[0]),
                       num_it=it + 1, converged=converged, history=history)


_LBFGS_MEM = 8


def _two_loop(g, S, Y, rho, k: int):
    """Standard L-BFGS two-loop recursion over the valid window of the
    circular memory (S, Y, rho) after ``k`` accepted updates."""
    MEM = _LBFGS_MEM
    window = min(k, MEM)
    q = g
    alphas = {}
    for i in range(window):
        idx = (k - 1 - i) % MEM
        a = rho[idx] * torch.dot(S[idx], q)
        q = q - a * Y[idx]
        alphas[idx] = a
    if k > 0:
        last = (k - 1) % MEM
        ys = torch.dot(Y[last], S[last])
        yy = torch.dot(Y[last], Y[last])
        gamma = torch.where((ys > 0) & (yy > 0),
                            ys / torch.clamp(yy, min=1e-30),
                            torch.ones_like(ys))
        q = gamma * q
    for i in range(window):
        idx = (k - window + i) % MEM
        b = rho[idx] * torch.dot(Y[idx], q)
        q = q + (alphas[idx] - b) * S[idx]
    return q


def lbfgs_device(vg_fn: Callable, theta0: np.ndarray, cfg: OptimConfig,
                 dtype=None, *op_args, final_fn: Optional[Callable] = None,
                 device="cuda") -> OptimResult:
    """L-BFGS whose state lives on the device.

    ``vg_fn(theta, *op_args) -> (value, grad)`` takes and returns tensors on
    ``device`` (log-scale parameters); its gradient is consumed as returned,
    never differentiated. Parameters, gradient and the curvature memory stay
    device tensors; the loop itself is Python. Each objective evaluation
    costs exactly ONE host read (value, curvature y's and the Armijo test
    packed into one transfer) — ``OptimResult.num_evals`` counts them, and
    ``lbfgs_device.host_reads`` counts the reads.

    Same algorithm as the reference package's compiled loop, so the iterates
    agree in float64: two-loop recursion with a memory of 8, Armijo
    backtracking (c1 = 1e-4, at most 30 halvings from step 1), reset to
    steepest descent when the direction is not a descent direction, memory
    update only when y's > 1e-10, and the stop rule of the reference's
    relative change in the NLL. ``num_it`` counts accepted memory updates.
    ``final_fn(theta, *op_args)`` is evaluated once at the final parameters
    and returned as ``aux``. The loop is :func:`lbfgs_device_loop`; this
    wrapper brings its results to the host.
    """
    dev = resolve_device(device)
    dt = dtype or torch.float64
    t0 = torch.as_tensor(np.asarray(theta0, np.float64), dtype=dt,
                         device=dev)
    t, v, k, extra, num_evals = lbfgs_device_loop(
        vg_fn, t0, cfg, dt, *op_args, final_fn=final_fn)
    return OptimResult(
        params=np.exp(t.detach().cpu().numpy().astype(np.float64)),
        nll=v, num_it=k, converged=bool(k < int(cfg.maxit)), history=[v],
        aux=None if extra is None else extra.detach().cpu().numpy(),
        num_evals=num_evals)


def lbfgs_device_loop(vg_fn: Callable, theta0: torch.Tensor,
                      cfg: OptimConfig, dtype, *op_args,
                      final_fn: Optional[Callable] = None):
    """The loop of :func:`lbfgs_device` from log-parameters ``theta0`` on
    their device, with its results left there: the counterpart of the JAX
    package's ``lbfgs_loop``, for callers that go on computing on the
    device (the device-resident boosting loop). Returns (theta, value,
    accepted updates, ``final_fn(theta, *op_args)`` or None, evaluations):
    theta and the final output are device tensors, the value is the host
    float its last stop test read. The curvature memory starts empty. The
    host reads are the evaluations' (``lbfgs_device.host_reads``)."""
    dt = dtype
    dev = theta0.device
    MEM = _LBFGS_MEM
    maxit = int(cfg.maxit)
    ftol = float(cfg.delta_rel_conv)

    t = theta0.to(dt)
    p = t.shape[0]

    def evaluate(theta):
        v, g = vg_fn(theta, *op_args)
        return (torch.as_tensor(v, dtype=dt, device=dev),
                torch.as_tensor(g, dtype=dt, device=dev))

    v_t, g = evaluate(t)
    v = float(v_t)                                        # a host read
    lbfgs_device.host_reads += 1
    num_evals = 1
    S = torch.zeros((MEM, p), dtype=dt, device=dev)
    Y = torch.zeros((MEM, p), dtype=dt, device=dev)
    rho = torch.zeros((MEM,), dtype=dt, device=dev)
    k = 0
    prev_v = math.inf
    stalled = False

    def keep_going():
        rel = abs(v - prev_v) / max(abs(v), abs(prev_v), 1.0)
        return ((k == 0 or rel >= ftol) and k < maxit and math.isfinite(v)
                and not stalled)

    while keep_going():
        d = -_two_loop(g, S, Y, rho, k)
        # fall back to steepest descent if d is not a descent direction
        d = torch.where(torch.dot(g, d) < 0, d, -g)
        gd = torch.dot(g, d)
        # Armijo backtracking from step 1
        a = 1.0
        for j in range(MAX_LR_SHRINKAGE_STEPS):
            if j > 0:
                a *= 0.5
            t_new = t + a * d
            v_new_t, g_new = evaluate(t_new)
            s = t_new - t
            yv = g_new - g
            ys_t = torch.dot(yv, s)
            bad_t = ((~torch.isfinite(v_new_t))
                     | (v_new_t > v_t + C_ARMIJO * a * gd))
            v_new, ys, bad = torch.stack(
                [v_new_t, ys_t, bad_t.to(dt)]).tolist()   # the one host read
            lbfgs_device.host_reads += 1
            num_evals += 1
            if not bad:
                break
        ok = not bad
        prev_v = v
        stalled = not ok
        if ok:
            if ys > 1e-10:
                idx = k % MEM
                S[idx] = s
                Y[idx] = yv
                rho[idx] = 1.0 / ys_t
                k += 1
            t, g, v_t, v = t_new, g_new, v_new_t, v_new

    extra = None if final_fn is None else final_fn(t, *op_args)
    return t, v, k, extra, num_evals


lbfgs_device.host_reads = 0
