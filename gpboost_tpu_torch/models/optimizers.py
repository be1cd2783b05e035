"""Covariance-parameter optimizers for the random-effects engine.

The equivalent of ``REModelTemplate::OptimLinRegrCoefCovPar``
(``re_model_template.h:846``) and the external optimizer bridge
(``optim_utils.h:562``) for the part that is ported: L-BFGS on the log
parameter scale with the reference's relative-change-in-NLL stop rule.

``gradient_descent`` (Nesterov + Armijo), ``nelder_mead``, ``fisher_scoring``
and ``adam`` are queued in ROADMAP.md and not in this module yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import resolve_device


@dataclass
class OptimConfig:
    """Optimization settings (subset of ``GPB_SetOptimConfig`` /
    ``gpboost.GPModel.set_optim_params``, ``basic.py:5347-5544``)."""
    optimizer_cov: str = "gradient_descent"
    maxit: int = 1000
    delta_rel_conv: float = 1e-6
    init_cov_pars: Optional[np.ndarray] = None
    init_coef: Optional[np.ndarray] = None
    # Set by the boosting objective from its second refit on, as in the
    # reference. It has no effect on ``lbfgs_device``, the only ported route:
    # like the reference's accelerator route it warm-starts from
    # ``init_cov_pars`` and carries no curvature memory between fits (the
    # host L-BFGS with persistent memory is ROADMAP.md Queue A, item 9b).
    lbfgs_reuse_mem: bool = False


@dataclass
class OptimResult:
    params: np.ndarray          # final parameters on the original scale
    nll: float
    num_it: int
    converged: bool
    history: list = field(default_factory=list)
    aux: Optional[np.ndarray] = None  # output of lbfgs_device's final_fn
    #   (e.g. Psi^-1 r at the final parameters)
    num_evals: int = 0          # objective evaluations = host reads


_LBFGS_MEM = 8
_C1 = 1e-4
_MAX_HALVINGS = 30


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
    packed into one transfer) — ``OptimResult.num_evals`` counts them.

    Same algorithm as the reference package's compiled loop, so the iterates
    agree in float64: two-loop recursion with a memory of 8, Armijo
    backtracking (c1 = 1e-4, at most 30 halvings from step 1), reset to
    steepest descent when the direction is not a descent direction, memory
    update only when y's > 1e-10, and the stop rule of the reference's
    relative change in the NLL. ``num_it`` counts accepted memory updates.
    ``final_fn(theta, *op_args)`` is evaluated once at the final parameters
    and returned as ``aux``.
    """
    dev = resolve_device(device)
    dt = dtype or torch.float64
    MEM = _LBFGS_MEM
    maxit = int(cfg.maxit)
    ftol = float(cfg.delta_rel_conv)

    t = torch.as_tensor(np.asarray(theta0, np.float64), dtype=dt, device=dev)
    p = t.shape[0]

    def evaluate(theta):
        v, g = vg_fn(theta, *op_args)
        return (torch.as_tensor(v, dtype=dt, device=dev),
                torch.as_tensor(g, dtype=dt, device=dev))

    v_t, g = evaluate(t)
    v = float(v_t)
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
        for j in range(_MAX_HALVINGS):
            if j > 0:
                a *= 0.5
            t_new = t + a * d
            v_new_t, g_new = evaluate(t_new)
            s = t_new - t
            yv = g_new - g
            ys_t = torch.dot(yv, s)
            bad_t = (~torch.isfinite(v_new_t)) | (v_new_t > v_t + _C1 * a * gd)
            v_new, ys, bad = torch.stack(
                [v_new_t, ys_t, bad_t.to(dt)]).tolist()   # the one host read
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
    return OptimResult(
        params=np.exp(t.detach().cpu().numpy().astype(np.float64)),
        nll=v, num_it=k, converged=bool(k < maxit), history=[v],
        aux=None if extra is None else extra.detach().cpu().numpy(),
        num_evals=num_evals)
