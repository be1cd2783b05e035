"""Grouped random effects by the Woodbury identity (PyTorch port).

The JAX package's ``gpboost_tpu/models/grouped.py`` (its Cholesky routes):
the incidence matrix Z [n, q] is never formed — Z' v is a sum over each
level's rows, Z b a gather — and the dense work happens in the
q-dimensional space of the stacked random effects:

  Psi = sigma2 I + Z Sigma_b Z'     (Sigma_b diagonal: each component's
                                     variance on its levels)
  Psi^-1 r = (r - Z M^-1 Z' r) / sigma2,   M = Z'Z + sigma2 Sigma_b^-1
  logdet Psi = n log sigma2 + logdet M - logdet(sigma2 Sigma_b^-1)

Non-Gaussian likelihoods: the Laplace approximation in b-space, Newton on
H = Z'WZ + Sigma_b^-1 [q, q] (``FindModePostRandEffCalcMLLGroupedRE``,
likelihoods.h:1975), through the shared Newton loop and implicit backward
of ``models/laplace.py``.

Determinism on the GPU. A scatter-add (``index_add_``) adds with float
atomics on CUDA, in an order that changes from run to run. So on a CUDA
device (:class:`GroupedZ` with ``deterministic=True``) every sum over rows
goes through a :class:`SegmentPlan` built once: the rows sorted by their
key (the level, or the flat (level, level) pair of Z'Z), each key's run
summed by a gather and a row sum, each sum written to its own position.
Z b and Z' v are autograd Functions whose backwards are each other, so no
backward scatters either. The CPU route adds with ``index_add_`` (the plain
version). The dense [q, q] factorisations are ``torch.linalg``'s; one
autograd Function (:func:`logdet_quad`) gives logdet M and v' M^-1 v with a
backward of one ``cholesky_inverse`` instead of autograd through the
Cholesky.

The iterative route (``matrix_inversion_method="iterative"``; reference
``CGRandomEffectsVec``, ``CG_utils.h:979``) stays in b-space without any
[q, q] matrix: the system M = Z'WZ + diag(shift) is applied through Z'v
and Z b (so on the card through the same fixed-order plans: bit-
reproducible, no scatter), solved by CG under its exact diagonal (the
Jacobi preconditioner that stands in for the reference's SSOR and
incomplete Cholesky), its log-determinant by stochastic Lanczos; the
posterior draws of the simulated predictive variances by the same CG.

Observation ``weights`` (the JAX package's ``grouped.py:45-52, :142,
:179``): Psi = sigma2 diag(1/w) + Z Sigma_b Z', so Z'Z becomes Z'WZ and Z'r
becomes Z'(w r) (:class:`GroupedZ` carries them); a non-Gaussian
likelihood takes them through ``likelihoods.weighted_family``. Not ported
(ROADMAP.md Queue A): row sharding (item 20; the JAX package's
``row_weight`` is its padding mask).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models.covariance import _grouped_cross_cov
from gpboost_tpu_torch.models.laplace import (_aux_arg, _aux_val, mode_vjp,
                                              newton_mode)
from gpboost_tpu_torch.models.spec import ModelData, ModelSpec
from gpboost_tpu_torch.ops import cg as cgops
from gpboost_tpu_torch.utils.timer import timed

LOG_2PI = math.log(2.0 * math.pi)

# what the grouped routes did since the last reset (read by the chip run's
# breakdown): dense O(q^3) operations on [q, q] matrices — factorisations
# (Cholesky, LU solve: ``qq_factor``) and inverses (``qq_inverse``) —,
# objective evaluations of the fits and their host reads, Newton steps of
# the Laplace mode finder and its host reads; on the iterative route the
# CG iterations of the quadratic form (``quad_cg_iters``), of the Newton-CG
# mode (``mode_cg_iters``) and its adjoint (``mode_adjoint_cg_iters``), of
# the log-determinant's gradient (``grad_cg_iters``) and of the posterior
# draws (``sim_cg_iters``), and the Lanczos steps (``lanczos_steps``)
GROUPED_COUNTS: Counter = Counter()
# posterior draws solved at once by the iterative prediction ([n, chunk]
# products)
SIM_CHUNK = 64


def grouped_layout(spec: ModelSpec):
    """(offsets, sizes, q) of the stacked random-effects vector."""
    offsets, sizes, off = [], [], 0
    for comp in spec.components:
        offsets.append(off)
        sizes.append(comp.num_groups)
        off += comp.num_groups
    return tuple(offsets), tuple(sizes), off


class SegmentPlan:
    """Sums of weighted entries grouped by an integer key, in an order fixed
    at construction (no float atomics on any device).

    Entry e contributes ``coef[e] * v[rows[e]]`` to key ``keys[e]``. The
    entries are sorted by key (stable); the keys are grouped by their
    number of entries into classes (w / 2, w], w = min_width, 2 min_width,
    ... (the first [1, min_width]), and each class is a [t, w] block of
    entry slots, padded with zero coefficients — so the padding is at most
    about the entries, however skewed the counts. :meth:`sums` is one
    gather over all slots, a row sum per class and one ``index_copy_``
    into the unique keys' places (the shape of
    ``ops/vecchia.py::incoming_sums``)."""

    def __init__(self, keys: torch.Tensor, rows: torch.Tensor,
                 coef: Optional[torch.Tensor], num_keys: int,
                 min_width: int = 8):
        self.num_keys = int(num_keys)
        uniq, inv, counts = torch.unique(keys, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
        order = torch.argsort(inv, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        max_count = int(counts.max()) if counts.numel() else 0
        slot_rows, slot_coef, targets, self.shapes = [], [], [], []
        lo, width = 0, int(min_width)
        while lo < max_count:
            sel = torch.nonzero((counts > lo) & (counts <= width)).reshape(-1)
            if sel.numel():
                w = min(width, max_count)
                k = torch.arange(w, device=keys.device)
                valid = k[None, :] < counts[sel][:, None]
                e = order[torch.where(valid, starts[sel][:, None] + k, 0)]
                slot_rows.append(torch.where(valid, rows[e], 0).reshape(-1))
                c = (torch.ones_like(e, dtype=torch.float64) if coef is None
                     else coef[e].to(torch.float64))
                slot_coef.append(torch.where(valid, c, 0.0).reshape(-1))
                targets.append(uniq[sel])
                self.shapes.append((int(sel.numel()), w))
            lo, width = width, 2 * width
        cat = (lambda xs, dt: torch.cat(xs) if xs
               else torch.zeros(0, dtype=dt, device=keys.device))
        self.rows = cat(slot_rows, torch.long)
        self.coef = cat(slot_coef, torch.float64)
        self.targets = cat(targets, torch.long)

    def sums(self, v: torch.Tensor) -> torch.Tensor:
        """[num_keys] (or [num_keys, k] for v [n, k]) sums; keys with no
        entry are 0."""
        c = self.coef.to(v.dtype)
        prod = v[self.rows] * (c if v.dim() == 1 else c[:, None])
        parts, at = [], 0
        for t, w in self.shapes:
            parts.append(prod[at:at + t * w].view(t, w, *v.shape[1:])
                         .sum(dim=1))
            at += t * w
        out = torch.zeros((self.num_keys,) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        if not parts:
            return out
        return out.index_copy_(0, self.targets, torch.cat(parts))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.coef, self.targets))


class GroupedZ:
    """The incidence Z [n, q] of a grouped model on its device: per
    component the stacked level index ``idx[j]`` = offset + level code and
    the multiplier ``weights[j]`` (the slope covariate; None for an
    intercept). With ``deterministic`` (the CUDA route) Z' v, Z'Z and
    Z'WZ go through :class:`SegmentPlan` s built here (Z'WZ's on first
    use); else through ``index_add_``. Z'Z is built once and kept. With
    observation weights (``data.weights``, ``obs_w``) it is Z' diag(w) Z:
    the Gaussian routes read ``ztz`` and :meth:`wmul`."""

    def __init__(self, spec: ModelSpec, data: ModelData,
                 deterministic: bool, dtype=torch.float64):
        self.spec = spec
        self.offsets, self.sizes, self.q = grouped_layout(spec)
        codes = data.group_codes
        self.n = int(codes.shape[0])
        self.device = codes.device
        self.dtype = dtype
        self.idx = [codes[:, c.code_col].long() + self.offsets[j]
                    for j, c in enumerate(spec.components)]
        self.weights = [
            data.slope_data[:, c.slope_data_idx].to(dtype) if c.is_slope
            else None for c in spec.components]
        self.obs_w = (None if data.weights is None
                      else data.weights.to(dtype))
        self.deterministic = bool(deterministic)
        self._probe_cache = None
        self._zt_sq_plan = None
        self._zt_plan = None
        self._pair_plan = None
        self._ztz = None
        if self.deterministic:
            ncomp = len(self.idx)
            rows = torch.arange(self.n, device=self.device).repeat(ncomp)
            self._zt_plan = SegmentPlan(torch.cat(self.idx), rows,
                                        self._stacked_weights(), self.q)

    def _stacked_weights(self):
        if all(w is None for w in self.weights):
            return None
        return torch.cat([torch.ones(self.n, dtype=self.dtype,
                                     device=self.device) if w is None else w
                          for w in self.weights])

    def _pairs(self):
        """Flat (level, level) keys [P n] and row multipliers [P n] of the
        P = ncomp^2 component pairs, pair-major."""
        keys, coefs = [], []
        for j1 in range(len(self.idx)):
            for j2 in range(len(self.idx)):
                keys.append(self.idx[j1] * self.q + self.idx[j2])
                w1, w2 = self.weights[j1], self.weights[j2]
                if w1 is None and w2 is None:
                    coefs.append(torch.ones(self.n, dtype=self.dtype,
                                            device=self.device))
                else:
                    coefs.append((1.0 if w1 is None else w1)
                                 * (1.0 if w2 is None else w2))
        return torch.cat(keys), torch.cat(coefs)

    def pair_plan(self) -> SegmentPlan:
        if self._pair_plan is None:
            keys, coefs = self._pairs()
            rows = torch.arange(self.n, device=self.device).repeat(
                len(self.idx) ** 2)
            self._pair_plan = SegmentPlan(keys, rows, coefs, self.q * self.q)
            self._pair_keys, self._pair_coef = keys, coefs
        return self._pair_plan

    def nbytes(self) -> int:
        """Bytes of the plans the model keeps."""
        return sum(p.nbytes() for p in (self._zt_plan, self._pair_plan)
                   if p is not None)

    # -- the products (no autograd: see the Functions below) --------------
    def _zt(self, v: torch.Tensor) -> torch.Tensor:
        if self._zt_plan is not None:
            return self._zt_plan.sums(v)
        out = torch.zeros((self.q,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        for idx, w in zip(self.idx, self.weights):
            out.index_add_(0, idx, v if w is None else
                           (w * v if v.dim() == 1 else w[:, None] * v))
        return out

    def _zt_sq(self, v: torch.Tensor) -> torch.Tensor:
        """Sums of v per level with the squared multipliers: diag(Z'
        diag(v) Z) (only a row's own level of a component reaches the
        diagonal of the stacked layout)."""
        if all(w is None for w in self.weights):
            return self._zt(v)
        if self.deterministic:
            if self._zt_sq_plan is None:
                rows = torch.arange(self.n, device=self.device).repeat(
                    len(self.idx))
                wsq = self._stacked_weights()
                self._zt_sq_plan = SegmentPlan(torch.cat(self.idx), rows,
                                               wsq * wsq, self.q)
            return self._zt_sq_plan.sums(v)
        out = torch.zeros(self.q, dtype=v.dtype, device=v.device)
        for idx, w in zip(self.idx, self.weights):
            out.index_add_(0, idx, v if w is None else w * w * v)
        return out

    def _z(self, b: torch.Tensor) -> torch.Tensor:
        out = None
        for idx, w in zip(self.idx, self.weights):
            g = b[idx]
            if w is not None:
                g = w * g if b.dim() == 1 else w[:, None] * g
            out = g if out is None else out + g
        return out

    def _ztwz(self, w: Optional[torch.Tensor]) -> torch.Tensor:
        q = self.q
        dt = self.dtype if w is None else w.dtype
        if self.deterministic:
            plan = self.pair_plan()
            ones = torch.ones(self.n, dtype=dt, device=self.device)
            return plan.sums(ones if w is None else w).view(q, q)
        keys, coefs = self._pairs()
        vals = coefs.to(dt)
        if w is not None:
            vals = vals * w.repeat(len(self.idx) ** 2)
        return torch.zeros(q * q, dtype=dt, device=self.device).index_add_(
            0, keys, vals).view(q, q)

    def wmul(self, v: torch.Tensor) -> torch.Tensor:
        """diag(w) v for v [n] or [n, k] (v without weights)."""
        if self.obs_w is None:
            return v
        return self.obs_w * v if v.dim() == 1 else self.obs_w[:, None] * v

    def log_w_sum(self) -> torch.Tensor:
        """sum log w (0 without weights): logdet diag(1/w) = -this."""
        if self.obs_w is None:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.sum(torch.log(self.obs_w))

    def ztz(self) -> torch.Tensor:
        """Z'Z [q, q] (Z' diag(w) Z with observation weights), built once
        (the pair plan that builds it on the CUDA route is released again:
        only the Laplace Z'WZ needs it later)."""
        if self._ztz is None:
            self._ztz = self._ztwz(self.obs_w)
            self._pair_plan = self._pair_keys = self._pair_coef = None
        return self._ztz


class _ZtMul(torch.autograd.Function):
    """Z' v; its backward is the gather Z g."""

    @staticmethod
    def forward(ctx, v, Z):
        ctx.Z = Z
        return Z._zt(v)

    @staticmethod
    def backward(ctx, g):
        return ctx.Z._z(g), None


class _ZMul(torch.autograd.Function):
    """Z b; its backward is Z' g (the plan on CUDA), not autograd's
    accumulating scatter."""

    @staticmethod
    def forward(ctx, b, Z):
        ctx.Z = Z
        return Z._z(b)

    @staticmethod
    def backward(ctx, g):
        return ctx.Z._zt(g), None


class _ZtWZ(torch.autograd.Function):
    """Z' diag(w) Z [q, q]; the gradient of w_i is the gathered sum over
    the component pairs of their multipliers times G at the row's
    (level, level) positions."""

    @staticmethod
    def forward(ctx, w, Z):
        ctx.Z = Z
        return Z._ztwz(w)

    @staticmethod
    def backward(ctx, G):
        Z = ctx.Z
        if Z.deterministic:
            Z.pair_plan()
            keys, coefs = Z._pair_keys, Z._pair_coef
        else:
            keys, coefs = Z._pairs()
        P = len(Z.idx) ** 2
        g = (G.reshape(-1)[keys] * coefs.to(G.dtype)).view(P, Z.n)
        return g.sum(dim=0), None


def zt_mul(Z: GroupedZ, v: torch.Tensor) -> torch.Tensor:
    """Z' v: [q] (or [q, k]) sums of v per component level."""
    return _ZtMul.apply(v, Z)


def z_mul(Z: GroupedZ, b: torch.Tensor) -> torch.Tensor:
    """Z b: a gather per component, summed; b the stacked [q] (or [q, k])."""
    return _ZMul.apply(b, Z)


def ztz_matrix(Z: GroupedZ) -> torch.Tensor:
    """Dense Z'Z [q, q] (data only: built once per model)."""
    return Z.ztz()


def ztw_z(Z: GroupedZ, w: torch.Tensor) -> torch.Tensor:
    """Z' diag(w) Z [q, q]."""
    return _ZtWZ.apply(w, Z)


def _sigma_b_diag(Z: GroupedZ, comp_vars: torch.Tensor) -> torch.Tensor:
    """Diagonal of Sigma_b: comp_vars[j] repeated sizes[j] times (an
    expand per component: its backward is a sum, not a scatter)."""
    return torch.cat([comp_vars[j].expand(s) for j, s in enumerate(Z.sizes)])


class _LogdetQuad(torch.autograd.Function):
    """(logdet M, v' M^-1 v) of M = base + diag(d), SPD, by one Cholesky.
    Backward: grad_M = g_ld M^-1 - g_q u u' (u = M^-1 v); only its
    diagonal when ``base`` needs no gradient; one ``cholesky_inverse``.
    A matrix that is not positive definite gives NaN, no exception (a line
    search backs off from it)."""

    @staticmethod
    def forward(ctx, base, d, v):
        M = base.clone()
        M.diagonal().add_(d)
        GROUPED_COUNTS["qq_factor"] += 1
        L, info = torch.linalg.cholesky_ex(M)
        del M
        bad = info != 0
        logdet = torch.where(bad, math.nan,
                             2.0 * torch.sum(torch.log(torch.diagonal(L))))
        if v is None:
            u, quad = None, torch.zeros((), dtype=d.dtype, device=d.device)
        else:
            u = torch.cholesky_solve(v[:, None], L)[:, 0]
            quad = torch.where(bad, math.nan, torch.dot(v, u))
        ctx.save_for_backward(L, u)
        ctx.has_v = v is not None
        return logdet, quad

    @staticmethod
    def backward(ctx, g_ld, g_q):
        L, u = ctx.saved_tensors
        need_base, need_d, need_v = ctx.needs_input_grad
        grad_base = grad_d = grad_v = None
        if need_base or need_d:
            GROUPED_COUNTS["qq_inverse"] += 1
            K = torch.cholesky_inverse(L)
            if need_base:
                G = g_ld * K
                if ctx.has_v:
                    G = G - g_q * torch.outer(u, u)
                grad_base = G
                grad_d = torch.diagonal(G).clone() if need_d else None
            else:
                grad_d = g_ld * torch.diagonal(K)
                if ctx.has_v:
                    grad_d = grad_d - g_q * u * u
        if need_v and ctx.has_v:
            grad_v = 2.0 * g_q * u
        return grad_base, grad_d, grad_v


def logdet_quad(base: torch.Tensor, d: torch.Tensor,
                v: Optional[torch.Tensor] = None):
    """(logdet(base + diag(d)), v' (base + diag(d))^-1 v) — 0 for the
    second without v — differentiable in all three."""
    return _LogdetQuad.apply(base, d, v)


def _chol(Z: GroupedZ, shift: torch.Tensor) -> torch.Tensor:
    GROUPED_COUNTS["qq_factor"] += 1
    M = Z.ztz().clone()
    M.diagonal().add_(shift)
    return torch.linalg.cholesky(M)


# ---------------------------------------------------------------------------
# Gaussian likelihood
# ---------------------------------------------------------------------------

def nll_gaussian(Z: GroupedZ, cov_pars: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """Exact Gaussian NLL of the residual r = y - F at cov_pars
    [sigma2, comp vars], by Woodbury: O(n + q^3)."""
    sigma2 = cov_pars[0]
    db = _sigma_b_diag(Z, cov_pars[1:])
    shift = sigma2 / db
    rw = Z.wmul(r)
    logdet_m, tt = logdet_quad(Z.ztz(), shift, zt_mul(Z, rw))
    quad = (torch.dot(r, rw) - tt) / sigma2
    logdet = (Z.n * torch.log(sigma2) - Z.log_w_sum() + logdet_m
              - torch.sum(torch.log(shift)))
    return 0.5 * (quad + logdet + Z.n * LOG_2PI)


def nll_gaussian_twice(Z: GroupedZ, cov_pars: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """:func:`nll_gaussian` by autograd through ``torch.linalg.cholesky`` of
    the [q, q] M: differentiable twice (the Hessian of Newton's method),
    still no [n, n] matrix."""
    sigma2 = cov_pars[0]
    db = _sigma_b_diag(Z, cov_pars[1:])
    shift = sigma2 / db
    rw = Z.wmul(r)
    with torch.no_grad():
        ztr = Z._zt(rw)
    M = Z.ztz() + torch.diag(shift)
    L = torch.linalg.cholesky(M)
    u = torch.linalg.solve_triangular(L, ztr[:, None], upper=False)[:, 0]
    quad = (torch.dot(r, rw) - torch.dot(u, u)) / sigma2
    logdet = (Z.n * torch.log(sigma2) - Z.log_w_sum()
              + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
              - torch.sum(torch.log(shift)))
    return 0.5 * (quad + logdet + Z.n * LOG_2PI)


def nll_profiled(Z: GroupedZ, ratio_vars: torch.Tensor, r: torch.Tensor):
    """Profiled-nugget NLL at ratio_vars = comp_vars / sigma2: returns
    (nll, sigma2_hat)."""
    db = _sigma_b_diag(Z, ratio_vars)
    rw = Z.wmul(r)
    logdet_m, tt = logdet_quad(Z.ztz(), 1.0 / db, zt_mul(Z, rw))
    sigma2_hat = (torch.dot(r, rw) - tt) / Z.n
    logdet_tilde = logdet_m + torch.sum(torch.log(db)) - Z.log_w_sum()
    nll = 0.5 * (Z.n * (torch.log(sigma2_hat) + LOG_2PI + 1.0)
                 + logdet_tilde)
    return nll, sigma2_hat


def nll_profiled_value_and_grad(Z: GroupedZ, log_ratio_vars: torch.Tensor,
                                r: torch.Tensor):
    """(nll, d nll / d log_ratio_vars, sigma2_hat), by autograd."""
    th = log_ratio_vars.detach().requires_grad_(True)
    with torch.enable_grad():
        nll, s2 = nll_profiled(Z, torch.exp(th), r.detach())
        (g,) = ag.grad(nll, th)
    return nll.detach(), g, s2.detach()


def psi_inv_mul(Z: GroupedZ, cov_pars: torch.Tensor,
                R: torch.Tensor) -> torch.Tensor:
    """Psi^-1 R by Woodbury; R [n] or [n, k]. With weights
    Psi^-1 R = (W R - W Z M^-1 Z' W R) / sigma2, M = Z'WZ +
    sigma2 Sigma_b^-1."""
    sigma2 = cov_pars[0]
    db = _sigma_b_diag(Z, cov_pars[1:])
    L = _chol(Z, sigma2 / db)
    wR = Z.wmul(R)
    ztr = Z._zt(wR)
    sol = torch.cholesky_solve(ztr[:, None] if R.dim() == 1 else ztr, L)
    if R.dim() == 1:
        sol = sol[:, 0]
    return (wR - Z.wmul(Z._z(sol))) / sigma2


def posterior_b_gaussian(Z: GroupedZ, cov_pars: torch.Tensor,
                         r: torch.Tensor):
    """Posterior of the stacked random effects b | y: precision M / sigma2
    (M = Z'WZ + sigma2 Sigma_b^-1), mean M^-1 Z'Wr, covariance
    sigma2 M^-1. Returns (mean [q], postcov [q, q])."""
    sigma2 = cov_pars[0]
    db = _sigma_b_diag(Z, cov_pars[1:])
    L = _chol(Z, sigma2 / db)
    mean = torch.cholesky_solve(Z._zt(Z.wmul(r))[:, None], L)[:, 0]
    GROUPED_COUNTS["qq_inverse"] += 1
    return mean, sigma2 * torch.cholesky_inverse(L)


def fisher_information(Z: GroupedZ, cov_pars: torch.Tensor) -> torch.Tensor:
    """Expected Fisher information of the log-scale parameters
    [sigma2, v_1, ..., v_J], FI_jk = 0.5 tr(Psi^-1 A_j Psi^-1 A_k) with
    A_0 = sigma2 I, A_j = v_j Z_j Z_j' (``CalcFisherInformation``,
    re_model_template.h:9144), in q-space. With K = M^-1 and
    Lambda = Sigma_b^-1 (diagonal lam): Psi^-1 Z = Z K Lambda and
    Z' Psi^-1 Z = Lambda - sigma2 Lambda K Lambda, so

      FI_00 = 0.5 (n - q + sigma2^2 lam' (K o K) lam)
      FI_0k = 0.5 sigma2 / v_k sum_{i in k} (K_ii - sigma2 ((K o K) lam)_i)
      FI_jk = 0.5 / (v_j v_k) || delta_jk v_j I - sigma2 K_jk ||_F^2

    — one Cholesky and one ``cholesky_inverse`` of [q, q], no [n, n]. With
    observation weights (A_0 = sigma2 W^-1, M = Z'WZ + sigma2 Lambda) the
    same three formulas hold."""
    s2 = cov_pars[0]
    v = cov_pars[1:]
    lam = 1.0 / _sigma_b_diag(Z, v)
    K = torch.cholesky_inverse(_chol(Z, s2 * lam))
    GROUPED_COUNTS["qq_inverse"] += 1
    ksq_lam = (K * K) @ lam
    kd = torch.diagonal(K)
    J = len(Z.sizes)
    fi = torch.zeros((J + 1, J + 1), dtype=K.dtype, device=K.device)
    fi[0, 0] = 0.5 * (Z.n - Z.q + s2 * s2 * torch.dot(lam, ksq_lam))
    sl = [slice(o, o + s) for o, s in zip(Z.offsets, Z.sizes)]
    for k in range(J):
        fi[0, k + 1] = fi[k + 1, 0] = 0.5 * s2 / v[k] * torch.sum(
            kd[sl[k]] - s2 * ksq_lam[sl[k]])
        for j in range(k, J):
            blk = K[sl[j], sl[k]]
            s = s2 * s2 * torch.sum(blk * blk)
            if j == k:
                s = s + v[j] * v[j] * Z.sizes[j] - 2.0 * v[j] * s2 * torch.sum(
                    torch.diagonal(blk))
            fi[j + 1, k + 1] = fi[k + 1, j + 1] = 0.5 * s / (v[j] * v[k])
    return fi


def predict_from_posterior(spec: ModelSpec, b_mean: torch.Tensor,
                           postcov: torch.Tensor, comp_vars: torch.Tensor,
                           want_cov: bool, pred_codes: torch.Tensor,
                           pred_weights: torch.Tensor):
    """Latent prediction at new rows from the posterior of b.

    ``pred_codes`` [n_p, n_code_cols]: level per code column, a code >= the
    component's number of levels marks a level training never saw (mean 0,
    the prior variance, correlated only with rows of the same unseen
    label). ``pred_weights`` [n_p, ncomp]: the slope covariates (1 for
    intercepts). Returns (mean [n_p], var [n_p], cov [n_p, n_p] or None)."""
    offsets, sizes, _ = grouped_layout(spec)
    mean = torch.zeros(pred_codes.shape[0], dtype=b_mean.dtype,
                       device=b_mean.device)
    seen, idx, a = [], [], []
    for j, comp in enumerate(spec.components):
        codes = pred_codes[:, comp.code_col]
        s = codes < sizes[j]
        seen.append(s)
        idx.append(offsets[j] + torch.clamp(codes, max=sizes[j] - 1))
        a.append(torch.where(s, pred_weights[:, j], 0.0))
        mean = mean + a[j] * b_mean[idx[j]]
    ncomp = len(spec.components)
    if want_cov:
        cov = None
        for j1 in range(ncomp):
            for j2 in range(ncomp):
                c = (a[j1][:, None] * a[j2][None, :]
                     * postcov[idx[j1][:, None], idx[j2][None, :]])
                cov = c if cov is None else cov + c
        for j, comp in enumerate(spec.components):
            codes = pred_codes[:, comp.code_col]
            cov = cov + comp_vars[j] * torch.where(
                ~seen[j][:, None], _grouped_cross_cov(
                    codes, codes, pred_weights[:, j], pred_weights[:, j],
                    dtype=cov.dtype), 0.0)
        return mean, torch.diagonal(cov).clone(), cov
    var = torch.zeros_like(mean)
    for j1 in range(ncomp):
        for j2 in range(ncomp):
            var = var + a[j1] * a[j2] * postcov[idx[j1], idx[j2]]
    for j in range(ncomp):
        w = pred_weights[:, j]
        var = var + torch.where(seen[j], 0.0, w * w * comp_vars[j])
    return mean, var, None


# ---------------------------------------------------------------------------
# Laplace approximation in b-space (non-Gaussian likelihoods)
# ---------------------------------------------------------------------------

def _h_matrix(Z: GroupedZ, w: torch.Tensor, db: torch.Tensor):
    """H = Z'WZ + Sigma_b^-1 [q, q] and its Cholesky factor, or None for
    the factor when H is not positive definite (a family whose
    information -d2 can be negative at the mode); one host read."""
    H = Z._ztwz(w)
    H.diagonal().add_(1.0 / db)
    GROUPED_COUNTS["qq_factor"] += 1
    L, info = torch.linalg.cholesky_ex(H)
    return H, (L if int(info) == 0 else None)


def _h_solve(Z: GroupedZ, db: torch.Tensor):
    """(w, rhs) -> (Z'WZ + Sigma_b^-1)^-1 rhs, dense [q, q]: by Cholesky,
    or by LU (the JAX package's ``jnp.linalg.solve``) when H is not
    positive definite."""
    def solve(w, rhs):
        H, L = _h_matrix(Z, w, db)
        if L is not None:
            return torch.cholesky_solve(rhs[:, None], L)[:, 0]
        GROUPED_COUNTS["qq_factor"] += 1
        return torch.linalg.solve(H, rhs)
    return solve


class _FindModeGrouped(torch.autograd.Function):
    """Mode of sum log p(y | F + Z b) - 1/2 b' Sigma_b^-1 b over b in R^q,
    differentiable in (db, F, aux) by implicit differentiation."""

    @staticmethod
    def forward(ctx, db, F, aux, lik_name, y, Z):
        fam = lk.get_family(lik_name)
        b = newton_mode(fam, y, F, _aux_val(aux), lambda v: v / db,
                        _h_solve(Z, db), GROUPED_COUNTS, z=Z._z, zt=Z._zt,
                        size=Z.q)
        ctx.save_for_backward(db, F, aux, y, b)
        ctx.lik_name, ctx.Z = lik_name, Z
        return b

    @staticmethod
    def backward(ctx, v):
        db, F, aux, y, b = ctx.saved_tensors
        Z = ctx.Z
        out = mode_vjp(lk.get_family(ctx.lik_name), y, b, v, _h_solve(Z, db),
                       lambda db_: b / db_, (db, F, aux),
                       ctx.needs_input_grad[:3],
                       z=Z._z, zt=lambda d: zt_mul(Z, d))
        return out[0], out[1], out[2], None, None, None


def find_mode_grouped(lik_name: str, Z: GroupedZ, db: torch.Tensor,
                      F: torch.Tensor, aux, y: torch.Tensor) -> torch.Tensor:
    """Posterior mode of b [q] (Newton on H = Z'WZ + Sigma_b^-1)."""
    return _FindModeGrouped.apply(db, F, _aux_arg(aux, y), _family(Z, lik_name),
                                  y, Z)


def _family(Z: GroupedZ, lik):
    """The likelihood family with the model's observation weights."""
    return lk.weighted_family(lik, Z.obs_w)


def _offset(y: torch.Tensor, F: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.zeros_like(y) if F is None else F


def nll_laplace(Z: GroupedZ, lik_name: str, cov_pars: torch.Tensor, aux,
                y: torch.Tensor, F: Optional[torch.Tensor] = None):
    """Laplace NLL in b-space: -loglik(mode) + 1/2 b' Sigma_b^-1 b
    + 1/2 logdet(I_q + Sigma_b Z'WZ), the last as
    logdet(Z'WZ + Sigma_b^-1) + logdet Sigma_b. Differentiable in
    (cov_pars, aux, F)."""
    fam = _family(Z, lik_name)
    F = _offset(y, F)
    db = _sigma_b_diag(Z, cov_pars)
    b = find_mode_grouped(lik_name, Z, db, F, aux, y)
    loc = F + z_mul(Z, b)
    w = -fam.d2_loc(y, loc, aux)
    loglik = torch.sum(fam.log_lik(y, loc, aux))
    quad = torch.sum(b * b / db)
    logdet_h, _ = logdet_quad(ztw_z(Z, w), 1.0 / db)
    return -(loglik - 0.5 * quad - 0.5 * (logdet_h + torch.sum(torch.log(db))))


def nll_laplace_value_and_grad(Z: GroupedZ, lik_name: str,
                               cov_pars: torch.Tensor, aux, y: torch.Tensor,
                               F: Optional[torch.Tensor] = None):
    """(nll, d nll / d cov_pars, d nll / d aux or None) by autograd."""
    cp = cov_pars.detach().requires_grad_(True)
    ap = None if aux is None else aux.detach().requires_grad_(True)
    with torch.enable_grad():
        v = nll_laplace(Z, lik_name, cp, ap, y, F)
        grads = ag.grad(v, [cp] if ap is None else [cp, ap])
    return v.detach(), grads[0], (None if ap is None else grads[1])


def gradient_wrt_F(Z: GroupedZ, lik_name: str, cov_pars: torch.Tensor, aux,
                   y: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """d NLL / dF of the b-space Laplace NLL at the fixed effects F (the
    LaGaBoost gradient with grouped effects; the JAX package takes it from
    the dense [n, n] route, ``laplace.gradient_wrt_F``). Through the mode's
    implicit backward (``mode_vjp`` over Z) and the gather backwards of Z b,
    Z'v and Z'WZ: O(n + q^3), bit-reproducible on the card."""
    Ft = F.detach().requires_grad_(True)
    with torch.enable_grad():
        v = nll_laplace(Z, lik_name, cov_pars.detach(),
                        None if aux is None else aux.detach(), y, Ft)
        (g,) = ag.grad(v, Ft)
    return g


def laplace_mode_and_w(Z: GroupedZ, lik_name: str, cov_pars: torch.Tensor,
                       aux, y: torch.Tensor, F: Optional[torch.Tensor]):
    """(mode b, W = -d2 at the mode, db)."""
    fam = _family(Z, lik_name)
    F = _offset(y, F)
    db = _sigma_b_diag(Z, cov_pars)
    b = find_mode_grouped(lik_name, Z, db, F, aux, y)
    w = -fam.d2_loc(y, F + Z._z(b), aux)
    return b, w, db


def posterior_b_laplace(Z: GroupedZ, lik_name: str, cov_pars: torch.Tensor,
                        aux, y: torch.Tensor, F: Optional[torch.Tensor]):
    """Laplace posterior of b: mean the mode, covariance
    (Z'WZ + Sigma_b^-1)^-1."""
    b, w, db = laplace_mode_and_w(Z, lik_name, cov_pars, aux, y, F)
    H, L = _h_matrix(Z, w, db)
    GROUPED_COUNTS["qq_inverse"] += 1
    return b, (torch.cholesky_inverse(L) if L is not None
               else torch.linalg.inv(H))


# ---------------------------------------------------------------------------
# iterative route (matrix_inversion_method="iterative"): CG + stochastic
# Lanczos in b-space, no [q, q] matrix (CGRandomEffectsVec, CG_utils.h:979)
# ---------------------------------------------------------------------------

def ztw_z_diag(Z: GroupedZ, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """diag(Z' diag(w) Z) [q] (w = 1 when None); a constant of the
    preconditioner, not differentiated."""
    with torch.no_grad():
        return Z._zt_sq(torch.ones(Z.n, dtype=Z.dtype, device=Z.device)
                        if w is None else w)


def _mv_sys(Z: GroupedZ, w_obs: Optional[torch.Tensor], shift: torch.Tensor,
            V: torch.Tensor) -> torch.Tensor:
    """(Z' diag(w_obs) Z + diag(shift)) V for V [q] or [q, k],
    differentiable in ``w_obs`` and ``shift`` (Z b and Z'v by their
    gather-backward Functions)."""
    zv = z_mul(Z, V)
    if w_obs is not None:
        zv = zv * (w_obs if V.dim() == 1 else w_obs[:, None])
    return zt_mul(Z, zv) + (shift if V.dim() == 1 else shift[:, None]) * V


def _jacobi(diag: torch.Tensor) -> cgops.JacobiPreconditioner:
    return cgops.JacobiPreconditioner(torch.clamp(diag.detach(), min=1e-10))


def _quadform_cg(matvec, u, pre_solve, tol, max_iter):
    """Differentiable u' M^-1 u without differentiating the CG loop: the
    stationary surrogate 2 u'v - v'Mv at v = M^-1 u (detached) has the
    exact value and exact first derivatives."""
    with torch.no_grad(), timed("cg: quadratic-form CG", sync=True):
        v, it = cgops.pcg(matvec, u.detach(), pre_solve, tol=tol,
                          max_iter=max_iter)
    GROUPED_COUNTS["quad_cg_iters"] += it
    return 2.0 * torch.dot(u, v) - torch.dot(v, matvec(v))


def grouped_probes(Z: GroupedZ, num_rand_vec_trace: int, seed: int):
    """(e, Zg) [q, k]: standard-normal value probes (scaled by the Jacobi
    preconditioner's square root) and Rademacher gradient probes, drawn in
    float64 from a ``torch.Generator`` seeded with ``seed`` on Z's device
    and cast to Z's dtype; the same in every evaluation, kept on Z."""
    key = (int(num_rand_vec_trace), int(seed))
    if Z._probe_cache is None or Z._probe_cache[0] != key:
        gen = torch.Generator(device=Z.device).manual_seed(key[1])
        e = cgops.normal_probes(gen, Z.q, key[0])
        zg = cgops.rademacher_probes(gen, Z.q, key[0])
        Z._probe_cache = (key, e.to(Z.dtype), zg.to(Z.dtype))
    return Z._probe_cache[1], Z._probe_cache[2]


def nll_profiled_iterative(Z: GroupedZ, ratio_vars: torch.Tensor,
                           r: torch.Tensor, num_rand_vec_trace: int = 50,
                           lanczos_steps: int = 50, cg_tol: float = 1e-6,
                           cg_max_iter: int = 1000, seed: int = 1,
                           probes=None):
    """Profiled-nugget Gaussian NLL, matrix-free (the JAX package's
    ``nll_profiled_iterative``): CG for the Woodbury quadratic form,
    stochastic Lanczos for logdet M, M = Z'Z + Sigma_b^-1 (ratio scale).
    ``probes`` = (e, Zg) [q, k] replaces the port's own draws. Returns
    (nll, sigma2_hat)."""
    db = _sigma_b_diag(Z, ratio_vars)
    shift = 1.0 / db

    def matvec(V):
        return _mv_sys(Z, Z.obs_w, shift, V)

    pre = _jacobi(ztw_z_diag(Z, Z.obs_w) + shift)
    rw = Z.wmul(r)
    quadform = _quadform_cg(matvec, zt_mul(Z, rw), pre.solve, cg_tol,
                            cg_max_iter)
    sigma2_hat = (torch.dot(r, rw) - quadform) / Z.n
    e, zg = (probes if probes is not None
             else grouped_probes(Z, num_rand_vec_trace, seed))
    logdet_m = cgops.stochastic_logdet_grad(
        matvec, None, torch.sqrt(pre.d)[:, None] * e, lanczos_steps,
        pre.solve, pre.logdet(), cg_tol, cg_max_iter, probes_grad=zg,
        stats=GROUPED_COUNTS)
    logdet_tilde = logdet_m + torch.sum(torch.log(db)) - Z.log_w_sum()
    nll = 0.5 * (Z.n * (torch.log(sigma2_hat) + LOG_2PI + 1.0)
                 + logdet_tilde)
    return nll, sigma2_hat


def nll_profiled_iterative_value_and_grad(Z: GroupedZ,
                                          log_ratio_vars: torch.Tensor,
                                          r: torch.Tensor, **kw):
    """(nll, d nll / d log_ratio_vars, sigma2_hat) of
    :func:`nll_profiled_iterative`, by autograd."""
    th = log_ratio_vars.detach().requires_grad_(True)
    with torch.enable_grad():
        nll, s2 = nll_profiled_iterative(Z, torch.exp(th), r.detach(), **kw)
        (g,) = ag.grad(nll, th)
    return nll.detach(), g, s2.detach()


def _h_cg_solve(Z: GroupedZ, db: torch.Tensor, tol: float, count: str,
                max_iter: int = 1000):
    """(w, rhs) -> (Z'WZ + Sigma_b^-1)^-1 rhs by Jacobi-preconditioned CG,
    its iterations added to ``GROUPED_COUNTS[count]``."""
    def solve(w, rhs):
        pre = _jacobi(ztw_z_diag(Z, w) + 1.0 / db)
        x, it = cgops.pcg(lambda V: _mv_sys(Z, w, 1.0 / db, V), rhs,
                          pre.solve, tol=tol, max_iter=max_iter)
        GROUPED_COUNTS[count] += it
        return x
    return solve


class _FindModeGroupedCG(torch.autograd.Function):
    """Matrix-free posterior mode in b-space: :func:`newton_mode` with
    each Newton step solved by CG to 1e-8, differentiable in (db, F, aux)
    by :func:`mode_vjp` with an adjoint CG solve to 1e-10 (the JAX
    package's ``find_mode_grouped_cg`` and its backward)."""

    @staticmethod
    def forward(ctx, db, F, aux, lik_name, y, Z):
        fam = lk.get_family(lik_name)
        with timed("Laplace: mode (Newton-CG)", sync=True):
            b = newton_mode(fam, y, F, _aux_val(aux), lambda v: v / db,
                            _h_cg_solve(Z, db, 1e-8, "mode_cg_iters"),
                            GROUPED_COUNTS, z=Z._z, zt=Z._zt, size=Z.q)
        ctx.save_for_backward(db, F, aux, y, b)
        ctx.lik_name, ctx.Z = lik_name, Z
        return b

    @staticmethod
    def backward(ctx, v):
        db, F, aux, y, b = ctx.saved_tensors
        Z = ctx.Z
        with timed("Laplace: mode adjoint CG", sync=True):
            out = mode_vjp(lk.get_family(ctx.lik_name), y, b, v,
                           _h_cg_solve(Z, db, 1e-10, "mode_adjoint_cg_iters"),
                           lambda db_: b / db_, (db, F, aux),
                           ctx.needs_input_grad[:3],
                           z=Z._z, zt=lambda d: zt_mul(Z, d))
        return out[0], out[1], out[2], None, None, None


def find_mode_grouped_cg(lik_name: str, Z: GroupedZ, db: torch.Tensor,
                         F: torch.Tensor, aux, y: torch.Tensor
                         ) -> torch.Tensor:
    """Posterior mode of b [q] by Newton-CG (no [q, q] matrix)."""
    return _FindModeGroupedCG.apply(db, F, _aux_arg(aux, y),
                                    _family(Z, lik_name), y, Z)


def nll_laplace_iterative(Z: GroupedZ, lik_name: str, cov_pars: torch.Tensor,
                          aux, y: torch.Tensor,
                          F: Optional[torch.Tensor] = None,
                          num_rand_vec_trace: int = 50,
                          lanczos_steps: int = 50, cg_tol: float = 1e-6,
                          cg_max_iter: int = 1000, seed: int = 1,
                          probes=None) -> torch.Tensor:
    """Laplace NLL in b-space, matrix-free (the JAX package's
    ``nll_laplace_iterative``): the Newton-CG mode and the stochastic
    log-determinant of H = Z'WZ + Sigma_b^-1 (logdet(I + Sigma_b Z'WZ) =
    logdet H + sum log db). Differentiable in (cov_pars, aux, F);
    ``probes`` = (e, Zg) [q, k] replaces the port's own draws."""
    fam = _family(Z, lik_name)
    F = _offset(y, F)
    db = _sigma_b_diag(Z, cov_pars)
    b = find_mode_grouped_cg(lik_name, Z, db, F, aux, y)
    loc = F + z_mul(Z, b)
    w = -fam.d2_loc(y, loc, aux)
    loglik = torch.sum(fam.log_lik(y, loc, aux))
    quad = torch.sum(b * b / db)

    def matvec(V):
        return _mv_sys(Z, w, 1.0 / db, V)

    pre = _jacobi(ztw_z_diag(Z, w.detach()) + 1.0 / db)
    e, zg = (probes if probes is not None
             else grouped_probes(Z, num_rand_vec_trace, seed))
    logdet_h = cgops.stochastic_logdet_grad(
        matvec, None, torch.sqrt(pre.d)[:, None] * e, lanczos_steps,
        pre.solve, pre.logdet(), cg_tol, cg_max_iter, probes_grad=zg,
        stats=GROUPED_COUNTS)
    return -(loglik - 0.5 * quad - 0.5 * (logdet_h + torch.sum(torch.log(db))))


def nll_laplace_iterative_value_and_grad(Z: GroupedZ, lik_name: str,
                                         cov_pars: torch.Tensor, aux,
                                         y: torch.Tensor,
                                         F: Optional[torch.Tensor] = None,
                                         **kw):
    """(nll, d nll / d cov_pars, d nll / d aux or None) of
    :func:`nll_laplace_iterative`, by autograd."""
    cp = cov_pars.detach().requires_grad_(True)
    ap = None if aux is None else aux.detach().requires_grad_(True)
    with torch.enable_grad():
        v = nll_laplace_iterative(Z, lik_name, cp, ap, y, F, **kw)
        grads = ag.grad(v, [cp] if ap is None else [cp, ap])
    return v.detach(), grads[0], (None if ap is None else grads[1])


def _draws_by_cg(Z: GroupedZ, solve, rhs_of, nsim: int, seed: int):
    """[q, nsim] solutions of ``solve`` on the right-hand sides
    ``rhs_of(z1 [n, c], z2 [q, c])`` of standard normals drawn in float64
    from a ``torch.Generator`` seeded with ``seed`` (z1 then z2, a chunk of
    ``SIM_CHUNK`` draws at a time: [n, c] products, never [n, nsim])."""
    gen = torch.Generator(device=Z.device).manual_seed(int(seed))
    out = []
    for s in range(0, int(nsim), SIM_CHUNK):
        c = min(SIM_CHUNK, int(nsim) - s)
        z1 = cgops.normal_probes(gen, Z.n, c).to(Z.dtype)
        z2 = cgops.normal_probes(gen, Z.q, c).to(Z.dtype)
        out.append(solve(rhs_of(z1, z2)))
    return torch.cat(out, dim=1)


def posterior_b_gaussian_iterative(Z: GroupedZ, cov_pars: torch.Tensor,
                                   r: torch.Tensor, nsim: int, seed: int,
                                   cg_tol: float = 1e-8,
                                   cg_max_iter: int = 1000):
    """Iterative Gaussian posterior of b (the JAX package's
    ``posterior_b_gaussian_iterative``): mean M^-1 Z'r by CG and draws
    u ~ N(0, sigma2 M^-1) as sqrt(sigma2) M^-1 (Z'z1 + sqrt(shift) z2),
    M = Z'Z + diag(shift), shift = sigma2 / db (the reference's
    ``Sample_Posterior_LaplaceApprox_GroupedRE`` sampling,
    likelihoods.h:6852). Returns (b_mean [q], draws [q, nsim])."""
    sigma2 = cov_pars[0]
    shift = sigma2 / _sigma_b_diag(Z, cov_pars[1:])
    pre = _jacobi(ztw_z_diag(Z, Z.obs_w) + shift)
    sqrt_w = None if Z.obs_w is None else torch.sqrt(Z.obs_w)[:, None]

    def solve(B):
        x, it = cgops.pcg(lambda V: _mv_sys(Z, Z.obs_w, shift, V), B,
                          pre.solve, tol=cg_tol, max_iter=cg_max_iter)
        GROUPED_COUNTS["sim_cg_iters"] += it
        return x

    b_mean = solve(Z._zt(Z.wmul(r)))
    draws = _draws_by_cg(
        Z, solve, lambda z1, z2: Z._zt(z1 if sqrt_w is None else sqrt_w * z1)
        + torch.sqrt(shift)[:, None] * z2, nsim, seed)
    return b_mean, torch.sqrt(sigma2) * draws


def posterior_b_laplace_iterative(Z: GroupedZ, lik_name: str,
                                  cov_pars: torch.Tensor, aux,
                                  y: torch.Tensor, F: Optional[torch.Tensor],
                                  nsim: int, seed: int, cg_tol: float = 1e-8,
                                  cg_max_iter: int = 1000):
    """Iterative Laplace posterior of b (the JAX package's
    ``posterior_b_laplace_iterative``): the Newton-CG mode and draws
    u ~ N(0, H^-1) as H^-1 (Z' W^1/2 z1 + Sigma_b^-1/2 z2),
    H = Z'WZ + Sigma_b^-1. Returns (mode [q], draws [q, nsim])."""
    fam = _family(Z, lik_name)
    F = _offset(y, F)
    db = _sigma_b_diag(Z, cov_pars)
    b = find_mode_grouped_cg(lik_name, Z, db, F, aux, y)
    w = torch.clamp(-fam.d2_loc(y, F + Z._z(b), aux), min=1e-10)
    solve = _h_cg_solve(Z, db, cg_tol, "sim_cg_iters", cg_max_iter)
    sqrt_w = torch.sqrt(w)[:, None]
    draws = _draws_by_cg(
        Z, lambda B: solve(w, B),
        lambda z1, z2: Z._zt(sqrt_w * z1) + z2 / torch.sqrt(db)[:, None],
        nsim, seed)
    return b, draws


def predict_from_posterior_draws(spec: ModelSpec, b_mean: torch.Tensor,
                                 draws: torch.Tensor, comp_vars: torch.Tensor,
                                 pred_codes: torch.Tensor,
                                 pred_weights: torch.Tensor):
    """Latent prediction mean and SIMULATED variance from posterior draws
    (no [q, q] covariance): mean as :func:`predict_from_posterior`, var =
    mean over the draws of (sum_j a_j u[idx_j])^2, plus the prior variance
    of each level training never saw (JAX ``predict_from_posterior_draws``;
    the level's component by ``code_col``). Returns (mean, var)."""
    offsets, sizes, _ = grouped_layout(spec)
    mean = torch.zeros(pred_codes.shape[0], dtype=b_mean.dtype,
                       device=b_mean.device)
    sims = torch.zeros((pred_codes.shape[0], draws.shape[1]),
                       dtype=b_mean.dtype, device=b_mean.device)
    var_unseen = torch.zeros_like(mean)
    for j, comp in enumerate(spec.components):
        codes = pred_codes[:, comp.code_col]
        seen = codes < sizes[j]
        idx = offsets[j] + torch.clamp(codes, max=sizes[j] - 1)
        wj = pred_weights[:, j]
        mean = mean + torch.where(seen, wj * b_mean[idx], 0.0)
        sims = sims + torch.where(seen, wj, 0.0)[:, None] * draws[idx]
        var_unseen = var_unseen + torch.where(seen, 0.0,
                                              wj * wj * comp_vars[j])
    return mean, torch.mean(sims * sims, dim=1) + var_unseen


def num_cg_steps(Z: GroupedZ, w: Optional[torch.Tensor],
                 shift: torch.Tensor, rhs: torch.Tensor, tol: float,
                 max_iter: int) -> int:
    """CG iterations of one solve (Z'WZ + diag(shift)) x = rhs under the
    Jacobi preconditioner (``GPModel.get_num_cg_steps``)."""
    with torch.no_grad():
        pre = _jacobi(ztw_z_diag(Z, w) + shift)
        _, it = cgops.pcg(lambda V: _mv_sys(Z, w, shift, V), rhs, pre.solve,
                          tol=tol, max_iter=max_iter)
    return int(it)
