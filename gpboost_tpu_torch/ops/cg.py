"""Iterative solvers: preconditioned CG + stochastic Lanczos log-determinants.

The JAX package's ``gpboost_tpu/ops/cg.py`` in PyTorch (the reference's
``include/GPBoost/CG_utils.h``; papers arXiv:2310.12000, 2405.14492):

- :func:`pcg`: preconditioned conjugate gradients, batched over the columns
  of an [n, k] right-hand side (per-column alpha / beta). The loop is
  Python; its stop test (every column's residual below ``tol`` times its
  right-hand side's norm, or ``max_iter``) is read on the host once an
  iteration, so it stops at the iteration where the JAX package's
  ``while_loop`` stops.
- :func:`lanczos_tridiag`: per-probe Lanczos tridiagonalisation (batched
  over probes), feeding the stochastic log-determinant
  ``logdet(A) ~ mean_k ||z_k||^2 e1' U log(L) U' e1``
  (reference ``LogDetStochTridiag``, CG_utils.h:384).
- :func:`stochastic_logdet_grad`: the same quantity with a Hutchinson
  surrogate for its gradient: value from Lanczos (detached), derivative from
  ``mean_k (A^-1 z_k)' A(theta) z_k`` with ``A^-1 z_k`` detached, whose
  theta-gradient is the unbiased trace estimator tr(A^-1 dA).
- :func:`stochastic_logdet_grad_vr`: the same value with the optimal-c
  control variate on the preconditioner for its gradient.
- preconditioners: :class:`JacobiPreconditioner`, the low-rank plus
  diagonal :class:`LowRankDiagPreconditioner` (Woodbury solve, exact
  log-determinant, probes ~ N(0, P)) and the randomised-Nystrom one built
  from matrix products, :func:`nystrom_preconditioner`.
- :func:`pcg_implicit`: CG with an implicit backward, under either
  preconditioner.

Probe vectors come from an explicit ``torch.Generator`` on the tensor's
device.

The heavy work here — the multi-RHS precision products inside CG and
Lanczos — is plain PyTorch, as in the JAX package (no Pallas kernel there).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch.utils.timer import timed


def rademacher_probes(generator: torch.Generator, n: int, num_probes: int,
                      dtype=torch.float64) -> torch.Tensor:
    """[n, num_probes] of +-1 from ``generator`` (on its device)."""
    bits = torch.randint(0, 2, (n, num_probes), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def normal_probes(generator: torch.Generator, n: int, num_probes: int,
                  dtype=torch.float64) -> torch.Tensor:
    """[n, num_probes] standard normal from ``generator``."""
    return torch.randn((n, num_probes), generator=generator,
                       device=generator.device, dtype=dtype)


def pcg(matvec: Callable, B: torch.Tensor,
        precond_solve: Optional[Callable] = None,
        tol: float = 1e-2, max_iter: int = 1000,
        x0: Optional[torch.Tensor] = None):
    """Batched preconditioned CG: solve A X = B for SPD A, B [n, k].

    All k systems iterate together (per-column alpha/beta); the loop stops
    when every column's residual norm is below tol * ||b|| or after
    ``max_iter`` iterations. Returns (X, num_iter). ``pcg.host_reads``
    counts the stop tests read on the host (one an iteration, one more at
    the end)."""
    if B.dim() == 1:
        X, it = pcg(matvec, B[:, None], precond_solve, tol, max_iter,
                    None if x0 is None else x0[:, None])
        return X[:, 0], it
    Pinv = precond_solve if precond_solve is not None else (lambda r: r)
    X = torch.zeros_like(B) if x0 is None else x0
    R = B - matvec(X)
    Z = Pinv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b_norm = torch.sqrt(torch.sum(B * B, dim=0))
    tol_vec = tol * torch.clamp(b_norm, min=1e-30)
    it = 0
    while it < max_iter:
        r_norm = torch.sqrt(torch.sum(R * R, dim=0))
        pcg.host_reads += 1
        if not bool(torch.any(r_norm > tol_vec)):
            break
        AP = matvec(P)
        denom = torch.sum(P * AP, dim=0)
        alpha = rz / torch.where(denom > 0, denom, 1e-30)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = Pinv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = rz_new / torch.where(rz > 0, rz, 1e-30)
        P = Z + beta[None, :] * P
        rz = rz_new
        it += 1
    return X, it


pcg.host_reads = 0


def lanczos_tridiag(matvec: Callable, Z: torch.Tensor, num_steps: int,
                    precond_solve: Optional[Callable] = None):
    """Batched Lanczos: tridiagonalise (P^-1)A w.r.t. the P-inner product
    for each probe column of Z [n, k]. Returns (alphas [steps, k],
    betas [steps-1, k]) of the tridiagonal matrices (reference
    ``CGTridiagVecchiaLaplace``, CG_utils.h:167). No host read."""
    k = Z.shape[1]
    Pinv = precond_solve if precond_solve is not None else (lambda r: r)
    q_prev = torch.zeros_like(Z)
    r = Z
    z = Pinv(r)
    gamma = torch.sqrt(torch.clamp(torch.sum(r * z, dim=0), min=1e-30))
    q = r / gamma[None, :]
    qz = z / gamma[None, :]
    beta_prev = torch.zeros(k, dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for _ in range(num_steps):
        w = matvec(qz) - beta_prev[None, :] * q_prev
        alpha = torch.sum(qz * w, dim=0)
        w = w - alpha[None, :] * q
        wz = Pinv(w)
        beta = torch.sqrt(torch.clamp(torch.sum(w * wz, dim=0), min=1e-30))
        q_prev, q, qz = q, w / beta[None, :], wz / beta[None, :]
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def _logdet_from_tridiag(alphas, betas, z_norms_sq):
    """Stochastic logdet from per-probe tridiagonal matrices:
    logdet ~ mean_k ||z_k||_P^2 * (e1' U log(Lambda) U' e1). A probe whose
    matrix is not finite (parameters a line search overshot to) gives NaN,
    as in the JAX package, instead of the exception ``eigh`` raises."""
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, offset=1)
         + torch.diag_embed(betas.T, offset=-1))          # [k, steps, steps]
    finite = torch.isfinite(T).all(dim=2).all(dim=1)
    T = torch.where(finite[:, None, None], T,
                    torch.eye(T.shape[1], dtype=T.dtype, device=T.device))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-30)
    tau = evecs[:, 0, :]
    vals = z_norms_sq * torch.sum(tau * tau * torch.log(evals), dim=1)
    return torch.mean(torch.where(finite, vals, torch.nan))


def stochastic_logdet_grad(matvec_of_theta: Callable, theta_free,
                           Z: torch.Tensor, num_lanczos_steps: int = 50,
                           precond_solve: Optional[Callable] = None,
                           precond_logdet: Optional[torch.Tensor] = None,
                           cg_tol: float = 1e-2, cg_max_iter: int = 1000,
                           probes_grad: Optional[torch.Tensor] = None,
                           stats: Optional[dict] = None):
    """Differentiable stochastic logdet(A(theta)).

    ``matvec_of_theta(V)`` is A V, differentiable through the autograd graph
    of the parameters it closes over (``theta_free`` is unused: the JAX
    signature's pytree). The value is the preconditioned Lanczos quadrature
    estimate of logdet(P^-1 A) + logdet(P), detached; the value probes
    ``Z`` must be ~ N(0, P). The gradient is the Hutchinson surrogate
    mean_k (A^-1 z)' A(theta) z with A^-1 z detached, over ``probes_grad``
    (E[z z'] = I; Rademacher) when given, else ``Z``:
    ``val + (s - s.detach())``, whose value is ``val`` to the bit. Called
    with gradients disabled it returns the value alone and skips the
    surrogate's CG solve (what the JAX package's compiled value leaves out).
    ``stats`` (a dict), when given, gets the Lanczos steps and CG iterations
    added under ``lanczos_steps`` and ``grad_cg_iters``; the two halves are
    timed scopes (``utils/timer``)."""
    want_grad = torch.is_grad_enabled()
    with torch.no_grad():
        with timed("cg: Lanczos", sync=True):
            alphas, betas = lanczos_tridiag(matvec_of_theta, Z,
                                            num_lanczos_steps, precond_solve)
            Pz = precond_solve(Z) if precond_solve is not None else Z
            z_norms_sq = torch.sum(Z * Pz, dim=0)
            val = _logdet_from_tridiag(alphas, betas, z_norms_sq)
            if precond_logdet is not None:
                val = val + precond_logdet
        if stats is not None:
            stats["lanczos_steps"] = stats.get("lanczos_steps", 0) \
                + num_lanczos_steps
        if not want_grad:
            return val
        Zg = probes_grad if probes_grad is not None else Z
        with timed("cg: gradient CG", sync=True):
            Ainv_Zg, it = pcg(matvec_of_theta, Zg, precond_solve, tol=cg_tol,
                              max_iter=cg_max_iter)
    if stats is not None:
        stats["grad_cg_iters"] = stats.get("grad_cg_iters", 0) + it
    # mean_k z' A^-1 A(theta) z: its value is a constant (= n in
    # expectation), its theta-derivative the estimate of tr(A^-1 dA)
    surrogate = torch.mean(torch.sum(Ainv_Zg * matvec_of_theta(Zg), dim=0))
    return val + (surrogate - surrogate.detach())


class JacobiPreconditioner(NamedTuple):
    d: torch.Tensor

    def solve(self, R):
        return R / (self.d[:, None] if R.dim() == 2 else self.d)

    def logdet(self):
        return torch.sum(torch.log(self.d))

    def sample_probes(self, generator: torch.Generator,
                      num_probes: int) -> torch.Tensor:
        e = normal_probes(generator, self.d.shape[0], num_probes,
                          self.d.dtype)
        return torch.sqrt(self.d)[:, None] * e


class LowRankDiagPreconditioner(NamedTuple):
    """P = U U' + diag(d): Woodbury solve, exact log-determinant and probes
    ~ N(0, P) (the JAX package's ``LowRankDiagPreconditioner``; the
    reference's FITC / ``predictive_process_plus_diagonal``
    preconditioner)."""
    U: torch.Tensor           # [n, r]
    d: torch.Tensor           # [n]
    chol_inner: torch.Tensor  # chol(I_r + U' diag(1/d) U)

    @staticmethod
    def create(U: torch.Tensor, d: torch.Tensor):
        inner = (U / d[:, None]).T @ U
        inner.diagonal().add_(1.0)
        return LowRankDiagPreconditioner(U, d, torch.linalg.cholesky(inner))

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """P^-1 R for R [n] or [n, k]."""
        dd = self.d[:, None] if R.dim() == 2 else self.d
        Rd = R / dd
        inner = self.U.T @ Rd
        sol = torch.cholesky_solve(inner[:, None] if R.dim() == 1 else inner,
                                   self.chol_inner)
        corr = self.U @ (sol[:, 0] if R.dim() == 1 else sol)
        return Rd - corr / dd

    def logdet(self) -> torch.Tensor:
        return (2.0 * torch.sum(torch.log(torch.diagonal(self.chol_inner)))
                + torch.sum(torch.log(self.d)))

    def probes_from(self, e_r: torch.Tensor, e_n: torch.Tensor):
        """U e_r + sqrt(d) e_n ~ N(0, P) from standard normals e_r [r, k]
        and e_n [n, k]."""
        return self.U @ e_r.to(self.U.dtype) + torch.sqrt(self.d)[:, None] \
            * e_n.to(self.U.dtype)

    def sample_probes(self, generator: torch.Generator,
                      num_probes: int) -> torch.Tensor:
        """Probes ~ N(0, P), so the preconditioned Lanczos quadrature is
        unbiased for logdet(A) - logdet(P); the normals are drawn in
        float64 (e_r, then e_n), so every dtype sees the same vectors."""
        n, r = self.U.shape
        e_r = normal_probes(generator, r, num_probes)
        e_n = normal_probes(generator, n, num_probes)
        return self.probes_from(e_r, e_n)


def nystrom_preconditioner(matvec: Callable, n: int, rank: int,
                           generator: Optional[torch.Generator] = None,
                           dtype=torch.float64, shift_floor: float = 1e-10,
                           omega: Optional[torch.Tensor] = None
                           ) -> LowRankDiagPreconditioner:
    """Randomised-Nystrom low-rank + diagonal preconditioner of an SPD A
    (Frangella-Tropp-Udell; the JAX package's replacement for the
    reference's sequential pivoted-Cholesky / FITC preconditioners):
    ``rank`` products A V sketch A's dominant eigenspace, giving
    P = delta I + U diag(lam - delta)_+ U' with delta = max(lam_rank,
    ``shift_floor``) — a :class:`LowRankDiagPreconditioner`. The sketch
    ``omega`` [n, rank] is standard normal, drawn in float64 from
    ``generator`` unless given; ``matvec`` takes [n, rank]."""
    if omega is None:
        omega = normal_probes(generator, n, rank)
    omega, _ = torch.linalg.qr(omega.to(dtype))
    Y = matvec(omega)
    nu = math.sqrt(n) * 1e-7 * torch.linalg.norm(Y)
    Yn = Y + nu * omega
    S = omega.T @ Yn
    S = 0.5 * (S + S.T)
    S.diagonal().add_(1e-12)
    C, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0 or not bool(torch.isfinite(C).all()):
        # parameters a line search overshot to (a non-finite operator):
        # a NaN preconditioner, so the NLL is NaN and the search backs off,
        # as the JAX package's NaN factor does (one host read a build)
        eye = torch.eye(rank, dtype=dtype, device=Y.device)
        return LowRankDiagPreconditioner(
            torch.zeros((n, rank), dtype=dtype, device=Y.device),
            torch.full((n,), math.nan, dtype=dtype, device=Y.device), eye)
    B = torch.linalg.solve_triangular(C, Yn.T, upper=False).T
    Ub, s, _ = torch.linalg.svd(B, full_matrices=False)
    lam = torch.clamp(s * s - nu, min=0.0)
    delta = torch.clamp(lam[-1], min=shift_floor)
    U_s = Ub * torch.sqrt(torch.clamp(lam - delta, min=0.0))[None, :]
    return LowRankDiagPreconditioner.create(
        U_s, delta * torch.ones(n, dtype=dtype, device=Y.device))


def _pre_solve(pre_diag: torch.Tensor, pre_U: Optional[torch.Tensor]):
    """The solve of the preconditioner given by tensors: Jacobi on
    ``pre_diag``, or U U' + diag(``pre_diag``) with ``pre_U``."""
    if pre_U is None:
        return JacobiPreconditioner(pre_diag).solve
    return LowRankDiagPreconditioner.create(pre_U, pre_diag).solve


class _PCGImplicit(torch.autograd.Function):

    @staticmethod
    def forward(ctx, B, mv_of_theta, pre_diag, pre_U, tol, max_iter, stats,
                *theta):
        with torch.no_grad():
            X, it = pcg(lambda V: mv_of_theta(theta, V), B,
                        _pre_solve(pre_diag, pre_U), tol, max_iter)
        if stats is not None:
            stats["implicit_cg_iters"] = stats.get("implicit_cg_iters",
                                                   0) + it
        ctx.save_for_backward(X, pre_diag, pre_U, *theta)
        ctx.mv_of_theta, ctx.tol, ctx.max_iter = mv_of_theta, tol, max_iter
        ctx.stats = stats
        return X

    @staticmethod
    def backward(ctx, X_bar):
        X, pre_diag, pre_U, *theta = ctx.saved_tensors
        mv = ctx.mv_of_theta
        with torch.no_grad():
            lam, it = pcg(lambda V: mv(theta, V), X_bar,
                          _pre_solve(pre_diag, pre_U), ctx.tol, ctx.max_iter)
        if ctx.stats is not None:
            ctx.stats["implicit_adjoint_cg_iters"] = ctx.stats.get(
                "implicit_adjoint_cg_iters", 0) + it
        needs = ctx.needs_input_grad[7:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(theta, needs)]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(ag.grad(mv(leaves, X), wrt,
                               grad_outputs=-lam,
                               allow_unused=True)
                         if wrt else ())
        g_theta = [next(grads) if t.requires_grad else None for t in leaves]
        return (lam if ctx.needs_input_grad[0] else None, None, None, None,
                None, None, None, *g_theta)


def pcg_implicit(mv_of_theta: Callable, theta, B: torch.Tensor,
                 pre_diag: torch.Tensor, tol: float = 1e-8,
                 max_iter: int = 1000, pre_U: Optional[torch.Tensor] = None,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """X = A(theta)^-1 B by preconditioned CG, with implicit
    differentiation (the JAX package's ``pcg_implicit``):
    ``mv_of_theta(theta, V)`` is the SPD product, differentiable in the
    tensors of the tuple ``theta``. The preconditioner is Jacobi on
    ``pre_diag``, or U U' + diag(``pre_diag``) with ``pre_U`` = U [n, r]
    (both taken as constants). The backward solves one adjoint system
    A lam = X_bar and returns d theta = -VJP_theta(A(theta) X)[lam],
    dB = lam — no graph is kept through the CG iterations. ``stats`` (a
    dict), when given, gets the CG iterations added under
    ``implicit_cg_iters`` and ``implicit_adjoint_cg_iters``."""
    return _PCGImplicit.apply(
        B, mv_of_theta, pre_diag.detach(),
        None if pre_U is None else pre_U.detach(), tol, max_iter, stats,
        *theta)


def _split_half_estimate(gq: torch.Tensor, gp: torch.Tensor,
                         gx: torch.Tensor) -> torch.Tensor:
    """The optimal-c estimate of one parameter leaf from per-probe
    gradients gq, gp [k, ...] and the exact d logdet P, gx: c pooled over
    the leaf's entries, estimated on one half of the probes and applied to
    the other, both ways, averaged (unbiased, every probe used)."""
    def pooled_c(q, p):
        dq, dp = q - q.mean(0), p - p.mean(0)
        cov = torch.sum(torch.mean(dq * dp, 0))
        var = torch.sum(torch.mean(dp * dp, 0))
        return cov / torch.clamp(var, min=1e-30)

    half = gq.shape[0] // 2
    qa, qb, pa, pb = gq[:half], gq[half:], gp[:half], gp[half:]
    est_b = qb.mean(0) - pooled_c(qa, pa) * (pb.mean(0) - gx)
    est_a = qa.mean(0) - pooled_c(qb, pb) * (pa.mean(0) - gx)
    return 0.5 * (est_a + est_b)


class _LogdetVR(torch.autograd.Function):
    """logdet A(theta) by preconditioned Lanczos; its backward is the
    optimal-c variance-reduced trace estimate (see
    :func:`stochastic_logdet_grad_vr`)."""

    @staticmethod
    def forward(ctx, spec, *theta):
        mv_A, mv_P, logdet_P, Z, steps, solve, cg_tol, cg_max_iter, stats \
            = spec
        with torch.no_grad():
            def mv(V):
                return mv_A(theta, V)
            with timed("cg: Lanczos", sync=True):
                alphas, betas = lanczos_tridiag(mv, Z, steps, solve)
                V = solve(Z)
                val = _logdet_from_tridiag(alphas, betas,
                                           torch.sum(Z * V, dim=0))
            with timed("cg: gradient CG", sync=True):
                U, it = pcg(mv, Z, solve, tol=cg_tol, max_iter=cg_max_iter)
            val = val + logdet_P(theta)
        if stats is not None:
            stats["lanczos_steps"] = stats.get("lanczos_steps", 0) + steps
            stats["grad_cg_iters"] = stats.get("grad_cg_iters", 0) + it
        ctx.spec = spec
        ctx.save_for_backward(U, V, *theta)
        return val

    @staticmethod
    def backward(ctx, lam):
        mv_A, mv_P, logdet_P = ctx.spec[:3]
        U, V, *theta = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(theta, needs)]
            wrt = [t for t in leaves if t.requires_grad]
            if not wrt:
                return (None,) + (None,) * len(theta)

            def grads(out):
                gs = ag.grad(out, wrt, allow_unused=True)
                return [torch.zeros_like(t) if g is None else g
                        for g, t in zip(gs, wrt)]

            per_q, per_p = [], []
            for j in range(U.shape[1]):
                u, v = U[:, j:j + 1], V[:, j:j + 1]
                per_q.append(grads(torch.sum(u * mv_A(leaves, v))))
                per_p.append(grads(torch.sum(v * mv_P(leaves, v))))
            g_exact = grads(logdet_P(leaves))
        out, i = [], 0
        for t in leaves:
            if not t.requires_grad:
                out.append(None)
                continue
            gq = torch.stack([g[i] for g in per_q])
            gp = torch.stack([g[i] for g in per_p])
            out.append(lam * _split_half_estimate(gq, gp, g_exact[i]))
            i += 1
        return (None, *out)


def stochastic_logdet_grad_vr(matvec_A: Callable, matvec_P: Callable,
                              logdet_P: Callable, theta, Z: torch.Tensor,
                              num_lanczos_steps: int = 50,
                              precond_solve: Optional[Callable] = None,
                              cg_tol: float = 1e-2, cg_max_iter: int = 1000,
                              stats: Optional[dict] = None) -> torch.Tensor:
    """Stochastic logdet(A(theta)) with OPTIMAL-C variance-reduced gradients
    (the JAX package's ``stochastic_logdet_grad_vr``; reference
    ``CalcOptimalC`` / ``CalcOptimalCVectorized``, ``CG_utils.h:399,413``;
    arXiv:2310.12000 §3.3). The preconditioner P(theta) is a control
    variate: with probes z ~ N(0, P),

        tr(A^-1 dA) ~ mean_k dq_k - c (mean_k dp_k - d logdet P),
        q_k = z_k' A^-1 A(theta) P^-1 z_k,  p_k = z_k' P^-1 P(theta) P^-1 z_k,

    c = Cov(dq, dp) / Var(dp) pooled over each leaf's entries, estimated on
    one half of the probes and applied to the other (both ways). The value
    is the preconditioned Lanczos estimate plus ``logdet_P(theta)``.
    ``matvec_A(theta, V)``, ``matvec_P(theta, V)`` and ``logdet_P(theta)``
    are differentiable in the tensors of the tuple ``theta``; the backward
    takes one autograd pass per probe and product (k of each), so it suits
    moderate n and k."""
    solve = precond_solve if precond_solve is not None else (lambda r: r)
    spec = (matvec_A, matvec_P, logdet_P, Z, num_lanczos_steps, solve,
            cg_tol, cg_max_iter, stats)
    return _LogdetVR.apply(spec, *theta)
