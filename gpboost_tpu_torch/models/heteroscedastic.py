"""Two-latent-set Fisher-Laplace engine for ``gaussian_heteroscedastic``
(PyTorch port of the JAX package's ``models/heteroscedastic.py``).

The model (reference ``likelihoods.h:258-268``, ``num_sets_re_ = 2``):

    y_i ~ N(mu_i, v_i),   mu_i = F1_i + b1_i,   log v_i = F2_i + b2_i,

with two independent latent random-effect sets (b1 for the mean, b2 for the
log-variance), each with its own covariance parameters. The log-likelihood
is not concave jointly in (mu, log v), so the reference forces the
``fisher_laplace`` approximation (``likelihoods.h:262``): mode finding and
the marginal likelihood's log-determinant use the EXPECTED information,
block-diagonal across the two sets —

    W1 = E[-d2 ll / d mu^2]      = exp(-log v)      (``likelihoods.h:9960``)
    W2 = E[-d2 ll / d (log v)^2] = 1/2,   cross term 0,

so every Newton step is two independent n x n solves; only the score couples
the sets (``likelihoods.h:9267``). The module works on latent precision
matrices Q_k = Sigma_k^-1, the Vecchia parametrisation.

Gradients w.r.t. (Q1, Q2, F1, F2) come from implicit differentiation of the
joint mode equation with the TRUE 2x2-per-observation Hessian
(``likelihoods.h:9951``) — :class:`_FindMode`'s backward, one [2n, 2n]
solve — composed with autograd of the Fisher-Laplace objective.
"""
from __future__ import annotations

import math

import torch

from gpboost_tpu_torch.utils import autograd as ag

LOG_2PI = math.log(2.0 * math.pi)

MAX_NEWTON_IT = 1000
# Fisher scoring converges linearly (the information is approximate), so
# the stop rule is part of the numerical specification: the reference stops
# when the objective changes by < 1e-8 * |psi| (``CheckConvergenceMode
# Finding``, likelihoods.h:11820, :12723) and evaluates the log-determinant
# at that slightly under-converged mode; the golden NLLs match only with
# the same rule
NEWTON_TOL = 1e-8
MAX_HALVING = 60


def loglik(y, loc1, loc2):
    """Elementwise log N(y | loc1, exp(loc2))."""
    r = y - loc1
    return -0.5 * (LOG_2PI + loc2 + r * r * torch.exp(-loc2))


def score(y, loc1, loc2):
    """(d ll / d loc1, d ll / d loc2) elementwise."""
    r = y - loc1
    s1 = r * torch.exp(-loc2)
    return s1, 0.5 * (s1 * r - 1.0)


def fisher_w(loc2):
    """Expected information blocks (W1, W2); the cross term is zero."""
    return torch.exp(-loc2), torch.full_like(loc2, 0.5)


def hessian_blocks(y, loc1, loc2):
    """True negative-Hessian blocks (h11, h12, h22) per observation."""
    e = torch.exp(-loc2)
    r = y - loc1
    return e, r * e, 0.5 * r * r * e


def _mode(Q1, Q2, y, F1, F2):
    """Fisher-scoring Newton with step halving on the joint objective; the
    stop rule of the JAX package (one host read of the objective per
    trial step)."""

    def objective(b1, b2):
        return float(torch.sum(loglik(y, F1 + b1, F2 + b2))
                     - 0.5 * torch.dot(b1, Q1 @ b1)
                     - 0.5 * torch.dot(b2, Q2 @ b2))

    b1 = torch.zeros_like(y)
    b2 = torch.zeros_like(y)
    psi = objective(b1, b2)
    for _ in range(MAX_NEWTON_IT):
        s1, s2 = score(y, F1 + b1, F2 + b2)
        w1, w2 = fisher_w(F2 + b2)
        d1 = torch.linalg.solve(Q1 + torch.diag(w1), s1 - Q1 @ b1)
        d2 = torch.linalg.solve(Q2 + torch.diag(w2), s2 - Q2 @ b2)
        t = 1.0
        val = objective(b1 + d1, b2 + d2)
        k = 0
        while (val < psi or math.isnan(val)) and k < MAX_HALVING:
            t *= 0.5
            val = objective(b1 + t * d1, b2 + t * d2)
            k += 1
        b1, b2 = b1 + t * d1, b2 + t * d2
        conv = abs(val - psi) < NEWTON_TOL * (abs(psi) + 1e-10)
        psi = val
        if conv:
            break
    return b1, b2


class _FindMode(torch.autograd.Function):
    """Joint posterior mode (b1, b2) of sum ll(y; F1 + b1, F2 + b2)
    - b1'Q1 b1 / 2 - b2'Q2 b2 / 2, differentiable w.r.t. (Q1, Q2, F1, F2):
    the adjoint of the mode equation g = [Q1 b1 - s1; Q2 b2 - s2] = 0 with
    the true coupled Hessian (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, Q1, Q2, y, F1, F2):
        b1, b2 = _mode(Q1, Q2, y, F1, F2)
        ctx.save_for_backward(Q1, Q2, y, F1, F2, b1, b2)
        return b1, b2

    @staticmethod
    def backward(ctx, v1, v2):
        Q1, Q2, y, F1, F2, b1, b2 = ctx.saved_tensors
        n = b1.shape[0]
        h11, h12, h22 = hessian_blocks(y, F1 + b1, F2 + b2)
        J = torch.zeros((2 * n, 2 * n), dtype=Q1.dtype, device=Q1.device)
        J[:n, :n] = Q1 + torch.diag(h11)
        J[n:, n:] = Q2 + torch.diag(h22)
        ii = torch.arange(n, device=Q1.device)
        J[ii, n + ii] = h12
        J[n + ii, ii] = h12
        lam = torch.linalg.solve(J, torch.cat([v1, v2]))
        l1, l2 = lam[:n], lam[n:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True)
                      for x in (Q1, Q2, F1, F2)]
            s1, s2 = score(y, leaves[2] + b1, leaves[3] + b2)
            g1 = leaves[0] @ b1 - s1
            g2 = leaves[1] @ b2 - s2
            gQ1, gQ2, gF1, gF2 = ag.grad(
                (g1, g2), leaves, grad_outputs=(-l1, -l2), allow_unused=True)
        zero = torch.zeros_like
        return (gQ1 if gQ1 is not None else zero(Q1),
                gQ2 if gQ2 is not None else zero(Q2), None,
                gF1 if gF1 is not None else zero(F1),
                gF2 if gF2 is not None else zero(F2))


def find_mode(Q1, Q2, y, F1, F2):
    return _FindMode.apply(Q1, Q2, y, F1, F2)


def nll(Q1, Q2, logdet_Q1, logdet_Q2, y, F1, F2):
    """Fisher-Laplace negative log marginal likelihood,

    -(ll(mode) - sum_k b_k'Q_k b_k / 2)
    + sum_k [logdet(Q_k + W_k) - logdet Q_k] / 2,

    W_k the Fisher information blocks at the mode."""
    b1, b2 = find_mode(Q1, Q2, y, F1, F2)
    ll = torch.sum(loglik(y, F1 + b1, F2 + b2))
    quad = torch.dot(b1, Q1 @ b1) + torch.dot(b2, Q2 @ b2)
    w1, w2 = fisher_w(F2 + b2)
    _, ld1 = torch.linalg.slogdet(Q1 + torch.diag(w1))
    _, ld2 = torch.linalg.slogdet(Q2 + torch.diag(w2))
    return -(ll - 0.5 * quad) + 0.5 * (ld1 - logdet_Q1 + ld2 - logdet_Q2)


def posterior_sets(Q1, Q2, y, F1, F2):
    """((b1, w1), (b2, w2)): the mode and the Fisher weights of each set,
    for the prediction."""
    b1, b2 = find_mode(Q1, Q2, y, F1, F2)
    w1, w2 = fisher_w(F2 + b2)
    return (b1, w1), (b2, w2)
