"""Full-scale Vecchia (VIF) approximation: inducing points + a Vecchia
residual (PyTorch port of ``gpboost_tpu/models/fsva_model.py``; reference
``gp_approx="full_scale_vecchia"``, ``re_model_template.h:4647``,
Gyger/Furrer/Sigrist arXiv:2405.14492):

    Psi = U S^-1 U' + Lambda,  U = K_nm [n, k],  S = K_mm,
    Lambda = Vecchia(K - U S^-1 U' (+ nugget I)),  Lambda^-1 = B' D^-1 B.

Every solve is Woodbury over one [k, k] Cholesky; a Lambda^-1 product is
``ops/vecchia.py::precision_product`` (gather-only transpose and backward on
CUDA) in column chunks (``ops/vecchia.py::col_chunk``), and the residual
factors come
from ``build_factors_residual``, whose low-rank products gather and whose
backward gathers too — no float atomics on the card, so a fit or a training
gives the same bits every run. No kernel of its own: the JAX package builds
these factors in plain XLA too, so the Vecchia kernels never launch here.

Neighbours: Euclidean (default) or by residual correlation
(``full_scale_vecchia_correlation_based``, ``Vecchia_utils.cpp:1254``),
redetermined from the parameters at power-of-2 evaluations of a fit.
Other likelihoods: the Laplace approximation, dense ([n, n], n <= 8192 with
``matrix_inversion_method="cholesky"``) or iterative (Newton-CG mode with an
implicit backward; logdet(Sigma) exact, logdet(Sigma^-1 + W) split into a
stochastic Lanczos part logdet(Q + W) and an exact [k, k] part).

The model holds C >= 1 equal-size clusters (cluster-major rows, per-cluster
inducing points [C, k, d]): C = 1 for a plain model, C > 1 when
``cluster_ids`` batches its clusters (:meth:`stack`, Gaussian only).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models.laplace import (_aux_arg, _aux_val,
                                              _laplace_nll_from_sigma,
                                              _response_moments, find_mode,
                                              mode_vjp, newton_mode)
from gpboost_tpu_torch.models.fitc_model import (gls_coef, grad_wrt_F,
                                                 log_scale_value_and_grad)
from gpboost_tpu_torch.models.predvar import sim_pred_mean_var
from gpboost_tpu_torch.models.vecchia_model import (DENSE_LAPLACE_MAX_N,
                                                    _PermuteRows)
from gpboost_tpu_torch.ops import cg as cgops
from gpboost_tpu_torch.ops import fitc as fops
from gpboost_tpu_torch.ops import vecchia as vops
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.ops.inducing import select_inducing_points
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.timer import timed

LOG_2PI = math.log(2.0 * math.pi)
# above this many entries of K_po [n_p, n] the Gaussian variances are
# simulated (the JAX package's rule)
SIM_VAR_MIN_ENTRIES = 50_000_000
PRED_CHUNK = 2048
# prediction points whose Laplace variances one multi-column CG solves
PRED_VAR_CHUNK = 256
_CORR_CHUNK = 512
_FSVA_PRECOND = ("", "default", "fitc", "vifdu",
                 "predictive_process_plus_diagonal")

# what the iterative FSVA-Laplace path did since the last reset: Newton
# steps, CG iterations of the mode finder and of its adjoint, of the k-column
# solve of the exact log-determinant term, Lanczos steps, gradient CG
FSVA_COUNTS: Counter = Counter()


def _sigma_inv_pieces(q_mv, u, l_mm):
    """(sigma_inv_mv, li_u, l_M) for one cluster: Sigma^-1 x = Q x - (Q U)
    M^-1 U' Q x, M = S + U' Q U (differentiable)."""
    li_u = q_mv(u)
    l_M = fops.cholesky(l_mm @ l_mm.T + u.T @ li_u)

    def sigma_inv_mv(x):
        t = q_mv(x)
        x2 = t if t.dim() == 2 else t[:, None]
        out = x2 - li_u @ torch.cholesky_solve(u.T @ x2, l_M)
        return out if t.dim() == 2 else out[:, 0]

    return sigma_inv_mv, li_u, l_M


def _sigma_inv_diag(diag_q, li_u, l_M):
    """diag(Sigma^-1) = diag(Q) - rowsum((Q U) L_M^-T)^2."""
    X = torch.linalg.solve_triangular(l_M, li_u.T, upper=False)
    return diag_q - torch.sum(X * X, dim=0)


class _FindModeCGFSVA(torch.autograd.Function):
    """Matrix-free FSVA posterior mode: :func:`newton_mode` on
    Sigma^-1 b = d1(y, F + b), each step a Jacobi-PCG solve with
    Sigma^-1 + W (tol 1e-6); implicit backward through :func:`mode_vjp`
    with an adjoint CG solve (tol 1e-8) — the JAX package's
    ``_find_mode_cg_fsva``."""

    @staticmethod
    def forward(ctx, a, d, u, l_mm, F, aux, model, y):
        fam = lk.get_family(model.likelihood)
        q_mv = model._q_mv(a, d)
        with torch.no_grad(), timed("FSVA Laplace: mode (Newton-CG)",
                                    sync=True):
            si_mv, li_u, l_M = _sigma_inv_pieces(q_mv, u, l_mm)
            diag_si = _sigma_inv_diag(model._diag_q(a, d), li_u, l_M)
            b = newton_mode(fam, y, F, _aux_val(aux), si_mv,
                            _si_solve(si_mv, diag_si, 1e-6, "mode_cg_iters"),
                            FSVA_COUNTS)
        ctx.save_for_backward(a, d, u, l_mm, F, aux, y, b)
        ctx.model = model
        return b

    @staticmethod
    def backward(ctx, v):
        a, d, u, l_mm, F, aux, y, b = ctx.saved_tensors
        model = ctx.model
        fam = lk.get_family(model.likelihood)
        with torch.no_grad():
            si_mv, li_u, l_M = _sigma_inv_pieces(model._q_mv(a, d), u, l_mm)
            diag_si = _sigma_inv_diag(model._diag_q(a, d), li_u, l_M)

        def qb(a_, d_, u_, l_mm_):
            return _sigma_inv_pieces(model._q_mv(a_, d_), u_, l_mm_)[0](b)

        with timed("FSVA Laplace: mode adjoint CG", sync=True):
            out = mode_vjp(fam, y, b, v,
                           _si_solve(si_mv, diag_si, 1e-8, "adjoint_cg_iters"),
                           qb, (a, d, u, l_mm, F, aux),
                           ctx.needs_input_grad[:6])
        return (*out, None, None)


def _si_solve(si_mv, diag_si, tol, count):
    """(w, rhs) -> (Sigma^-1 + W)^-1 rhs by CG, Jacobi on diag + w."""
    def solve(w, rhs):
        pre_d = torch.clamp(diag_si + w, min=1e-10)
        x, it = cgops.pcg(lambda V: si_mv(V) + vops._cols(w, V) * V, rhs,
                          lambda r: r / vops._cols(pre_d, r), tol=tol,
                          max_iter=1000)
        FSVA_COUNTS[count] += it
        return x
    return solve


class FSVAGP:
    """State of a full-scale-Vecchia GP: ordering, neighbours (rows in the
    permuted order; C equal-size clusters one after the other) and inducing
    points [C, k, d]."""

    def __init__(self, coords: np.ndarray, cov_fn: CovFunction,
                 num_neighbors: int = 30, num_ind_points: int = 200,
                 ind_points_selection: str = "kmeans++",
                 ordering: str = "none", seed: int = 0,
                 cover_tree_radius: float = 1.0,
                 likelihood: str = "gaussian",
                 neighbor_selection: str = "nearest",
                 dtype=torch.float64, device="cuda"):
        coords = np.asarray(coords, dtype=np.float64)
        n = coords.shape[0]
        self.device = resolve_device(device)
        self.dtype = dtype
        self.n = n
        self.C = 1
        self.cov_fn = cov_fn
        self.likelihood = likelihood
        self.num_neighbors = min(num_neighbors, n - 1)
        self.num_neighbors_pred = 2 * self.num_neighbors
        self.neighbor_selection = neighbor_selection
        self.seed_rand_vec_trace = 1
        self.coords = torch.as_tensor(coords, dtype=dtype, device=self.device)
        self.ind_points = select_inducing_points(
            coords, num_ind_points, ind_points_selection, seed,
            cover_tree_radius=cover_tree_radius,
            device=self.device).to(dtype)[None]
        self._corr_neighbors_pars = None
        self._probe_cache = None
        self._set_perm(vops.apply_ordering(n, ordering, seed))
        self._set_neighbors(
            vops.find_neighbors(self.coords_perm, self.num_neighbors)
            if neighbor_selection == "nearest" else None)

    def _set_perm(self, perm):
        self.perm = np.asarray(perm)
        self.inv_perm = np.argsort(self.perm)
        self._perm_t = torch.as_tensor(self.perm, dtype=torch.long,
                                       device=self.device)
        self._inv_perm_t = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                           device=self.device)
        self.coords_perm = self.coords[self._perm_t].contiguous()

    def _set_neighbors(self, neighbors):
        """Neighbours and, on CUDA, their incoming slices (the gather-only
        transpose)."""
        self.neighbors = neighbors
        self._incoming = (vops.build_incoming_sliced(neighbors)
                          if neighbors is not None and neighbors.is_cuda
                          else None)

    def load_structure(self, perm: np.ndarray, neighbors: np.ndarray):
        """Take another model's ordering and neighbours (numpy; rows in the
        permuted order, -1 padding), to compare two implementations on the
        same conditioning sets."""
        self._set_perm(np.asarray(perm))
        nb = torch.as_tensor(np.asarray(neighbors).astype(np.int32),
                             device=self.device).contiguous()
        self.num_neighbors = nb.shape[1]
        self._corr_neighbors_pars = None
        self._set_neighbors(nb)

    @classmethod
    def stack(cls, subs) -> "FSVAGP":
        """One model over equal-size clusters (Gaussian FSVAGPs with
        Euclidean neighbours): rows cluster after cluster, each in its own
        sub-model's order, neighbour indices offset to the stacked rows
        (a block-diagonal Lambda^-1), inducing points [C, k, d]. ``perm``
        maps a stacked row to its row in the clusters' concatenated data
        order."""
        out = cls.__new__(cls)
        out.__dict__.update(subs[0].__dict__)
        n_c = subs[0].n
        out.C, out.n = len(subs), n_c * len(subs)
        out.coords = torch.cat([s.coords for s in subs])
        out.ind_points = torch.cat([s.ind_points for s in subs])
        out._set_perm(np.concatenate([c * n_c + s.perm
                                      for c, s in enumerate(subs)]))
        out._set_neighbors(torch.cat([
            torch.where(s.neighbors >= 0, s.neighbors + c * n_c, -1)
            for c, s in enumerate(subs)]).to(torch.int32).contiguous())
        return out

    @property
    def redetermines_neighbors(self) -> bool:
        """Whether a fit redetermines the neighbours (at power-of-2
        evaluations)."""
        return self.neighbor_selection != "nearest"

    # ---- structure ------------------------------------------------------
    def _gp_pars(self, cov_pars_full):
        """The GP's parameters of a full parameter vector (gaussian: the
        nugget first)."""
        return cov_pars_full[1:] if self.likelihood == "gaussian" \
            else cov_pars_full

    def _lr(self, gp_pars):
        """(U [n, k], L_mm [C, k, k], P = (L_mm^-1 K_mn)' [n, k]) over the
        permuted rows, cluster by cluster."""
        k = self.ind_points.shape[1]
        cp = self.coords_perm.view(self.C, -1, self.coords_perm.shape[1])
        u = fops.cov_between(self.cov_fn, gp_pars, cp, self.ind_points)
        l_mm = fops.cholesky(fops.inducing_cov(self.cov_fn, gp_pars,
                                               self.ind_points))
        v = torch.linalg.solve_triangular(l_mm, u.mT, upper=False)
        return u.reshape(-1, k), l_mm, v.mT.reshape(-1, k)

    def _factors(self, gp_pars, nugget):
        """(U, L_mm, A, D) of the residual Vecchia, with the nugget
        (gaussian) or without (latent)."""
        u, l_mm, P = self._lr(gp_pars)
        a, d = vops.build_factors_residual(
            self.cov_fn, gp_pars, self.coords_perm, self.neighbors, P,
            nugget, nugget is not None, slices=self._incoming)
        return u, l_mm, a, d

    def _q_mv(self, a, d):
        nb, sl = self.neighbors, self._incoming
        step = vops.col_chunk(*nb.shape)
        return lambda V: vops.precision_product(a, d, V, nb, sl,
                                                col_chunk=step)

    def _diag_q(self, a, d):
        return vops.precision_diag(a, self.neighbors, d, self._incoming)

    def _by_cluster(self, x):
        """[n, q] -> [C, n_c, q]."""
        return x.reshape(self.C, -1, x.shape[-1])

    def _woodbury(self, u, l_mm, li_u):
        """Cholesky of M = S + U' Lambda^-1 U, cluster by cluster."""
        U, LU = self._by_cluster(u), self._by_cluster(li_u)
        return fops.cholesky(l_mm @ l_mm.mT + U.mT @ LU)

    def _permuted(self, x):
        """x [n] (or [n, q]) in the permuted row order; differentiable
        with a gather backward."""
        return _PermuteRows.apply(x, self._perm_t, self._inv_perm_t)

    # ---- Gaussian -------------------------------------------------------
    def nll_gaussian(self, cov_pars: torch.Tensor, y: torch.Tensor,
                     fixed_part: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Woodbury NLL: logdet(Psi) = logdet(Lambda) + logdet(M) -
        logdet(S) (``re_model_template.h:2698-2712``); cov_pars =
        [nugget, sigma1^2, range, ...]."""
        r = self._permuted(y if fixed_part is None else y - fixed_part)
        u, l_mm, a, d = self._factors(cov_pars[1:], cov_pars[0])
        q_mv = self._q_mv(a, d)
        li_r = q_mv(r)
        li_u = q_mv(u)
        l_M = self._woodbury(u, l_mm, li_u)
        w = self._by_cluster(u).mT @ self._by_cluster(li_r[:, None])
        t = torch.linalg.solve_triangular(l_M, w, upper=False)
        quad = torch.dot(r, li_r) - torch.sum(t * t)
        logdet = (torch.sum(torch.log(d))
                  + 2.0 * torch.sum(fops._log_diag_sum(l_M))
                  - 2.0 * torch.sum(fops._log_diag_sum(l_mm)))
        return 0.5 * (quad + logdet + self.n * LOG_2PI)

    def nll_gaussian_value(self, cov_pars, y, fixed_part=None):
        with torch.no_grad():
            return self.nll_gaussian(cov_pars, y, fixed_part)

    def _vg_gaussian(self, th, y, fp):
        return log_scale_value_and_grad(self.nll_gaussian, th, y, fp)

    def _psi_solver(self, cov_pars):
        """R -> Psi^-1 R (permuted rows, R [n] or [n, q]), factorising
        once."""
        u, l_mm, a, d = self._factors(cov_pars[1:], cov_pars[0])
        q_mv = self._q_mv(a, d)
        li_u = q_mv(u)
        l_M = self._woodbury(u, l_mm, li_u)
        U = self._by_cluster(u)

        def solve(R):
            R2 = R if R.dim() == 2 else R[:, None]
            li_R = q_mv(R2)
            sol = torch.cholesky_solve(U.mT @ self._by_cluster(li_R), l_M)
            out = li_R - q_mv((U @ sol).reshape(R2.shape))
            return out if R.dim() == 2 else out[:, 0]
        return solve

    def psi_inv_mul(self, cov_pars, R):
        """Psi^-1 R for R [n] or [n, q] in the permuted row order."""
        return self._psi_solver(cov_pars)(R)

    def psi_inv_resid(self, cov_pars, R):
        """Psi^-1 R in the data's row order."""
        return self.psi_inv_mul(cov_pars, R[self._perm_t])[self._inv_perm_t]

    def wls_coef(self, cov_pars, y, X, fixed_effects=None):
        return gls_coef(self.psi_inv_resid, cov_pars, y, X, fixed_effects)

    # ---- neighbours by residual correlation ------------------------------
    def ensure_neighbors(self, cov_pars_full):
        """(Re)determine the residual-correlation neighbours at these
        parameters (``RedetermineNearestNeighborsVecchiaInducingPointsFITC``);
        no-op for Euclidean neighbours or unchanged parameters."""
        if not self.redetermines_neighbors:
            return
        pars = np.asarray(cov_pars_full, dtype=np.float64)
        if (self._corr_neighbors_pars is not None
                and np.allclose(pars, self._corr_neighbors_pars)):
            return
        gp_pars = self._gp_pars(torch.as_tensor(pars, dtype=self.dtype,
                                                device=self.device))
        with torch.no_grad():
            _, _, P = self._lr(gp_pars)
            self._set_neighbors(self._find_neighbors_residual_corr(gp_pars,
                                                                   P))
        self._corr_neighbors_pars = pars

    def _find_neighbors_residual_corr(self, gp_pars, P):
        """The m previous points with the largest squared residual
        correlation (``find_nearest_neighbors_Vecchia_FSA_fast``,
        ``Vecchia_utils.cpp:311``), rows in chunks of 512."""
        n, m = self.n, self.num_neighbors
        coords = self.coords_perm
        r_diag = torch.clamp(gp_pars[0] - torch.sum(P * P, dim=1), min=1e-12)
        sq = torch.sum(coords * coords, dim=1)
        cols = torch.arange(n, device=self.device)[None, :]
        out = []
        for s in range(0, n, _CORR_CHUNK):
            rows, Pr = coords[s:s + _CORR_CHUNK], P[s:s + _CORR_CHUNK]
            dist = torch.sqrt(torch.clamp(
                torch.sum(rows * rows, 1)[:, None] + sq[None, :]
                - 2.0 * (rows @ coords.T), min=0.0))
            r_rows = self.cov_fn.cov_matrix(gp_pars, dist=dist) - Pr @ P.T
            rd = torch.clamp(gp_pars[0] - torch.sum(Pr * Pr, dim=1),
                             min=1e-12)
            corr2 = (r_rows * r_rows) / (rd[:, None] * r_diag[None, :])
            row_ids = torch.arange(s, s + rows.shape[0],
                                   device=self.device)[:, None]
            corr2 = torch.where(cols < row_ids, corr2, -math.inf)
            val, idx = torch.topk(corr2, m, dim=1)
            out.append(torch.where(torch.isfinite(val), idx, -1))
        return torch.cat(out).to(torch.int32).contiguous()

    # ---- Gaussian prediction ---------------------------------------------
    def _cross(self, gp_pars, coords_pred):
        """K_po [p, n] against the permuted training points."""
        return self.cov_fn.cov_matrix(
            gp_pars, dist=fops.distance(coords_pred, self.coords_perm))

    def predict_gaussian(self, cov_pars, y, coords_pred, fixed_part=None,
                         predict_response=True, predict_var=False,
                         nsim_var_pred=None):
        """Prediction with the exact cross-covariance K_po and the
        approximate Psi^-1 (JAX ``fsva_model.py:540``): mean K_po Psi^-1 r,
        variance sigma1^2 - diag(K_po Psi^-1 K_op) (+ nugget) — exact by
        chunks of prediction points, or simulated
        (:func:`sim_pred_mean_var`) when ``nsim_var_pred`` is set or K_po
        would hold more than ``SIM_VAR_MIN_ENTRIES`` entries."""
        r = y if fixed_part is None else y - fixed_part
        gp_pars = cov_pars[1:]
        solve = self._psi_solver(cov_pars)
        pi_r = solve(r[self._perm_t])
        n_p = coords_pred.shape[0]
        if predict_var and (nsim_var_pred is not None
                            or n_p * self.n > SIM_VAR_MIN_ENTRIES):
            mean, quad = sim_pred_mean_var(
                lambda cpc: self._cross(gp_pars, cpc), coords_pred, solve,
                pi_r, int(nsim_var_pred or 1000),
                seed=self.seed_rand_vec_trace)
            var = gp_pars[0] - quad
        else:
            means, quads = [], []
            for s in range(0, n_p, PRED_CHUNK):
                k_po = self._cross(gp_pars, coords_pred[s:s + PRED_CHUNK])
                means.append(k_po @ pi_r)
                if predict_var:
                    quads.append(torch.sum(k_po * solve(k_po.T).T, dim=1))
            mean = torch.cat(means)
            if not predict_var:
                return mean, None
            var = gp_pars[0] - torch.cat(quads)
        if predict_response:
            var = var + cov_pars[0]
        return mean, torch.clamp(var, min=0.0)

    # ---- non-Gaussian (Laplace) ------------------------------------------
    def _latent_sigma_dense(self, gp_pars):
        """Dense latent Sigma = U S^-1 U' + B^-1 D B^-T (n <= 8192)."""
        _, _, P = self._lr(gp_pars)
        a, d = vops.build_factors_residual(
            self.cov_fn, gp_pars, self.coords_perm, self.neighbors, P, None,
            False, slices=self._incoming)
        n, nb = self.n, self.neighbors
        mask = nb >= 0
        rows = torch.arange(n, device=self.device)[:, None].expand_as(nb)
        A = torch.zeros((n, n), dtype=a.dtype, device=self.device).index_put(
            (rows[mask], nb[mask].long()), a[mask])
        eye = torch.eye(n, dtype=a.dtype, device=self.device)
        Binv = torch.linalg.solve_triangular(eye - A, eye, upper=False)
        return P @ P.T + Binv @ (d[:, None] * Binv.T)

    def _laplace_inputs(self, y, fixed_part, aux_pars):
        yp = y[self._perm_t]
        Fp = (torch.zeros(self.n, dtype=self.dtype, device=self.device)
              if fixed_part is None else self._permuted(fixed_part))
        return yp, Fp, _aux_arg(aux_pars, yp)

    def nll_laplace(self, cov_pars, y, aux_pars, fixed_part=None):
        """Dense Laplace NLL; cov_pars = [sigma1^2, range, ...]."""
        yp, Fp, aux = self._laplace_inputs(y, fixed_part, aux_pars)
        return _laplace_nll_from_sigma(self.likelihood,
                                       self._latent_sigma_dense(cov_pars),
                                       yp, Fp, _aux_val(aux))

    def laplace_probes(self, num_rand_vec_trace: int, seed: int):
        """(e, Zg) [n, k]: standard-normal value probes (scaled by the
        preconditioner's square root) and Rademacher gradient probes, in
        float64 from a ``torch.Generator`` seeded with ``seed`` on the
        model's device, cast to its dtype; the same in every evaluation,
        kept between calls."""
        key = (int(num_rand_vec_trace), int(seed))
        if self._probe_cache is None or self._probe_cache[0] != key:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            e = cgops.normal_probes(gen, self.n, key[0])
            zg = cgops.rademacher_probes(gen, self.n, key[0])
            self._probe_cache = (key, e.to(self.dtype), zg.to(self.dtype))
        return self._probe_cache[1], self._probe_cache[2]

    def nll_laplace_iterative(self, cov_pars, y, aux_pars, fixed_part=None,
                              num_rand_vec_trace: int = 50,
                              lanczos_steps: int = 50, cg_tol: float = 1e-3,
                              cg_max_iter: int = 1000,
                              seed_rand_vec_trace: int = 1,
                              preconditioner: str = "",
                              piv_chol_rank: int = 50):
        """Laplace NLL with a matrix-free Newton-CG mode and a split
        log-determinant (the reference's CGVIF path,
        ``CG_utils.h:208-282``): logdet(Sigma) = sum log D + logdet(M) -
        logdet(S) exactly; logdet(Sigma^-1 + W) = logdet(Q + W) +
        logdet(I_k - M^-1 U'Q (Q + W)^-1 Q U), the first by stochastic
        Lanczos with a Jacobi preconditioner on diag(Q) + W, the second
        exact given one k-column CG solve (``pcg_implicit``). The
        preconditioner names 'fitc' (default) and 'vifdu' both map to this
        scheme, as in the JAX package; others raise."""
        if str(preconditioner or "").lower() not in _FSVA_PRECOND:
            raise ValueError(
                f"unsupported cg_preconditioner_type {preconditioner!r} for "
                "full_scale_vecchia; options: fitc (default) or vifdu")
        e, Zg = self.laplace_probes(num_rand_vec_trace, seed_rand_vec_trace)
        return self._nll_laplace_iterative(cov_pars, y, aux_pars, fixed_part,
                                           e, Zg, lanczos_steps, cg_tol,
                                           cg_max_iter)

    def _mode_iterative(self, cov_pars, y, aux_pars, fixed_part):
        """(b, yp, Fp, aux, (u, l_mm, a, d)) with the Newton-CG mode."""
        yp, Fp, aux = self._laplace_inputs(y, fixed_part, aux_pars)
        with timed("FSVA Laplace: latent factors", sync=True):
            u, l_mm, a, d = self._factors(cov_pars, None)
        l0 = l_mm[0]
        b = _FindModeCGFSVA.apply(a, d, u, l0, Fp, aux, self, yp)
        return b, yp, Fp, aux, (u, l0, a, d)

    def _nll_laplace_iterative(self, cov_pars, y, aux_pars, fixed_part, e,
                               Zg, lanczos_steps, cg_tol, cg_max_iter):
        """:meth:`nll_laplace_iterative` with the probes given (``e``
        standard normal, ``Zg`` Rademacher, [n, k], permuted rows)."""
        fam = lk.get_family(self.likelihood)
        b, yp, Fp, aux, (u, l_mm, a, d) = self._mode_iterative(
            cov_pars, y, aux_pars, fixed_part)
        auxv = _aux_val(aux)
        loc = Fp + b
        w = -fam.d2_loc(yp, loc, auxv)
        loglik = torch.sum(fam.log_lik(yp, loc, auxv))
        q_mv = self._q_mv(a, d)
        si_mv, li_u, l_M = _sigma_inv_pieces(q_mv, u, l_mm)
        quad = torch.dot(b, si_mv(b))
        with torch.no_grad():
            pre_d = torch.clamp(self._diag_q(a, d) + w, min=1e-10)
        pre = cgops.JacobiPreconditioner(pre_d)
        nb, sl = self.neighbors, self._incoming
        step = vops.col_chunk(*nb.shape)

        def qw_of(theta, V):
            a_, d_, w_ = theta
            return (vops.precision_product(a_, d_, V, nb, sl, col_chunk=step)
                    + vops._cols(w_, V) * V)

        with timed("FSVA Laplace: k-column CG", sync=True):
            X = cgops.pcg_implicit(qw_of, (a, d, w), li_u, pre_d,
                                   min(cg_tol, 1e-6), cg_max_iter,
                                   stats=FSVA_COUNTS)
        k = u.shape[1]
        M = l_mm @ l_mm.T + u.T @ li_u
        K2 = torch.eye(k, dtype=M.dtype, device=M.device) \
            - torch.linalg.solve(M, li_u.T @ X)
        _, logdet_k = torch.linalg.slogdet(K2)
        logdet_qw = cgops.stochastic_logdet_grad(
            lambda V: qw_of((a, d, w), V), None,
            torch.sqrt(pre_d)[:, None] * e, lanczos_steps, pre.solve,
            pre.logdet(), cg_tol, cg_max_iter, probes_grad=Zg,
            stats=FSVA_COUNTS)
        logdet_sigma = (torch.sum(torch.log(d))
                        + 2.0 * fops._log_diag_sum(l_M)
                        - 2.0 * fops._log_diag_sum(l_mm))
        return -(loglik - 0.5 * quad
                 - 0.5 * (logdet_qw + logdet_k + logdet_sigma))

    def grad_F_laplace(self, cov_pars, y, aux_pars, fixed_part,
                       iterative: Optional[bool] = None, **iter_kwargs):
        """d NLL / dF (the LaGaBoost gradient) by autograd: the dense
        Laplace NLL up to ``DENSE_LAPLACE_MAX_N`` points, the iterative one
        above (with ``nll_laplace_iterative``'s defaults unless
        ``iter_kwargs`` say otherwise)."""
        if iterative is None:
            iterative = self.n > DENSE_LAPLACE_MAX_N
        if iterative:
            return grad_wrt_F(lambda F: self.nll_laplace_iterative(
                cov_pars, y, aux_pars, F, **iter_kwargs), fixed_part)
        return grad_wrt_F(lambda F: self.nll_laplace(cov_pars, y, aux_pars,
                                                     F), fixed_part)

    def predict_laplace(self, cov_pars, y, aux_pars, coords_pred,
                        fixed_part=None, fixed_part_pred=None,
                        predict_response=True, predict_var=False,
                        iterative: bool = False):
        """Laplace prediction with the exact cross-covariance K_po: mean
        K_po d1, variance sigma1^2 - diag(K_po W (I + Sigma W)^-1 K_op).
        Dense (the JAX package's route) or, with ``iterative``, matrix-free:
        the Newton-CG mode and, for the variances,
        W (I + Sigma W)^-1 = W (Sigma^-1 + W)^-1 Sigma^-1 with a CG solve
        for ``PRED_VAR_CHUNK`` prediction points at a time."""
        fam = lk.get_family(self.likelihood)
        with torch.no_grad():
            if iterative:
                b, yp, Fp, aux, (u, l_mm, a, d) = self._mode_iterative(
                    cov_pars, y, aux_pars, fixed_part)
            else:
                yp, Fp, aux = self._laplace_inputs(y, fixed_part, aux_pars)
                sigma = self._latent_sigma_dense(cov_pars)
                b = find_mode(self.likelihood, sigma, yp, Fp, aux)
            auxv = _aux_val(aux)
            loc = Fp + b
            d1 = fam.d_loc(yp, loc, auxv)
            w = -fam.d2_loc(yp, loc, auxv)
            want_var = predict_var or predict_response
            if iterative and want_var:
                si_mv, li_u, l_M = _sigma_inv_pieces(self._q_mv(a, d), u,
                                                     l_mm)
                solve = _si_solve(si_mv, _sigma_inv_diag(
                    self._diag_q(a, d), li_u, l_M), 1e-8, "pred_cg_iters")
            elif want_var:
                M = sigma * w[None, :]
                M.diagonal().add_(1.0)
            means, quads = [], []
            n_p = coords_pred.shape[0]
            chunk = PRED_VAR_CHUNK if (iterative and want_var) else PRED_CHUNK
            for s in range(0, n_p, chunk):
                cross = self._cross(cov_pars, coords_pred[s:s + chunk])
                means.append(cross @ d1)
                if not want_var:
                    continue
                if iterative:
                    z = solve(w, si_mv(cross.T))
                else:
                    z = torch.linalg.solve(M, cross.T)
                quads.append(torch.sum(cross * (w[:, None] * z).T, dim=1))
            mean = torch.cat(means)
            var = None
            if want_var:
                var = torch.clamp(cov_pars[0] - torch.cat(quads), min=1e-12)
        if fixed_part_pred is not None:
            mean = mean + fixed_part_pred
        if predict_response:
            mr, vr = _response_moments(self.likelihood, mean, var, auxv)
            return mr, (vr if predict_var else None)
        return mean, (var if predict_var else None)
