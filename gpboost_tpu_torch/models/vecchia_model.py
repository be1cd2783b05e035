"""Vecchia-approximated GP model paths (Gaussian response + Vecchia-Laplace).

Dispatch target of ``GPModel`` for ``gp_approx="vecchia"``. Mirrors the
reference's ``CreateREComponentsVecchia`` (``Vecchia_utils.cpp:1060``) +
the Gaussian and Laplace Vecchia branches of ``REModelTemplate``.

Cost structure: factor build O(n m^3) (one per-row Cholesky), solves
O(n m). Gaussian models inside the kernel gate (float32, nugget among the
parameters, exponential / Matern 0.5, 1.5, 2.5 / gaussian, isotropic or ARD)
go through the fused kernels of ``ops/kernels/vecchia_factors.py``; every
other model differentiates the plain factor build with ``torch.autograd``.

Non-Gaussian likelihoods (Vecchia-Laplace; the JAX package's
``vecchia_model.py:62-200``, ``:892-1422``): the latent process has no
nugget, so its factors stay outside the kernel gate, as in the JAX package,
and come from the plain build with autograd. The posterior mode is found by
Newton-CG (``_FindModeCG``, implicit backward); the NLL is either dense
(:meth:`VecchiaGP.nll_laplace`, exact, n <= 8192) or matrix-free
(:meth:`VecchiaGP.nll_laplace_iterative`: CG + stochastic Lanczos
log-determinant, the reference fork's iterative method). Every precision
product goes through ``ops/vecchia.py::precision_product``, whose backward
is made of gathers; on CUDA its transpose is the sliced gather too, so no
float atomics run on the path, forward or backward.

The iterative route's preconditioner is the Jacobi one on diag(Q) + W
(``cg_preconditioner_type`` "vadu", the default) or a randomised-Nystrom
low-rank plus diagonal one sketched from Q + W ("pivoted_cholesky",
"fitc", "nystrom", "predictive_process_plus_diagonal", of rank
``piv_chol_rank``); with the Jacobi one the log-determinant's gradient can
take the optimal-c control variate (``variance_reduction``).

GP random coefficients (``rand_coef_data``, the SVC build of
``ops/vecchia.py::build_factors_svc``) and ``cluster_ids`` (``cluster_codes``:
the neighbour searches take a row's own cluster only, -1 padding where a
cluster has fewer earlier points) ride on the same structure; the
random-coefficient build stays outside the kernel gate, the cluster-masked
neighbour matrix inside it. The prediction types of ``vecchia_pred_type``
(``predict_gaussian_cond_all`` / ``_pred_first`` / ``_latent_vecchia``),
the heteroscedastic two-set model (``nll_het`` / ``predict_het``, through
``models/heteroscedastic.py``) and the latent-process parametrisation
(``nugget_in_pars=False``: ``gp_approx="vecchia_latent"``) follow the JAX
package.

The time orderings (``"time"``, ``"time_random_space"``) sort by
coordinate 0 and need a space-time covariance, as in the JAX package.
Not ported (ROADMAP.md): the banded compute layout ``BandedB``, row sharding
over several GPUs (item 20).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models import heteroscedastic as het
from gpboost_tpu_torch.models.laplace import (_aux_arg, _aux_val,
                                              _response_moments, dense_solve,
                                              find_mode_prec, mode_vjp,
                                              newton_mode)
from gpboost_tpu_torch.ops import cg as cgops
from gpboost_tpu_torch.ops import vecchia as vops
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vkern
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.timer import timed

# cg_preconditioner_type resolution (reference names, basic.py:5147-5159):
# 'diag' is the Jacobi preconditioner on diag(Q) + W, 'low_rank' the
# randomised-Nystrom low-rank + diagonal one (ops/cg.py)
_PRECOND_DIAG = ("", "default", "vadu", "sigma_inv_plus_btwb", "jacobi",
                 "vecchia_approximation_with_diagonal_update")
_PRECOND_LOW_RANK = ("pivoted_cholesky", "fitc", "nystrom",
                     "predictive_process_plus_diagonal")
# the dense Laplace route holds [n, n] matrices; above this the iterative one
DENSE_LAPLACE_MAX_N = 8192
# posterior draws of predict_laplace_sim per chunk ([n, chunk] solves)
SIM_CHUNK = 128

# what the Vecchia-Laplace path did since the last reset (read by the chip
# run's breakdown): Newton steps, the Newton loop's host reads (objective
# values), CG iterations of the mode finder, of its adjoint solve, of the
# log-determinant's gradient solve and of the posterior draws, Lanczos steps
LAPLACE_COUNTS: Counter = Counter()


def _resolve_precond_name(name) -> str:
    """'diag' (Jacobi on diag(Q) + W) or 'low_rank' (the randomised-Nystrom
    stand-in for the reference's pivoted-Cholesky / FITC preconditioners).
    Unknown names raise — a requested preconditioner is never silently
    ignored."""
    s = str(name or "").lower()
    if s in _PRECOND_DIAG:
        return "diag"
    if s in _PRECOND_LOW_RANK:
        return "low_rank"
    raise ValueError(
        f"unsupported cg_preconditioner_type {name!r} for the Vecchia "
        f"approximation; options: {_PRECOND_DIAG[2]} (default, diagonal of "
        f"the vadu matrix) or one of {_PRECOND_LOW_RANK} (randomised-"
        "Nystrom low-rank + diagonal)")


def _mode_cg_tols(dtype):
    """(cg tol, max_iter) for the mode-finder solves: float32 CG stalls
    below ~1e-5 relative residual, float64 keeps the tight tolerance."""
    if dtype == torch.float32:
        return 1e-5, 400
    return 1e-6, 1000


def _cg_solve(a, d, vec, tol, max_iter, count):
    """(w, rhs) -> (Q + W)^-1 rhs by Jacobi-preconditioned CG (on
    diag(Q) + W), its iterations added to ``LAPLACE_COUNTS[count]``."""
    nb, sl = vec.neighbors, vec._incoming
    diag_q = vops.precision_diag(a, nb, d, sl)

    def solve(w, rhs):
        pre_d = torch.clamp(diag_q + w, min=1e-10)[:, None]
        x, it = cgops.pcg(
            lambda V: vops.precision_product(a, d, V, nb, sl)
            + w[:, None] * V, rhs, lambda r: r / pre_d, tol=tol,
            max_iter=max_iter)
        LAPLACE_COUNTS[count] += it
        return x
    return solve


class _FindModeCG(torch.autograd.Function):
    """Matrix-free posterior mode: :func:`newton_mode` with each Newton
    step solved by CG (one host read a step besides CG's stop tests and
    the halvings), differentiable w.r.t. (a, d, F, aux) by
    :func:`mode_vjp` with an adjoint CG solve (the JAX package's
    ``_find_mode_cg`` and ``_find_mode_cg_bwd``)."""

    @staticmethod
    def forward(ctx, a, d, F, aux, vec, y):
        cg_tol, cg_maxit = _mode_cg_tols(d.dtype)
        with timed("Laplace: mode (Newton-CG)", sync=True):
            b = newton_mode(lk.get_family(vec.likelihood), y, F,
                            _aux_val(aux), vec._q_mv(a, d),
                            _cg_solve(a, d, vec, cg_tol, cg_maxit,
                                      "mode_cg_iters"), LAPLACE_COUNTS)
        ctx.save_for_backward(a, d, F, aux, y, b)
        ctx.vec = vec
        return b

    @staticmethod
    def backward(ctx, v):
        a, d, F, aux, y, b = ctx.saved_tensors
        vec = ctx.vec
        nb, sl = vec.neighbors, vec._incoming
        cg_tol, cg_maxit = _mode_cg_tols(d.dtype)
        adj_tol = cg_tol * (1e-2 if d.dtype != torch.float32 else 1.0)
        adjoint = _cg_solve(a.detach(), d.detach(), vec, adj_tol, cg_maxit,
                            "adjoint_cg_iters")

        def solve(w, rhs):
            with timed("Laplace: mode adjoint CG", sync=True):
                return adjoint(w, rhs)
        out = mode_vjp(
            lk.get_family(vec.likelihood), y, b, v, solve,
            lambda a_, d_: vops.precision_product(a_, d_, b, nb, sl),
            (a, d, F, aux), ctx.needs_input_grad[:4])
        return out[0], out[1], out[2], out[3], None, None


class _PermuteRows(torch.autograd.Function):
    """x[perm] whose backward is the gather g[inv_perm] (autograd's own
    backward of an index is an accumulating scatter)."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.inv_perm = inv_perm
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.inv_perm], None, None


class VecchiaGP:
    """State holder for a Vecchia-approximated GP component.

    Static structure (ordering permutation + neighbor indices) is computed
    once at construction — like the reference, neighbors stay fixed during
    optimization (ARD kernels redetermine them in the scaled space, see
    :meth:`ensure_neighbors`).
    """

    def __init__(self, coords: np.ndarray, cov_fn: CovFunction,
                 num_neighbors: int = 20, ordering: str = "random",
                 seed: int = 0, likelihood: str = "gaussian",
                 num_neighbors_pred: Optional[int] = None,
                 nugget_in_pars: bool = True,
                 rand_coef_data: Optional[np.ndarray] = None,
                 cluster_codes: Optional[np.ndarray] = None,
                 dtype=torch.float64, device="cuda"):
        time_col = None
        if ordering in ("time", "time_random_space"):
            # the reference errors when the kernel is not space-time
            # (Vecchia_utils.cpp:1133-1135); time is coordinate 0
            if cov_fn.cov_fct_type not in ("matern_space_time",
                                           "exponential_space_time",
                                           "space_time_gneiting"):
                raise ValueError(
                    f"'vecchia_ordering' is '{ordering}' but the "
                    "'cov_function' is not a space-time covariance function")
            time_col = np.asarray(coords, dtype=np.float64)[:, 0]
        self.device = resolve_device(device)
        coords = np.asarray(coords, dtype=np.float64)
        n = coords.shape[0]
        self.n = n
        self.cov_fn = cov_fn
        self.likelihood = likelihood
        self.num_neighbors = min(num_neighbors, n - 1)
        # reference default: num_neighbors_pred = 2 * num_neighbors
        # (re_model_template.h:299; NOT capped at n — the search pads short
        # candidate sets with -1)
        self.num_neighbors_pred = num_neighbors_pred or 2 * num_neighbors
        self.dtype = dtype
        self.nugget_in_pars = bool(nugget_in_pars)
        self.coords = torch.as_tensor(coords, dtype=dtype, device=self.device)
        # independent realisations per cluster_ids: cluster codes [n] in the
        # original row order (the neighbour searches mask other codes)
        self.codes = (None if cluster_codes is None else torch.as_tensor(
            np.asarray(cluster_codes).astype(np.int32), device=self.device))
        # GP random coefficients (SVC): z[:, 0] = 1 is the base GP, further
        # columns multiply coefficient GPs with their own [var, range]
        self.z = self.z_orig = None
        if rand_coef_data is not None:
            if not cov_fn.is_isotropic:
                raise NotImplementedError(
                    "GP random coefficients under Vecchia require an "
                    "isotropic covariance function")
            zr = np.asarray(rand_coef_data, np.float64).reshape(n, -1)
            self.z_orig = torch.as_tensor(
                np.concatenate([np.ones((n, 1)), zr], axis=1), dtype=dtype,
                device=self.device)
        self._ard_neighbors_pars = None
        self._probe_cache = None
        self._set_structure(vops.apply_ordering(n, ordering, seed, time_col),
                            None)
        # (shape code, is_ard) when the fused kernels serve this model
        self._kernel_shape = self._kernel_shape_code()

    def _set_structure(self, perm: np.ndarray, neighbors) -> None:
        self.perm = np.asarray(perm)
        self.inv_perm = np.argsort(self.perm)
        self._perm_t = torch.as_tensor(self.perm, dtype=torch.long,
                                       device=self.device)
        self._inv_perm_t = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                           device=self.device)
        self.coords_perm = self.coords[self._perm_t].contiguous()
        self.codes_perm = (None if self.codes is None
                           else self.codes[self._perm_t].contiguous())
        if self.z_orig is not None:
            self.z = self.z_orig[self._perm_t].contiguous()
        if neighbors is None:
            neighbors = vops.find_neighbors(self.coords_perm,
                                            self.num_neighbors,
                                            codes=self.codes_perm)
        self._set_neighbors(neighbors)

    def _set_neighbors(self, neighbors) -> None:
        """The neighbour matrix and, on CUDA, its transpose: the incoming
        structure of the gather-only ``B' v`` (rebuilt whenever the
        neighbours change; the CPU route uses the plain scatter)."""
        self.neighbors = neighbors
        self._incoming = (vops.build_incoming_sliced(neighbors)
                          if neighbors.is_cuda else None)

    def load_structure(self, perm: np.ndarray, neighbors: np.ndarray) -> None:
        """Replace the ordering permutation and the neighbor matrix by given
        ones (numpy arrays: ``perm`` [n], ``neighbors`` [n, m] with -1
        padding, rows in permuted order) — carries the structure of another
        model over, so that two implementations can be compared on
        identical conditioning sets whatever their top-k tie-breaking. With
        cluster codes they follow the new permutation, and a row may hold
        indices of its own cluster only."""
        perm = np.asarray(perm)
        nb = np.asarray(neighbors)
        if perm.shape != (self.n,) or not np.array_equal(
                np.sort(perm), np.arange(self.n)):
            raise ValueError("perm: expected a permutation of range(n)")
        if nb.ndim != 2 or nb.shape[0] != self.n:
            raise ValueError("neighbors: expected an [n, m] matrix")
        if nb.max(initial=-1) >= self.n or np.any(
                nb >= np.arange(self.n)[:, None]):
            raise ValueError(
                "neighbors: row i may only hold indices < i (or -1)")
        if self.codes is not None:
            cp = self.codes.cpu().numpy()[perm]
            if np.any((nb >= 0) & (cp[np.maximum(nb, 0)] != cp[:, None])):
                raise ValueError(
                    "neighbors: a row may only hold indices of its own "
                    "cluster")
        self.num_neighbors = nb.shape[1]
        self._ard_neighbors_pars = None
        self._set_structure(perm, torch.as_tensor(
            nb.astype(np.int32), device=self.device).contiguous())

    def _kernel_shape_code(self):
        """(matern-shape code, is_ard) for the fused kernels, or None if
        the model/kernel combination is not eligible. The kernels build the
        response covariance (nugget among the parameters): the latent
        process of a non-Gaussian model, which has no nugget, stays outside
        the gate (the JAX package's ``_pallas_shape_code``), and so do the
        latent parametrisation and random coefficients; a cluster-masked
        neighbour matrix is inside it."""
        cf = self.cov_fn
        if (self.dtype != torch.float32 or self.likelihood != "gaussian"
                or not self.nugget_in_pars or self.z is not None):
            return None
        if cf.cov_fct_type in ("matern", "matern_ard"):
            for s in (0.5, 1.5, 2.5):
                if abs(cf.shape - s) < 1e-10:
                    return (s, cf.cov_fct_type == "matern_ard")
        if cf.cov_fct_type == "gaussian":
            return (-1.0, False)
        if cf.cov_fct_type == "gaussian_ard":
            return (-1.0, True)
        return None

    # ---- objective ------------------------------------------------------
    def _vg_gaussian(self, th, y, fp):
        """(NLL, dNLL/dtheta) at log-scale parameters ``th``; device tensors
        in, device tensors out."""
        r = y if fp is None else y - fp
        if self._kernel_shape is not None:
            # fused NLL + hand-derived gradient in one kernel pass
            shape_code, is_ard = self._kernel_shape
            return vkern.vecchia_nll_grad(
                th.to(torch.float32), self.coords_perm, self.neighbors,
                r.to(torch.float32)[self._perm_t], shape_code, ard=is_ard)
        lp = th.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            nll = self.nll_gaussian(torch.exp(lp), r)
            (grad,) = ag.grad(nll, lp)
        return nll.detach(), grad

    def _fit_psi_inv(self, th, r):
        """Psi^-1 r at the log-scale parameters ``th`` — the GPBoost
        pseudo-gradient solve, evaluated once at the end of a fit
        (``regression_objective.hpp:153-171`` role)."""
        return self.psi_inv_resid(torch.exp(th), r)

    def nll_gaussian_value(self, cov_pars, y, fixed_part=None):
        """NLL value without gradients: the fused factor kernel when the
        model is eligible, else the plain factor build."""
        if self._kernel_shape is not None:
            shape_code, is_ard = self._kernel_shape
            r = y if fixed_part is None else y - fixed_part
            cp = cov_pars.to(torch.float32)
            a, d_c = vkern.vecchia_factors(cp[1:], self.coords_perm,
                                           self.neighbors, cp[0], True,
                                           shape_code, ard=is_ard)
            return vops.vecchia_nll(a, d_c, self.neighbors,
                                    r.to(torch.float32)[self._perm_t])
        with torch.no_grad():
            return self.nll_gaussian(cov_pars, y, fixed_part)

    def ensure_neighbors(self, cov_pars_full: np.ndarray):
        """Redetermine neighbors in the SCALED coordinate space for ARD
        kernels (``RedetermineNearestNeighborsVecchia...``,
        ``re_model_template.h:4630-4656``: neighbor search happens in the
        transformed space where the kernel is isotropic, re-run when the
        range parameters change). No-op for isotropic kernels."""
        if self.cov_fn.is_isotropic or not self.cov_fn.has_coord_scaling:
            return
        pars = np.asarray(cov_pars_full, dtype=np.float64)
        gp_pars = pars[1:] if self.nugget_in_pars else pars
        if (self._ard_neighbors_pars is not None
                and np.allclose(gp_pars, self._ard_neighbors_pars)):
            return
        scaled = self.cov_fn.scale_coords(
            self.coords_perm, torch.as_tensor(gp_pars, dtype=self.dtype,
                                              device=self.device))
        self._set_neighbors(vops.find_neighbors(scaled, self.num_neighbors,
                                                codes=self.codes_perm))
        self._ard_neighbors_pars = gp_pars

    def _pred_neighbors(self, gp_pars, coords_pred, codes_pred=None):
        """Observed neighbors of prediction points (of the same cluster with
        ``codes_pred``); ARD kernels search in the scaled coordinate
        space."""
        codes = ({} if codes_pred is None
                 else dict(codes_pred=codes_pred, codes_obs=self.codes))
        if not self.cov_fn.is_isotropic and self.cov_fn.has_coord_scaling:
            return vops.find_neighbors_cross(
                self.cov_fn.scale_coords(coords_pred, gp_pars),
                self.cov_fn.scale_coords(self.coords, gp_pars),
                self.num_neighbors_pred, **codes)
        return vops.find_neighbors_cross(coords_pred, self.coords,
                                         self.num_neighbors_pred, **codes)

    # ---- Gaussian response-scale Vecchia ------------------------------
    def _pars_stack(self, gp_pars):
        """[C, p] per-component parameters of the random-coefficient
        build."""
        return gp_pars.reshape(self.z.shape[1], self.cov_fn.num_cov_par)

    def _zp_full(self, z_pred, n_p):
        """[n_p, C] prediction covariates with the leading ones column
        (zeros for the coefficient columns when none are given)."""
        ones = torch.ones((n_p, 1), dtype=self.dtype, device=self.device)
        if z_pred is None:
            rest = torch.zeros((n_p, self.z.shape[1] - 1), dtype=self.dtype,
                               device=self.device)
        else:
            rest = torch.as_tensor(
                np.asarray(z_pred, np.float64).reshape(n_p, -1),
                dtype=self.dtype, device=self.device)
        return torch.cat([ones, rest], dim=1)

    def _codes_tensor(self, codes_pred):
        return (None if codes_pred is None else torch.as_tensor(
            np.asarray(codes_pred).astype(np.int32), device=self.device))

    def _response_factors(self, cov_pars, nb):
        """(A, D) of the response covariance; cov_pars = [nugget, comps...]."""
        if self.z is not None:
            return vops.build_factors_svc(
                self.cov_fn, self._pars_stack(cov_pars[1:]), self.coords_perm,
                nb, self.z, cov_pars[0], True)
        return vops.build_factors(self.cov_fn, cov_pars[1:], self.coords_perm,
                                  nb, cov_pars[0], True)

    def nll_gaussian(self, cov_pars: torch.Tensor, y: torch.Tensor,
                     fixed_part: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """cov_pars = [nugget, var, range, ...]; Vecchia on Sigma + nugget I."""
        nb = self.neighbors
        r = y if fixed_part is None else y - fixed_part
        a, d = self._response_factors(cov_pars, nb)
        return vops.vecchia_nll(a, d, nb, r[self._perm_t])

    def psi_inv_resid(self, cov_pars, r):
        """Psi^-1 r via the response-scale Vecchia precision (matrix-free,
        original row order; r [n]) — the GPBoost pseudo-gradient and
        Newton-leaf solves (``regression_objective.hpp:153-171``). On CUDA
        the transpose ``B'`` is the gather-only one, so the result is the
        same bits on every call; on the CPU the plain scatter."""
        if self._kernel_shape is not None:
            # inside the kernel gate: the fused factor kernel, float32
            shape_code, is_ard = self._kernel_shape
            cp = cov_pars.to(torch.float32)
            a, d = vkern.vecchia_factors(cp[1:], self.coords_perm,
                                         self.neighbors, cp[0], True,
                                         shape_code, ard=is_ard)
            r = r.to(torch.float32)
        else:
            a, d = self._response_factors(cov_pars, self.neighbors)
        out = vops.precision_product(a, d, r[self._perm_t], self.neighbors,
                                     self._incoming)
        return out[self._inv_perm_t]

    def wls_coef(self, cov_pars, y, X, fixed_effects=None):
        """GLS coefficients with the Vecchia precision: solve
        (X'B'D^-1BX) beta = X'B'D^-1B y — all matrix-free O(n m p)."""
        yv = y if fixed_effects is None else y - fixed_effects
        nb = self.neighbors
        a, d = self._response_factors(cov_pars, nb)
        yp = yv[self._perm_t]
        Xp = X[self._perm_t]
        BX = torch.stack([vops.apply_B(a, nb, Xp[:, j])
                          for j in range(Xp.shape[1])], dim=1)
        By = vops.apply_B(a, nb, yp)
        Xw = BX / d[:, None]
        return torch.linalg.solve(BX.T @ Xw, Xw.T @ By)

    def predict_gaussian(self, cov_pars, y, coords_pred,
                         fixed_part=None, predict_response=True,
                         predict_var=False, z_pred=None, codes_pred=None):
        """Local-kriging prediction conditioning on observed neighbors (of
        the prediction point's cluster with ``codes_pred``; a cluster
        training never saw has none, so its points are at the prior).
        ``coords_pred`` is a tensor [n_p, d] on the model's device; ``z_pred``
        the random-coefficient covariates of the prediction points."""
        r = y if fixed_part is None else y - fixed_part
        nb_pred = self._pred_neighbors(cov_pars[1:], coords_pred,
                                       self._codes_tensor(codes_pred))
        if self.z is not None:
            mean, var = vops.predict_vecchia_response_svc(
                self.cov_fn, self._pars_stack(cov_pars[1:]), cov_pars[0],
                self.coords, coords_pred, nb_pred, self.z_orig,
                self._zp_full(z_pred, coords_pred.shape[0]), r,
                bool(predict_response))
            return mean, (var if predict_var else None)
        if self._kernel_shape is not None:
            # the fused factor kernel serves the PREDICTION build too
            # (row_coords = the prediction points)
            shape_code, is_ard = self._kernel_shape
            cp32 = cov_pars.to(torch.float32)
            a, d = vkern.vecchia_factors(
                cp32[1:], self.coords, nb_pred, cp32[0], True, shape_code,
                ard=is_ard,
                row_coords=coords_pred.to(torch.float32).contiguous())
            mean, var = vops.kriging_from_factors(
                a, d, nb_pred, r.to(torch.float32), cp32[0],
                bool(predict_response))
        else:
            mean, var = vops.predict_vecchia_response(
                self.cov_fn, cov_pars[1:], cov_pars[0], self.coords,
                coords_pred, nb_pred, r, bool(predict_response))
        return mean, (var if predict_var else None)

    def predict_gaussian_cond_all(self, cov_pars, y, coords_pred,
                                  fixed_part=None, predict_response=True,
                                  codes_pred=None, z_pred=None):
        """``order_obs_first_cond_all`` prediction: (mean, cov) with the full
        [n_p, n_p] predictive covariance; random coefficients through
        ``z_pred``, clusters through ``codes_pred``."""
        r = y if fixed_part is None else y - fixed_part
        if self.z is not None:
            return vops.predict_vecchia_cond_all_svc(
                self.cov_fn, self._pars_stack(cov_pars[1:]), cov_pars[0],
                self.coords, coords_pred, self.z_orig,
                self._zp_full(z_pred, coords_pred.shape[0]), r,
                self.num_neighbors_pred,
                predict_response=bool(predict_response))
        return vops.predict_vecchia_cond_all(
            self.cov_fn, cov_pars[1:], cov_pars[0], self.coords, coords_pred,
            r, self.num_neighbors_pred, codes_obs=self.codes,
            codes_pred=self._codes_tensor(codes_pred),
            predict_response=bool(predict_response))

    def predict_gaussian_pred_first(self, cov_pars, y, coords_pred,
                                    fixed_part=None, predict_response=True):
        """``order_pred_first``: one Vecchia approximation with the
        prediction points ordered first. Returns (mean, cov)."""
        if self.z is not None:
            raise NotImplementedError(
                "vecchia_pred_type='order_pred_first' is not implemented "
                "with GP random coefficients")
        if self.codes is not None:
            raise NotImplementedError(
                "vecchia_pred_type='order_pred_first' is not implemented "
                "with cluster_ids")
        r = y if fixed_part is None else y - fixed_part
        return vops.predict_vecchia_pred_first(
            self.cov_fn, cov_pars[1:], cov_pars[0], self.coords, coords_pred,
            r, self.num_neighbors_pred,
            predict_response=bool(predict_response))

    def predict_gaussian_latent_vecchia(self, cov_pars, y, coords_pred,
                                        fixed_part=None, cond_obs_only=True,
                                        predict_response=True):
        """``latent_order_obs_first_cond_obs_only`` / ``..._cond_all``:
        Vecchia on the latent process over the unique locations, its solves
        by CG (``LAPLACE_COUNTS["latent_cg_iters"]``). Returns (mean, var,
        cov)."""
        if self.z is not None:
            raise NotImplementedError(
                "The Vecchia approximation for latent process(es) is "
                "currently not implemented when having random coefficients")
        if self.codes is not None:
            raise NotImplementedError(
                "latent Vecchia prediction types are not implemented "
                "with cluster_ids")
        r = y if fixed_part is None else y - fixed_part
        return vops.predict_vecchia_latent(
            self.cov_fn, cov_pars[1:], cov_pars[0], self.coords, coords_pred,
            r, self.num_neighbors_pred, bool(cond_obs_only),
            predict_response=bool(predict_response), stats=LAPLACE_COUNTS)

    # ---- Vecchia-Laplace (non-Gaussian) -------------------------------
    def _latent_factors(self, cov_pars):
        """Latent-process factors (no nugget): Sigma^-1 ~ B' D^-1 B. The
        plain build with autograd, on the card too: the kernel gate needs
        the nugget among the parameters, as in the JAX package."""
        with timed("Laplace: latent factors", sync=True):
            if self.z is not None:
                return vops.build_factors_svc(
                    self.cov_fn, self._pars_stack(cov_pars), self.coords_perm,
                    self.neighbors, self.z, None, False)
            return vops.build_factors(self.cov_fn, cov_pars, self.coords_perm,
                                      self.neighbors, None, False)

    def _q_mv(self, a, d):
        """V -> Q V through :func:`vops.precision_product` (gather-only
        transpose and backward on CUDA)."""
        nb, sl = self.neighbors, self._incoming
        return lambda V: vops.precision_product(a, d, V, nb, sl)

    def _permuted(self, y, fixed_part):
        """(y, F) in the ordering's row order; F stays differentiable, its
        backward a gather."""
        yp = y[self._perm_t]
        Fp = (torch.zeros(self.n, dtype=self.dtype, device=self.device)
              if fixed_part is None else _PermuteRows.apply(
                  fixed_part, self._perm_t, self._inv_perm_t))
        return yp, Fp

    def _dense_precision(self, cov_pars):
        """Dense Sigma^-1 = B' D^-1 B (exact small-n path). Returns (Q, d).
        B is written entry by entry (each (row, neighbour) pair once, no
        accumulation)."""
        a, d = self._latent_factors(cov_pars)
        n = self.n
        nb = self.neighbors
        mask = nb >= 0
        rows = torch.arange(n, device=self.device)[:, None].expand_as(nb)
        A = torch.zeros((n, n), dtype=a.dtype, device=self.device).index_put(
            (rows[mask], nb[mask].long()), a[mask])
        Bmat = torch.eye(n, dtype=a.dtype, device=self.device) - A
        return Bmat.T @ (Bmat / d[:, None]), d

    def nll_laplace(self, cov_pars: torch.Tensor, y: torch.Tensor,
                    aux_pars, fixed_part=None) -> torch.Tensor:
        """Laplace-approximate NLL with the Vecchia latent precision
        (``FindModePostRandEffCalcMLLVecchia``, likelihoods.h:2765): dense
        logdet and solves (exact); cov_pars = [var, range, ...] (no nugget
        for non-Gaussian likelihoods). Differentiable in cov_pars, aux_pars
        and fixed_part. ``gaussian_heteroscedastic`` takes the two-set
        route (:meth:`nll_het`)."""
        if self.likelihood == "gaussian_heteroscedastic":
            return self.nll_het(cov_pars, y, fixed_part)
        fam = lk.get_family(self.likelihood)
        yp, Fp = self._permuted(y, fixed_part)
        Q, d = self._dense_precision(cov_pars)
        b = find_mode_prec(self.likelihood, Q, yp, Fp, aux_pars)
        loc = Fp + b
        w = -fam.d2_loc(yp, loc, aux_pars)
        loglik = torch.sum(fam.log_lik(yp, loc, aux_pars))
        quad = torch.dot(b, Q @ b)
        # logdet(Sigma^-1 + W) - logdet(Sigma^-1); logdet(Sigma^-1) = -sum log d
        _, ld1 = torch.linalg.slogdet(Q + torch.diag(w))
        ld0 = -torch.sum(torch.log(d))
        return -(loglik - 0.5 * quad - 0.5 * (ld1 - ld0))

    # ---- gaussian_heteroscedastic (two latent sets) ---------------------
    def _split_het(self, cov_pars):
        """A two-set parameter vector [set-0 pars, set-1 pars] (the
        reference's num_sets_re_ = 2) split in its sets."""
        k = self.cov_fn.num_cov_par
        return cov_pars[:k], cov_pars[k:]

    def _het_fixed_parts(self, fixed_part):
        """The stacked [2n] fixed effects as per-set (F1, F2) in the
        ordering's row order."""
        if fixed_part is None:
            z = torch.zeros(self.n, dtype=self.dtype, device=self.device)
            return z, z
        return (fixed_part[:self.n][self._perm_t],
                fixed_part[self.n:][self._perm_t])

    def nll_het(self, cov_pars, y, fixed_part=None):
        """Fisher-Laplace NLL of ``gaussian_heteroscedastic``: two latent
        sets with independent Vecchia priors (dense precisions)."""
        p1, p2 = self._split_het(cov_pars)
        Q1, d1 = self._dense_precision(p1)
        Q2, d2 = self._dense_precision(p2)
        F1, F2 = self._het_fixed_parts(fixed_part)
        return het.nll(Q1, Q2, -torch.sum(torch.log(d1)),
                       -torch.sum(torch.log(d2)), y[self._perm_t], F1, F2)

    def predict_het(self, cov_pars, y, coords_pred, fixed_part=None,
                    fixed_part_pred=None, predict_response=True,
                    predict_var=False):
        """Prediction of ``gaussian_heteroscedastic``: the latent outputs are
        the set-0 (mean) process; the response variance adds the expected
        noise variance E[exp(loc2)] = exp(mu2 + var2 / 2) (reference
        ``likelihoods.h:7660-7667``). ``fixed_part_pred`` is stacked [2 n_p]."""
        p1, p2 = self._split_het(cov_pars)
        Q1, _ = self._dense_precision(p1)
        Q2, _ = self._dense_precision(p2)
        F1, F2 = self._het_fixed_parts(fixed_part)
        (b1, w1), (b2, w2) = het.posterior_sets(Q1, Q2, y[self._perm_t], F1,
                                                F2)
        n_p = coords_pred.shape[0]
        mu1, var1 = self._posterior_set_pred(p1, Q1, b1, w1, coords_pred)
        mu2, var2 = self._posterior_set_pred(p2, Q2, b2, w2, coords_pred)
        if fixed_part_pred is not None:
            mu1 = mu1 + fixed_part_pred[:n_p]
            mu2 = mu2 + fixed_part_pred[n_p:]
        if predict_response:
            var_resp = var1 + torch.exp(mu2 + 0.5 * var2)
            return mu1, (var_resp if predict_var else None)
        return mu1, (var1 if predict_var else None)

    def _posterior_set_pred(self, cov_pars_k, Q, b_perm, w_perm,
                            coords_pred):
        """Posterior latent mean and variance of one set at the prediction
        points: kriging on the mode; prior - c_po (Sigma + W^-1)^-1 c_op with
        (Sigma + W^-1)^-1 = W (Q + W)^-1 Q."""
        nb_pred = self._pred_neighbors(cov_pars_k, coords_pred)
        mean, _ = vops.predict_vecchia_response(
            self.cov_fn, cov_pars_k, 0.0, self.coords, coords_pred, nb_pred,
            b_perm[self._inv_perm_t], False)
        c_po = self._cross_cov(cov_pars_k, coords_pred, self.coords_perm)
        z = torch.linalg.solve(Q + torch.diag(w_perm), Q @ c_po.T)
        quad = torch.einsum("pn,n,np->p", c_po, w_perm, z)
        return mean, torch.clamp(cov_pars_k[0] - quad, min=1e-12)

    def laplace_probes(self, num_rand_vec_trace: int, seed: int,
                       rank: int = 0):
        """(e, Zg) [n, k]: standard-normal value probes (scaled by the
        preconditioner's square root in :meth:`nll_laplace_iterative`) and
        Rademacher gradient probes, drawn in float64 from a
        ``torch.Generator`` on the model's device seeded with ``seed``, then
        cast to the model's dtype — so a float32 and a float64 model see the
        same probes. With ``rank`` > 0 also the low-rank preconditioner's
        draws from the same stream: (e, Zg, omega [n, rank], e_r
        [rank, k]), the Nystrom sketch and the low-rank half of the probes
        (e then serves as their diagonal half). The same seed gives the
        same draws in every evaluation (the reference's
        ``reuse_rand_vec_trace``); kept between calls."""
        key = (int(num_rand_vec_trace), int(seed), int(rank))
        if self._probe_cache is None or self._probe_cache[0] != key:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            k = key[0]
            draws = [cgops.normal_probes(gen, self.n, k),
                     cgops.rademacher_probes(gen, self.n, k)]
            if rank:
                draws += [cgops.normal_probes(gen, self.n, key[2]),
                          cgops.normal_probes(gen, key[2], k)]
            self._probe_cache = (key, tuple(t.to(self.dtype) for t in draws))
        return self._probe_cache[1]

    def nll_laplace_iterative(self, cov_pars, y, aux_pars, fixed_part=None,
                              num_rand_vec_trace: int = 50,
                              lanczos_steps: int = 50,
                              cg_tol: float = 1e-3, cg_max_iter: int = 1000,
                              seed_rand_vec_trace: int = 1,
                              variance_reduction: bool = False,
                              preconditioner: str = "",
                              piv_chol_rank: int = 50):
        """Laplace NLL with preconditioned CG + stochastic Lanczos logdet —
        the reference fork's iterative method (arXiv:2310.12000), O(n m k)
        per multi-RHS precision product, no dense [n, n] matrix.
        Differentiable in cov_pars, aux_pars and fixed_part (the gradient
        w.r.t. the log-determinant is the Hutchinson estimate over
        Rademacher probes, or with ``variance_reduction`` the optimal-c
        control-variate estimate over the value probes). Preconditioner
        (``preconditioner``, :func:`_resolve_precond_name`): Jacobi on
        diag(Q) + W, or the randomised-Nystrom low-rank + diagonal one of
        rank min(``piv_chol_rank``, n), sketched from Q + W with the factors
        detached; variance reduction takes the Jacobi one only, as in the
        JAX package."""
        low_rank = _resolve_precond_name(preconditioner) == "low_rank"
        if low_rank and variance_reduction:
            raise NotImplementedError(
                "optimal-c variance reduction is implemented for the 'vadu' "
                "(diagonal) preconditioner only, as in the JAX package")
        rank = min(int(piv_chol_rank), self.n) if low_rank else 0
        draws = self.laplace_probes(num_rand_vec_trace, seed_rand_vec_trace,
                                    rank)
        return self._nll_laplace_iterative(
            cov_pars, y, aux_pars, fixed_part, draws[0], draws[1],
            lanczos_steps, cg_tol, cg_max_iter,
            low_rank=draws[2:] if low_rank else None,
            variance_reduction=variance_reduction)

    def _nll_laplace_iterative(self, cov_pars, y, aux_pars, fixed_part, e,
                               Zg, lanczos_steps, cg_tol, cg_max_iter,
                               low_rank=None, variance_reduction=False):
        """:meth:`nll_laplace_iterative` with the draws given, in permuted
        row order: ``e`` [n, k] standard normal (value probes
        Z = sqrt(diag P) e under the Jacobi preconditioner), ``Zg`` [n, k]
        Rademacher (gradient probes); ``low_rank`` = (omega [n, r], e_r
        [r, k]) selects the Nystrom preconditioner sketched from omega, its
        value probes U e_r + sqrt(delta) e (the JAX package draws them as
        ``pre.sample_probes``)."""
        fam = lk.get_family(self.likelihood)
        a, d = self._latent_factors(cov_pars)
        yp, Fp = self._permuted(y, fixed_part)
        aux = _aux_arg(aux_pars, yp)
        b = _FindModeCG.apply(a, d, Fp, aux, self, yp)
        auxv = _aux_val(aux)
        loc = Fp + b
        w = -fam.d2_loc(yp, loc, auxv)
        loglik = torch.sum(fam.log_lik(yp, loc, auxv))
        q_mv = self._q_mv(a, d)
        quad = torch.dot(b, q_mv(b))

        def a_mv(V):
            return q_mv(V) + vops._cols(w, V) * V

        nb, sl = self.neighbors, self._incoming
        with torch.no_grad(), timed("cg: preconditioner", sync=True):
            if low_rank is not None:
                omega, e_r = low_rank
                q_sg = self._q_mv(a.detach(), d.detach())
                w_sg = w.detach()
                pre = cgops.nystrom_preconditioner(
                    lambda V: q_sg(V) + w_sg[:, None] * V, self.n,
                    omega.shape[1], dtype=self.dtype, omega=omega)
                Z = pre.probes_from(e_r, e)
            else:
                pre = cgops.JacobiPreconditioner(torch.clamp(
                    vops.precision_diag(a, nb, d, sl) + w, min=1e-10))
                Z = torch.sqrt(pre.d)[:, None] * e
            pre_logdet = pre.logdet()
        if variance_reduction:
            def p_diag(th):
                a_, d_, w_ = th
                return torch.clamp(vops.precision_diag(a_, nb, d_, sl) + w_,
                                   min=1e-10)

            logdet_A = cgops.stochastic_logdet_grad_vr(
                lambda th, V: vops.precision_product(th[0], th[1], V, nb, sl)
                + th[2][:, None] * V,
                lambda th, V: p_diag(th)[:, None] * V,
                lambda th: torch.sum(torch.log(p_diag(th))), (a, d, w), Z,
                lanczos_steps, pre.solve, cg_tol, cg_max_iter,
                stats=LAPLACE_COUNTS)
        else:
            logdet_A = cgops.stochastic_logdet_grad(
                a_mv, None, Z, lanczos_steps, pre.solve, pre_logdet, cg_tol,
                cg_max_iter, probes_grad=Zg, stats=LAPLACE_COUNTS)
        # logdet(Sigma^-1) = -sum log d (exact)
        logdet_ratio = logdet_A + torch.sum(torch.log(d))
        return -(loglik - 0.5 * quad - 0.5 * logdet_ratio)

    def num_cg_steps(self, gp_pars, y, preconditioner, piv_chol_rank, seed,
                     tol, max_iter, omega=None) -> int:
        """CG iterations of one solve Q x = y (the latent precision at
        ``gp_pars``, y in the ordering's row order) under the Jacobi
        diagonal of Q or, for a low-rank ``preconditioner``, the Nystrom
        one of rank min(``piv_chol_rank``, n) sketched from ``omega`` (by
        default standard normals from a ``torch.Generator`` seeded with
        ``seed``) — ``GPModel.get_num_cg_steps`` (JAX
        ``gp_model.py:508-540``)."""
        with torch.no_grad():
            a, d = self._latent_factors(gp_pars)
            mv = self._q_mv(a, d)
            if _resolve_precond_name(preconditioner) == "low_rank":
                rank = min(int(piv_chol_rank), self.n)
                if omega is None:
                    gen = torch.Generator(device=self.device).manual_seed(
                        int(seed))
                    omega = cgops.normal_probes(gen, self.n, rank)
                solve = cgops.nystrom_preconditioner(
                    mv, self.n, rank, dtype=self.dtype, omega=omega).solve
            else:
                solve = cgops.JacobiPreconditioner(torch.clamp(
                    vops.precision_diag(a, self.neighbors, d,
                                        self._incoming), min=1e-10)).solve
            _, it = cgops.pcg(mv, y[self._perm_t], solve, tol=tol,
                              max_iter=max_iter)
        return int(it)

    def grad_F_laplace(self, cov_pars, y, aux_pars, fixed_part,
                       iterative: Optional[bool] = None, **iter_kwargs):
        """d NLL / dF for LaGaBoost (``regression_objective.hpp:173-186``) by
        autograd: the dense Laplace NLL at small n, the matrix-free
        iterative one above ``DENSE_LAPLACE_MAX_N`` without random
        coefficients (the JAX package's rule).
        The iterative route takes ``nll_laplace_iterative``'s defaults
        (50 probes, 50 Lanczos steps, CG tolerance 1e-3) unless
        ``iter_kwargs`` say otherwise, as the JAX package's objective
        calls it."""
        if iterative is None:
            iterative = self.n > DENSE_LAPLACE_MAX_N and self.z is None
        fe = fixed_part.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            if iterative:
                nll = self.nll_laplace_iterative(cov_pars, y, aux_pars, fe,
                                                 **iter_kwargs)
            else:
                nll = self.nll_laplace(cov_pars, y, aux_pars, fe)
            (g,) = ag.grad(nll, fe)
        return g

    def _cross_cov(self, gp_pars, coords1, coords2):
        """Cross-covariance for isotropic and coordinate-scaled kernels
        (distances from coordinate differences, as the JAX package)."""
        if self.cov_fn.is_isotropic:
            diff = coords1[:, None, :] - coords2[None, :, :]
            d = vops._safe_dist(torch.sum(diff * diff, -1))
            return self.cov_fn.cov_matrix(gp_pars, dist=d)
        return self.cov_fn.cov_matrix(gp_pars, coords1=coords1,
                                      coords2=coords2)

    def _find_mode_dense(self, cov_pars, y, aux, fixed_part):
        """The dense Newton mode for the prediction: (b, w, Q) in
        permuted order."""
        fam = lk.get_family(self.likelihood)
        yp, Fp = self._permuted(y, fixed_part)
        Q, _ = self._dense_precision(cov_pars)
        b = newton_mode(fam, yp, Fp, aux, lambda v: Q @ v, dense_solve(Q))
        return b, -fam.d2_loc(yp, Fp + b, aux), Q

    def _prior_cross(self, cov_pars, coords_pred, zp, codes_pred):
        """(c_po [n_p, n], prior variance [n_p]) of the latent process
        between the prediction points and the observations (permuted
        order): the covariate-weighted sum over components with random
        coefficients, zero across clusters with codes."""
        n_p = coords_pred.shape[0]
        if self.z is not None:
            ps = self._pars_stack(cov_pars)
            diff = coords_pred[:, None, :] - self.coords_perm[None, :, :]
            d_po = vops._safe_dist(torch.sum(diff * diff, -1))
            c_po = prior = None
            for c in range(self.z.shape[1]):
                k_c = (zp[:, c][:, None] * self.z[:, c][None, :]) \
                    * self.cov_fn.cov_matrix(ps[c], dist=d_po)
                v = zp[:, c] ** 2 * ps[c, 0]
                c_po = k_c if c_po is None else c_po + k_c
                prior = v if prior is None else prior + v
        else:
            c_po = self._cross_cov(cov_pars, coords_pred, self.coords_perm)
            prior = cov_pars[0] * torch.ones(n_p, dtype=self.dtype,
                                             device=self.device)
        if codes_pred is not None and self.codes_perm is not None:
            c_po = torch.where(codes_pred[:, None] == self.codes_perm[None, :],
                               c_po, 0.0)
        return c_po, prior

    def predict_laplace(self, cov_pars, y, aux_pars, coords_pred,
                        fixed_part=None, fixed_part_pred=None,
                        predict_response=True, predict_var=False,
                        z_pred=None, codes_pred=None):
        """Vecchia-Laplace prediction: the mode, local kriging on the
        latent mode values (with random coefficients through ``z_pred``, of
        the own cluster through ``codes_pred``), and the posterior variance
        prior - c_po (Sigma + W^-1)^-1 c_op with (Sigma + W^-1)^-1
        = W (Q + W)^-1 Q. Dense up to ``DENSE_LAPLACE_MAX_N`` points (the
        JAX package's route); above, the mode by Newton-CG and the
        variance's solve by CG on the [n, n_p] columns (the JAX package
        forms [n, n] at every n)."""
        cdp = self._codes_tensor(codes_pred)
        n_p = coords_pred.shape[0]
        if self.n > DENSE_LAPLACE_MAX_N:
            fam = lk.get_family(self.likelihood)
            a, d = self._latent_factors(cov_pars)
            yp, Fp = self._permuted(y, fixed_part)
            aux = _aux_arg(aux_pars, yp)
            aux_pars = _aux_val(aux)
            b_perm = _FindModeCG.apply(a, d, Fp, aux, self, yp)
            w_perm = torch.clamp(-fam.d2_loc(yp, Fp + b_perm, aux_pars),
                                 min=1e-10)
            Q = None
        else:
            b_perm, w_perm, Q = self._find_mode_dense(cov_pars, y, aux_pars,
                                                      fixed_part)
        b_orig = b_perm[self._inv_perm_t]
        nb_pred = self._pred_neighbors(cov_pars, coords_pred, cdp)
        zp = None if self.z is None else self._zp_full(z_pred, n_p)
        if self.z is not None:
            mean_lat, _ = vops.predict_vecchia_response_svc(
                self.cov_fn, self._pars_stack(cov_pars), 0.0, self.coords,
                coords_pred, nb_pred, self.z_orig, zp, b_orig, False)
        else:
            mean_lat, _ = vops.predict_vecchia_response(
                self.cov_fn, cov_pars, 0.0, self.coords, coords_pred,
                nb_pred, b_orig, False)
        if fixed_part_pred is not None:
            mean_lat = mean_lat + fixed_part_pred
        var = None
        if predict_var or predict_response:
            c_po, prior = self._prior_cross(cov_pars, coords_pred, zp, cdp)
            if Q is None:
                tol, maxit = _mode_cg_tols(self.dtype)
                solve = _cg_solve(a, d, self, tol, maxit, "pred_cg_iters")
                rhs = c_po.T.contiguous()
                z = torch.cat([solve(w_perm, vops.precision_product(
                    a, d, rhs[:, s:s + SIM_CHUNK], self.neighbors,
                    self._incoming)) for s in range(0, n_p, SIM_CHUNK)],
                    dim=1)
            else:
                z = torch.linalg.solve(Q + torch.diag(w_perm), Q @ c_po.T)
            quad = torch.einsum("pn,n,np->p", c_po, w_perm, z)
            var = torch.clamp(prior - quad, min=1e-12)
        return self._respond(mean_lat, var, aux_pars, predict_response,
                             predict_var)

    def _respond(self, mean_lat, var, aux, predict_response, predict_var):
        if predict_response:
            mean, var_resp = _response_moments(self.likelihood, mean_lat, var,
                                               aux)
            return mean, (var_resp if predict_var else None)
        return mean_lat, (var if predict_var else None)

    def predict_laplace_sim(self, cov_pars, y, aux_pars, coords_pred,
                            fixed_part=None, fixed_part_pred=None,
                            predict_response=True, predict_var=False,
                            nsim: int = 1000, seed: int = 1,
                            cg_tol: float = 1e-6, cg_max_iter: int = 1000):
        """Scalable Vecchia-Laplace prediction with SIMULATED predictive
        variances (``nsim_var_pred``; reference
        ``Sample_Posterior_LaplaceApprox_Vecchia``, likelihoods.h:6818-7121).

        Matrix-free: the Newton-CG mode, posterior draws
        u = H^-1 (B' D^-1/2 z1 + W^1/2 z2) ~ N(0, H^-1), H = Q + W, solved
        by Jacobi-PCG in chunks of ``SIM_CHUNK`` draws (so the [n, m, chunk]
        gathers stay bounded), and the latent predictive variance
        var_p = Dp_p + mean_k (Bpo_p u^k)^2 with (Bpo, Dp) the latent
        conditioning of each prediction point on its observed neighbours.
        The draws come in float64 from a ``torch.Generator`` seeded with
        ``seed`` on the model's device, cast to the model's dtype."""
        fam = lk.get_family(self.likelihood)
        nb = self.neighbors
        a, d = self._latent_factors(cov_pars)
        yp, Fp = self._permuted(y, fixed_part)
        aux = _aux_arg(aux_pars, yp)
        auxv = _aux_val(aux)
        b = _FindModeCG.apply(a, d, Fp, aux, self, yp)
        w = torch.clamp(-fam.d2_loc(yp, Fp + b, auxv), min=1e-10)
        b_orig = b[self._inv_perm_t]
        nb_pred = self._pred_neighbors(cov_pars, coords_pred)
        a_pred, d_pred = vops.build_factors(
            self.cov_fn, cov_pars, self.coords, nb_pred, None, False,
            row_coords=coords_pred)
        idx_p = torch.clamp(nb_pred, min=0).long()
        a_p = a_pred * (nb_pred >= 0).to(self.dtype)
        mean_lat = torch.sum(a_p * b_orig[idx_p], dim=1)
        if fixed_part_pred is not None:
            mean_lat = mean_lat + fixed_part_pred
        var = None
        if predict_var or predict_response:
            solve = _cg_solve(a, d, self, cg_tol, cg_max_iter,
                              "sim_cg_iters")
            sqrt_dinv = (1.0 / torch.sqrt(d))[:, None]
            sqrt_w = torch.sqrt(w)[:, None]
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            chunk = min(int(nsim), SIM_CHUNK)
            n_chunks = (int(nsim) + chunk - 1) // chunk
            s2_sum = torch.zeros(coords_pred.shape[0], dtype=self.dtype,
                                 device=self.device)
            for _ in range(n_chunks):
                z1 = cgops.normal_probes(gen, self.n, chunk).to(self.dtype)
                z2 = cgops.normal_probes(gen, self.n, chunk).to(self.dtype)
                # z ~ N(0, H): B' D^-1/2 z1 + W^1/2 z2
                z = vops._bt(a, nb, self._incoming, sqrt_dinv * z1) \
                    + sqrt_w * z2
                u = solve(w, z)
                u_orig = u[self._inv_perm_t]                 # [n, chunk]
                s = torch.sum(a_p[:, :, None] * u_orig[idx_p], dim=1)
                s2_sum = s2_sum + torch.sum(s * s, dim=1)
            var = d_pred + s2_sum / (n_chunks * chunk)
        return self._respond(mean_lat, var, auxv, predict_response,
                             predict_var)
