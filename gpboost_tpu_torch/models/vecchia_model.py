"""Vecchia-approximated GP model paths (Gaussian response).

Dispatch target of ``GPModel`` for ``gp_approx="vecchia"``. Mirrors the
reference's ``CreateREComponentsVecchia`` (``Vecchia_utils.cpp:1060``) +
the Gaussian Vecchia branch of ``REModelTemplate``.

Cost structure: factor build O(n m^3) (one per-row Cholesky), solves
O(n m). Models inside the kernel gate (float32, nugget among the
parameters, exponential / Matern 0.5, 1.5, 2.5 / gaussian, isotropic or ARD)
go through the fused kernels of ``ops/kernels/vecchia_factors.py``; every
other model differentiates the plain factor build with ``torch.autograd``.

Not ported yet (ROADMAP.md): Vecchia-Laplace for non-Gaussian likelihoods,
GP random coefficients, ``cluster_ids``, the other ``vecchia_pred_type``
variants, row sharding over several GPUs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.ops import vecchia as vops
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vkern
from gpboost_tpu_torch.utils import resolve_device


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
                 dtype=torch.float64, device="cuda"):
        if likelihood != "gaussian":
            raise NotImplementedError(
                f"likelihood '{likelihood}': only the gaussian Vecchia model "
                "is ported (Vecchia-Laplace: ROADMAP.md Queue A, item 13)")
        if ordering in ("time", "time_random_space"):
            raise NotImplementedError(
                f"vecchia_ordering '{ordering}' needs a space-time "
                "covariance, which is not ported (ROADMAP.md Queue A, "
                "items 14-15)")
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
        self.coords = torch.as_tensor(coords, dtype=dtype, device=self.device)
        self._ard_neighbors_pars = None
        self._set_structure(vops.apply_ordering(n, ordering, seed), None)
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
        if neighbors is None:
            neighbors = vops.find_neighbors(self.coords_perm,
                                            self.num_neighbors)
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
        identical conditioning sets whatever their top-k tie-breaking."""
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
        self.num_neighbors = nb.shape[1]
        self._ard_neighbors_pars = None
        self._set_structure(perm, torch.as_tensor(
            nb.astype(np.int32), device=self.device).contiguous())

    def _kernel_shape_code(self):
        """(matern-shape code, is_ard) for the fused kernels, or None if
        the model/kernel combination is not eligible. The kernels build the
        response covariance (nugget among the parameters), which is the only
        parametrization this class has so far; latent-process models must
        stay outside the gate when they are ported."""
        cf = self.cov_fn
        if self.dtype != torch.float32:
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
            (grad,) = torch.autograd.grad(nll, lp)
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
        gp_pars = np.asarray(cov_pars_full, dtype=np.float64)[1:]
        if (self._ard_neighbors_pars is not None
                and np.allclose(gp_pars, self._ard_neighbors_pars)):
            return
        scaled = self.cov_fn.scale_coords(
            self.coords_perm, torch.as_tensor(gp_pars, dtype=self.dtype,
                                              device=self.device))
        self._set_neighbors(vops.find_neighbors(scaled, self.num_neighbors))
        self._ard_neighbors_pars = gp_pars

    def _pred_neighbors(self, gp_pars, coords_pred):
        """Observed neighbors of prediction points; ARD kernels search in
        the scaled coordinate space."""
        if not self.cov_fn.is_isotropic and self.cov_fn.has_coord_scaling:
            return vops.find_neighbors_cross(
                self.cov_fn.scale_coords(coords_pred, gp_pars),
                self.cov_fn.scale_coords(self.coords, gp_pars),
                self.num_neighbors_pred)
        return vops.find_neighbors_cross(coords_pred, self.coords,
                                         self.num_neighbors_pred)

    # ---- Gaussian response-scale Vecchia ------------------------------
    def _response_factors(self, cov_pars, nb):
        """(A, D) of the response covariance; cov_pars = [nugget, var, ...]."""
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
        if r.is_cuda:
            out = vops.precision_matvec_gather(a, self.neighbors,
                                               self._incoming, d,
                                               r[self._perm_t])
        else:
            out = vops.precision_matvec(a, self.neighbors, d,
                                        r[self._perm_t])
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
                         predict_var=False):
        """Local-kriging prediction conditioning on observed neighbors.
        ``coords_pred`` is a tensor [n_p, d] on the model's device."""
        r = y if fixed_part is None else y - fixed_part
        nb_pred = self._pred_neighbors(cov_pars[1:], coords_pred)
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
