"""A Vecchia GP together with grouped random effects (PyTorch port of the
JAX package's ``models/vecchia_combined.py``; Gaussian likelihood).

The reference keeps grouped components next to a Vecchia GP
(``CreateREComponentsVecchia``, ``Vecchia_utils.cpp:1060``); the JAX package
writes the response covariance as a Woodbury pair

    Psi = Lambda + U U',   Lambda = Vecchia(K_gp + nugget I),
    Lambda^-1 = B' D^-1 B,   U = Z Sigma_b^1/2   [n, q],

so the grouped part enters through its q columns only.

Cholesky route (the default): X = B Z [n, q] by one gather pass over the
neighbours (:class:`_BConstant`, whose backward in the factors ``a`` is a
gather too), M = I + S X' D^-1 X S [q, q] by one product, its Cholesky and
log-determinant through ``grouped.logdet_quad``; no transpose B' in the
NLL, and Psi^-1 R = B' D^-1 (B R - X S M^-1 S X' D^-1 B R) with one.
``matrix_inversion_method="iterative"``: CG on M = I + U' Lambda^-1 U
applied through Z b / Z' v (``models/grouped.py``'s fixed-order plans on the
card) and the Vecchia precision product (its gather transpose), stochastic
Lanczos for logdet M (the reference has no iterative route for this
combination; the JAX package's ``nll_gaussian_iterative``).

Z is built in the ordering's row order; the dense incidence of the Cholesky
route is [n, q] (as the JAX package's ``Z_perm``). Prediction takes the
exact cross-covariance (the GP's and the matching levels') with the
approximate Psi^-1; ``num_neighbors_pred`` is ``num_neighbors`` (the JAX
package's choice, not the 2 m of ``VecchiaGP``; ROADMAP.md "Not faults").
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch.models import grouped
from gpboost_tpu_torch.models.spec import ModelData, ModelSpec
from gpboost_tpu_torch.ops import cg as cgops
from gpboost_tpu_torch.ops import vecchia as vops
from gpboost_tpu_torch.ops.cov_fns import CovFunction
from gpboost_tpu_torch.utils import resolve_device

LOG_2PI = math.log(2.0 * math.pi)


class _BConstant(torch.autograd.Function):
    """B V = V - A V for a constant V [n, q] (no gradient to V),
    differentiable in a: grad a_ik = -sum_c G_ic V[nb_ik, c]. Both ways
    gather V's neighbour rows in column chunks (``vops.col_chunk``), so no
    [n, m, q] tensor is kept and nothing scatters."""

    @staticmethod
    def forward(ctx, a, neighbors, V):
        idx = torch.clamp(neighbors, min=0).long()
        a = torch.where(neighbors >= 0, a, 0.0)
        step = vops.col_chunk(*neighbors.shape)
        out = torch.cat([
            V[:, s:s + step] - (a[:, None, :] @ V[:, s:s + step][idx])[:, 0]
            for s in range(0, V.shape[1], step)], dim=1)
        ctx.save_for_backward(neighbors, V)
        return out

    @staticmethod
    def backward(ctx, G):
        neighbors, V = ctx.saved_tensors
        idx = torch.clamp(neighbors, min=0).long()
        step = vops.col_chunk(*neighbors.shape)
        ga = None
        for s in range(0, V.shape[1], step):
            part = (V[:, s:s + step][idx] @ G[:, s:s + step, None])[..., 0]
            ga = part if ga is None else ga + part
        return torch.where(neighbors >= 0, -ga, 0.0), None, None


class VecchiaGroupedGP:
    """Vecchia GP + grouped random effects, Gaussian response.

    ``spec`` holds the grouped components (``GroupedRESpec``), ``data`` their
    level codes and slope covariates in the original row order; cov_pars
    are [nugget, grouped variances..., GP parameters...] (the declaration
    order of the JAX package)."""

    def __init__(self, coords: np.ndarray, cov_fn: CovFunction,
                 spec: ModelSpec, data: ModelData, num_neighbors: int = 20,
                 ordering: str = "random", seed: int = 0,
                 matrix_inversion_method: str = "cholesky",
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        coords = np.asarray(coords, dtype=np.float64)
        n = coords.shape[0]
        self.n = n
        self.cov_fn = cov_fn
        self.likelihood = "gaussian"
        self.num_neighbors = min(num_neighbors, n - 1)
        self.num_neighbors_pred = self.num_neighbors
        self.dtype = dtype
        self.spec = spec
        self._data = data
        self.n_comp = len(spec.components)
        self.matrix_inversion_method = matrix_inversion_method
        self.coords = torch.as_tensor(coords, dtype=dtype, device=self.device)
        # iterative settings (sync_iter_cfg)
        self._iter_cfg = dict(num_rand_vec_trace=50, lanczos_steps=50,
                              cg_tol=1e-6, cg_max_iter=1000, seed=1)
        self._set_structure(vops.apply_ordering(n, ordering, seed), None)

    def _set_structure(self, perm, neighbors) -> None:
        self.perm = np.asarray(perm)
        self.inv_perm = np.argsort(self.perm)
        self._perm_t = torch.as_tensor(self.perm, device=self.device)
        self._inv_perm_t = torch.as_tensor(self.inv_perm, device=self.device)
        self.coords_perm = self.coords[self._perm_t].contiguous()
        if neighbors is None:
            neighbors = vops.find_neighbors(self.coords_perm,
                                            self.num_neighbors)
        self.neighbors = neighbors
        self._incoming = (vops.build_incoming_sliced(neighbors)
                          if neighbors.is_cuda else None)
        d = self._data
        data_perm = ModelData(
            group_codes=d.group_codes[self._perm_t],
            slope_data=(None if d.slope_data is None
                        else d.slope_data[self._perm_t]))
        self._Z = grouped.GroupedZ(self.spec, data_perm,
                                   deterministic=self.device.type == "cuda",
                                   dtype=self.dtype)
        self.q_total = self._Z.q
        self.level_counts = list(self._Z.sizes)
        self._Zd = None
        self._probe_cache = None

    def load_structure(self, perm: np.ndarray, neighbors: np.ndarray) -> None:
        """Replace the ordering permutation and the neighbour matrix by given
        ones (rows in permuted order, -1 padding): the incidence follows the
        new order. Carries another implementation's structure over, so that
        both condition on the same sets."""
        perm = np.asarray(perm)
        nb = np.asarray(neighbors)
        if perm.shape != (self.n,) or not np.array_equal(
                np.sort(perm), np.arange(self.n)):
            raise ValueError("perm: expected a permutation of range(n)")
        if nb.ndim != 2 or nb.shape[0] != self.n or np.any(
                nb >= np.arange(self.n)[:, None]):
            raise ValueError("neighbors: an [n, m] matrix whose row i holds "
                             "indices < i (or -1)")
        self.num_neighbors = self.num_neighbors_pred = nb.shape[1]
        self._set_structure(perm, torch.as_tensor(
            nb.astype(np.int32), device=self.device).contiguous())

    def sync_iter_cfg(self, cfg) -> None:
        """Adopt the model's iterative settings (``OptimConfig``)."""
        self._iter_cfg = dict(
            num_rand_vec_trace=int(cfg.num_rand_vec_trace),
            lanczos_steps=min(int(cfg.cg_max_num_it_tridiag), 100,
                              self.q_total),
            cg_tol=float(cfg.cg_delta_conv),
            cg_max_iter=int(cfg.cg_max_num_it),
            seed=int(cfg.seed_rand_vec_trace))

    def ensure_neighbors(self, cov_pars_full) -> None:
        """The neighbours stay those of construction (the JAX package's
        combined model does not redetermine them)."""

    # ---- pieces ---------------------------------------------------------
    def _split_pars(self, cov_pars):
        return (cov_pars[0], cov_pars[1:1 + self.n_comp],
                cov_pars[1 + self.n_comp:])

    def _scale(self, gvars):
        """sqrt(diag Sigma_b) [q]."""
        return torch.sqrt(grouped._sigma_b_diag(self._Z, gvars))

    def _factors(self, cov_pars):
        nugget, gvars, gp_pars = self._split_pars(cov_pars)
        a, d = vops.build_factors(self.cov_fn, gp_pars, self.coords_perm,
                                  self.neighbors, nugget, True)
        return a, d, self._scale(gvars)

    def _dense_z(self) -> torch.Tensor:
        """The incidence [n, q] in permuted order (each (row, level) entry
        written once), built at first use."""
        if self._Zd is None:
            Z = self._Z
            out = torch.zeros((self.n, self.q_total), dtype=self.dtype,
                              device=self.device)
            rows = torch.arange(self.n, device=self.device)
            for idx, w in zip(Z.idx, Z.weights):
                out.index_put_((rows, idx), torch.ones(
                    self.n, dtype=self.dtype, device=self.device)
                    if w is None else w)
            self._Zd = out
        return self._Zd

    def _chol_parts(self, cov_pars):
        """(a, d, s, X = B Z, base = S X' D^-1 X S)."""
        a, d, s = self._factors(cov_pars)
        X = _BConstant.apply(a, self.neighbors, self._dense_z())
        Xd = X / torch.sqrt(d)[:, None]
        base = s[:, None] * (Xd.T @ Xd) * s[None, :]
        return a, d, s, X, base

    # ---- Cholesky route ---------------------------------------------------
    def nll_gaussian(self, cov_pars, y, fixed_part=None):
        """Woodbury NLL: logdet Psi = sum log d + logdet(I + U' Lambda^-1 U)."""
        if self.matrix_inversion_method == "iterative":
            return self.nll_gaussian_iterative(cov_pars, y, fixed_part)
        a, d, s, X, base = self._chol_parts(cov_pars)
        r = y if fixed_part is None else y - fixed_part
        br = vops.apply_B(a, self.neighbors, r[self._perm_t])
        bd = br / d
        ones = torch.ones(self.q_total, dtype=d.dtype, device=d.device)
        logdet_m, tt = grouped.logdet_quad(base, ones, s * (X.T @ bd))
        quad = torch.dot(br, bd) - tt
        return 0.5 * (quad + torch.sum(torch.log(d)) + logdet_m
                      + self.n * LOG_2PI)

    def psi_inv_mul(self, cov_pars, R):
        """Psi^-1 R for R [n] or [n, k] in permuted order."""
        if self.matrix_inversion_method == "iterative":
            return self.psi_inv_mul_iterative(cov_pars, R)
        a, d, s, X, base = self._chol_parts(cov_pars)
        M = base.clone()
        M.diagonal().add_(1.0)
        grouped.GROUPED_COUNTS["qq_factor"] += 1
        L = torch.linalg.cholesky(M)
        BR = vops.apply_B(a, self.neighbors, R)
        BRd = BR / vops._cols(d, BR)
        inner = vops._cols(s, BRd) * (X.T @ BRd)
        sol = torch.cholesky_solve(inner[:, None] if R.dim() == 1 else inner,
                                   L)
        if R.dim() == 1:
            sol = sol[:, 0]
        T = BRd - (X @ (vops._cols(s, sol) * sol)) / vops._cols(d, BR)
        return vops._bt(a, self.neighbors, self._incoming, T)

    # ---- iterative route --------------------------------------------------
    def _lam_inv(self, a, d, V):
        return vops.precision_product(
            a, d, V, self.neighbors, self._incoming,
            col_chunk=vops.col_chunk(*self.neighbors.shape))

    def _mv_M(self, a, d, s, V):
        """M V = V + S Z' Lambda^-1 Z S V, never [q, q]."""
        u = grouped.z_mul(self._Z, vops._cols(s, V) * V)
        return V + vops._cols(s, V) * grouped.zt_mul(self._Z,
                                                    self._lam_inv(a, d, u))

    def _jacobi(self, a, d, s):
        """Jacobi preconditioner of M with diag(Lambda^-1) in place of
        Lambda^-1 inside: 1 + s_j^2 sum_i Z_ij^2 (Lambda^-1)_ii."""
        lam_diag = vops.precision_diag(a, self.neighbors, d, self._incoming)
        diag = 1.0 + s * s * grouped.ztw_z_diag(self._Z, lam_diag)
        return cgops.JacobiPreconditioner(torch.clamp(diag.detach(),
                                                      min=1e-10))

    def probes(self):
        """(e, Zg) [q, k]: standard-normal value probes (scaled by the
        preconditioner's square root) and Rademacher gradient probes, drawn
        in float64 from a ``torch.Generator`` seeded with the configured
        seed, kept between calls."""
        cfg = self._iter_cfg
        key = (cfg["num_rand_vec_trace"], cfg["seed"])
        if self._probe_cache is None or self._probe_cache[0] != key:
            gen = torch.Generator(device=self.device).manual_seed(key[1])
            e = cgops.normal_probes(gen, self.q_total, key[0])
            zg = cgops.rademacher_probes(gen, self.q_total, key[0])
            self._probe_cache = (key, e.to(self.dtype), zg.to(self.dtype))
        return self._probe_cache[1:]

    def nll_gaussian_iterative(self, cov_pars, y, fixed_part=None,
                               probes=None):
        """Matrix-free NLL: CG on M for the Woodbury quadratic form (the
        stationary surrogate: exact value and gradient without
        differentiating CG) and stochastic Lanczos for logdet M. ``probes``
        = (e, Zg) [q, k] replaces :meth:`probes`."""
        cfg = self._iter_cfg
        a, d, s = self._factors(cov_pars)
        r = y if fixed_part is None else y - fixed_part
        r = r[self._perm_t]
        li_r = self._lam_inv(a, d, r)
        w = s * grouped.zt_mul(self._Z, li_r)
        pre = self._jacobi(a, d, s)

        def matvec(V):
            return self._mv_M(a, d, s, V)

        quad_w = grouped._quadform_cg(matvec, w, pre.solve, cfg["cg_tol"],
                                      cfg["cg_max_iter"])
        quad = torch.dot(r, li_r) - quad_w
        e, zg = self.probes() if probes is None else probes
        logdet_m = cgops.stochastic_logdet_grad(
            matvec, None, torch.sqrt(pre.d)[:, None] * e,
            cfg["lanczos_steps"], pre.solve, pre.logdet(), cfg["cg_tol"],
            cfg["cg_max_iter"], probes_grad=zg, stats=grouped.GROUPED_COUNTS)
        return 0.5 * (quad + torch.sum(torch.log(d)) + logdet_m
                      + self.n * LOG_2PI)

    def psi_inv_mul_iterative(self, cov_pars, R):
        """Psi^-1 R (permuted order) by CG on M, all columns together."""
        cfg = self._iter_cfg
        a, d, s = self._factors(cov_pars)
        pre = self._jacobi(a, d, s)
        li_R = self._lam_inv(a, d, R)
        w = vops._cols(s, li_R) * grouped.zt_mul(self._Z, li_R)
        sol, it = cgops.pcg(lambda V: self._mv_M(a, d, s, V), w, pre.solve,
                            tol=cfg["cg_tol"], max_iter=cfg["cg_max_iter"])
        grouped.GROUPED_COUNTS["sim_cg_iters"] += it
        return li_R - self._lam_inv(
            a, d, grouped.z_mul(self._Z, vops._cols(s, sol) * sol))

    # ---- what the fits and GPModel call -----------------------------------
    def _vg_gaussian(self, th, y, fp):
        lp = th.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            nll = self.nll_gaussian(torch.exp(lp), y, fp)
            (g,) = ag.grad(nll, lp)
        return nll.detach(), g

    def _fit_psi_inv(self, th, r):
        return self.psi_inv_resid(torch.exp(th), r)

    def nll_gaussian_value(self, cov_pars, y, fixed_part=None):
        with torch.no_grad():
            return self.nll_gaussian(cov_pars, y, fixed_part)

    def psi_inv_resid(self, cov_pars, r):
        """Psi^-1 r in the original row order (the GPBoost
        pseudo-gradient)."""
        return self.psi_inv_mul(cov_pars, r[self._perm_t])[self._inv_perm_t]

    def wls_coef(self, cov_pars, y, X, fixed_effects=None):
        yv = y if fixed_effects is None else y - fixed_effects
        yp, Xp = yv[self._perm_t], X[self._perm_t]
        pi_X = self.psi_inv_mul(cov_pars, Xp)
        return torch.linalg.solve(Xp.T @ pi_X, pi_X.T @ yp)

    def predict_gaussian(self, cov_pars, y, coords_pred, fixed_part=None,
                         predict_response=True, predict_var=False,
                         Z_pred=None, prior_z=None):
        """Exact cross-covariance (the GP's and the matching levels') with
        the approximate Psi^-1. ``Z_pred`` [n_p, q] is the unscaled
        incidence of the prediction points (zero rows for unseen levels);
        ``prior_z`` [n_p, n_comp] the multipliers of the prior variance
        (an unseen level still has its prior variance)."""
        nugget, gvars, gp_pars = self._split_pars(cov_pars)
        r = y if fixed_part is None else y - fixed_part
        pi_r = self.psi_inv_mul(cov_pars, r[self._perm_t])
        diff = coords_pred[:, None, :] - self.coords_perm[None, :, :]
        cross = self.cov_fn.cov_matrix(
            gp_pars, dist=vops._safe_dist(torch.sum(diff * diff, -1)))
        s = self._scale(gvars)
        if Z_pred is not None:
            cross = cross + (Z_pred * (s * s)[None, :]) @ self._dense_z().T
        mean = cross @ pi_r
        var = None
        if predict_var:
            pi_c = self.psi_inv_mul(cov_pars, cross.T.contiguous())
            prior = gp_pars[0] * torch.ones(coords_pred.shape[0],
                                            dtype=self.dtype,
                                            device=self.device)
            if prior_z is not None:
                for j in range(self.n_comp):
                    prior = prior + gvars[j] * prior_z[:, j] ** 2
            var = prior - torch.einsum("pn,np->p", cross, pi_c)
            if predict_response:
                var = var + nugget
            var = torch.clamp(var, min=0.0)
        return mean, var
