"""FITC and full-scale-tapering GPs (PyTorch port of
``gpboost_tpu/models/fitc_model.py``).

Dispatch target of ``GPModel`` for ``gp_approx="fitc"`` and
``"full_scale_tapering"`` (the Cholesky route). Gaussian NLL, solves and
prediction go through ``ops/fitc.py`` (Woodbury for FITC, a dense Psi for
full-scale tapering). Other likelihoods: FITC's latent covariance
Sigma = V'V + diag(dD) (V = L_mm^-1 C_mn [k, n]) in a Woodbury Laplace
approximation — the mode by damped Newton in the stable (b, a = Sigma^-1 b)
form with Woodbury solves (``_FindModeFITC``, an autograd Function with the
implicit backward), the log-determinant from a [k, k] one (reference
``FindModePostRandEffCalcMLLFITC``, ``likelihoods.h:3090``); full-scale
tapering's latent covariance is dense ([n, n], ``models/laplace.py``).
FITC's Laplace prediction stays in k-space too, where the JAX package forms
the dense [n, n] covariance.

Full-scale tapering with ``matrix_inversion_method="iterative"`` (the
reference's ``CGFSA`` / ``CGTridiagFSA``, ``CG_utils.h:507,622``) never
forms the dense Psi: Psi x = V'(V x) + (T o (Sigma - Q) + diag) x with the
taper-sparse residual of ``ops/fitc.py`` (a gather-only product), the
quadratic form by CG with an implicit backward, the log-determinant by
stochastic Lanczos, both under the FITC preconditioner V'V + diag
(``ops/cg.py::LowRankDiagPreconditioner``); solves and predictions by the
same CG. Its Laplace approximation stays dense, as in the JAX package.

No kernel runs here (the JAX package has none for these models): the work
is ``torch.linalg`` on [n, k] and [k, k] matrices and gathers.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from gpboost_tpu_torch.utils import autograd as ag
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.models.laplace import (_aux_arg, _aux_val,
                                              _laplace_nll_from_sigma,
                                              _response_moments, find_mode,
                                              newton_halving, MAX_NEWTON_IT,
                                              NEWTON_TOL)
from gpboost_tpu_torch.models.predvar import sim_pred_mean_var
from gpboost_tpu_torch.ops import cg as cgops
from gpboost_tpu_torch.ops import fitc as fops
from gpboost_tpu_torch.ops.cov_fns import CovFunction, wendland_correlation
from gpboost_tpu_torch.ops.inducing import select_inducing_points
from gpboost_tpu_torch.utils import resolve_device
from gpboost_tpu_torch.utils.log import log_info
from gpboost_tpu_torch.utils.timer import timed

# above this many entries of C [n_p, n] the variances of full-scale tapering
# are simulated unless nsim_var_pred says otherwise (the JAX package's rule)
SIM_VAR_MIN_ENTRIES = 50_000_000
# prediction points a cross-covariance block holds at once
PRED_CHUNK = 2048
LOG_2PI = fops.LOG_2PI

# what full-scale tapering's iterative route did since the last reset (read
# by the chip run's breakdown): CG iterations of the quadratic form's solve
# and of its adjoint, Lanczos steps, CG iterations of the log-determinant's
# gradient solve and of the solves of GLS, prediction and get_num_cg_steps
FSA_COUNTS: Counter = Counter()


def log_scale_value_and_grad(nll_gaussian, th, y, fp):
    """(NLL, dNLL/dtheta) at log-scale parameters ``th`` of a model's
    ``nll_gaussian(cov_pars, y, fixed_part)`` — the fit loop's
    ``_vg_gaussian`` of the low-rank models."""
    lp = th.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        nll = nll_gaussian(torch.exp(lp), y, fp)
        (grad,) = ag.grad(nll, lp)
    return nll.detach(), grad


def gls_coef(psi_inv_resid, cov_pars, y, X, fixed_effects=None):
    """GLS coefficients (X' Psi^-1 X)^-1 X' Psi^-1 y, Psi^-1 [X, y] by one
    ``psi_inv_resid(cov_pars, R)``."""
    yv = y if fixed_effects is None else y - fixed_effects
    w = psi_inv_resid(cov_pars, torch.cat([X, yv[:, None]], 1))
    return torch.linalg.solve(X.T @ w[:, :-1], X.T @ w[:, -1])


def grad_wrt_F(nll_of_F, fixed_part):
    """d NLL / dF (the LaGaBoost gradient) of ``nll_of_F(F)`` by autograd."""
    fe = fixed_part.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = ag.grad(nll_of_F(fe), fe)
    return g


def taper_mu(dim: int, taper_shape: float) -> float:
    """The Wendland taper's mu of full-scale tapering: (1 + d) / 2 + shape
    + 1/2 (the reference applies the taper with apply_tapering = true,
    ``re_model_template.h:7090``, ``re_comp.h:842-845``)."""
    return (1.0 + dim) / 2.0 + taper_shape + 0.5


class FITCGP:
    """State of a FITC or full-scale-tapering GP: its coordinates
    ([n, d], or [C, n_c, d] for the equal-size clusters of a
    ``cluster_ids`` model batched by :meth:`stack`) and its inducing points
    ([k, d] / [C, k, d])."""

    def __init__(self, coords: np.ndarray, cov_fn: CovFunction,
                 num_ind_points: int = 500,
                 ind_points_selection: str = "kmeans++", seed: int = 0,
                 cover_tree_radius: float = 1.0,
                 likelihood: str = "gaussian", gp_approx: str = "fitc",
                 cov_fct_taper_range: float = 1.0,
                 cov_fct_taper_shape: float = 1.0,
                 matrix_inversion_method: str = "cholesky",
                 dtype=torch.float64, device="cuda"):
        coords = np.asarray(coords, dtype=np.float64)
        if num_ind_points > np.unique(coords, axis=0).shape[0]:
            raise ValueError(
                "Cannot have more inducing points than (unique) samples")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.n = coords.shape[0]
        self.cov_fn = cov_fn
        self.likelihood = likelihood
        self.gp_approx = gp_approx
        self.taper_range = float(cov_fct_taper_range)
        self.taper_shape = float(cov_fct_taper_shape)
        self.taper_mu = taper_mu(coords.shape[1], self.taper_shape)
        self.matrix_inversion_method = matrix_inversion_method
        # the iterative route's settings (the reference's defaults;
        # sync_iter_cfg takes the optimizer config's)
        self.num_rand_vec_trace = 50
        self.lanczos_steps = 50
        self.cg_tol = 1e-4
        self.cg_max_iter = 1000
        self.seed_rand_vec_trace = 1
        self._probe_cache = None
        self.coords = torch.as_tensor(coords, dtype=dtype, device=self.device)
        self.ind_points = select_inducing_points(
            coords, num_ind_points, ind_points_selection, seed,
            cover_tree_radius=cover_tree_radius,
            device=self.device).to(dtype)
        self.taper = None
        if self._use_iterative:
            with timed("FSA: taper structure", sync=True):
                self.taper = fops.taper_structure(
                    self.coords, self.taper_range, self.taper_shape,
                    self.taper_mu)

    @property
    def _use_iterative(self) -> bool:
        return (self.gp_approx == "full_scale_tapering"
                and self.matrix_inversion_method == "iterative")

    def sync_iter_cfg(self, cfg):
        """Take the optimizer config's settings of the iterative route
        (the JAX package's ``sync_iter_cfg``: at most 200 Lanczos
        steps)."""
        self.num_rand_vec_trace = max(int(cfg.num_rand_vec_trace), 1)
        self.lanczos_steps = min(int(cfg.cg_max_num_it_tridiag), 200)
        self.cg_tol = float(cfg.cg_delta_conv)
        self.cg_max_iter = int(cfg.cg_max_num_it)
        self.seed_rand_vec_trace = int(cfg.seed_rand_vec_trace)

    @classmethod
    def stack(cls, subs) -> "FITCGP":
        """One model over the equal-size clusters ``subs`` (FITCGPs of one
        kind and one number of inducing points): coordinates [C, n_c, d],
        inducing points [C, k, d]; its Gaussian NLL is the sum over the
        clusters, its solves block-diagonal — the JAX package's batched
        layout (``clustered_approx.py:_nll_gaussian_batched``)."""
        out = cls.__new__(cls)
        out.__dict__.update(subs[0].__dict__)
        out.coords = torch.stack([s.coords for s in subs])
        out.ind_points = torch.stack([s.ind_points for s in subs])
        out.n = sum(s.n for s in subs)
        return out

    # ---- Gaussian ------------------------------------------------------
    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """[n] or [n, q] in the batch layout of the coordinates."""
        return x.reshape(*self.coords.shape[:-1], *x.shape[1:])

    def nll_gaussian(self, cov_pars: torch.Tensor, y: torch.Tensor,
                     fixed_part: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """cov_pars = [nugget, sigma1^2, range, ...]."""
        r = self._rows(y if fixed_part is None else y - fixed_part)
        if self.gp_approx == "fitc":
            return torch.sum(fops.fitc_nll(self.cov_fn, cov_pars, self.coords,
                                           self.ind_points, r))
        if self._use_iterative:
            return self.nll_gaussian_iterative(cov_pars, y, fixed_part)
        return torch.sum(fops.fsa_nll_from_psi(self._fsa_psi(cov_pars), r))

    def nll_gaussian_value(self, cov_pars, y, fixed_part=None):
        with torch.no_grad():
            return self.nll_gaussian(cov_pars, y, fixed_part)

    def _vg_gaussian(self, th, y, fp):
        return log_scale_value_and_grad(self.nll_gaussian, th, y, fp)

    def _fsa_psi(self, cov_pars):
        return fops.fsa_psi(self.cov_fn, self.taper_range, self.taper_shape,
                            self.taper_mu, cov_pars, self.coords,
                            self.ind_points)

    # ---- full-scale tapering, iterative (CGFSA, CG_utils.h:507-900) ------
    def _fsa_iter_theta(self, cov_pars):
        """The differentiable pieces of the matrix-free Psi: (v [k, n],
        vals [n, k_t], diag + nugget [n]) with Psi x = v'(v x) +
        ``fsa_resid_mv(vals, diag + nugget, x)``."""
        nugget, gp_pars = cov_pars[0], cov_pars[1:]
        with timed("FSA: taper values", sync=True):
            _, _, _, v = fops.fitc_parts(self.cov_fn, gp_pars, self.coords,
                                         self.ind_points, nugget)
            vals, diag = fops.fsa_taper_values(self.cov_fn, gp_pars, v,
                                               self.taper)
        return v, vals, diag + nugget

    def _psi_of(self, theta, X):
        v, vals, dfull = theta
        return fops.fsa_resid_mv(vals, dfull, X, self.taper) + v.T @ (v @ X)

    @staticmethod
    def _fitc_preconditioner(theta):
        """The FITC preconditioner v'v + diag of the current parameters,
        detached (the JAX package's ``stop_gradient``)."""
        v, _, dfull = theta
        return cgops.LowRankDiagPreconditioner.create(
            v.detach().T, torch.clamp(dfull.detach(), min=1e-10))

    def fsa_probes(self, num_rand_vec_trace: int, seed: int):
        """(e_r [k, K], e_n [n, K], Zg [n, K]): the standard normals of the
        value probes U e_r + sqrt(d) e_n ~ N(0, P) under the FITC
        preconditioner and the Rademacher gradient probes, drawn in
        float64 in that order from a ``torch.Generator`` seeded with
        ``seed`` and cast to the model's dtype; kept between calls."""
        key = (int(num_rand_vec_trace), int(seed))
        if self._probe_cache is None or self._probe_cache[0] != key:
            gen = torch.Generator(device=self.device).manual_seed(key[1])
            draws = (cgops.normal_probes(gen, self.ind_points.shape[0],
                                         key[0]),
                     cgops.normal_probes(gen, self.n, key[0]),
                     cgops.rademacher_probes(gen, self.n, key[0]))
            self._probe_cache = (key, tuple(t.to(self.dtype) for t in draws))
        return self._probe_cache[1]

    def nll_gaussian_iterative(self, cov_pars, y, fixed_part=None):
        """Gaussian full-scale-tapering NLL, matrix-free (the JAX package's
        ``nll_gaussian_iterative``): the quadratic form r' Psi^-1 r by CG
        with an implicit backward, logdet Psi by preconditioned stochastic
        Lanczos with the Hutchinson gradient over Rademacher probes, both
        under the FITC preconditioner. O(n k_t + n k) a product;
        differentiable in cov_pars and fixed_part."""
        e_r, e_n, zg = self.fsa_probes(self.num_rand_vec_trace,
                                       self.seed_rand_vec_trace)
        return self._nll_gaussian_iterative(cov_pars, y, fixed_part, e_r,
                                            e_n, zg)

    def _nll_gaussian_iterative(self, cov_pars, y, fixed_part, e_r, e_n,
                                zg):
        """:meth:`nll_gaussian_iterative` with the draws given."""
        r = y if fixed_part is None else y - fixed_part
        theta = self._fsa_iter_theta(cov_pars)
        with torch.no_grad(), timed("cg: preconditioner", sync=True):
            pre = self._fitc_preconditioner(theta)
            Z = pre.probes_from(e_r, e_n)
            pre_logdet = pre.logdet()
        with timed("FSA: quadratic-form CG", sync=True):
            alpha = cgops.pcg_implicit(self._psi_of, theta, r, pre.d,
                                       self.cg_tol, self.cg_max_iter,
                                       pre_U=pre.U, stats=FSA_COUNTS)
        logdet = cgops.stochastic_logdet_grad(
            lambda V: self._psi_of(theta, V), None, Z, self.lanczos_steps,
            pre.solve, pre_logdet, self.cg_tol, self.cg_max_iter,
            probes_grad=zg, stats=FSA_COUNTS)
        return 0.5 * (torch.dot(r, alpha) + logdet + r.shape[0] * LOG_2PI)

    def _iterative_solver(self, cov_pars, tol, count):
        """R -> Psi^-1 R by CG under the FITC preconditioner (to ``tol``),
        its iterations added to ``FSA_COUNTS[count]``."""
        theta = self._fsa_iter_theta(cov_pars)
        pre = self._fitc_preconditioner(theta)

        def solve(R):
            X, it = cgops.pcg(lambda V: self._psi_of(theta, V), R, pre.solve,
                              tol=tol, max_iter=self.cg_max_iter)
            FSA_COUNTS[count] += it
            return X
        return solve

    def num_cg_steps(self, cov_pars, y, tol, max_iter) -> int:
        """CG iterations of one solve Psi x = y under the FITC
        preconditioner (``GPModel.get_num_cg_steps``)."""
        with torch.no_grad():
            theta = self._fsa_iter_theta(cov_pars)
            _, it = cgops.pcg(lambda V: self._psi_of(theta, V), y,
                              self._fitc_preconditioner(theta).solve,
                              tol=tol, max_iter=max_iter)
        return int(it)

    def _psi_solver(self, cov_pars):
        """R -> Psi^-1 R for R [n] or [n, q], factorising once (by CG for
        the iterative route, to min(cg_tol, 1e-6) as in the JAX
        package)."""
        if self._use_iterative:
            return self._iterative_solver(cov_pars, min(self.cg_tol, 1e-6),
                                          "solve_cg_iters")
        if self.gp_approx == "fitc":
            def solve(R):
                R2 = R if R.dim() == 2 else R[:, None]
                out = fops.fitc_psi_inv_mul(self.cov_fn, cov_pars,
                                            self.coords, self.ind_points,
                                            self._rows(R2))
                return out.reshape(R.shape)
            return solve
        chol = fops.cholesky(self._fsa_psi(cov_pars))

        def solve(R):
            R2 = R if R.dim() == 2 else R[:, None]
            return torch.cholesky_solve(self._rows(R2), chol).reshape(R.shape)
        return solve

    def psi_inv_resid(self, cov_pars, R):
        """Psi^-1 R in the data's row order (R [n] or [n, q])."""
        return self._psi_solver(cov_pars)(R)

    def ensure_neighbors(self, cov_pars_full):
        """No neighbours to redetermine."""

    def wls_coef(self, cov_pars, y, X, fixed_effects=None):
        return gls_coef(self.psi_inv_resid, cov_pars, y, X, fixed_effects)

    def predict_gaussian(self, cov_pars, y, coords_pred, fixed_part=None,
                         predict_response=True, predict_var=False,
                         nsim_var_pred=None):
        """FITC: ``fops.fitc_predict`` (k-space). Full-scale tapering: the
        cross-covariance Q_pn + T o (Sigma_pn - Q_pn) by chunks of
        prediction points, exact variances, or simulated ones
        (:func:`sim_pred_mean_var`) when ``nsim_var_pred`` > 0 or, unset,
        when C [n_p, n] would hold more than ``SIM_VAR_MIN_ENTRIES``
        entries. Returns (mean, var)."""
        r = y if fixed_part is None else y - fixed_part
        if self.gp_approx == "fitc":
            mean, var, _ = fops.fitc_predict(
                self.cov_fn, cov_pars, self.coords, self.ind_points,
                coords_pred, r, bool(predict_response), bool(predict_var))
            return mean, var
        gp_pars = cov_pars[1:]
        solve = self._psi_solver(cov_pars)
        psi_inv_r = solve(r)
        sol_mn = self._fsa_cross_sol(gp_pars)
        n_p = coords_pred.shape[0]
        use_sim = predict_var and (
            (nsim_var_pred is not None and int(nsim_var_pred) > 0)
            or (nsim_var_pred is None
                and n_p * self.n > SIM_VAR_MIN_ENTRIES))
        if use_sim:
            if nsim_var_pred is None:
                log_info("Using simulation-based predictive variances "
                         "(large n_p * n; set 'nsim_var_pred=0' to force "
                         "the exact path)")
            mean, quad = sim_pred_mean_var(
                lambda cpc: self._fsa_cross(gp_pars, cpc, sol_mn),
                coords_pred, solve, psi_inv_r, int(nsim_var_pred or 1000),
                seed=self.seed_rand_vec_trace)
            var = gp_pars[0] - quad
            if predict_response:
                var = var + cov_pars[0]
            return mean, torch.clamp(var, min=0.0)
        means, variances = [], []
        for s in range(0, n_p, PRED_CHUNK):
            cross = self._fsa_cross(gp_pars, coords_pred[s:s + PRED_CHUNK],
                                    sol_mn)
            means.append(cross @ psi_inv_r)
            if predict_var:
                z = solve(cross.T)
                variances.append(gp_pars[0] - torch.sum(cross * z.T, dim=1))
        var = None
        if predict_var:
            var = torch.cat(variances)
            if predict_response:
                var = var + cov_pars[0]
        return torch.cat(means), var

    def _fsa_cross_sol(self, gp_pars):
        """C_mm^-1 C_mn [k, n] of the cross-covariance (once a
        prediction)."""
        c_nm = fops.cov_between(self.cov_fn, gp_pars, self.coords,
                                self.ind_points)
        return torch.linalg.solve(
            fops.inducing_cov(self.cov_fn, gp_pars, self.ind_points), c_nm.T)

    def _fsa_cross(self, gp_pars, coords_pred, sol_mn):
        """Q_pn + T o (Sigma_pn - Q_pn) [p, n]."""
        d_pn = fops.distance(coords_pred, self.coords)
        sigma_pn = self.cov_fn.cov_matrix(gp_pars, dist=d_pn)
        q_pn = fops.cov_between(self.cov_fn, gp_pars, coords_pred,
                                       self.ind_points) @ sol_mn
        T = wendland_correlation(d_pn, self.taper_range, self.taper_shape,
                                 self.taper_mu)
        return q_pn + T * (sigma_pn - q_pn)

    # ---- non-Gaussian (Laplace) -----------------------------------------
    def _latent_lowrank(self, gp_pars):
        """FITC's latent Sigma = V'V + diag(dD), V = L_mm^-1 C_mn [k, n]."""
        c_nm = fops.cov_between(self.cov_fn, gp_pars, self.coords,
                                self.ind_points)
        l_mm = fops.cholesky(fops.inducing_cov(self.cov_fn, gp_pars,
                                               self.ind_points))
        V = torch.linalg.solve_triangular(l_mm, c_nm.T, upper=False)
        dD = torch.clamp(gp_pars[0] - torch.sum(V * V, dim=0), min=1e-10)
        return V, dD, l_mm

    def _latent_sigma(self, gp_pars):
        """Full-scale tapering's dense latent Sigma = Q + T o (Sigma - Q)."""
        d_nn = fops.distance(self.coords, self.coords)
        c_nm = fops.cov_between(self.cov_fn, gp_pars, self.coords,
                                self.ind_points)
        Q = c_nm @ torch.linalg.solve(
            fops.inducing_cov(self.cov_fn, gp_pars, self.ind_points), c_nm.T)
        sigma = self.cov_fn.cov_matrix(gp_pars, dist=d_nn)
        T = wendland_correlation(d_nn, self.taper_range, self.taper_shape,
                                 self.taper_mu)
        return Q + T * (sigma - Q)

    def _F(self, fixed_part):
        if fixed_part is None:
            return torch.zeros(self.n, dtype=self.dtype, device=self.device)
        return fixed_part

    def nll_laplace(self, cov_pars, y, aux_pars, fixed_part=None):
        """Laplace NLL; cov_pars = [sigma1^2, range, ...] (no nugget).
        Differentiable in cov_pars, aux_pars and fixed_part."""
        F = self._F(fixed_part)
        if self.gp_approx == "fitc":
            V, dD, _ = self._latent_lowrank(cov_pars)
            return fitc_laplace_nll_woodbury(self.likelihood, V, dD, y, F,
                                             aux_pars)
        return _laplace_nll_from_sigma(self.likelihood,
                                       self._latent_sigma(cov_pars), y, F,
                                       aux_pars)

    def grad_F_laplace(self, cov_pars, y, aux_pars, fixed_part, **_):
        """d NLL / dF (the LaGaBoost gradient) by autograd."""
        return grad_wrt_F(lambda F: self.nll_laplace(cov_pars, y, aux_pars, F),
                          fixed_part)

    def predict_laplace(self, cov_pars, y, aux_pars, coords_pred,
                        fixed_part=None, fixed_part_pred=None,
                        predict_response=True, predict_var=False):
        """Laplace prediction. FITC: the Woodbury mode, the mean
        V_p' V d1 and the variance sigma1^2 - V_p' G (I + G)^-1 V_p with
        G = V diag(w / (1 + w dD)) V' [k, k] (= the dense
        Sigma_pn W (I + Sigma W)^-1 Sigma_np of the JAX package). Full-scale
        tapering: the dense route of the JAX package."""
        fam = lk.get_family(self.likelihood)
        F = self._F(fixed_part)
        aux = _aux_arg(aux_pars, y)
        auxv = _aux_val(aux)
        var = None
        if self.gp_approx == "fitc":
            V, dD, l_mm = self._latent_lowrank(cov_pars)
            b = _FindModeFITC.apply(V, dD, F, aux, self.likelihood, y)
            loc = F + b
            d1 = fam.d_loc(y, loc, auxv)
            w = -fam.d2_loc(y, loc, auxv)
            c_pm = fops.cov_between(self.cov_fn, cov_pars, coords_pred,
                                           self.ind_points)
            vp = torch.linalg.solve_triangular(l_mm, c_pm.T, upper=False)
            mean = vp.T @ (V @ d1)
            if predict_var or predict_response:
                G = (V * (w / (1.0 + w * dD))[None, :]) @ V.T
                eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
                H = torch.linalg.solve(eye + G, G)
                var = torch.clamp(cov_pars[0] - torch.sum(vp * (H @ vp), 0),
                                  min=1e-12)
        else:
            sigma = self._latent_sigma(cov_pars)
            b = find_mode(self.likelihood, sigma, y, F, aux)
            loc = F + b
            d1 = fam.d_loc(y, loc, auxv)
            w = -fam.d2_loc(y, loc, auxv)
            cross = self._fsa_cross(cov_pars, coords_pred,
                                    self._fsa_cross_sol(cov_pars))
            mean = cross @ d1
            if predict_var or predict_response:
                M = sigma * w[None, :]
                M.diagonal().add_(1.0)
                z = torch.linalg.solve(M, cross.T)
                var = torch.clamp(cov_pars[0] - torch.einsum(
                    "pn,np->p", cross, w[:, None] * z), min=1e-12)
        if fixed_part_pred is not None:
            mean = mean + fixed_part_pred
        if predict_response:
            mr, vr = _response_moments(self.likelihood, mean, var, auxv)
            return mr, (vr if predict_var else None)
        return mean, (var if predict_var else None)


# ---------------------------------------------------------------------------
# FITC-Laplace by Woodbury, O(n k^2) (``FindModePostRandEffCalcMLLFITC``)
# ---------------------------------------------------------------------------

def _sigma_mv(V, dD, x):
    """(V'V + diag(dD)) x for V [k, n], x [n]."""
    return V.T @ (V @ x) + dD * x


def _woodbury_solve(lam, U2, x):
    """(diag(lam) + U2' U2)^-1 x with U2 [k, n]."""
    xl = x / lam
    inner = (U2 / lam[None, :]) @ U2.T
    inner.diagonal().add_(1.0)
    t = torch.cholesky_solve((U2 @ xl)[:, None], fops.cholesky(inner))[:, 0]
    return xl - (U2.T @ t) / lam


def _mode_fitc(fam, V, dD, y, F, aux):
    """The stable Newton iteration (R&W Alg. 3.1) with Woodbury solves:
    a = c - W^1/2 B^-1 W^1/2 Sigma c, B = I + W^1/2 Sigma W^1/2, halving
    along (db, da) while psi = loglik - 1/2 a'b falls (the JAX package's
    ``_find_mode_fitc_impl``)."""
    n = y.shape[0]

    def objective(x):
        return torch.sum(fam.log_lik(y, F + x[:n], aux)) \
            - 0.5 * torch.dot(x[n:], x[:n])

    x = torch.zeros(2 * n, dtype=V.dtype, device=V.device)
    psi = float(objective(x))
    for _ in range(MAX_NEWTON_IT):
        b, a = x[:n], x[n:]
        loc = F + b
        d1 = fam.d_loc(y, loc, aux)
        w = torch.clamp(-fam.d2_loc(y, loc, aux), min=1e-10)
        sw = torch.sqrt(w)
        c = w * b + d1
        a_new = c - sw * _woodbury_solve(1.0 + w * dD, V * sw[None, :],
                                         sw * _sigma_mv(V, dD, c))
        delta = torch.cat([_sigma_mv(V, dD, a_new) - b, a_new - a])
        x, psi_new, _ = newton_halving(x, psi, delta, objective)
        conv = abs(psi_new - psi) < NEWTON_TOL * (abs(psi) + 1e-10)
        psi = psi_new
        if conv:
            break
    return x[:n]


class _FindModeFITC(torch.autograd.Function):
    """Posterior mode with FITC's latent Sigma = V'V + diag(dD),
    differentiable w.r.t. (V, dD, F, aux) by implicit differentiation of
    g = b - Sigma d1(y, F + b) = 0: lam = (I + W Sigma)^-1 v by a
    non-symmetric Woodbury solve, then the VJP of g at -lam (the JAX
    package's ``_find_mode_fitc_bwd``)."""

    @staticmethod
    def forward(ctx, V, dD, F, aux, lik_name, y):
        fam = lk.get_family(lik_name)
        b = _mode_fitc(fam, V, dD, y, F, _aux_val(aux))
        ctx.save_for_backward(V, dD, F, aux, y, b)
        ctx.lik_name = lik_name
        return b

    @staticmethod
    def backward(ctx, v):
        V, dD, F, aux, y, b = ctx.saved_tensors
        fam = lk.get_family(ctx.lik_name)

        def solve(w, rhs):
            # (I + W Sigma) = diag(A) + (V W)' V, A = 1 + w dD
            A = 1.0 + w * dD
            rl = rhs / A
            inner = (V * (w / A)[None, :]) @ V.T
            inner.diagonal().add_(1.0)
            t = torch.linalg.solve(inner, V @ rl)
            return rl - ((V * w[None, :]).T @ t) / A

        out = _mode_vjp_sigma(fam, y, b, v, solve, (V, dD, F, aux),
                              ctx.needs_input_grad[:4])
        return out[0], out[1], out[2], out[3], None, None


def _mode_vjp_sigma(fam, y, b, v, solve, inputs, needs):
    """VJP of the mode of g(V, dD, F, aux) = b - Sigma(V, dD) d1(y, F + b)
    = 0 at -lam, lam = (I + W Sigma)^-1 v."""
    V, dD, F, aux = inputs
    with torch.no_grad():
        lam = solve(-fam.d2_loc(y, F + b, _aux_val(aux)), v)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need and x.numel() > 0)
                  for x, need in zip(inputs, needs)]
        d1 = fam.d_loc(y, leaves[2] + b, _aux_val(leaves[3]))
        g = b - _sigma_mv(leaves[0], leaves[1], d1)
        wrt = [x for x in leaves if x.requires_grad]
        grads = iter(ag.grad(g, wrt, grad_outputs=-lam,
                           allow_unused=True) if wrt else ())
    out = []
    for x in leaves:
        gr = next(grads) if x.requires_grad else None
        if gr is None and x.requires_grad:
            gr = torch.zeros_like(x)
        out.append(gr)
    return out


def fitc_laplace_nll_woodbury(lik_name, V, dD, y, F, aux):
    """Laplace NLL with FITC's latent Sigma = V'V + diag(dD), O(n k^2):
    logdet(I + W Sigma) = sum log(1 + w dD) + logdet(I_k + U2 diag(1/lam)
    U2'), U2 = V W^1/2 (the JAX package's ``fitc_laplace_nll_woodbury``)."""
    fam = lk.get_family(lik_name)
    auxt = _aux_arg(aux, y)
    b = _FindModeFITC.apply(V, dD, F, auxt, lik_name, y)
    auxv = _aux_val(auxt)
    loc = F + b
    d1 = fam.d_loc(y, loc, auxv)
    w = -fam.d2_loc(y, loc, auxv)
    loglik = torch.sum(fam.log_lik(y, loc, auxv))
    lam = 1.0 + w * dD
    U2 = V * torch.sqrt(torch.clamp(w, min=0.0))[None, :]
    inner = (U2 / lam[None, :]) @ U2.T
    inner.diagonal().add_(1.0)
    _, ld_inner = torch.linalg.slogdet(inner)
    logdet = torch.sum(torch.log(lam)) + ld_inner
    return -(loglik - 0.5 * torch.dot(b, d1) - 0.5 * logdet)
