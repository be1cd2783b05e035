"""``cluster_ids`` under the inducing-point and full-scale approximations
(PyTorch port of ``gpboost_tpu/models/clustered_approx.py``).

The reference keeps one approximation per cluster and loops over them
(``re_model_template.h:6015``; each cluster selects its own inducing points
from its own coordinates). Here each cluster gets its own sub-model
(:class:`FITCGP` / :class:`FSVAGP`) and the likelihood is the sum over the
independent clusters. When the clusters have one size (and the sub-models
one kind, number of inducing points and, for FSVA, Euclidean neighbours)
the Gaussian NLL, its gradient and the Psi^-1 solves run on one batched
model over all clusters (``FITCGP.stack`` / ``FSVAGP.stack``) — the JAX
package's batched layout — instead of the loop. Predictions and the
Laplace approximation loop over the sub-models, as in the JAX package; a
cluster training never saw gets the prior. Rows go to the clusters and
back by gathers only (no scatter).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gpboost_tpu_torch.models.fitc_model import (FITCGP, gls_coef,
                                                 grad_wrt_F,
                                                 log_scale_value_and_grad)
from gpboost_tpu_torch.models.fsva_model import FSVAGP
from gpboost_tpu_torch.models.laplace import _aux_arg, _aux_val, \
    _response_moments


class ClusteredApprox:
    """One sub-model per ``cluster_id``, sharing the covariance
    parameters; ``make_sub(coords_of_cluster)`` builds one."""

    def __init__(self, coords: np.ndarray, cluster_codes: np.ndarray,
                 make_sub: Callable, likelihood: str = "gaussian",
                 dtype=torch.float64, device="cuda"):
        codes = np.asarray(cluster_codes, np.int64).ravel()
        self.n = coords.shape[0]
        self.likelihood = likelihood
        self.dtype = dtype
        self.num_clusters = int(codes.max()) + 1
        self.idx = [np.flatnonzero(codes == c)
                    for c in range(self.num_clusters)]
        self.subs = [make_sub(np.asarray(coords)[ix]) for ix in self.idx]
        self.device = self.subs[0].device
        self.cov_fn = self.subs[0].cov_fn
        order = np.concatenate(self.idx)
        self._idx_t = [torch.as_tensor(ix, device=self.device)
                       for ix in self.idx]
        self._order = torch.as_tensor(order, device=self.device)
        self._inv_order = torch.as_tensor(np.argsort(order),
                                          device=self.device)
        self.stacked = self._stack()

    def _stack(self):
        """The batched model over all clusters, or None where they differ
        (sizes, kinds, numbers of inducing points or neighbours)."""
        subs = self.subs
        if self.likelihood != "gaussian" or len(subs) < 2 or len(
                {s.n for s in subs}) != 1:
            return None
        if all(isinstance(s, FITCGP) and not s._use_iterative
               for s in subs):
            if len({(s.gp_approx, tuple(s.ind_points.shape))
                    for s in subs}) == 1:
                return FITCGP.stack(subs)
        elif all(isinstance(s, FSVAGP) for s in subs):
            if len({(tuple(s.ind_points.shape), tuple(s.neighbors.shape))
                    for s in subs if s.neighbors is not None}) == 1 and not \
                    subs[0].redetermines_neighbors:
                return FSVAGP.stack(subs)
        return None

    @property
    def redetermines_neighbors(self) -> bool:
        return any(getattr(s, "redetermines_neighbors", False)
                   for s in self.subs)

    def sync_iter_cfg(self, cfg):
        """Pass the iterative route's settings to every sub-model."""
        for sub in self.subs:
            if hasattr(sub, "sync_iter_cfg"):
                sub.sync_iter_cfg(cfg)

    def ensure_neighbors(self, cov_pars_full):
        for sub in self.subs:
            sub.ensure_neighbors(cov_pars_full)

    def _parts(self, v):
        return [None if v is None else v[ix] for ix in self._idx_t]

    def _ordered(self, v):
        return None if v is None else v[self._order]

    # ---- Gaussian -------------------------------------------------------
    def nll_gaussian(self, cov_pars, y, fixed_part=None):
        if self.stacked is not None:
            return self.stacked.nll_gaussian(cov_pars, self._ordered(y),
                                             self._ordered(fixed_part))
        return sum(sub.nll_gaussian(cov_pars, yc, fc) for sub, yc, fc in
                   zip(self.subs, self._parts(y), self._parts(fixed_part)))

    def nll_gaussian_value(self, cov_pars, y, fixed_part=None):
        with torch.no_grad():
            return self.nll_gaussian(cov_pars, y, fixed_part)

    def _vg_gaussian(self, th, y, fp):
        return log_scale_value_and_grad(self.nll_gaussian, th, y, fp)

    def psi_inv_resid(self, cov_pars, R):
        """Psi^-1 R in the data's row order (block-diagonal Psi)."""
        if self.stacked is not None:
            out = self.stacked.psi_inv_resid(cov_pars, R[self._order])
        else:
            out = torch.cat([sub.psi_inv_resid(cov_pars, Rc) for sub, Rc in
                             zip(self.subs, self._parts(R))])
        return out[self._inv_order]

    def wls_coef(self, cov_pars, y, X, fixed_effects=None):
        return gls_coef(self.psi_inv_resid, cov_pars, y, X, fixed_effects)

    def _by_cluster(self, codes_pred, fn, prior):
        """Assemble per-cluster results: ``fn(c, sel)`` for a cluster
        training saw, ``prior(sel)`` for one it did not; returns a list of
        tensors in the prediction points' order (a gather)."""
        codes = np.asarray(codes_pred, np.int64).ravel()
        parts, sels = None, []
        for c in np.unique(codes):
            sel = np.flatnonzero(codes == c)
            sel_t = torch.as_tensor(sel, device=self.device)
            out = fn(int(c), sel_t) if c < self.num_clusters else prior(sel_t)
            parts = ([[o] for o in out] if parts is None
                     else [p + [o] for p, o in zip(parts, out)])
            sels.append(sel)
        back = torch.as_tensor(np.argsort(np.concatenate(sels)),
                               device=self.device)
        return [None if p[0] is None else torch.cat(p)[back] for p in parts]

    def predict_gaussian(self, cov_pars, y, coords_pred, fixed_part=None,
                         predict_response=True, predict_var=False,
                         codes_pred=None, nsim_var_pred=None):
        if codes_pred is None:
            raise ValueError("cluster_ids_pred is required for predictions "
                             "from a model trained with cluster_ids")
        r = y if fixed_part is None else y - fixed_part
        rs = self._parts(r)

        def seen(c, sel):
            return self.subs[c].predict_gaussian(
                cov_pars, rs[c], coords_pred[sel], None, predict_response,
                predict_var, nsim_var_pred=nsim_var_pred)

        def prior(sel):
            pv = cov_pars[1] + (cov_pars[0] if predict_response else 0.0)
            ones = torch.ones(sel.shape[0], dtype=self.dtype,
                              device=self.device)
            return 0.0 * ones, (pv * ones if predict_var else None)

        mean, var = self._by_cluster(codes_pred, seen, prior)
        return mean, var

    # ---- non-Gaussian (Laplace) -----------------------------------------
    def nll_laplace(self, cov_pars, y, aux_pars, fixed_part=None):
        return sum(sub.nll_laplace(cov_pars, yc, aux_pars, fc)
                   for sub, yc, fc in zip(self.subs, self._parts(y),
                                          self._parts(fixed_part)))

    def grad_F_laplace(self, cov_pars, y, aux_pars, fixed_part, **_):
        return grad_wrt_F(lambda F: self.nll_laplace(cov_pars, y, aux_pars, F),
                          fixed_part)

    def predict_laplace(self, cov_pars, y, aux_pars, coords_pred,
                        fixed_part=None, fixed_part_pred=None,
                        predict_response=True, predict_var=False,
                        codes_pred=None):
        if codes_pred is None:
            raise ValueError("cluster_ids_pred is required for predictions "
                             "from a model trained with cluster_ids")
        ys, fs = self._parts(y), self._parts(fixed_part)
        auxv = _aux_val(_aux_arg(aux_pars, y))

        def fpp(sel):
            return None if fixed_part_pred is None else fixed_part_pred[sel]

        def seen(c, sel):
            return self.subs[c].predict_laplace(
                cov_pars, ys[c], aux_pars, coords_pred[sel], fs[c], fpp(sel),
                predict_response, True)

        def prior(sel):
            mu0 = torch.zeros(sel.shape[0], dtype=self.dtype,
                              device=self.device)
            if fixed_part_pred is not None:
                mu0 = mu0 + fpp(sel)
            v0 = cov_pars[0] * torch.ones_like(mu0)
            if predict_response:
                return _response_moments(self.likelihood, mu0, v0, auxv)
            return mu0, v0

        mean, var = self._by_cluster(codes_pred, seen, prior)
        return mean, (var if predict_var else None)
