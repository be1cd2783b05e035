"""Covariance function library (vectorized, differentiable PyTorch).

Covariance families of the reference's ``include/GPBoost/cov_fcts.h``
(GPBoost v1.6.5) as plain functions mapping pairwise structure (distances or
coordinates) + parameters to dense covariance matrices. Gradients w.r.t. the
parameters come from ``torch.autograd``.

Ported so far (the families the Vecchia kernels serve):

- ``matern`` shape 0.5 / ``exponential``:  sigma2 * exp(-d / rho)
- ``matern`` shape 1.5:  sigma2 * (1 + s3) * exp(-s3),        s3 = sqrt(3) d / rho
- ``matern`` shape 2.5:  sigma2 * (1 + s5 + s5^2/3) exp(-s5), s5 = sqrt(5) d / rho
- ``gaussian`` (sq. exponential): sigma2 * exp(-(d/rho)^2)
- ``matern_ard`` / ``gaussian_ard`` via per-dimension coordinate scaling
  (``cov_fcts.h:249-330``).

General-shape Matern (Bessel K), the wendland covariance and tapering,
space-time, hurst, linear and powered_exponential are queued in ROADMAP.md
(Queue A, item 14) and raise ``NotImplementedError`` here; only the Wendland
taper of ``full_scale_tapering`` (:func:`wendland_correlation`) is ported.

Parameter vector layout per component (original scale, as user-facing):
``[sigma2, range]`` for isotropic, ``[sigma2, rho_1..rho_d]`` for ARD.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)

ISOTROPIC_TYPES = frozenset({"matern", "gaussian"})
ARD_TYPES = frozenset({"matern_ard", "gaussian_ard"})
SUPPORTED_COV_TYPES = frozenset(ISOTROPIC_TYPES | ARD_TYPES)
# known to the reference, not ported yet
_QUEUED_COV_TYPES = frozenset({
    "powered_exponential", "wendland", "matern_space_time",
    "matern_estimate_shape", "matern_ard_estimate_shape", "linear",
    "space_time_gneiting", "hurst"})
_PORTED_MATERN_SHAPES = (0.5, 1.5, 2.5)


def parse_cov_alias(cov_fct_type: str, shape: float) -> tuple[str, float]:
    """Resolve covariance-name aliases as the reference does.

    ``exponential`` == matern(0.5); ``sq_exp``/``rbf`` -> gaussian.
    """
    if cov_fct_type == "exponential":
        return "matern", 0.5
    if cov_fct_type == "exponential_space_time":
        return "matern_space_time", 0.5
    if cov_fct_type in ("sq_exp", "rbf", "squared_exponential"):
        return "gaussian", shape
    if cov_fct_type == "linear_no_woodbury":
        return "linear", shape
    return cov_fct_type, shape


def _matern_correlation(scaled_dist: torch.Tensor, shape: float) -> torch.Tensor:
    """Matern correlation given the *transformed* distance x = c(nu) d / rho.

    c(0.5)=1, c(1.5)=sqrt(3), c(2.5)=sqrt(5).
    """
    x = scaled_dist
    if abs(shape - 0.5) < 1e-10:
        return torch.exp(-x)
    if abs(shape - 1.5) < 1e-10:
        return (1.0 + x) * torch.exp(-x)
    if abs(shape - 2.5) < 1e-10:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    raise NotImplementedError(
        f"matern shape {shape}: only 0.5, 1.5 and 2.5 are ported (general "
        "shapes: ROADMAP.md Queue A, item 14)")


def _matern_mult_const(shape: float) -> float:
    if abs(shape - 0.5) < 1e-9:
        return 1.0
    if abs(shape - 1.5) < 1e-9:
        return SQRT3
    if abs(shape - 2.5) < 1e-9:
        return SQRT5
    return math.sqrt(2.0 * shape)


def euclidean_distance(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [..., n1, n2] via inner products (the
    same formula as the reference package, so that both agree to rounding);
    leading batch dimensions broadcast."""
    sq1 = torch.sum(c1 * c1, dim=-1)[..., :, None]
    sq2 = torch.sum(c2 * c2, dim=-1)[..., None, :]
    d2 = torch.clamp(sq1 + sq2 - 2.0 * (c1 @ c2.transpose(-1, -2)), min=0.0)
    # double-where: sqrt'(0) = inf would poison gradients when coordinates are
    # parameter-scaled (ARD) and i == j distances are exactly 0
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def wendland_correlation(dist: torch.Tensor, taper_range: float,
                         taper_shape: float, taper_mu: float) -> torch.Tensor:
    """Wendland correlation (compact support), shapes 0, 1 and 2
    (``cov_fcts.h`` ``WendlandCorrelationShape{0,1,2}``, the Bevilacqua et
    al. (2019) parametrisation) — the taper of ``full_scale_tapering``. The
    wendland covariance and ``gp_approx="tapering"`` themselves stay queued
    (ROADMAP.md Queue A, item 14)."""
    r = dist / taper_range
    rc = torch.clamp(r, max=1.0)
    base = torch.clamp(1.0 - rc, min=0.0)
    if abs(taper_shape) < 1e-10:
        corr = torch.pow(base, taper_mu)
    elif abs(taper_shape - 1.0) < 1e-10:
        corr = torch.pow(base, taper_mu + 1.0) * (1.0 + rc * (taper_mu + 1.0))
    elif abs(taper_shape - 2.0) < 1e-10:
        corr = torch.pow(base, taper_mu + 2.0) * (
            1.0 + rc * (taper_mu + 2.0)
            + rc * rc * (taper_mu * taper_mu + 4.0 * taper_mu + 3.0) / 3.0)
    else:
        raise ValueError(
            f"taper_shape {taper_shape} not supported (only 0, 1, 2)")
    return torch.where(r >= 1.0, torch.zeros_like(corr), corr)


@dataclass(frozen=True)
class CovFunction:
    """Static spec of one covariance function (hashable).

    Equivalent of the reference's ``CovFunction<T_mat>`` class
    (``cov_fcts.h:46``): instead of element-loop lambdas it exposes
    whole-matrix functions over distances/coordinates.
    """

    cov_fct_type: str
    shape: float = 0.0
    dim_coords: int = 2

    @staticmethod
    def create(cov_fct_type: str, shape: float = 0.0,
               dim_coords: int = 2) -> "CovFunction":
        cov_fct_type, shape = parse_cov_alias(cov_fct_type, shape)
        if cov_fct_type in _QUEUED_COV_TYPES:
            raise NotImplementedError(
                f"covariance '{cov_fct_type}' is not ported yet (ROADMAP.md "
                "Queue A, item 14); ported: exponential, matern / matern_ard "
                "with shape 0.5, 1.5 or 2.5, gaussian / gaussian_ard")
        if cov_fct_type not in SUPPORTED_COV_TYPES:
            raise ValueError(
                f"Covariance of type '{cov_fct_type}' is not supported")
        if cov_fct_type in ("matern", "matern_ard"):
            if shape <= 0.0:
                raise ValueError("'shape' must be > 0 for matern covariances")
            if not any(abs(shape - s) < 1e-10 for s in _PORTED_MATERN_SHAPES):
                raise NotImplementedError(
                    f"matern shape {shape}: only 0.5, 1.5 and 2.5 are ported "
                    "(general shapes: ROADMAP.md Queue A, item 14)")
        return CovFunction(cov_fct_type, shape, dim_coords)

    # ---- parameter bookkeeping -------------------------------------------
    @property
    def num_cov_par(self) -> int:
        if self.cov_fct_type in ARD_TYPES:
            return 1 + self.dim_coords
        return 2  # [sigma2, range]

    @property
    def is_isotropic(self) -> bool:
        return self.cov_fct_type in ISOTROPIC_TYPES

    @property
    def has_coord_scaling(self) -> bool:
        """True when the kernel is isotropic in per-dimension SCALED
        coordinates (ARD): k(s, s') = sigma2 * corr(||scale(s) - scale(s')||)
        with unit transformed range (``cov_fcts.h:249`` anisotropic
        coordinate scaling). This is what makes Vecchia neighbor search +
        batched factor builds work for anisotropic kernels."""
        return self.cov_fct_type in ARD_TYPES

    def corr_from_scaled_dist(self, sdist: torch.Tensor,
                              pars: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """Correlation given distances in the SCALED coordinate space."""
        t = self.cov_fct_type
        if t == "matern_ard":
            return _matern_correlation(sdist, self.shape)
        if t == "gaussian_ard":
            return torch.exp(-sdist * sdist)
        raise ValueError(f"corr_from_scaled_dist: unsupported type {t}")

    # ---- covariance evaluation -------------------------------------------
    def correlation_from_dist(self, dist: torch.Tensor,
                              pars: torch.Tensor) -> torch.Tensor:
        """Correlation matrix for isotropic types given raw distances."""
        t = self.cov_fct_type
        if t == "matern":
            c = _matern_mult_const(self.shape)
            return _matern_correlation(c * dist / pars[1], self.shape)
        if t == "gaussian":
            r = dist / pars[1]
            return torch.exp(-r * r)
        raise ValueError(f"correlation_from_dist: unsupported type {t}")

    def scale_coords(self, coords: torch.Tensor,
                     pars: torch.Tensor) -> torch.Tensor:
        """Per-dimension coordinate scaling for ARD types.

        After scaling, the covariance is the base function with unit
        (transformed) range on the scaled distance (``cov_fcts.h:249-330``).
        """
        t = self.cov_fct_type
        d = coords.shape[1]
        if t == "matern_ard":
            c = _matern_mult_const(self.shape)
            return coords * (c / pars[1:1 + d])[None, :]
        if t == "gaussian_ard":
            return coords / pars[1:1 + d][None, :]
        raise ValueError(f"scale_coords: unsupported type {t}")

    def cov_between(self, pars: torch.Tensor, coords1: torch.Tensor,
                    coords2: torch.Tensor) -> torch.Tensor:
        """Covariance between two coordinate sets, dispatching distances for
        isotropic kernels and raw coordinates for anisotropic ones."""
        if self.is_isotropic:
            return self.cov_matrix(pars,
                                   dist=euclidean_distance(coords1, coords2))
        return self.cov_matrix(pars, coords1=coords1, coords2=coords2)

    def cov_matrix(self, pars: torch.Tensor,
                   dist: Optional[torch.Tensor] = None,
                   coords1: Optional[torch.Tensor] = None,
                   coords2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Dense covariance matrix.

        For isotropic types pass ``dist`` (precomputed distances; reference
        ``use_precomputed_dist_for_calc_cov_``); for ARD pass coordinates.
        Returns ``[n1, n2]``.
        """
        if self.is_isotropic:
            if dist is None:
                dist = euclidean_distance(
                    coords1, coords1 if coords2 is None else coords2)
            return pars[0] * self.correlation_from_dist(dist, pars)
        # coordinate-based (ARD)
        cs1 = self.scale_coords(coords1, pars)
        cs2 = (cs1 if coords2 is None or coords2 is coords1
               else self.scale_coords(coords2, pars))
        sdist = euclidean_distance(cs1, cs2)
        return pars[0] * self.corr_from_scaled_dist(sdist, pars)
