"""Deterministic RNG utilities.

The linear-congruential generators used by the reference's R test suite
(``R-package/tests/testthat/test_GPModel_gaussian_process.R:29-35``) so that
simulated fixture data is bit-identical across languages and platforms.
On-device sampling in the port uses explicit ``torch.Generator`` objects at
the call site; there is no global generator.
"""
from __future__ import annotations

import numpy as np


def sim_rand_unif(n: int, init_c: float = 0.1) -> np.ndarray:
    """Simulate ``n`` uniforms with the reference test-suite LCG.

    Mirrors ``sim_rand_unif`` in the reference R tests: seed is
    ``floor(init_c * 2^32)``; recurrence ``x <- (22695477 x + 1) mod 2^32``
    (the Borland C "random0" LCG). Returned values are ``x / 2^32``.

    CRITICAL: R evaluates the recurrence in *double* arithmetic, and the
    products exceed 2^53, so IEEE-754 rounding is part of the de-facto spec.
    We therefore compute ``a*x + 1`` and ``%%`` exactly as R does (float64
    multiply, add, then x - floor(x/m)*m), NOT in exact integer arithmetic.
    """
    mod_lcg = float(2 ** 32)
    a = 22695477.0
    out = np.empty(n, dtype=np.float64)
    x = np.floor(init_c * mod_lcg)
    out[0] = x
    for i in range(1, n):
        x = a * x + 1.0
        x = x - np.floor(x / mod_lcg) * mod_lcg
        out[i] = x
    return out / mod_lcg


def sim_rand_unif_boost(n: int, init_c: float = 0.1) -> np.ndarray:
    """The second LCG used by the combined-algorithm R tests
    (``test_z_GPBoost_algorithm.R:25-31``): x <- (8121 x + 28411) mod 134456.
    Products stay below 2^53, so plain float64 arithmetic is exact."""
    mod_lcg = 134456.0
    out = np.empty(n, dtype=np.float64)
    x = np.floor(init_c * mod_lcg)
    out[0] = x
    for i in range(1, n):
        x = 8121.0 * x + 28411.0
        x = x - np.floor(x / mod_lcg) * mod_lcg
        out[i] = x
    return out / mod_lcg


def sim_rand_normal(n: int, init_c: float) -> np.ndarray:
    """``qnorm(sim_rand_unif(...))`` as used by the reference tests."""
    from scipy.stats import norm

    return norm.ppf(sim_rand_unif(n, init_c))
