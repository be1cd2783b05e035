"""PyTorch port vs the JAX package: the covariance families beyond the
exponential / Matern 0.5-1.5-2.5 / gaussian ones (``ops/cov_fns.py``).

The same numpy-seeded coordinates and parameters go through
``gpboost_tpu.ops.cov_fns`` and ``gpboost_tpu_torch.ops.cov_fns``.
Tolerances: covariance matrices 1e-12 relative (float64, the same formulas;
the ranges of the Bessel-series families keep the transformed distance
below ~4, where the series is well conditioned); the Bessel K and the
traced-order Matern correlation over nu in {0.3, 1.0, 3.7, 9.5} (nu >= 8
takes the log-space expansion) 1e-10 relative plus the series' own
rounding bound. The series K = pi/2 (I_-nu - I_nu) / sin(nu pi) cancels:
rounding of relative size eps in its terms becomes eps e^(2x) / |sin(nu
pi)| in K (both packages compute it so, and each lies that far from
``scipy.special.kv`` near x = 10, the switch to the asymptotic branch), so
the bound is 16 eps e^(2 min(x, 10)) / |sin(nu_eff pi)| for nu < 8. The
gradients in nu and in the range against ``jax.grad`` at 1e-8 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.ops import cov_fns as jcov
from gpboost_tpu_torch.ops import cov_fns as tcov


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (name, shape, create kwargs, dimension): every family the port gained
FAMILIES = [
    ("matern", 0.8, {}, 2),
    ("matern", 1.0, {}, 2),
    ("matern", 3.7, {}, 2),
    ("powered_exponential", 1.5, {}, 2),
    ("wendland", 0.0, dict(taper_shape=0.0, taper_range=0.6), 2),
    ("wendland", 0.0, dict(taper_shape=1.0, taper_range=0.6), 2),
    ("wendland", 0.0, dict(taper_shape=2.0, taper_range=0.6), 2),
    ("exponential", 0.0, dict(apply_tapering=True, taper_shape=1.0,
                              taper_range=0.5), 2),
    ("matern_space_time", 1.5, {}, 3),
    ("exponential_space_time", 0.0, {}, 3),
    ("matern_estimate_shape", 0.0, {}, 2),
    ("matern_ard_estimate_shape", 0.0, {}, 2),
    ("linear", 0.0, {}, 2),
    ("hurst", 0.0, {}, 2),
    ("space_time_gneiting", 0.0, {}, 3),
]
IDS = [f"{n}-{s}-{i}" for i, (n, s, _, _) in enumerate(FAMILIES)]


def _pars(name, num_par, rng):
    if name == "space_time_gneiting":
        return np.array([1.3, 0.9, 2.0, 0.7, 1.2, 0.6, 0.4])
    if name == "hurst":
        return np.array([1.3, 0.35])
    # the Bessel-series families: ranges that keep x = sqrt(2 nu) d / rho
    # below ~4 (module docstring)
    series = name.endswith("estimate_shape") or name in ("matern",
                                                         "matern_space_time")
    extra = rng.uniform(0.8, 1.2, num_par - 1) if series else rng.uniform(
        0.1, 0.4, num_par - 1)
    if name.endswith("estimate_shape"):
        extra[-1] = 1.7
    return np.concatenate([[1.3], extra])


@pytest.mark.parametrize("name,shape,kw,dim", FAMILIES, ids=IDS)
def test_cov_matrix_matches_jax(name, shape, kw, dim):
    rng = np.random.default_rng(7)
    c1 = rng.uniform(size=(30, dim))
    c2 = rng.uniform(size=(20, dim))
    jf = jcov.CovFunction.create(name, shape=shape, dim_coords=dim, **kw)
    tf = tcov.CovFunction.create(name, shape=shape, dim_coords=dim, **kw)
    assert (tf.cov_fct_type, tf.num_cov_par, tf.is_isotropic,
            tf.has_coord_scaling, tf.taper_mu) == (
        jf.cov_fct_type, jf.num_cov_par, jf.is_isotropic,
        jf.has_coord_scaling, jf.taper_mu)
    pars = _pars(jf.cov_fct_type, jf.num_cov_par, rng)
    # the families whose distances the port takes from coordinate
    # differences (a point's distance to itself exactly 0) against the JAX
    # function compiled, as its models run it (XLA gives that 0 too); the
    # others (inner products on both sides) eager
    cov_j = (jax.jit(jf.cov_between) if jf.cov_fct_type in (
        "hurst", "space_time_gneiting", "matern_estimate_shape",
        "matern_ard_estimate_shape") else jf.cov_between)
    for a, b in ((c1, c2), (c1, c1)):
        want = np.asarray(cov_j(jnp.asarray(pars), jnp.asarray(a),
                                jnp.asarray(b)))
        got = tf.cov_between(torch.tensor(pars), torch.tensor(a),
                             torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_supported_names_match_jax():
    assert tcov.SUPPORTED_COV_TYPES == jcov.SUPPORTED_COV_TYPES
    assert tcov.ISOTROPIC_TYPES == jcov.ISOTROPIC_TYPES
    assert tcov.SPACE_TIME_TYPES == jcov.SPACE_TIME_TYPES
    for name in jcov.SUPPORTED_COV_TYPES:
        tcov.CovFunction.create(name, shape=1.5, dim_coords=3)
    with pytest.raises(ValueError, match="shape"):
        tcov.CovFunction.create("powered_exponential", shape=2.5)
    with pytest.raises(ValueError, match="shape"):
        tcov.CovFunction.create("matern", shape=-1.0)


@pytest.mark.parametrize("name,shape,dim,apply", [
    ("wendland", 0.0, 2, False), ("wendland", 2.0, 3, False),
    ("matern", 1.0, 2, True), ("exponential", 1.0, 1, False)])
def test_get_taper_mu_matches_jax(name, shape, dim, apply):
    assert tcov.get_taper_mu(name, shape, dim, apply) == \
        jcov.get_taper_mu(name, shape, dim, apply)


NUS = [0.3, 1.0, 3.7, 9.5]
X = np.concatenate([[1e-13, 1e-6, 0.01], np.linspace(0.05, 9.9, 40),
                    np.linspace(10.0, 40.0, 12)])


def _assert_series_close(got, want, x, nu):
    """|got - want| <= (1e-10 + the series' rounding bound) |want|."""
    nu_eff = nu if abs(nu - round(nu)) >= 1e-4 else round(nu) + 1e-4
    bound = 1e-10 + (0.0 if nu >= 8 else 16.0 * np.finfo(float).eps
                     * np.exp(2.0 * np.minimum(x, 10.0))
                     / abs(np.sin(nu_eff * np.pi)))
    assert np.all(np.abs(got - want) <= bound * np.abs(want)), \
        np.max(np.abs(got - want) / (bound * np.abs(want)))


@pytest.mark.parametrize("nu", NUS)
def test_bessel_and_traced_correlation_match_jax(nu):
    nu_t = torch.tensor(nu, dtype=torch.float64)
    got = tcov.matern_correlation_traced(torch.tensor(X), nu_t).numpy()
    want = np.asarray(jcov.matern_correlation_traced(jnp.asarray(X), nu))
    _assert_series_close(got, want, X, nu)
    # where the series is well conditioned (x <= 2) and on the asymptotic
    # branch (x >= 10), 1e-10 alone
    ok = (X <= 2.0) | (X >= 10.0) | (nu >= 8)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10)
    if nu < 8:
        xs = X[X > 1e-3]
        _assert_series_close(
            tcov.bessel_kv_traced(nu_t, torch.tensor(xs)).numpy(),
            np.asarray(jcov.bessel_kv_traced(nu, jnp.asarray(xs))), xs, nu)
        _assert_series_close(
            tcov._bessel_kv(nu, torch.tensor(xs)).numpy(),
            np.asarray(jcov._bessel_kv(nu, jnp.asarray(xs))), xs, nu)
        _assert_series_close(
            tcov._matern_correlation(torch.tensor(X), nu).numpy(),
            np.asarray(jcov._matern_correlation(jnp.asarray(X), nu)), X, nu)


@pytest.mark.parametrize("nu", NUS)
def test_shape_and_range_gradients_match_jax_grad(nu):
    """d/d(nu, rho) of a sum of estimated-shape correlations against
    ``jax.grad`` of the JAX function (the reference's finite differences
    are replaced by autograd through the series on both sides)."""
    rng = np.random.default_rng(11)
    d = rng.uniform(0.0, 1.2, size=(9, 9))
    w = rng.normal(size=(9, 9))
    jf = jcov.CovFunction.create("matern_estimate_shape")
    tf = tcov.CovFunction.create("matern_estimate_shape")

    def jfun(p):
        return jnp.sum(jnp.asarray(w) * jf.cov_matrix(p, dist=jnp.asarray(d)))

    # range 1: x = sqrt(2 nu) d / rho stays where the series is well
    # conditioned (module docstring)
    p0 = np.array([1.1, 1.0, nu])
    want = np.asarray(jax.grad(jfun)(jnp.asarray(p0)))
    pt = torch.tensor(p0, requires_grad=True)
    torch.sum(torch.tensor(w) * tf.cov_matrix(pt, dist=torch.tensor(d))
              ).backward()
    np.testing.assert_allclose(pt.grad.numpy(), want, rtol=1e-8, atol=1e-12)


def test_chunked_evaluation_equals_the_plain_one(monkeypatch):
    """The chunked route of large inputs (value, first and second
    derivatives, and the value under ``no_grad``) equals the plain one on
    the same entries."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(0.0, 12.0, 500))
    w = torch.tensor(rng.normal(size=500))

    def run():
        nu = torch.tensor(1.7, requires_grad=True)
        xx = x.clone().requires_grad_(True)
        v = torch.sum(w * tcov.matern_correlation_traced(xx, nu))
        gx, gnu = torch.autograd.grad(v, (xx, nu), create_graph=True)
        (h,) = torch.autograd.grad(gnu, nu)
        fixed = tcov._matern_correlation(x.clone().requires_grad_(True), 0.8)
        with torch.no_grad():
            value_only = tcov.matern_correlation_traced(x, 1.7)
        return (v.detach(), gx.detach(), gnu.detach(), h, fixed.detach(),
                value_only)

    plain = run()
    monkeypatch.setattr(tcov, "BESSEL_CHUNK", 64)
    chunked = run()
    for a, b in zip(plain, chunked):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13,
                                   atol=1e-15)
    # first-order gradients through the chunked backward alone
    nu = torch.tensor(2.3, requires_grad=True)
    xx = x.clone().requires_grad_(True)
    torch.sum(w * tcov.matern_correlation_traced(xx, nu)).backward()
    monkeypatch.setattr(tcov, "BESSEL_CHUNK", 2 ** 21)
    nu2 = torch.tensor(2.3, requires_grad=True)
    xx2 = x.clone().requires_grad_(True)
    torch.sum(w * tcov.matern_correlation_traced(xx2, nu2)).backward()
    np.testing.assert_allclose(nu.grad.numpy(), nu2.grad.numpy(), rtol=1e-13)
    np.testing.assert_allclose(xx.grad.numpy(), xx2.grad.numpy(), rtol=1e-13,
                               atol=1e-15)


@pytest.mark.parametrize("cov,approx,cp", [
    ("matern_space_time", "fitc", [0.2, 1.0, 0.3, 0.4]),
    ("matern_space_time", "full_scale_tapering", [0.2, 1.0, 0.3, 0.4]),
    ("matern_estimate_shape", "fitc", [0.2, 1.0, 0.3, 1.2]),
    ("matern_estimate_shape", "full_scale_vecchia", [0.2, 1.0, 0.3, 1.2]),
    ("hurst", "full_scale_tapering", [0.2, 1.0, 0.4]),
    ("linear", "full_scale_tapering", [0.2, 1.0])])
def test_lowrank_models_take_the_new_families(cov, approx, cp):
    """FITC, full-scale tapering and full-scale Vecchia with the new
    families where the JAX package runs them: its NLL within 1e-10
    relative (full-scale Vecchia on the JAX package's structure)."""
    rng = np.random.default_rng(0)
    n = 150
    c = np.column_stack([np.repeat(np.arange(15.0), 10) / 15,
                         rng.uniform(size=(n, 2))])
    y = np.sin(5 * c[:, 1]) + rng.normal(0.0, 0.3, n)
    kw = dict(gp_coords=c, cov_function=cov, gp_approx=approx,
              num_ind_points=20, cov_fct_shape=1.5)
    if approx == "full_scale_vecchia":
        kw["num_neighbors"] = 8
    jm, tm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    if approx == "full_scale_vecchia":
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
    nll_j = jm.neg_log_likelihood(cov_pars=cp, y=y)
    assert abs(tm.neg_log_likelihood(cp, y) - nll_j) < 1e-10 * abs(nll_j)


class _Records(torch.autograd.Function):
    """Identity whose backward records whether the engine could have run it
    on a worker thread of its own."""
    seen = []

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Records.seen.append(torch._C._is_multithreading_enabled())
        return g


def test_port_grads_run_on_the_calling_thread():
    """``utils.autograd.grad`` runs the backward pass with the engine's
    multithreading off (so on the calling thread, also on a GPU, where the
    autograd sequence numbers of nested create_graph derivatives would
    otherwise come from the worker's counter), and leaves the caller's
    setting as it was."""
    from gpboost_tpu_torch.utils import autograd as ag
    x = torch.linspace(0.1, 1.0, 5, dtype=torch.float64, requires_grad=True)
    _Records.seen.clear()
    before = torch._C._is_multithreading_enabled()
    (g,) = ag.grad(torch.sum(torch.sin(_Records.apply(x))), x,
                   create_graph=True)
    assert _Records.seen == [False]
    assert torch._C._is_multithreading_enabled() == before
    torch.testing.assert_close(g, torch.cos(x), rtol=1e-15, atol=0)


def test_no_module_of_the_port_calls_the_engine_directly():
    """Every reverse-mode derivative of the port goes through
    ``utils.autograd.grad``: a direct ``torch.autograd.grad`` or
    ``.backward()`` would number its nested nodes on the engine's worker
    thread again on a GPU."""
    from pathlib import Path
    root = Path(gpt.__file__).resolve().parent
    direct = [f"{p.relative_to(root)}:{i}"
              for p in sorted(root.rglob("*.py"))
              if p.name != "autograd.py"
              for i, line in enumerate(p.read_text().splitlines(), 1)
              if ("torch.autograd.grad(" in line or ".backward(" in line)
              and not line.lstrip().startswith("#")
              and "``" not in line]
    assert direct == []
