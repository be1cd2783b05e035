"""The port's optimizers vs the JAX package's (float64, CPU).

The device-resident L-BFGS and the JAX package's compiled loop run the same
algorithm (two-loop recursion, memory 8, Armijo halving, relative-NLL-change
stop rule), so the iterates agree: same ``num_it``, parameters within 1e-8.
Gradient descent (host and device loop) vs the JAX package's host loop on a
Vecchia NLL: NLL 1e-6, parameters rtol 1e-5, same ``num_it`` (the JAX
package's own tolerances for its device loop); the port's two loops against
each other in the reuse mode: parameters rtol 1e-10. ``lbfgs_host`` over
two calls with carried memory: parameters rtol 1e-8; scipy's L-BFGS-B and
Nelder-Mead: NLL 1e-8, parameters rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.models import optimizers as jopt
from gpboost_tpu_torch.models import optimizers as topt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other (a GD fit here took
    ~580 s with six processes at once, 4.5 s with one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quad_j(t, A, b):
    r = A @ t - b
    return 0.5 * jnp.dot(r, r), A.T @ r


def _quad_t(t, A, b):
    r = A @ t - b
    return 0.5 * torch.dot(r, r), A.T @ r


@pytest.mark.parametrize("seed,shape", [(0, (6, 4)), (7, (8, 5))])
def test_lbfgs_quadratic_matches_jax(seed, shape):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape)
    b = rng.standard_normal(shape[0])
    want = jopt.lbfgs_device(
        _quad_j, np.zeros(shape[1]),
        jopt.OptimConfig(maxit=200, delta_rel_conv=1e-12), None,
        jnp.asarray(A), jnp.asarray(b))
    got = topt.lbfgs_device(
        _quad_t, np.zeros(shape[1]),
        topt.OptimConfig(maxit=200, delta_rel_conv=1e-12), None,
        torch.tensor(A), torch.tensor(b), device="cpu")
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(np.log(got.params), x_ls, atol=1e-6)
    assert got.num_it == want.num_it
    assert got.converged and 0 < got.num_it <= 200
    np.testing.assert_allclose(got.params, want.params, rtol=0, atol=1e-8)
    assert abs(got.nll - want.nll) < 1e-10
    assert got.num_evals >= got.num_it + 1


def test_lbfgs_final_fn_output_returned():
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((6, 4)))
    b = torch.tensor(rng.standard_normal(6))
    cfg = topt.OptimConfig(maxit=200, delta_rel_conv=1e-14)
    res = topt.lbfgs_device(_quad_t, np.zeros(4), cfg, torch.float64, A, b,
                            final_fn=lambda t, A_, b_: A_ @ t - b_,
                            device="cpu")
    assert res.aux is not None and res.aux.shape == (6,)
    t_fin = torch.log(torch.tensor(res.params))
    np.testing.assert_allclose(res.aux, (A @ t_fin - b).numpy(), rtol=1e-8,
                               atol=1e-10)
    res2 = topt.lbfgs_device(_quad_t, np.zeros(4), cfg, torch.float64, A, b,
                             device="cpu")
    assert res2.aux is None


def test_lbfgs_never_differentiates_the_objective():
    """A vg_fn without an AD rule (like the CUDA kernel): the loop only
    consumes the gradient it is handed."""
    def vg(t):
        with torch.no_grad():
            return torch.sum((t - 2.0) ** 2), 2.0 * (t - 2.0)

    res = topt.lbfgs_device(vg, np.zeros(3),
                            topt.OptimConfig(maxit=100, delta_rel_conv=1e-12),
                            device="cpu")
    np.testing.assert_allclose(np.log(res.params), 2.0 * np.ones(3),
                               atol=1e-6)


def test_lbfgs_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topt.lbfgs_device(lambda t: (t.sum(), t), np.zeros(2),
                          topt.OptimConfig())


def test_lbfgs_vecchia_nll_matches_jax(gp_fixture_data):
    """The n = 100 Vecchia NLL of the R-test fixture: same iterates."""
    from gpboost_tpu import GPModel as JModel
    from gpboost_tpu_torch import GPModel as TModel
    coords = gp_fixture_data["coords"]
    y = gp_fixture_data["eps"] + gp_fixture_data["xi"]
    D = gp_fixture_data["D"]
    jm = JModel(gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=30)
    tm = TModel(gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=30, device="cpu")
    jvec, tvec = jm._approx, tm._approx
    tvec.load_structure(np.asarray(jvec.perm), np.asarray(jvec.neighbors))
    init = np.log([np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
                   np.mean(D[np.triu_indices(len(y), 1)]) / 3])

    def vg_j(th, yv, nb):
        return jvec._vg_gaussian_jit(th, yv, None, nb)

    want = jopt.lbfgs_device(
        vg_j, init, jopt.OptimConfig(maxit=1000, delta_rel_conv=1e-6),
        jnp.float64, jnp.asarray(y), jvec.neighbors)
    got = topt.lbfgs_device(
        lambda th, yv: tvec._vg_gaussian(th, yv, None), init,
        topt.OptimConfig(maxit=1000, delta_rel_conv=1e-6), torch.float64,
        torch.tensor(y), device="cpu")
    assert got.num_it == want.num_it
    np.testing.assert_allclose(got.params, want.params, rtol=0, atol=1e-8)
    assert abs(got.nll - want.nll) < 1e-8


def _vecchia_objectives(n=100, m=30):
    """The problem of the JAX package's ``test_device_gd_matches_host_gd``:
    (JAX vg(theta), port vg(theta tensor), port host vg(theta numpy),
    init)."""
    from gpboost_tpu import GPModel as JModel
    from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif
    from gpboost_tpu_torch import GPModel as TModel
    x = sim_rand_unif(n * 2, init_c=0.1)
    coords = np.column_stack([x[:n], x[n:]])
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + np.eye(n) * 1e-20)
    y = C @ sim_rand_normal(n, init_c=0.8) \
        + sim_rand_normal(n, init_c=0.1) / 5.0
    jm = JModel(gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=m)
    tm = TModel(gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=m, device="cpu")
    jvec, tvec = jm._approx, tm._approx
    tvec.load_structure(np.asarray(jvec.perm), np.asarray(jvec.neighbors))
    yj, yt = jnp.asarray(y), torch.tensor(y)

    def vg_j(t):
        v, g = jvec._vg_gaussian_jit(jnp.asarray(t), yj, None,
                                     jvec.neighbors)
        return float(v), np.asarray(g)

    def vg_t(th):
        return tvec._vg_gaussian(th, yt, None)

    def vg_host(t):
        v, g = vg_t(torch.tensor(t))
        return float(v), g.numpy()

    iu = np.triu_indices(n, 1)
    init = np.log([np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
                   np.mean(D[iu]) / 3])
    return vg_j, vg_t, vg_host, init


def test_gradient_descent_host_and_device_match_jax():
    """Port ``gradient_descent`` and ``gd_device`` vs JAX
    ``gradient_descent`` on a Vecchia NLL (the JAX package's
    ``test_device_gd_matches_host_gd``): NLL 1e-6, parameters rtol 1e-5,
    the same number of iterations; one host read per evaluation."""
    vg_j, vg_t, vg_host, init = _vecchia_objectives()
    kw = dict(maxit=1000, delta_rel_conv=1e-6, lr_cov=0.1,
              use_nesterov_acc=True, acc_rate_cov=0.5)
    want = jopt.gradient_descent(lambda t: vg_j(t)[0], lambda t: vg_j(t)[1],
                                 init, jopt.OptimConfig(**kw))
    host = topt.gradient_descent(lambda t: vg_host(t)[0],
                                 lambda t: vg_host(t)[1], init,
                                 topt.OptimConfig(**kw))
    reads = topt.gd_device.host_reads
    dev = topt.gd_device(lambda th, _: vg_t(th), init,
                         topt.OptimConfig(**kw), torch.float64,
                         torch.zeros(1), device="cpu")
    assert topt.gd_device.host_reads - reads == dev.num_evals
    for got in (host, dev):
        assert abs(got.nll - want.nll) < 1e-6
        np.testing.assert_allclose(got.params, want.params, rtol=1e-5)
        assert got.num_it == want.num_it
        assert got.lr_after_first == pytest.approx(want.lr_after_first,
                                                   rel=1e-12)
    assert dev.converged and dev.num_evals >= dev.num_it


@pytest.mark.parametrize("criterion", ["relative_change_in_log_likelihood",
                                       "relative_change_in_parameters"])
def test_gd_device_matches_host_gd_in_the_reuse_mode(criterion):
    """With ``_reuse_lr_start`` (the GPBoost refits from the second on:
    Armijo off, half the halvings, the learning-rate doubling) and either
    convergence criterion, ``gd_device`` takes the host loop's steps:
    same iterations, ``lr_after_first`` and final parameters."""
    _, vg_t, vg_host, init = _vecchia_objectives()
    out = []
    for run in ("host", "device"):
        cfg = topt.OptimConfig(convergence_criterion=criterion, maxit=150)
        cfg._reuse_lr_start = 0.003
        if run == "host":
            out.append(topt.gradient_descent(lambda t: vg_host(t)[0],
                                             lambda t: vg_host(t)[1],
                                             init, cfg))
        else:
            out.append(topt.gd_device(lambda th, _: vg_t(th), init, cfg,
                                      torch.float64, None, device="cpu"))
    host, dev = out
    assert dev.num_it == host.num_it
    assert dev.lr_after_first == pytest.approx(host.lr_after_first,
                                               rel=1e-12)
    np.testing.assert_allclose(dev.params, host.params, rtol=1e-10)
    assert abs(dev.nll - host.nll) < 1e-9


def test_lbfgs_host_carries_its_memory_like_jax():
    """``lbfgs_host`` twice, the second call warm-started with the first's
    curvature memory, against the JAX package's: the same iterates."""
    vg_j, _, vg_host, init = _vecchia_objectives()
    cfg_j = jopt.OptimConfig(maxit=1000, delta_rel_conv=1e-8)
    cfg_t = topt.OptimConfig(maxit=1000, delta_rel_conv=1e-8)
    r1_j, mem_j = jopt.lbfgs_host(vg_j, init, cfg_j)
    r1_t, mem_t = topt.lbfgs_host(vg_host, init, cfg_t)
    start = np.log(r1_j.params) + np.array([0.05, -0.1, 0.08])
    r2_j, _ = jopt.lbfgs_host(vg_j, start, cfg_j, mem_j)
    r2_t, _ = topt.lbfgs_host(vg_host, start, cfg_t, mem_t)
    assert len(mem_t) == len(mem_j) > 0
    for got, want in ((r1_t, r1_j), (r2_t, r2_j)):
        assert got.num_it == want.num_it
        np.testing.assert_allclose(got.params, want.params, rtol=1e-8)
        assert abs(got.nll - want.nll) < 1e-8
    # through ``lbfgs`` with ``lbfgs_reuse_mem``: the memory rides on cfg
    cfg_t.lbfgs_reuse_mem = True
    via = topt.lbfgs(vg_host, init, cfg_t)
    assert via.num_it == r1_t.num_it and len(cfg_t._lbfgs_mem) == len(mem_t)


@pytest.mark.parametrize("which", ["lbfgs", "nelder_mead"])
def test_scipy_routes_match_jax(which):
    """scipy's L-BFGS-B and Nelder-Mead driven by the port's objective vs
    the JAX package's: the same optimum (NLL 1e-8, parameters rtol 1e-6)."""
    vg_j, _, vg_host, init = _vecchia_objectives()
    if which == "lbfgs":
        want = jopt.lbfgs(vg_j, init, jopt.OptimConfig())
        got = topt.lbfgs(vg_host, init, topt.OptimConfig())
    else:
        want = jopt.nelder_mead(lambda t: vg_j(t)[0], init,
                                jopt.OptimConfig())
        got = topt.nelder_mead(lambda t: vg_host(t)[0], init,
                               topt.OptimConfig())
    assert abs(got.nll - want.nll) < 1e-8
    np.testing.assert_allclose(got.params, want.params, rtol=1e-6)
