"""The port's device-resident L-BFGS vs the JAX package's compiled loop.

Both run the same algorithm (two-loop recursion, memory 8, Armijo halving,
relative-NLL-change stop rule), so in float64 on the CPU the iterates agree:
same ``num_it``, parameters within 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.models import optimizers as jopt
from gpboost_tpu_torch.models import optimizers as topt


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
