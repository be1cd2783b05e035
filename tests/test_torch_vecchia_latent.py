"""``gp_approx="vecchia_latent"`` in the port: the latent-process Vecchia
GP with Gaussian noise whose variance (the nugget) is the gaussian
likelihood's auxiliary parameter, through the Laplace route (JAX
``gp_model.py:681-688``, ``vecchia_fit.py:97-104``), and
``likelihood_additional_param`` with the gaussian likelihood — on the CPU,
float64, the counterpart of ``tests/test_vecchia_golden.py::
TestVecchiaLatent`` (its R golden at 1e-5), against the JAX package:

- with n - 1 neighbours the NLL is the exact one (124.2549533), and equals
  the JAX package's at 1e-10 relative, also with 20 neighbours and at the
  default aux (1);
- the fit moves the nugget of the Gaussian inits to the aux slot and
  meets the exact model's optimum and the JAX package's;
- the prediction (latent and response) equals the JAX package's at 1e-8;
- the model stays outside the kernel gate in float32;
- ``likelihood_additional_param`` sets the aux init as in the JAX package.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vf(gp_fixture_data):
    d = gp_fixture_data
    return dict(coords=d["coords"], y=d["eps"] + d["xi"], n=d["n"])


def _pair(vf, nn, **kw):
    kw = dict(dict(gp_coords=vf["coords"], cov_function="exponential",
                   gp_approx="vecchia_latent", num_neighbors=nn,
                   vecchia_ordering="none"), **kw)
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


@pytest.mark.parametrize("nn,aux", [(99, [0.1]), (20, [0.1]), (20, None)])
def test_nll_golden_and_jax(vf, nn, aux):
    jm, tm = _pair(vf, nn)
    nt = tm.neg_log_likelihood([1.6, 0.2], vf["y"], aux_pars=aux)
    nj = jm.neg_log_likelihood([1.6, 0.2], vf["y"], aux_pars=aux)
    if nn == 99 and aux is not None:
        assert abs(nt - 124.2549533) < 1e-5
    assert abs(nt - nj) <= 1e-10 * abs(nj)


def test_fit_recovers_optimum_and_jax(vf):
    y = vf["y"]
    params = {"optimizer_cov": "lbfgs",
              "init_cov_pars": [np.var(y) / 2, np.var(y) / 2, 0.2]}
    jm, tm = _pair(vf, 30)
    tm.fit(y=y, params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), [1.0761, 0.1135],
                               rtol=5e-2)
    np.testing.assert_allclose(tm.get_aux_pars(), [0.0328], rtol=2e-1)
    jm.fit(y=y, params=params)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)
    np.testing.assert_allclose(tm.get_aux_pars(), jm.get_aux_pars(),
                               rtol=1e-5)


def test_predict_matches_jax(vf):
    jm, tm = _pair(vf, 30)
    for m in (jm, tm):
        m.aux_pars_ = np.array([0.05])
    cpp = np.random.default_rng(2).uniform(size=(6, 2))
    kw = dict(y=vf["y"], gp_coords_pred=cpp, cov_pars=[1.1, 0.12],
              predict_var=True, predict_response=False)
    pt, pj = tm.predict(**kw), jm.predict(**kw)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=1e-8)
    # the response adds the noise variance (the aux) to the latent one
    pr = tm.predict(**dict(kw, predict_response=True))
    np.testing.assert_allclose(pr["mu"], pt["mu"], rtol=1e-12)
    np.testing.assert_allclose(pr["var"], pt["var"] + 0.05, rtol=1e-12)


def test_float32_outside_kernel_gate(vf):
    tm = gpt.GPModel(gp_coords=vf["coords"], cov_function="exponential",
                     gp_approx="vecchia_latent", num_neighbors=10,
                     dtype=torch.float32, device="cpu")
    assert tm._approx._kernel_shape is None
    assert not tm._approx.nugget_in_pars


def test_likelihood_additional_param_gaussian(vf):
    """The JAX package stores ``likelihood_additional_param`` and starts the
    gaussian family's aux (the error variance) there: a Gaussian Vecchia GP
    does not read it (same NLL), the latent one starts its aux there."""
    kw = dict(gp_coords=vf["coords"], cov_function="exponential",
              num_neighbors=10, likelihood_additional_param=0.3)
    tv = gpt.GPModel(gp_approx="vecchia", device="cpu", **kw)
    jv = gpb.GPModel(gp_approx="vecchia", **kw)
    cp = [0.1, 1.6, 0.2]
    assert abs(tv.neg_log_likelihood(cp, vf["y"])
               - jv.neg_log_likelihood(cp, vf["y"])) <= 1e-10 * 200
    tl = gpt.GPModel(gp_approx="vecchia_latent", device="cpu", **kw)
    assert np.allclose(tl._aux_tensor().numpy(), [0.3])
    jl = gpb.GPModel(gp_approx="vecchia_latent", **kw)
    assert np.allclose(np.asarray(jl._aux_pars_array()), [0.3])
