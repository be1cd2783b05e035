"""The port's Vecchia-Laplace model pieces vs the JAX package's, float64 on
the CPU, on the same ordering and neighbours (carried over with
``load_structure``), inputs from a numpy seed:

- the precision product Q V = B' D^-1 B V (``ops/vecchia.py``) for [n] and
  [n, k], with the plain scatter and with the sliced gather transpose, vs
  the dense Q (1e-12); its gather-only backward vs ``gradcheck``;
  diag(Q) both ways vs the JAX package's ``_precision_diag`` (1e-12);
- the Newton-CG mode (``_FindModeCG``) at 1e-6, and its implicit gradient
  w.r.t. (a, d, F) against ``jax.vjp`` of the JAX package's custom VJP at
  1e-5 relative;
- the R golden of ``tests/test_vecchia_golden.py::TestVecchiaLaplace``
  (probit, all previous points as neighbours: 67.18342059 within 1e-4);
- the model dict of a JAX non-Gaussian model gives the same NLL; responses
  the likelihood does not allow raise; the default device is the GPU.
"""
import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.models import vecchia_model as jvm
from gpboost_tpu.utils.rng import sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import vecchia_model as tvm
from gpboost_tpu_torch.ops import vecchia as tv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, M = 120, 8
CP = [1.2, 0.15]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    counts = rng.poisson(np.exp(0.5 * f)).astype(float)
    pos = rng.gamma(2.0, np.exp(0.3 * f) / 2.0)
    X = np.column_stack([np.ones(N), coords[:, 0] - 0.5])
    fe = 0.3 * rng.standard_normal(N)
    return dict(coords=coords, y=y, counts=counts, pos=pos, X=X, fe=fe)


def _pair(data, likelihood="bernoulli_logit", **kw):
    args = dict(gp_coords=data["coords"], cov_function="exponential",
                gp_approx="vecchia", num_neighbors=M, likelihood=likelihood,
                **kw)
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    return jm, tm


@pytest.fixture(scope="module")
def models(data):
    return _pair(data)


@pytest.fixture(scope="module")
def factors(models):
    jm, tm = models
    a, d = tm._approx._latent_factors(torch.tensor(CP, dtype=torch.float64))
    return a.detach(), d.detach()


def test_precision_product_matches_dense_both_transposes(models, factors):
    jm, tm = models
    a, d = factors
    Qd, _ = jm._approx._dense_precision(jnp.asarray(CP))
    Q = np.asarray(Qd)
    nb = tm._approx.neighbors
    slices = tv.build_incoming_sliced(nb)
    rng = np.random.default_rng(0)
    V = rng.standard_normal((N, 4))
    for sl in (None, slices):
        got = tv.precision_product(a, d, torch.tensor(V), nb, sl)
        np.testing.assert_allclose(got.numpy(), Q @ V, rtol=0, atol=1e-12)
        got1 = tv.precision_product(a, d, torch.tensor(V[:, 0]), nb, sl)
        np.testing.assert_allclose(got1.numpy(), Q @ V[:, 0], rtol=0,
                                   atol=1e-12)
    for got in (tv.precision_diag(a, nb, d), tv.precision_diag(a, nb, d,
                                                               slices)):
        want = jvm._precision_diag(jnp.asarray(a.numpy()),
                                   jnp.asarray(nb.numpy()),
                                   jnp.asarray(d.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(tv.apply_Bt_sliced(a, slices,
                                                  torch.tensor(V)).numpy(),
                               tv.apply_Bt(a, nb, torch.tensor(V)).numpy(),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_precision_product_backward_gradcheck(data, sliced, k):
    """The gather-only backward (grad a, d, V) against finite differences,
    for a vector and for [n, k] right-hand sides."""
    coords = torch.tensor(data["coords"][:40])
    nb = tv.find_neighbors(coords, 5)
    a, d = tv.build_factors(gpt.GPModel(
        gp_coords=data["coords"][:40], cov_function="exponential",
        gp_approx="vecchia", num_neighbors=5, device="cpu").cov_fn,
        torch.tensor(CP, dtype=torch.float64), coords, nb, None, False)
    sl = tv.build_incoming_sliced(nb) if sliced else None
    rng = np.random.default_rng(k)
    V = torch.tensor(rng.standard_normal((40, k)) if k
                     else rng.standard_normal(40), requires_grad=True)
    a = a.detach().requires_grad_(True)
    d = d.detach().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a_, d_, V_: tv.precision_product(a_, d_, V_, nb, sl),
        (a, d, V), eps=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mode_case(data, models, factors):
    jm, tm = models
    a, d = factors
    vec = tm._approx
    perm = vec.perm
    yp = data["y"][perm]
    Fp = data["fe"][perm]
    b_j, vjp = jax.vjp(
        lambda a_, d_, F_: jvm._find_mode_cg(
            "bernoulli_logit", None, a_, d_, jm._approx.neighbors,
            jnp.asarray(yp), F_, jnp.zeros((0,)), jnp.ones(N)),
        jnp.asarray(a.numpy()), jnp.asarray(d.numpy()), jnp.asarray(Fp))
    cot = np.random.default_rng(5).standard_normal(N)
    return dict(yp=yp, Fp=Fp, b_j=np.asarray(b_j), cot=cot,
                grads_j=[np.asarray(g) for g in vjp(jnp.asarray(cot))])


def test_find_mode_cg_matches_jax(models, factors, mode_case):
    _, tm = models
    a, d = factors
    at = a.clone().requires_grad_(True)
    dt = d.clone().requires_grad_(True)
    Ft = torch.tensor(mode_case["Fp"], requires_grad=True)
    b = tvm._FindModeCG.apply(at, dt, Ft, torch.zeros(0, dtype=torch.float64),
                              tm._approx, torch.tensor(mode_case["yp"]))
    np.testing.assert_allclose(b.detach().numpy(), mode_case["b_j"],
                               rtol=0, atol=1e-6)
    grads = torch.autograd.grad(b, (at, dt, Ft),
                                grad_outputs=torch.tensor(mode_case["cot"]))
    # padding slots of a are not parameters (the factor build writes 0
    # there); the JAX package's scatter reads them, so its cotangent there
    # is not 0 — compared on the neighbour slots only
    valid = tm._approx.neighbors.numpy() >= 0
    for got, want, what in zip(grads, mode_case["grads_j"], "adF"):
        got = got.numpy()
        if what == "a":
            assert np.all(got[~valid] == 0.0)
            got, want = got[valid], want[valid]
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < 1e-5, f"gradient w.r.t. {what}: {err}"


def test_jax_model_dict_gives_the_same_nll(data):
    for likelihood, ykey, aux in (("bernoulli_logit", "y", None),
                                  ("gamma", "pos", [2.2])):
        jm = gpb.GPModel(gp_coords=data["coords"], cov_function="exponential",
                         gp_approx="vecchia", num_neighbors=M,
                         likelihood=likelihood)
        y = data[ykey]
        jm.fit(y=y, params={"optimizer_cov": "lbfgs", "maxit": 3,
                            "init_cov_pars": CP})
        if aux is not None:
            jm.aux_pars_ = np.asarray(aux)
        d = jm.model_to_dict()
        tm = gpt.GPModel.from_dict(d, device="cpu")
        assert tm.likelihood == likelihood
        if aux is not None:
            np.testing.assert_array_equal(tm.get_aux_pars(), aux)
        want = jm.neg_log_likelihood(jm.get_cov_pars(), y)
        got = tm.neg_log_likelihood(tm.get_cov_pars(), y)
        assert abs(got - want) < 1e-8 * abs(want)
        back = tm.model_to_dict()
        assert back["aux_pars"] == d["aux_pars"]
        assert back["matrix_inversion_method"] == "cholesky"


def test_responses_the_likelihood_does_not_allow_raise(data):
    _, tm = _pair(data)
    with pytest.raises(ValueError, match="0 or 1"):
        tm.neg_log_likelihood(CP, data["counts"])
    _, tg = _pair(data, "gamma")
    with pytest.raises(ValueError, match="strictly positive"):
        tg.fit(y=data["y"])


def test_non_gaussian_model_runs_on_the_gpu_by_default(data):
    kw = dict(gp_coords=data["coords"], gp_approx="vecchia",
              likelihood="bernoulli_logit")
    if torch.cuda.is_available():
        assert gpt.GPModel(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gpt.GPModel(**kw)


@pytest.mark.parametrize("kwargs,item", [
    (dict(likelihood="zero_one_censored_shifted_gamma"), "item 11"),
    (dict(likelihood="gaussian_heteroscedastic"), None),
    (dict(likelihood="bernoulli_logit", weights=np.ones(N)), "Not faults"),
])
def test_unported_likelihood_options_name_their_item(data, kwargs, item):
    """The likelihood options that were queued. ``gaussian_heteroscedastic``
    is ported (ROADMAP.md item 15, ``models/heteroscedastic.py``) and so is
    the censored shifted gamma (item 11): on the JAX package's neighbour
    structure each NLL is the JAX package's within 1e-10 relative (the
    censored one 1e-8, the mode finders' stop rules).
    ``weights`` under Vecchia, which the JAX package accepts and never
    reads, raise (ROADMAP.md, "Not faults")."""
    if item == "Not faults":
        with pytest.raises(NotImplementedError, match=item):
            gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                        device="cpu", **kwargs)
        return
    kw = dict(gp_coords=data["coords"], gp_approx="vecchia",
              num_neighbors=M, **kwargs)
    tm = gpt.GPModel(device="cpu", **kw)
    jm = gpb.GPModel(**kw)
    tm._approx.load_structure(np.asarray(jm._approx.perm),
                              np.asarray(jm._approx.neighbors))
    if item == "item 11":
        # 1e-8: the two dense mode finders stop at different changes (the
        # JAX package's at 1e-8, the port's at 1e-9; ROADMAP.md "Mode
        # finders"), and the censored likelihood's mode carries it to ~1e-9
        y = np.clip(data["pos"] - 0.1, 0.0, 1.0)
        cp, aux = [0.8, 0.2], [3.0, 0.1]
        nll_j = jm.neg_log_likelihood(cov_pars=cp, y=y, aux_pars=aux)
        assert abs(tm.neg_log_likelihood(cp, y, aux_pars=aux) - nll_j) \
            < 1e-8 * abs(nll_j)
        return
    y = data["y"] + 0.5 * np.sin(7 * data["coords"][:, 0])
    cp = [1.0, 0.2, 0.1, 0.2]
    nll_j = jm.neg_log_likelihood(cp, y)
    assert abs(tm.neg_log_likelihood(cp, y) - nll_j) < 1e-10 * abs(nll_j)


def test_prediction_settings(data):
    jm, tm = _pair(data)
    assert tm.set_prediction_data(nsim_var_pred=50).nsim_var_pred == 50
    # vecchia_pred_type is accepted and kept (ROADMAP.md item 15), as the
    # JAX package does; a non-Gaussian model's prediction does not read it
    for m in (tm, jm):
        m.set_prediction_data(vecchia_pred_type="order_pred_first")
    assert tm.vecchia_pred_type == jm.vecchia_pred_type == "order_pred_first"
    # the JAX package accepts reuse_rand_vec_trace=False and draws the same
    # probes all the same; the port refuses it, pointing at ROADMAP.md's
    # "Not faults"
    with pytest.raises(NotImplementedError, match="Not faults"):
        tm.set_optim_params({"reuse_rand_vec_trace": False})
    tm.set_optim_params({"cg_preconditioner_type": "fitc"})
    # the low-rank preconditioners are ported (ROADMAP.md item 12): the
    # public NLL runs the Nystrom one of rank piv_chol_rank
    it = gpt.GPModel(gp_coords=data["coords"], gp_approx="vecchia",
                     num_neighbors=M, likelihood="bernoulli_logit",
                     matrix_inversion_method="iterative", device="cpu")
    it.set_optim_params({"cg_preconditioner_type": "fitc",
                         "piv_chol_rank": 20})
    nll = it.neg_log_likelihood(CP, data["y"])
    assert np.isfinite(nll) and nll == float(it._approx.nll_laplace_iterative(
        torch.tensor(CP, dtype=torch.float64), it._y_tensor(data["y"]), None,
        num_rand_vec_trace=it.optim_cfg.num_rand_vec_trace,
        lanczos_steps=min(it.optim_cfg.cg_max_num_it_tridiag, 100, N),
        cg_tol=it.optim_cfg.cg_delta_conv, preconditioner="fitc",
        piv_chol_rank=20))
