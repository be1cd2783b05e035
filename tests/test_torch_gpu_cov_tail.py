"""The covariance families and the likelihood tail on the card: what the
full-size run of ``chip_smoke.py`` (phase 12) does not hold at 1e-9. Needs
an NVIDIA GPU; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_cov_tail.py --noconftest -q

Card against CPU, float64, within 1e-9 relative:
- every family the port gained (general-order and estimated-shape Matern,
  powered exponential, wendland, the tapered exponential, space-time,
  linear, hurst, Gneiting): the dense covariance and the Vecchia factors
  (A, D) on the same neighbour matrix (m = 20, n = 2 000) where the
  Vecchia build runs the family (not Gneiting: its Vecchia build raises in
  both packages);
- the incomplete beta / gamma functions (their first and second shape
  derivatives within 1e-7: they cancel where I ~ 1);
- the censored families' log-likelihood and response moments, and the
  Laplace NLL of a weighted binomial GLMM and of a censored GLMM.

And an exact bernoulli_logit fit to the same bits whichever of the autograd
engine's sequence counters (the calling thread's, the worker's) is ahead.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch import likelihoods as lk
from gpboost_tpu_torch.likelihoods import special as sp
from gpboost_tpu_torch.ops import cov_fns as cf
from gpboost_tpu_torch.ops import vecchia as tv

pytestmark = pytest.mark.gpu

N = 2_000
M = 20
RTOL = 1e-9
FAMILIES = [
    ("matern", 0.8, {}, 2, [1.3, 0.3]),
    ("matern", 1.0, {}, 2, [1.3, 0.3]),
    ("matern_estimate_shape", 0.0, {}, 2, [1.3, 0.3, 1.7]),
    ("matern_ard_estimate_shape", 0.0, {}, 2, [1.3, 0.3, 0.2, 0.9]),
    ("powered_exponential", 1.5, {}, 2, [1.3, 0.3]),
    ("wendland", 0.0, dict(taper_shape=1.0, taper_range=0.2), 2, [1.3]),
    ("exponential", 0.0, dict(apply_tapering=True, taper_shape=0.0,
                              taper_range=0.2), 2, [1.3, 0.3]),
    ("matern_space_time", 1.5, {}, 3, [1.3, 0.4, 0.3]),
    ("linear", 0.0, {}, 2, [1.3]),
    ("hurst", 0.0, {}, 2, [1.3, 0.35]),
    ("space_time_gneiting", 0.0, {}, 3,
     [1.3, 0.9, 2.0, 0.7, 1.2, 0.6, 0.4]),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = (np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for v in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("name,shape,kw,dim,pars", FAMILIES,
                         ids=[f"{f[0]}-{i}" for i, f in enumerate(FAMILIES)])
def test_family_on_the_card(dev, name, shape, kw, dim, pars):
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(N, dim))
    fn = cf.CovFunction.create(name, shape=shape, dim_coords=dim, **kw)
    nb = tv.find_neighbors(torch.tensor(coords), M)
    out = []
    for where in (dev, torch.device("cpu")):
        c = torch.tensor(coords, device=where)
        p = torch.tensor(pars, dtype=torch.float64, device=where)
        res = [fn.cov_between(p, c[:300], c)]
        if name != "space_time_gneiting":
            res += list(tv.build_factors(
                fn, p, c, nb.to(where), torch.tensor(
                    0.1, dtype=torch.float64, device=where), True))
        out.append(res)
    for x, y in zip(*out):
        assert _rel(x, y) <= RTOL


def test_special_functions_on_the_card(dev):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.3, 30.0, 500)
    b = rng.uniform(0.3, 30.0, 500)
    x = rng.uniform(1e-6, 1 - 1e-6, 500)
    g = rng.uniform(1e-3, 60.0, 500)
    out = []
    for where in (dev, torch.device("cpu")):
        at = torch.tensor(a, device=where, requires_grad=True)
        bt, xt, gt = (torch.tensor(v, device=where) for v in (b, x, g))
        vals = [sp.betainc_ad(at, bt, xt), sp.log_betainc_ad(at, bt, xt),
                sp.gammainc_ad(at, gt), sp.log_gammainc_upper_ad(at, gt)]
        derivs = []
        for v in vals:
            (d1,) = torch.autograd.grad(v.sum(), at, create_graph=True)
            (d2,) = torch.autograd.grad(d1.sum(), at, retain_graph=True)
            derivs += [d1, d2]
        out.append(([v.detach() for v in vals], derivs))
    for x_, y_ in zip(out[0][0], out[1][0]):
        assert _rel(x_, y_) <= RTOL
    # the shape derivatives: J / B - I (psi(a) - psi(a + b)) cancels where I
    # is near 1, and the quadratures' sums run in another order on the card
    # (3.5e-9 measured), so 1e-7, the CPU tests' tolerance against the JAX
    # package
    for x_, y_ in zip(out[0][1], out[1][1]):
        assert _rel(x_, y_) <= 1e-7


@pytest.mark.parametrize("lik", ["zero_one_censored_transformed_beta",
                                 "zero_one_censored_shifted_gamma"])
def test_censored_family_on_the_card(dev, lik):
    rng = np.random.default_rng(3)
    y = np.clip(rng.uniform(-0.2, 1.2, 400), 0.0, 1.0)
    loc = rng.normal(0.0, 0.8, 400)
    aux = [12.0, 0.1] if "beta" in lik else [3.0, 0.1]
    fam = lk.get_family(lik)
    out = []
    for where in (dev, torch.device("cpu")):
        t = [torch.tensor(v, dtype=torch.float64, device=where)
             for v in (y, loc, aux)]
        out.append([fam.log_lik(*t), fam.d2_loc(*t),
                    fam.response_mean(t[1], t[2]),
                    fam.response_var(t[1], t[2])])
    for x_, y_ in zip(*out):
        assert _rel(x_, y_) <= RTOL


@pytest.mark.parametrize("lik,aux", [
    ("binomial_logit", None),
    ("zero_one_censored_shifted_gamma", [3.0, 0.1])])
def test_glmm_nll_on_the_card(dev, lik, aux):
    """A grouped GLMM's Laplace NLL (the binomial with trial counts as
    weights; the censored gamma) on the card against the CPU."""
    rng = np.random.default_rng(4)
    n = 5_000
    group = rng.integers(0, 100, n)
    eta = 0.5 * rng.standard_normal(100)[group]
    if lik == "binomial_logit":
        trials = rng.poisson(5.0, n).astype(float)
        y = rng.binomial(trials.astype(int), 1 / (1 + np.exp(-eta))) \
            / np.maximum(trials, 1.0)
        kw = dict(weights=trials)
    else:
        y = np.clip(rng.gamma(3.0, np.exp(eta) / 3.0) - 0.1, 0.0, 1.0)
        kw = {}
    nll = [gpt.GPModel(group_data=group, likelihood=lik, device=where, **kw
                       ).neg_log_likelihood([0.4], y, aux_pars=aux)
           for where in (dev, "cpu")]
    assert abs(nll[0] - nll[1]) <= RTOL * abs(nll[1])


def _sequence_numbers(dev):
    """(the calling thread's autograd sequence number, the engine worker's):
    a node made here, and one made inside a create_graph backward that the
    engine runs on its worker thread (multithreading on, the default)."""
    x = torch.ones(2, dtype=torch.float64, device=dev, requires_grad=True)
    y = x * 2.0
    (g,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    return y.grad_fn._sequence_nr(), g.grad_fn._sequence_nr()


def _worker_nodes(dev, k):
    """k steps of a graph whose create_graph backward builds its nodes on
    the engine's worker thread: the worker's sequence counter moves, as
    the chunked Bessel backward of a general-order Matern moves it."""
    x = torch.rand(4, dtype=torch.float64, device=dev, requires_grad=True)
    y = x
    for _ in range(k):
        y = torch.sin(y) * 1.0001
    torch.autograd.grad(y.sum(), x, create_graph=True)


def _caller_nodes(dev, k):
    x = torch.rand(4, dtype=torch.float64, device=dev, requires_grad=True)
    y = x
    for _ in range(k):
        y = y * 1.0


def test_fit_bits_do_not_move_with_the_engine_worker(dev):
    """An exact bernoulli_logit fit (the first refit of exact LaGaBoost)
    gives the same bits whichever of the calling thread's and the engine
    worker's autograd counters is ahead. Before the port ran its backward
    passes on the calling thread (``utils/autograd.py``), the nested
    likelihood derivatives' nodes were numbered by the worker, and the
    fit's NLL moved in its last bit once the worker's counter passed the
    caller's."""
    rng = np.random.default_rng(5)
    n = 5_000
    coords = rng.uniform(size=(n, 2))
    lat = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-lat))).astype(float)
    F = np.full(n, float(np.log(y.mean() / (1 - y.mean()))))

    def fit():
        gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                         likelihood="bernoulli_logit", device=dev)
        gp.fit(y=y, fixed_effects=F, params={})
        return gp.current_nll_, gp.get_cov_pars().tolist()

    ref = fit()
    caller, worker = _sequence_numbers(dev)
    _worker_nodes(dev, max(0, caller - worker) // 2 + 20_000)
    caller, worker = _sequence_numbers(dev)
    assert worker > caller
    assert fit() == ref
    _caller_nodes(dev, worker - caller + 20_000)
    caller, worker = _sequence_numbers(dev)
    assert caller > worker
    assert fit() == ref
