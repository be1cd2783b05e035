"""The port's Vecchia-Laplace path and LaGaBoost on the card, at n = 5 000
(a ``bernoulli_logit`` Vecchia GP, m = 20, ``matrix_inversion_method=
"iterative"``, float32): the corners the full-size run of ``chip_smoke.py``
does not reach. Needs an NVIDIA GPU and ``nvcc``; skipped elsewhere. Run on
the GPU machine with

    python -m pytest tests/test_torch_gpu_laplace.py --noconftest -q

- two fits, and two three-round LaGaBoost trainings, are bit-identical
  (covariance parameters, NLL, scores, evaluation counts);
- the float32 path against the same computation in float64 on the card,
  with the same probes (drawn in float64 by both): NLL within 1e-4
  relative, gradient within 1e-3 relative;
- the precision product's gather-only backward against ``gradcheck`` in
  float64 on the card (sliced gather transpose);
- no ``index_add_`` / ``scatter_add_`` / accumulating ``index_put_`` in the
  precision product (forward and backward) or in diag(Q) (profiler trace);
- the two Vecchia kernels' launch counters read 0 on this path.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops import vecchia as tv
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

pytestmark = pytest.mark.gpu

N, M = 5000, 20
CP = [1.0, 0.1]
PARAMS = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}
# names of the operations that add with colliding indices (float atomics)
SCATTERS = ("index_add", "scatter_add", "index_put", "scatter_reduce",
            "indexFunc", "put_")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    X = rng.uniform(size=(N, 5))
    Fb = 2 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    yb = rng.binomial(1, 1 / (1 + np.exp(-(f + Fb - Fb.mean())))).astype(
        float)
    return dict(coords=coords, y=y, X=X, yb=yb)


def _model(data, dev, dtype=torch.float32, maxit=2):
    gp = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M,
                     likelihood="bernoulli_logit",
                     matrix_inversion_method="iterative", dtype=dtype,
                     device=dev)
    gp.set_optim_params({"optimizer_cov": "lbfgs", "init_cov_pars": CP,
                         "maxit": maxit})
    return gp


def test_two_fits_bit_identical(data, dev):
    out = []
    for _ in range(2):
        gp = _model(data, dev)
        gp.fit(y=data["y"])
        out.append((gp.get_cov_pars(), gp.get_current_neg_log_likelihood(),
                    gp._fit_result.num_evals))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_two_lagaboost_trainings_bit_identical(data, dev):
    ds = gpt.Dataset(data["X"], label=data["yb"], device=dev)
    runs = []
    for _ in range(2):
        gp = _model(data, dev, maxit=1)
        bst = gpt.train(PARAMS, ds, gp_model=gp, num_boost_round=3)
        runs.append((bst._score.copy(), gp.get_cov_pars(),
                     [f["num_evals"] for f in bst.objective.fits]))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]


def test_float32_matches_float64_on_the_card(data, dev):
    m32 = _model(data, dev)
    m64 = _model(data, dev, dtype=torch.float64)
    m64._approx.load_structure(m32._approx.perm,
                               m32._approx.neighbors.cpu().numpy())
    vals = []
    for m in (m32, m64):
        kw = m._iter_kwargs(fit=True)
        th = torch.log(torch.tensor(CP, dtype=m.dtype, device=dev))
        th.requires_grad_(True)
        nll = m._approx.nll_laplace_iterative(torch.exp(th),
                                              m._y_tensor(data["y"]), None,
                                              None, **kw)
        (g,) = torch.autograd.grad(nll, th)
        vals.append((float(nll.detach()), g.double().cpu().numpy()))
    (v32, g32), (v64, g64) = vals
    assert abs(v32 - v64) < 1e-4 * abs(v64)
    rel = np.max(np.abs(g32 - g64)) / np.max(np.abs(g64))
    assert rel < 1e-3, (g32, g64, rel)


def test_precision_product_backward_gradcheck_on_the_card(dev):
    rng = np.random.default_rng(1)
    coords = torch.tensor(rng.uniform(size=(300, 2)), device=dev)
    nb = tv.find_neighbors(coords, 10)
    from gpboost_tpu_torch.ops.cov_fns import CovFunction
    a, d = tv.build_factors(CovFunction.create("exponential"),
                            torch.tensor(CP, dtype=torch.float64, device=dev),
                            coords, nb, None, False)
    slices = tv.build_incoming_sliced(nb)
    for V in (torch.randn(300, 4, dtype=torch.float64, device=dev),
              torch.randn(300, dtype=torch.float64, device=dev)):
        args = (a.detach().requires_grad_(True),
                d.detach().requires_grad_(True), V.requires_grad_(True))
        assert torch.autograd.gradcheck(
            lambda a_, d_, V_: tv.precision_product(a_, d_, V_, nb, slices),
            args, eps=1e-6, atol=1e-7)


def test_precision_ops_do_not_scatter(data, dev):
    gp = _model(data, dev)
    vec = gp._approx
    a, d = vec._latent_factors(torch.tensor(CP, device=dev))
    a = a.detach().requires_grad_(True)
    d = d.detach().requires_grad_(True)
    V = torch.randn(N, 8, device=dev, requires_grad=True)
    act = [torch.profiler.ProfilerActivity.CPU]     # the operations called
    with torch.profiler.profile(activities=act) as prof:
        out = tv.precision_product(a, d, V, vec.neighbors, vec._incoming)
        torch.autograd.grad(out.sum(), (a, d, V))
        tv.precision_diag(a.detach(), vec.neighbors, d.detach(),
                          vec._incoming)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("index" in n for n in names), names     # the trace is there
    bad = [n for n in names if any(s in n for s in SCATTERS)]
    assert not bad, bad


def test_vecchia_kernels_do_not_run_on_this_path(data, dev):
    vk.reset_launch_counts()
    gp = _model(data, dev, maxit=1)
    gp.neg_log_likelihood(CP, data["y"])
    gp.fit(y=data["y"])
    gp.set_prediction_data(nsim_var_pred=128)
    out = gp.predict(gp_coords_pred=data["coords"][:100] + 0.001,
                     predict_var=True)
    assert np.all(np.isfinite(out["mu"])) and np.all(out["var"] > 0)
    assert vk.launch_counts() == {"vecchia_factors": 0,
                                  "vecchia_nll_grad": 0}
