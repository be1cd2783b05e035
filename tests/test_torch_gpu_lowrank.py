"""The low-rank and full-scale approximations on the card (float64): what
the full-size run of ``chip_smoke.py`` does not hold at 1e-10. Needs an
NVIDIA GPU; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_lowrank.py --noconftest -q

At n = 2 000 (k = 100 inducing points, FSVA m = 20):
- card vs CPU within 1e-10 relative for FITC, full-scale tapering and FSVA:
  the NLL, its gradient, a prediction's mean and variance (the CPU model
  takes the card's inducing points and, for FSVA, its structure);
- the residual-correlation neighbours of FSVA equal on card and CPU;
- two FSVA fits, two GPBoost trainings with FSVA and two LaGaBoost
  trainings with FITC give the same bits (parameters, scores, evaluation
  counts);
- no ``index_add_`` / ``scatter_add_`` / accumulating ``index_put_`` in the
  traced FSVA value-and-gradient (profiler).
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt

pytestmark = pytest.mark.gpu

N = 2_000
K = 100
CP = [0.25, 1.0, 0.1]
PARAMS = {"num_leaves": 31, "learning_rate": 0.1, "min_data_in_leaf": 20,
          "verbose": -1}
SCATTERS = ("index_add", "scatter_add", "index_put", "scatter_reduce",
            "indexFunc", "put_")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    b = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    Xf = rng.uniform(size=(N, 5))
    f = 2.0 * np.sin(5 * Xf[:, 0]) + Xf[:, 1] ** 2 + Xf[:, 2]
    return dict(coords=coords, Xf=Xf, y=b + 0.5 * rng.standard_normal(N),
                yf=f + b + 0.5 * rng.standard_normal(N),
                yb=rng.binomial(1, 1 / (1 + np.exp(-(f - 1 + b))))
                .astype(float), pred=rng.uniform(size=(100, 2)))


def _model(data, approx, device, **kw):
    kw.setdefault("num_ind_points", K)
    if approx.startswith("full_scale_vecchia"):
        kw.setdefault("num_neighbors", 20)
    return gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                       gp_approx=approx, device=device, **kw)


@pytest.mark.parametrize("approx,kw", [
    ("fitc", {}), ("full_scale_tapering", {"cov_fct_taper_range": 0.1}),
    ("full_scale_vecchia", {})])
def test_card_matches_cpu(data, dev, approx, kw):
    g, h = (_model(data, approx, d, **kw) for d in (dev, "cpu"))
    h._approx.ind_points = g._approx.ind_points.cpu()
    if approx == "full_scale_vecchia":
        h._approx.load_structure(g._approx.perm,
                                 g._approx.neighbors.cpu().numpy())
    out = []
    for m in (g, h):
        _, grad = m._approx._vg_gaussian(torch.log(m._tensor(CP)),
                                         m._tensor(data["y"]), None)
        pr = m.predict(y=data["y"], gp_coords_pred=data["pred"],
                       cov_pars=CP, predict_var=True)
        out.append((m.neg_log_likelihood(CP, data["y"]), grad.cpu().numpy(),
                    pr["mu"], pr["var"]))
    for a, b in zip(*out):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b))


def test_correlation_neighbors_equal_on_card_and_cpu(data, dev):
    g, h = (_model(data, "full_scale_vecchia_correlation_based", d)
            for d in (dev, "cpu"))
    h._approx.ind_points = g._approx.ind_points.cpu()
    g.neg_log_likelihood(CP, data["y"])
    h.neg_log_likelihood(CP, data["y"])
    np.testing.assert_array_equal(g._approx.neighbors.cpu().numpy(),
                                  h._approx.neighbors.numpy())


def test_fsva_fits_are_bit_identical(data, dev):
    fits = []
    for _ in range(2):
        m = _model(data, "full_scale_vecchia", dev)
        m.fit(data["y"], params={"optimizer_cov": "lbfgs"})
        fits.append((m.get_cov_pars(), m.current_nll_,
                     m._fit_result.num_evals))
    assert np.array_equal(fits[0][0], fits[1][0])
    assert fits[0][1:] == fits[1][1:]


@pytest.mark.parametrize("approx,binary", [("full_scale_vecchia", False),
                                           ("fitc", True)])
def test_trainings_are_bit_identical(data, dev, approx, binary):
    runs = []
    for _ in range(2):
        gp = _model(data, approx, dev,
                    likelihood="bernoulli_logit" if binary else "gaussian")
        if not binary:
            gp.set_optim_params({"optimizer_cov": "lbfgs",
                                 "init_cov_pars": CP})
        label = data["yb"] if binary else data["yf"]
        bst = gpt.train(dict(PARAMS, objective="binary" if binary
                             else "regression"),
                        gpt.Dataset(data["Xf"], label=label, device=dev),
                        gp_model=gp, num_boost_round=5)
        runs.append((bst._score.copy(), gp.get_cov_pars(),
                     [f["num_evals"] for f in bst.objective.fits]))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]


def test_fsva_value_and_gradient_has_no_scatter(data, dev):
    from torch.profiler import ProfilerActivity, profile
    m = _model(data, "full_scale_vecchia", dev)
    th = torch.log(m._tensor(CP))
    y = m._tensor(data["y"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m._approx._vg_gaussian(th, y, None)
        m._psi_solve(CP, data["y"])
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    assert any("cholesky" in x for x in names)
    assert not [x for x in names if any(b in x for b in SCATTERS)]
