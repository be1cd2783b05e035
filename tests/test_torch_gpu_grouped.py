"""Grouped random effects on the card at n = 20 000 (two crossed random
intercepts of 200 and 500 levels, the second Zipf-skewed, a random slope on
the first): the corners the full-size run of ``chip_smoke.py`` does not
reach. Needs an NVIDIA GPU; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_grouped.py --noconftest -q

- two GPBoost trainings with the grouped model, and two GLMM fits
  (``bernoulli_logit``), are bit-identical (scores, covariance parameters,
  NLL, evaluation counts);
- Z' v through the fixed-order plan is bit-identical over 10 calls on the
  skewed codes, and within 1e-12 of the ``index_add_`` scatter;
- the card (plans, float64) agrees with the CPU plain path (``index_add_``,
  float64): the Gaussian and the Laplace NLL within 1e-10 relative, their
  gradients within 1e-9;
- no ``index_add_`` / ``scatter_add_`` / accumulating ``index_put_`` in the
  grouped NLL (forward and backward, Gaussian and Laplace) or in Z' v
  (profiler trace).
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import grouped as tg

pytestmark = pytest.mark.gpu

N = 20_000
LEVELS = (200, 500)
CP = [1.0, 0.5, 0.3, 0.2]
PARAMS = {"objective": "regression", "num_leaves": 31, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}
# names of the operations that add with colliding indices (float atomics)
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
    l1, l2 = LEVELS
    g1 = rng.integers(0, l1, N)
    p = 1.0 / np.arange(1, l2 + 1) ** 1.1
    g2 = rng.permutation(np.concatenate(
        [np.arange(l2), rng.choice(l2, N - l2, p=p / p.sum())]))
    xs = rng.uniform(-1, 1, N)
    b1, b2, b3 = (rng.standard_normal(l1), rng.standard_normal(l2),
                  rng.standard_normal(l1))
    lat = np.sqrt(0.5) * b1[g1] + np.sqrt(0.3) * b2[g2] \
        + np.sqrt(0.2) * xs * b3[g1]
    X = rng.uniform(size=(N, 5))
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    return dict(kw=dict(group_data=np.column_stack([g1, g2]),
                        group_rand_coef_data=xs,
                        ind_effect_group_rand_coef=[1]),
                g1=g1, X=X, y=lat + rng.standard_normal(N),
                yb=rng.binomial(1, 1 / (1 + np.exp(-lat))).astype(float),
                yf=f + lat + rng.standard_normal(N))


def _vg_gauss(m, y):
    th = m._tensor(np.log(np.asarray(CP[1:]) / CP[0]))
    v, g, _ = tg.nll_profiled_value_and_grad(m._Z, th, m._tensor(y))
    return float(v), g.cpu().numpy()


def _vg_laplace(m, yb):
    cp = m._tensor(CP[1:])
    v, g, _ = tg.nll_laplace_value_and_grad(m._Z, "bernoulli_logit", cp,
                                            None, m._tensor(yb))
    return float(v), g.cpu().numpy()


def test_card_matches_cpu_plain_path(data, dev):
    on_card = gpt.GPModel(device=dev, **data["kw"])
    on_cpu = gpt.GPModel(device="cpu", **data["kw"])
    assert on_card._Z.deterministic and not on_cpu._Z.deterministic
    assert on_card.neg_log_likelihood(CP, data["y"]) == pytest.approx(
        on_cpu.neg_log_likelihood(CP, data["y"]), rel=1e-10)
    for vg, y in ((_vg_gauss, data["y"]), (_vg_laplace, data["yb"])):
        (v1, g1), (v2, g2) = vg(on_card, y), vg(on_cpu, y)
        assert v1 == pytest.approx(v2, rel=1e-10)
        np.testing.assert_allclose(g1, g2, rtol=1e-9,
                                   atol=1e-9 * np.abs(g2).max())


def test_zt_mul_bit_identical_on_skewed_codes(data, dev):
    m = gpt.GPModel(device=dev, **data["kw"])
    v = m._tensor(np.random.default_rng(3).standard_normal(N))
    first = tg.zt_mul(m._Z, v)
    for _ in range(10):
        assert torch.equal(first, tg.zt_mul(m._Z, v))
    ref = torch.zeros_like(first)
    for idx, w in zip(m._Z.idx, m._Z.weights):
        ref.index_add_(0, idx, v if w is None else w * v)
    assert float((first - ref).abs().max()) <= 1e-12 * float(
        ref.abs().max())


def test_two_gpboost_trainings_bit_identical(data, dev):
    out = []
    for _ in range(2):
        gp = gpt.GPModel(group_data=data["g1"], device=dev)
        ds = gpt.Dataset(data["X"], label=data["yf"], device=dev)
        bst = gpt.train(PARAMS, ds, gp_model=gp, num_boost_round=3)
        out.append((bst._score.copy(), gp.get_cov_pars(),
                    [f["num_evals"] for f in bst.objective.fits]))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


def test_two_glmm_fits_bit_identical(data, dev):
    out = []
    for _ in range(2):
        m = gpt.GPModel(group_data=data["kw"]["group_data"],
                        likelihood="bernoulli_logit", device=dev)
        m.fit(data["yb"], params={"maxit": 5})
        out.append((m.get_cov_pars(), m.get_current_neg_log_likelihood(),
                    m._fit_result.num_evals))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_no_scatter_in_the_trace(data, dev):
    from torch.profiler import ProfilerActivity, profile
    m = gpt.GPModel(device=dev, **data["kw"])
    m._Z.pair_plan()
    v = m._tensor(data["y"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _vg_gauss(m, data["y"])
        _vg_laplace(m, data["yb"])
        tg.zt_mul(m._Z, v)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    assert any("index" in x for x in names), names
    assert not [x for x in names if any(b in x for b in SCATTERS)], names
