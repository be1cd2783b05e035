"""The iterative methods on the card (``matrix_inversion_method=
"iterative"``), at sizes the full-size run of ``chip_smoke.py`` does not
check piece by piece. Needs an NVIDIA GPU; skipped elsewhere. Run on the GPU
machine with

    python -m pytest tests/test_torch_gpu_iterative.py --noconftest -q

The card's draws come from a CUDA ``torch.Generator``, the CPU's from the
CPU one, so each comparison hands both sides the same draws:

- grouped random effects (n = 20 000, two crossed intercepts and a slope):
  the iterative profiled Gaussian NLL and the Laplace NLL with their
  gradients, card (fixed-order plans) vs CPU (``index_add_``), within 1e-9;
  two iterative GLMM fits on the card bit-identical;
- full-scale tapering by CG (n = 3 000, k = 100, taper range 0.05): NLL and
  gradient card vs CPU within 1e-9, and the taper structure equal;
- the Vecchia-Laplace NLL with the Nystrom preconditioner (n = 5 000,
  float64): the preconditioner P = U U' + delta I from the same sketch within
  1e-10, and the NLL within 1e-8 with value probes sqrt(delta) e (its low-rank
  half U e_r depends on the SVD's choice of basis, which cuSOLVER and LAPACK
  make differently: with it the two NLLs are two valid draws, 2e-4 apart)
  and its gradient within 1e-6 with the CG solved to 1e-10 (at the package's
  1e-3 the two devices' CG stop at different iterates, 2e-4 apart);
- Poisson LaGaBoost with grouped effects (fault C3): the histogram kernel
  once a leaf, two trainings bit-identical.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import grouped as tg
from gpboost_tpu_torch.ops import cg as tcg

pytestmark = pytest.mark.gpu

N = 20_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    g1, g2 = rng.integers(0, 200, N), rng.integers(0, 500, N)
    xs = rng.uniform(-1, 1, N)
    lat = (0.7 * rng.standard_normal(200)[g1] + 0.5 * rng.standard_normal(
        500)[g2] + 0.4 * xs * rng.standard_normal(200)[g1])
    return dict(kw=dict(group_data=np.column_stack([g1, g2]),
                        group_rand_coef_data=xs,
                        ind_effect_group_rand_coef=[1]),
                g=np.column_stack([g1, g2]), y=lat + rng.standard_normal(N),
                yb=rng.binomial(1, 1 / (1 + np.exp(-lat))).astype(float))


def _probes(q, k, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return tcg.normal_probes(gen, q, k), tcg.rademacher_probes(gen, q, k)


def test_grouped_iterative_card_matches_cpu(data, dev):
    out = []
    for device in (dev, "cpu"):
        m = gpt.GPModel(device=device, matrix_inversion_method="iterative",
                        **data["kw"])
        e, zg = _probes(m._Z.q, 30)
        probes = (e.to(m.device), zg.to(m.device))
        th = m._tensor(np.log([0.5, 0.3, 0.2]))
        v, g, s2 = tg.nll_profiled_iterative_value_and_grad(
            m._Z, th, m._tensor(data["y"]), lanczos_steps=30, probes=probes)
        mb = gpt.GPModel(device=device, group_data=data["g"],
                         likelihood="bernoulli_logit",
                         matrix_inversion_method="iterative")
        eb, zb = _probes(mb._Z.q, 30)
        vb, gb, _ = tg.nll_laplace_iterative_value_and_grad(
            mb._Z, "bernoulli_logit", mb._tensor([0.5, 0.3]), None,
            mb._tensor(data["yb"]), lanczos_steps=30,
            probes=(eb.to(mb.device), zb.to(mb.device)))
        out.append((float(v), g.cpu().numpy(), float(s2), float(vb),
                    gb.cpu().numpy()))
    (v1, g1, s1, vb1, gb1), (v2, g2, s2_, vb2, gb2) = out
    assert v1 == pytest.approx(v2, rel=1e-9)
    assert s1 == pytest.approx(s2_, rel=1e-9)
    assert vb1 == pytest.approx(vb2, rel=1e-9)
    np.testing.assert_allclose(g1, g2, rtol=1e-9, atol=1e-9 * np.abs(g2).max())
    np.testing.assert_allclose(gb1, gb2, rtol=1e-9,
                               atol=1e-9 * np.abs(gb2).max())


def test_two_iterative_glmm_fits_bit_identical(data, dev):
    fits = []
    for _ in range(2):
        m = gpt.GPModel(device=dev, group_data=data["g"],
                        likelihood="bernoulli_logit",
                        matrix_inversion_method="iterative")
        m.fit(data["yb"], params={"maxit": 5})
        fits.append((m.get_cov_pars(), m.current_nll_,
                     m._fit_result.num_evals))
    assert np.array_equal(fits[0][0], fits[1][0])
    assert fits[0][1:] == fits[1][1:]


def test_fsa_iterative_card_matches_cpu(dev):
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(3000, 2))
    y = np.sin(6 * coords[:, 0]) + 0.5 * rng.standard_normal(3000)
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="full_scale_tapering", num_ind_points=100,
              cov_fct_taper_range=0.05, matrix_inversion_method="iterative")
    out = []
    for device in (dev, "cpu"):
        m = gpt.GPModel(device=device, **kw)
        a = m._approx
        gen = torch.Generator().manual_seed(2)
        draws = [tcg.normal_probes(gen, 100, 20),
                 tcg.normal_probes(gen, 3000, 20),
                 tcg.rademacher_probes(gen, 3000, 20)]
        lp = m._tensor(np.log([0.25, 1.0, 0.1])).requires_grad_(True)
        v = a._nll_gaussian_iterative(torch.exp(lp), m._tensor(y), None,
                                      *[d.to(m.device) for d in draws])
        (g,) = torch.autograd.grad(v, lp)
        out.append((float(v.detach()), g.cpu().numpy(),
                    a.taper.idx.cpu().numpy(), a.ind_points.cpu().numpy()))
    (v1, g1, i1, p1), (v2, g2, i2, p2) = out
    np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-12)
    assert np.array_equal(i1, i2)
    assert v1 == pytest.approx(v2, rel=1e-9)
    np.testing.assert_allclose(g1, g2, rtol=1e-9, atol=1e-9 * np.abs(g2).max())


def test_lowrank_vecchia_laplace_card_matches_cpu(dev):
    rng = np.random.default_rng(2)
    n, k, r = 5000, 40, 50
    coords = rng.uniform(size=(n, 2))
    f = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    yb = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(float)
    gen = torch.Generator().manual_seed(4)
    e, zg = tcg.normal_probes(gen, n, k), tcg.rademacher_probes(gen, n, k)
    om, e_r = tcg.normal_probes(gen, n, r), tcg.normal_probes(gen, r, k)
    ref = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                      gp_approx="vecchia", num_neighbors=10,
                      likelihood="bernoulli_logit",
                      matrix_inversion_method="iterative", device="cpu")
    out = []
    for device in (dev, "cpu"):
        m = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=10,
                        likelihood="bernoulli_logit",
                        matrix_inversion_method="iterative", device=device)
        m._approx.load_structure(ref._approx.perm,
                                 ref._approx.neighbors.numpy())
        c = m._tensor([1.0, 0.1]).requires_grad_(True)
        dv = m.device
        v = m._approx._nll_laplace_iterative(
            c, m._tensor(yb), None, None, e.to(dv), zg.to(dv), 30, 1e-10,
            1000, low_rank=(om.to(dv), torch.zeros_like(e_r).to(dv)))
        (g,) = torch.autograd.grad(v, c)
        a, d = m._approx._latent_factors(c.detach())
        q_mv = m._approx._q_mv(a, d)
        pre = tcg.nystrom_preconditioner(q_mv, n, r, dtype=torch.float64,
                                         omega=om.to(dv))
        U = pre.U.cpu()
        out.append((float(v.detach()), g.cpu().numpy(),
                    (U @ U.T).numpy(), float(pre.d[0])))
    assert out[0][3] == pytest.approx(out[1][3], rel=1e-10)
    np.testing.assert_allclose(out[0][2], out[1][2], rtol=0,
                               atol=1e-10 * np.abs(out[1][2]).max())
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-8)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-6)


def test_poisson_lagaboost_on_the_card(data, dev):
    from gpboost_tpu_torch.boosting import tree as tt
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(N, 5))
    y = rng.poisson(np.exp(0.5 * X[:, 0] + 0.3 * rng.standard_normal(200)[
        data["g"][:, 0]])).astype(float)
    runs = []
    for _ in range(2):
        hk.histogram.launches = 0
        gp = gpt.GPModel(group_data=data["g"][:, 0], likelihood="poisson",
                         device=dev)
        bst = gpt.train({"objective": "poisson", "num_leaves": 15,
                         "verbose": -1},
                        gpt.Dataset(X, label=y, device=dev), gp_model=gp,
                        num_boost_round=3)
        assert hk.histogram.launches == tt.histogram_launches(bst.trees, 15)
        runs.append((bst._score.copy(), gp.get_cov_pars()))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
