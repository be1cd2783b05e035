"""The rest of the boosting tail on the card (ROADMAP item 18c): what the
full-size run of ``chip_smoke.py`` does not hold case by case. Needs an
NVIDIA GPU; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_boosting_tail_2.py --noconftest -q

- GOSS: the histogram kernel's fixed-point scales come from the amplified
  gradients of a sampled round (the kernel's histogram of that round
  against its float64 plain version: counts exact, sums within 1e-5 x the
  sum of |v| over the bin), and a GOSS training launches it once a leaf;
- the Newton leaf re-solve's multi-column ``Psi^-1`` on the kernel route
  (a float32 Vecchia GP): one ``vecchia_factors`` launch, the columns
  within 2e-4 relative of the float64 CPU model's;
- the vectorised LambdaRank lambdas on the card against their CPU twin
  (float64 both): 1e-12 relative.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import booster as booster_mod
from gpboost_tpu_torch.boosting import objectives as tobj
from gpboost_tpu_torch.boosting import tree as tt
from gpboost_tpu_torch.ops.kernels import histogram as hk
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

pytestmark = pytest.mark.gpu

HIST_SUM_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = 4000
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.3 * rng.standard_normal(n))
    return dict(X=X, y=y, coords=coords)


def test_goss_scales_come_from_the_amplified_gradients(dev, data,
                                                       monkeypatch):
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "boosting": "goss", "learning_rate": 0.25, "top_rate": 0.2,
              "other_rate": 0.1}
    ds = gpt.Dataset(data["X"], label=data["y"], device=dev)
    bst = gpt.Booster(params=params, train_set=ds)
    for _ in range(4):                   # before 1 / learning_rate: no sample
        bst.update()
    seen = {}

    def spy_of(grow):
        def spy(binned, num_bins, g, h, *args, **kwargs):
            seen.update(g=g, h=h, mask=kwargs["row_mask"])
            return grow(binned, num_bins, g, h, *args, **kwargs)
        return spy

    # the fixed-shape grower on the card, the host grower where it does not
    # cover the options: watch both
    for name in ("grow_tree", "grow_tree_fast"):
        monkeypatch.setattr(booster_mod, name,
                            spy_of(getattr(booster_mod, name)))
    hk.histogram.launches = 0
    bst.update()
    tree = bst.trees[-1]
    assert hk.histogram.launches == tt.histogram_launches(
        [tree], params["num_leaves"])
    g, h, mask = seen["g"], seen["h"], seen["mask"]
    n = ds.num_data
    top_k, other_k = int(0.2 * n), int(0.1 * n)
    assert int(mask.sum()) == top_k + other_k
    # the sampled rows carry (n - top_k) / other_k times their gradient:
    # the largest |g| on the round's rows is one of them or a top row
    mult = (n - top_k) / other_k
    assert float(g.abs().max()) > float(g[mask].abs().min()) * mult
    scales = hk.fixed_point_scales(g, h)
    got = hk.histogram(ds.binned, g, h, mask, ds.max_num_bins,
                       binned_t=ds.binned_t, scales=scales)
    want = hk.histogram_plain(ds.binned, g.double(), h.double(), mask,
                              ds.max_num_bins)
    np.testing.assert_array_equal(got[2].cpu().numpy(),
                                  want[2].cpu().numpy())
    for k, v in ((0, g), (1, h)):
        absum = hk.histogram_plain(ds.binned, v.double().abs(),
                                   v.double().abs(), mask,
                                   ds.max_num_bins)[0]
        err = (got[k].double() - want[k]).abs()
        assert bool((err <= HIST_SUM_TOL * absum + 1e-12).all())


def test_newton_psi_solve_columns_on_the_kernel_route(dev, data):
    n = 3000
    coords = data["coords"][:n]
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=20)
    card = gpt.GPModel(dtype=torch.float32, device=dev, **kw)
    cpu = gpt.GPModel(device="cpu", **kw)
    cpu._approx.load_structure(card._approx.perm,
                               card._approx.neighbors.cpu().numpy())
    assert card._approx._kernel_shape is not None
    leaf = np.random.default_rng(2).integers(0, 7, size=n)
    H = (leaf[:, None] == np.arange(7)[None, :]).astype(np.float64)
    cov_pars = np.array([0.25, 1.0, 0.1])
    before = vk.vecchia_factors.launches
    got = card._psi_solve(cov_pars, torch.as_tensor(H, device=dev))
    assert vk.vecchia_factors.launches == before + 1
    assert got.shape == (n, 7) and got.dtype == torch.float32
    want = cpu._psi_solve(cov_pars, H).numpy()
    err = np.abs(got.double().cpu().numpy() - want).max()
    assert err <= 2e-4 * np.abs(want).max(), err


def test_newton_leaf_update_launches_once_a_round(dev, data):
    gp = gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20,
                     dtype=torch.float32, device=dev)
    ds = gpt.Dataset(data["X"], label=data["y"], device=dev)
    common = {"objective": "regression", "num_leaves": 7, "verbose": -1}
    out = {}
    for key, extra in (("plain", {}), ("newton",
                                      {"leaves_newton_update": True})):
        vk.vecchia_factors.launches = 0
        gpt.train(dict(common, **extra), ds, gp_model=gp, num_boost_round=3)
        out[key] = vk.vecchia_factors.launches
    assert out["newton"] == out["plain"] + 3


def test_lambdarank_on_the_card_as_on_the_cpu(dev):
    rng = np.random.default_rng(5)
    group = rng.integers(1, 60, size=200)
    y = rng.integers(0, 5, group.sum()).astype(float)
    score = np.round(rng.normal(size=group.sum()), 2)
    out = []
    for device in (dev, torch.device("cpu")):
        obj = tobj.LambdaRank(device=device)
        obj.init(y, None, group=group)
        out.append(obj.get_gradients(score))
    for a, b in zip(out[0], out[1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
