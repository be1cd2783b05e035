"""The module that holds the port's two CUDA kernels, on the CPU.

The kernels themselves need a GPU (``chip_smoke.py`` holds them against
their plain versions there). Here:

- the plain PyTorch versions (float32) are held against the Pallas TPU
  kernels they stand in for, run in interpret mode, at the bars of
  ``tests/test_pallas_kernels.py``: atol 2e-5 on A and D; |dNLL| < 1e-2,
  gradient rtol 2e-3 / atol 2e-2 (float32 sums in different orders);
- the gradient formulas that the CUDA kernel carries (derived by hand,
  there is no AD in CUDA) are transcribed to a few lines of float64 PyTorch
  and held against ``torch.autograd`` of the plain version at 1e-9, for all
  four shapes, isotropic and ARD, with -1 padding present;
- the wrappers' input checks, which are plain Python;
- the NLL kernel's launch geometry (rows per block, shared memory per block,
  rows of the scratch tensor), through its Python mirror, which the library
  is checked against when it is loaded.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.ops import vecchia as jv
from gpboost_tpu.ops.kernels.vecchia_factors import (vecchia_factors_pallas,
                                                     vecchia_nll_grad_pallas)
from gpboost_tpu_torch.ops import vecchia as tv
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk


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


def _f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _i32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def test_factors_plain_matches_pallas():
    rng = np.random.default_rng(0)
    n, m = 1024, 10
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    nb = np.asarray(jv.find_neighbors(jnp.asarray(coords), m, method="exact"))
    a_p, d_p = vecchia_factors_pallas(
        jnp.asarray([1.0, 0.1], jnp.float32), jnp.asarray(coords),
        jnp.asarray(nb), jnp.float32(0.25), True, 0.5)
    a_t, d_t = vk.vecchia_factors(_f32([1.0, 0.1]), _f32(coords), _i32(nb),
                                  _f32(0.25), True, 0.5)
    assert a_t.dtype == torch.float32
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_p), atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=2e-5)


def test_factors_plain_matches_pallas_row_coords():
    rng = np.random.default_rng(1)
    n_o, n_p, m = 600, 1100, 8
    coords = rng.uniform(size=(n_o, 2)).astype(np.float32)
    pred = rng.uniform(size=(n_p, 2)).astype(np.float32)
    nb = np.asarray(jv.find_neighbors_cross(
        jnp.asarray(pred), jnp.asarray(coords), m, method="exact"))
    a_p, d_p = vecchia_factors_pallas(
        jnp.asarray([1.0, 0.15], jnp.float32), jnp.asarray(coords),
        jnp.asarray(nb), jnp.float32(0.2), True, 0.5,
        row_coords=jnp.asarray(pred))
    a_t, d_t = vk.vecchia_factors(_f32([1.0, 0.15]), _f32(coords), _i32(nb),
                                  _f32(0.2), True, 0.5,
                                  row_coords=_f32(pred))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_p), atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=2e-5)


@pytest.mark.parametrize("shape,ard,cp", [
    (0.5, False, [0.2, 1.1, 0.13]),
    (1.5, True, [0.2, 1.1, 0.13, 0.21]),
])
def test_nll_grad_plain_matches_pallas(shape, ard, cp):
    rng = np.random.default_rng(1)
    n, m = 1500, 8   # m = 8: tracing AD through the Pallas body grows as m^3
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    y = (np.sin(4 * coords[:, 0])
         + 0.4 * rng.standard_normal(n)).astype(np.float32)
    nb = np.asarray(jv.find_neighbors(jnp.asarray(coords), m, method="exact"))
    lp = np.log(np.asarray(cp, np.float32))
    with jax.enable_x64(False):
        v_p, g_p = vecchia_nll_grad_pallas(
            jnp.asarray(lp), jnp.asarray(coords), jnp.asarray(nb),
            jnp.asarray(y), shape, ard=ard)
    v_t, g_t = vk.vecchia_nll_grad(_f32(lp), _f32(coords), _i32(nb), _f32(y),
                                   shape, ard=ard)
    assert v_t.dtype == torch.float32 and tuple(g_t.shape) == (len(cp),)
    assert abs(float(v_t) - float(v_p)) < 1e-2
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=2e-3,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the CUDA kernel's gradient formulas, transcribed
# ---------------------------------------------------------------------------

def _corr_and_g(x, code):
    """corr(x) and g(x) = -corr'(x) / x, as in csrc/vecchia_factors.cu."""
    if code == 0:
        e = torch.exp(-x)
        return e, torch.where(x > 0, e / torch.where(x > 0, x, 1.0), 0.0)
    if code == 1:
        e = torch.exp(-x)
        return (1 + x) * e, e
    if code == 2:
        e = torch.exp(-x)
        return (1 + x + x * x / 3) * e, (1 + x) * e / 3
    e = torch.exp(-x * x)
    return e, 2 * e


def _hand_nll_grad(lp, coords, nb, r, code, ard, row_valid=None):
    """Row-wise NLL and hand-derived gradient, vectorised over rows:
    dD = dv - 2 a.dc + a.dC.a, de = -u.dc + u.dC.a,
    dl = 0.5 dD/D + e de/D - 0.5 e^2 dD/D^2."""
    n, m = nb.shape
    d = coords.shape[1]
    nug, var = torch.exp(lp[0]), torch.exp(lp[1])
    mc = {1: math.sqrt(3.0), 2: math.sqrt(5.0)}.get(code, 1.0)
    scale = mc * torch.exp(-lp[2:]) if ard else (
        mc * torch.exp(-lp[2])).expand(d)
    mask = nb >= 0
    xn = coords[torch.clamp(nb, min=0).long()]                 # [n, m, d]
    q_in = ((coords[:, None, :] - xn) * scale) ** 2            # [n, m, d]
    q_nn = ((xn[:, :, None, :] - xn[:, None, :, :]) * scale) ** 2
    x_in, x_nn = tv._safe_dist(q_in.sum(-1)), tv._safe_dist(q_nn.sum(-1))
    corr_in, g_in = _corr_and_g(x_in, code)
    corr_nn, g_nn = _corr_and_g(x_nn, code)
    eye = torch.eye(m, dtype=lp.dtype)
    pair = mask[:, :, None] & mask[:, None, :]
    offdiag = pair & ~eye.bool()
    c0 = torch.where(pair, var * corr_nn, 0.0)                 # var corr
    C = torch.where(pair, c0 + nug * eye, eye)
    c = torch.where(mask, var * corr_in, 0.0)
    rn = torch.where(mask, r[torch.clamp(nb, min=0).long()], 0.0)
    a = torch.where(mask, torch.linalg.solve(C, c), 0.0)
    u = torch.linalg.solve(C, rn)
    D = var + nug - (c * a).sum(1)
    e = r - (a * rn).sum(1)
    w = torch.ones(n, dtype=lp.dtype) if row_valid is None else row_valid
    g_D = 0.5 * (1 / D - (e / D) ** 2) * w
    g_e = e / D * w
    nll = (0.5 * (torch.log(D) + e * e / D) * w).sum()

    def forms(dC, dc):
        return (torch.einsum("nj,njk,nk->n", a, dC, a),
                torch.einsum("nj,njk,nk->n", u, dC, a),
                (a * dc).sum(1), (u * dc).sum(1))

    grads = []
    # log nugget: dC = nugget I on valid slots, dc = 0, dv = nugget
    aa, ua, _, _ = forms(nug * eye * mask[:, :, None], torch.zeros_like(c))
    grads.append((g_D * (nug + aa) + g_e * ua).sum())
    # log var: dC = var corr, dc = c, dv = var
    aa, ua, ac, uc = forms(c0, c)
    grads.append((g_D * (var - 2 * ac + aa) + g_e * (ua - uc)).sum())
    # log range(s): d corr / d log rho_k = g(x) q_k, dv = 0
    ranges = range(d) if ard else [slice(None)]
    for k in ranges:
        qk_nn = q_nn[..., k] if ard else q_nn.sum(-1)
        qk_in = q_in[..., k] if ard else q_in.sum(-1)
        dC = torch.where(offdiag, var * g_nn * qk_nn, 0.0)
        dc = torch.where(mask, var * g_in * qk_in, 0.0)
        aa, ua, ac, uc = forms(dC, dc)
        grads.append((g_D * (aa - 2 * ac) + g_e * (ua - uc)).sum())
    return nll, torch.stack(grads)


@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
@pytest.mark.parametrize("shape", [0.5, 1.5, 2.5, -1.0])
def test_hand_gradient_formulas_match_autograd(shape, ard):
    rng = np.random.default_rng(11)
    n, m, d = 160, 7, 3
    coords = torch.tensor(rng.uniform(size=(n, d)))
    coords[5] = coords[2]            # a zero distance inside a neighbor set
    r = torch.tensor(rng.standard_normal(n))
    nb = tv.find_neighbors(coords, m)
    nb[40, 3] = -1                   # padding in the middle of a row, too
    assert (nb[:m] < 0).any()
    rv = torch.tensor((rng.random(n) < 0.9).astype(np.float64))
    cp = [0.3, 1.2] + ([0.4, 0.25, 0.6] if ard else [0.3])
    lp = torch.log(torch.tensor(cp, dtype=torch.float64))
    v_ref, g_ref = vk.vecchia_nll_grad_plain(
        lp, coords, nb, r, shape, ard=ard, row_valid=rv, include_const=False)
    v, g = _hand_nll_grad(lp, coords, nb, r, vk._shape_code(shape), ard, rv)
    assert abs(float(v) - float(v_ref)) < 1e-9
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-9)


def test_nll_grad_plain_row_shard_arguments():
    """row_coords / row_r / row_valid / include_const: the NLL of two row
    shards adds up to the NLL of all rows."""
    rng = np.random.default_rng(12)
    n, m = 300, 6
    coords = torch.tensor(rng.uniform(size=(n, 2)))
    r = torch.tensor(rng.standard_normal(n))
    nb = tv.find_neighbors(coords, m)
    lp = torch.log(torch.tensor([0.3, 1.2, 0.2], dtype=torch.float64))
    v_all, g_all = vk.vecchia_nll_grad(lp, coords, nb, r, 1.5)
    tot_v, tot_g = 0.5 * n * math.log(2 * math.pi), 0.0
    for rows in (slice(0, 140), slice(140, n)):
        v, g = vk.vecchia_nll_grad(
            lp, coords, nb[rows], r, 1.5, row_r=r[rows],
            row_valid=torch.ones(len(r[rows]), dtype=torch.float64),
            row_coords=coords[rows], include_const=False)
        tot_v, tot_g = tot_v + v, tot_g + g
    assert abs(float(tot_v) - float(v_all)) < 1e-9
    np.testing.assert_allclose(tot_g.numpy(), g_all.numpy(), atol=1e-9)


# ---------------------------------------------------------------------------
# wrapper input checks (what a CUDA call verifies before it launches)
# ---------------------------------------------------------------------------

def _ok_args(n=20, m=4, d=2):
    return (torch.zeros((n, d), dtype=torch.float32),
            torch.zeros((n, m), dtype=torch.int32),
            torch.zeros((n, d), dtype=torch.float32))


def test_check_problem_accepts_valid():
    coords, nb, rc = _ok_args()
    assert vk._check_problem(coords, nb, rc)[:4] == (20, 4, 20, 2)


@pytest.mark.parametrize("mutate,name", [
    (lambda c, nb, rc: (c.double(), nb, rc), "coords"),
    (lambda c, nb, rc: (c, nb.long(), rc), "neighbors"),
    (lambda c, nb, rc: (c, nb, rc[:-1]), "row_coords"),
    (lambda c, nb, rc: (c, nb.T.contiguous().T, rc), "neighbors"),
    (lambda c, nb, rc: (c, torch.zeros((20, vk.MAX_M + 1),
                                       dtype=torch.int32), rc), "neighbors"),
    (lambda c, nb, rc: (torch.zeros((20, vk.MAX_D + 1)), nb,
                        torch.zeros((20, vk.MAX_D + 1))), "coords"),
    (lambda c, nb, rc: (c, nb, rc.to("meta")), "row_coords"),
])
def test_check_problem_names_the_argument(mutate, name):
    with pytest.raises(ValueError, match=f"^{name}:"):
        vk._check_problem(*mutate(*_ok_args()))


def test_unsupported_shape_raises():
    coords, nb, rc = _ok_args()
    with pytest.raises(ValueError, match="^shape:"):
        vk.vecchia_factors(torch.ones(2), coords, nb, torch.tensor(0.1), True,
                           0.8)
    with pytest.raises(ValueError, match="^shape:"):
        vk.vecchia_nll_grad(torch.zeros(3), coords, nb, torch.zeros(20), 3.5)


def test_launch_counters_untouched_on_cpu():
    vk.reset_launch_counts()
    coords, nb, _ = _ok_args()
    nb[:] = -1
    vk.vecchia_factors(torch.ones(2), coords, nb, torch.tensor(0.1), True,
                       0.5)
    assert vk.launch_counts() == {"vecchia_factors": 0,
                                  "vecchia_nll_grad": 0}


@pytest.mark.parametrize("d", range(1, vk.MAX_D + 1))
def test_nll_launch_geometry_fits_the_card(d):
    """Every (m, d) the kernel takes: R in {8, 16, 32} rows, a block within
    the budget unless R = 8 and always within the 227 KB of shared memory a
    Hopper block can have, room in each row for its triangle, neighbour
    coordinates, a and u, fewer rows a block as m grows, and one scratch row
    per block."""
    prev_rows = 32
    for m in range(1, vk.MAX_M + 1):
        rows, nbytes = vk.nll_launch_geometry(m, d)
        assert rows in (8, 16, 32)
        assert rows <= prev_rows
        prev_rows = rows
        assert nbytes <= vk.SMEM_PER_BLOCK_MAX == 232_448
        assert rows == 8 or nbytes <= vk.SMEM_BUDGET
        assert nbytes % (4 * rows) == 0
        assert nbytes // (4 * rows) >= m * (m + 1) // 2 + m * d + 2 * m
        for n in (1, rows - 1, rows, rows + 1, 10_007, 100_000):
            blocks = vk.nll_blocks(n, rows)
            assert blocks == math.ceil(n / rows)
            assert (blocks - 1) * rows < n <= blocks * rows
    # the main path's shape keeps full warps: 32 rows of 4 lanes, 290 floats
    # a row (210 of triangle, 40 of coordinates, 20 + 20 of a and u)
    assert vk.nll_launch_geometry(20, 2) == (32, 32 * 4 * 290)
