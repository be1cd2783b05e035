"""The port's CUDA kernels on the card, at small sizes: the corners that the
full-size run of ``chip_smoke.py`` does not reach (for both Vecchia kernels
every rows-per-block choice, a last block that is not full, the largest
shared-memory block at m = 64, d = 8, a second launch bit-identical; d = 1
and 3, no nugget, prediction rows below one wave of the card, row shards;
the histogram over several feature tiles and clusters, fewer rows than a
cluster has threads, one and 256 bins, an output that no memset clears, two
launches bit-identical (float64 plain route too), the fixed-point scale at
its overflow edge; the gather-only ``B' v``; two GPBoost trainings
bit-identical; the input checks on CUDA tensors). Needs an NVIDIA GPU and
``nvcc``; skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_kernels.py --noconftest -q

Tolerances: A, D atol 2e-5 vs the float32 plain version; NLL 1e-5 relative
and gradient rtol 1e-3 (+ 1e-3 absolute per 900 rows: float32 row terms
add up) vs float64 autograd, two launches bit-identical; histogram
counts exact, its gradient / hessian sums within 1e-5 x (sum of |v| over the
bin) of the float64 plain version (fixed-point sums, rounded to float32 once)
and bit-identical from launch to launch; gather ``B' v`` within 1e-5 of the
scatter in float32, bit-identical from call to call.
"""
import numpy as np
import pytest
import torch

from gpboost_tpu_torch.boosting.tree import (build_histogram,
                                             histogram_launches)
from gpboost_tpu_torch.ops import vecchia as tv
from gpboost_tpu_torch.ops.kernels import histogram as hk
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


def _problem(dev, n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    coords = torch.tensor(rng.uniform(size=(n, d)), dtype=torch.float32,
                          device=dev)
    r = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    nb = tv.find_neighbors(coords, m)
    nb[n // 2, m // 2] = -1          # padding inside a row as well
    return coords, r, nb


def _pars(dev, ard, d, dtype=torch.float32):
    ranges = [0.3, 0.2, 0.45, 0.25, 0.35, 0.5, 0.4, 0.3][:d] if ard else [0.3]
    return torch.tensor([0.25, 1.1] + ranges, dtype=dtype, device=dev)


@pytest.mark.parametrize("m", [1, 5, 24, 25, 40, 41, 64])
@pytest.mark.parametrize("d,ard,shape", [(1, False, 0.5), (2, True, 1.5),
                                          (3, True, 2.5), (3, False, -1.0)])
def test_factors_kernel_matches_plain(dev, m, d, ard, shape):
    coords, _, nb = _problem(dev, 700, m, d)
    cp = _pars(dev, ard, d)
    before = vk.vecchia_factors.launches
    a_k, d_k = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, shape,
                                  ard=ard)
    torch.cuda.synchronize()
    assert vk.vecchia_factors.launches == before + 1
    a_p, d_p = vk.vecchia_factors_plain(cp[1:], coords, nb, cp[0], True,
                                        shape, ard=ard)
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_k.cpu(), d_p.cpu(), rtol=0, atol=2e-5)


def _assert_factors_close(cp, coords, nb, shape, ard, a_k, d_k, rows=None):
    a_p, d_p = vk.vecchia_factors_plain(cp[1:], coords, nb, cp[0], True,
                                        shape, ard=ard, row_coords=rows)
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_k.cpu(), d_p.cpu(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("which", ["one", "rows-1", "rows+1", "10007"])
@pytest.mark.parametrize("m,d", [(20, 2), (40, 2), (64, 2)])
def test_factors_kernel_last_block_not_full(dev, m, d, which):
    rows, _ = vk.factors_launch_geometry(m, d)
    assert rows == {20: 32, 40: 16, 64: 8}[m]
    n = {"one": 1, "rows-1": rows - 1, "rows+1": rows + 1,
         "10007": 10_007}[which]
    coords, _, nb = _problem(dev, n, m, d, seed=5)
    cp = _pars(dev, False, d)
    a_k, d_k = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 0.5)
    torch.cuda.synchronize()
    _assert_factors_close(cp, coords, nb, 0.5, False, a_k, d_k)


def test_factors_kernel_largest_shared_memory_block(dev):
    """m = 64, d = 8 ARD: 8 rows of 10 880 bytes, the largest block (above
    48 KB, so the launch opts in to more dynamic shared memory)."""
    m, d = 64, 8
    assert vk.factors_launch_geometry(m, d) == (8, 87_040)
    coords, _, nb = _problem(dev, 700, m, d, seed=6)
    cp = _pars(dev, True, d)
    a_k, d_k = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 1.5,
                                  ard=True)
    torch.cuda.synchronize()
    _assert_factors_close(cp, coords, nb, 1.5, True, a_k, d_k)


def test_factors_kernel_prediction_rows_below_one_wave(dev):
    """Prediction factors (``row_coords``, neighbours among the observed
    points) for 500 rows at m = 40: 32 blocks, fewer than the card's SMs."""
    coords, _, _ = _problem(dev, 3000, 40, 2, seed=8)
    rows = torch.rand((500, 2), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(8))
    nb = tv.find_neighbors_cross(rows, coords, 40)
    n_rows, _ = vk.factors_launch_geometry(40, 2)
    assert -(-500 // n_rows) < torch.cuda.get_device_properties(
        dev).multi_processor_count
    cp = _pars(dev, False, 2)
    a_k, d_k = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 2.5,
                                  row_coords=rows)
    torch.cuda.synchronize()
    _assert_factors_close(cp, coords, nb, 2.5, False, a_k, d_k, rows=rows)


@pytest.mark.parametrize("m,d,ard", [(20, 2, False), (40, 3, True),
                                     (64, 8, True)])
def test_factors_kernel_second_launch_bit_identical(dev, m, d, ard):
    coords, _, nb = _problem(dev, 3001, m, d, seed=7)
    cp = _pars(dev, ard, d)
    a1, d1 = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 2.5, ard=ard)
    a2, d2 = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 2.5, ard=ard)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)


def test_factors_kernel_without_nugget_and_with_row_coords(dev):
    coords, _, _ = _problem(dev, 500, 8, 2)
    rows = torch.rand((300, 2), device=dev)
    nb = tv.find_neighbors_cross(rows, coords, 8)
    # a short range keeps C_NN well conditioned without a nugget, so that
    # two float32 computations can be compared at all
    cp = torch.tensor([0.25, 1.1, 0.05], dtype=torch.float32, device=dev)
    for nugget, include in ((cp[0], False), (None, False), (cp[0], True)):
        a_k, d_k = vk.vecchia_factors(cp[1:], coords, nb, nugget, include,
                                      0.5, row_coords=rows)
        a_p, d_p = vk.vecchia_factors_plain(cp[1:], coords, nb, nugget,
                                            include, 0.5, row_coords=rows)
        atol = 2e-5 if include else 2e-4
        np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), rtol=0, atol=atol)
        np.testing.assert_allclose(d_k.cpu(), d_p.cpu(), rtol=0, atol=atol)


@pytest.mark.parametrize("m", [1, 2, 6, 20, 24, 25, 32, 40, 41, 64])
@pytest.mark.parametrize("d,ard,shape", [(1, False, 1.5), (2, False, 0.5),
                                          (3, True, 0.5), (3, True, -1.0),
                                          (2, True, 2.5)])
def test_nll_grad_kernel_matches_float64_autograd(dev, m, d, ard, shape):
    coords, r, nb = _problem(dev, 900, m, d, seed=1)
    lp = torch.log(_pars(dev, ard, d))
    before = vk.vecchia_nll_grad.launches
    v_k, g_k = vk.vecchia_nll_grad(lp, coords, nb, r, shape, ard=ard)
    torch.cuda.synchronize()
    assert vk.vecchia_nll_grad.launches == before + 1
    v64, g64 = vk.vecchia_nll_grad_plain(lp.double(), coords.double(), nb,
                                         r.double(), shape, ard=ard)
    assert abs(float(v_k) - float(v64)) < 1e-5 * abs(float(v64))
    np.testing.assert_allclose(g_k.cpu().double(), g64.cpu(), rtol=1e-3,
                               atol=1e-3)


def _assert_nll_grad_close(lp, coords, nb, r, shape, ard, v_k, g_k):
    v64, g64 = vk.vecchia_nll_grad_plain(lp.double(), coords.double(), nb,
                                         r.double(), shape, ard=ard)
    assert abs(float(v_k) - float(v64)) < 1e-5 * abs(float(v64))
    atol = 1e-3 * max(1.0, nb.shape[0] / 900)
    np.testing.assert_allclose(g_k.cpu().double(), g64.cpu(), rtol=1e-3,
                               atol=atol)


@pytest.mark.parametrize("which", ["one", "rows-1", "rows+1", "10007"])
@pytest.mark.parametrize("m,d", [(20, 2), (40, 2), (64, 2)])
def test_nll_grad_kernel_last_block_not_full(dev, m, d, which):
    rows = vk._lib().vf_nll_rows_per_block(m, d)
    assert rows == {20: 32, 40: 16, 64: 8}[m]
    n = {"one": 1, "rows-1": rows - 1, "rows+1": rows + 1,
         "10007": 10_007}[which]
    coords, r, nb = _problem(dev, n, m, d, seed=5)
    lp = torch.log(_pars(dev, False, d))
    v_k, g_k = vk.vecchia_nll_grad(lp, coords, nb, r, 0.5)
    torch.cuda.synchronize()
    _assert_nll_grad_close(lp, coords, nb, r, 0.5, False, v_k, g_k)


def test_nll_grad_kernel_largest_shared_memory_block(dev):
    """m = 64, d = 8 ARD: 8 rows of 10 880 bytes, the largest block (above
    48 KB, so the launch opts in to more dynamic shared memory)."""
    m, d = 64, 8
    assert vk.nll_launch_geometry(m, d) == (8, 87_040)
    coords, r, nb = _problem(dev, 700, m, d, seed=6)
    lp = torch.log(_pars(dev, True, d))
    v_k, g_k = vk.vecchia_nll_grad(lp, coords, nb, r, 1.5, ard=True)
    torch.cuda.synchronize()
    _assert_nll_grad_close(lp, coords, nb, r, 1.5, True, v_k, g_k)


@pytest.mark.parametrize("m,d,ard", [(20, 2, False), (40, 3, True),
                                     (64, 8, True)])
def test_nll_grad_kernel_second_launch_bit_identical(dev, m, d, ard):
    coords, r, nb = _problem(dev, 3001, m, d, seed=7)
    lp = torch.log(_pars(dev, ard, d))
    v1, g1 = vk.vecchia_nll_grad(lp, coords, nb, r, 2.5, ard=ard)
    v2, g2 = vk.vecchia_nll_grad(lp, coords, nb, r, 2.5, ard=ard)
    assert torch.equal(v1, v2) and torch.equal(g1, g2)


def test_nll_grad_kernel_row_shards_add_up(dev):
    n, m = 1000, 10
    coords, r, nb = _problem(dev, n, m, 2, seed=2)
    lp = torch.log(_pars(dev, False, 2))
    v_all, g_all = vk.vecchia_nll_grad(lp, coords, nb, r, 1.5,
                                       include_const=False)
    valid = (torch.rand(n, device=dev) < 0.8).float()
    v_w, g_w = vk.vecchia_nll_grad(lp, coords, nb, r, 1.5, row_valid=valid,
                                   include_const=False)
    v_w64, g_w64 = vk.vecchia_nll_grad_plain(
        lp.double(), coords.double(), nb, r.double(), 1.5,
        row_valid=valid.double(), include_const=False)
    assert abs(float(v_w) - float(v_w64)) < 1e-5 * abs(float(v_w64))
    np.testing.assert_allclose(g_w.cpu().double(), g_w64.cpu(), rtol=1e-3,
                               atol=1e-3)
    tot_v, tot_g = 0.0, 0.0
    for rows in (slice(0, 333), slice(333, n)):
        v, g = vk.vecchia_nll_grad(
            lp, coords, nb[rows].contiguous(), r, 1.5,
            row_r=r[rows].contiguous(), row_coords=coords[rows].contiguous(),
            include_const=False)
        tot_v, tot_g = tot_v + float(v), tot_g + g.cpu().double()
    assert abs(tot_v - float(v_all)) < 1e-5 * abs(float(v_all))
    np.testing.assert_allclose(tot_g, g_all.cpu().double(), rtol=1e-4,
                               atol=1e-3)


def test_cuda_tensors_that_the_kernels_do_not_take_raise(dev):
    coords, r, nb = _problem(dev, 200, 6, 2)
    cp = _pars(dev, False, 2)
    lp = torch.log(cp)
    bad = [
        ("coords", dict(coords=coords.double())),
        ("neighbors", dict(neighbors=nb.long())),
        ("neighbors", dict(neighbors=nb.cpu())),
        ("neighbors", dict(neighbors=nb.T.contiguous().T)),
        ("row_coords", dict(row_coords=coords[:-1])),
    ]
    for name, kw in bad:
        args = dict(coords=coords, neighbors=nb, row_coords=None)
        args.update(kw)
        with pytest.raises(ValueError, match=f"^{name}:"):
            vk.vecchia_factors(cp[1:], args["coords"], args["neighbors"],
                               cp[0], True, 0.5, row_coords=args["row_coords"])
        with pytest.raises(ValueError, match=f"^{name}:"):
            vk.vecchia_nll_grad(lp, args["coords"], args["neighbors"], r, 0.5,
                                row_coords=args["row_coords"])
    with pytest.raises(ValueError, match="^cov_pars:"):
        vk.vecchia_factors(cp, coords, nb, cp[0], True, 0.5)
    with pytest.raises(ValueError, match="^log_cov_pars:"):
        vk.vecchia_nll_grad(lp.double(), coords, nb, r, 0.5)
    with pytest.raises(ValueError, match="^r:"):
        vk.vecchia_nll_grad(lp, coords, nb, r[:-1], 0.5)
    with pytest.raises(ValueError, match="^row_r:"):
        vk.vecchia_nll_grad(lp, coords, nb[:50].contiguous(), r, 0.5,
                            row_coords=coords[:50].contiguous())
    wide = torch.full((200, vk.MAX_M + 1), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="^neighbors:"):
        vk.vecchia_factors(cp[1:], coords, wide, cp[0], True, 0.5)


def test_float32_model_on_the_card_goes_through_the_kernels(dev):
    import gpboost_tpu_torch as gpt
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(2000, 2))
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    vk.reset_launch_counts()
    m32 = gpt.GPModel(gp_coords=coords, cov_function="matern",
                      cov_fct_shape=1.5, gp_approx="vecchia",
                      num_neighbors=12, dtype=torch.float32)   # device="cuda"
    m64 = gpt.GPModel(gp_coords=coords, cov_function="matern",
                      cov_fct_shape=1.5, gp_approx="vecchia",
                      num_neighbors=12)
    m32.fit(y, params={"optimizer_cov": "lbfgs"})
    counts = vk.launch_counts()
    assert counts["vecchia_nll_grad"] == m32._fit_result.num_evals
    assert counts["vecchia_factors"] == 1
    m64.fit(y, params={"optimizer_cov": "lbfgs"})
    assert vk.launch_counts() == counts      # float64: plain version on the card
    np.testing.assert_allclose(m32.get_cov_pars(), m64.get_cov_pars(),
                               rtol=2e-2)
    p32 = m32.predict(gp_coords_pred=coords[:100] + 0.001, predict_var=True,
                      cov_pars=m64.get_cov_pars())
    p64 = m64.predict(gp_coords_pred=coords[:100] + 0.001, predict_var=True)
    np.testing.assert_allclose(p32["mu"], p64["mu"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p32["var"], p64["var"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def _hist_inputs(dev, n, F, B, keep, seed=0):
    rng = np.random.default_rng(seed)
    binned_np = rng.integers(0, B, size=(n, F))
    binned = torch.tensor(binned_np, dtype=torch.int32, device=dev)
    panel = torch.tensor(np.ascontiguousarray(binned_np.T.astype(np.uint8)),
                         device=dev)
    g = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    h = torch.tensor(np.abs(rng.standard_normal(n)), dtype=torch.float32,
                     device=dev)
    mask = torch.tensor(rng.random(n) < keep, device=dev)
    return binned, panel, g, h, mask


def _assert_hist_close(got, binned, g, h, mask, B):
    want = hk.histogram_plain(binned, g.double(), h.double(), mask, B)
    scale = hk.histogram_plain(binned, g.double().abs(), h.double().abs(),
                               mask, B)
    assert torch.equal(got[2].double(), want[2])            # counts: exact
    for k in (0, 1):
        err = (got[k].double() - want[k]).abs()
        assert bool((err <= 1e-5 * scale[k] + 1e-30).all()), float(err.max())


@pytest.mark.parametrize("n,F,B,keep", [
    (1, 1, 1, 1.0), (1000, 5, 255, 1.0), (1023, 8, 256, 0.5),
    (1025, 9, 64, 0.03), (5000, 17, 2, 0.9), (3000, 10, 64, 0.0),
    (300_001, 3, 256, 0.7), (100, 9, 256, 1.0), (20_000, 17, 1, 1.0),
    (70_001, 17, 256, 0.5)])
def test_histogram_kernel_matches_plain(dev, n, F, B, keep):
    binned, panel, g, h, mask = _hist_inputs(dev, n, F, B, keep)
    scales = hk.fixed_point_scales(g, h)
    before = hk.histogram.launches
    got = hk.histogram(binned, g, h, mask, B, binned_t=panel, scales=scales)
    torch.cuda.synchronize()
    assert hk.histogram.launches == before + 1
    assert all(a.shape == (F, B) and a.dtype == torch.float32 for a in got)
    _assert_hist_close(got, binned, g, h, mask, B)
    # without the panel the wrapper transposes ``binned`` itself: same bits
    again = hk.histogram(binned, g, h, mask, B, scales=scales)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_histogram_kernel_empty_mask_gives_zeros(dev):
    binned, panel, g, h, _ = _hist_inputs(dev, 40_000, 17, 256, 1.0)
    none = torch.zeros(40_000, dtype=torch.bool, device=dev)
    got = hk.histogram(binned, g, h, none, 256, binned_t=panel,
                       scales=hk.fixed_point_scales(g, h))
    for a in got:
        assert torch.equal(a, torch.zeros_like(a))


def _launch(panel, g, h, mask, out, scales=None):
    F, n = panel.shape
    scale_g, scale_h = scales or hk.fixed_point_scales(g, h)
    err = hk._lib().histogram_launch(
        panel.data_ptr(), g.data_ptr(), h.data_ptr(), mask.data_ptr(),
        out.data_ptr(), n, F, out.shape[2], scale_g, scale_h,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,F,B", [(5000, 9, 64), (100_000, 17, 256),
                                   (10, 3, 1)])
def test_histogram_launch_writes_an_output_full_of_nan(dev, n, F, B):
    """The C launcher into a buffer of NaN: every slot is written (the
    result does not rely on a memset), in one launch."""
    binned, panel, g, h, mask = _hist_inputs(dev, n, F, B, 0.6)
    out = torch.full((3, F, B), float("nan"), device=dev)
    _launch(panel, g, h, mask, out)
    assert not bool(out.isnan().any())
    _assert_hist_close((out[0], out[1], out[2]), binned, g, h, mask, B)


def test_histogram_launch_empty_mask_writes_zeros_over_nan(dev):
    binned, panel, g, h, _ = _hist_inputs(dev, 30_000, 9, 256, 1.0)
    none = torch.zeros(30_000, dtype=torch.bool, device=dev)
    out = torch.full((3, 9, 256), float("nan"), device=dev)
    _launch(panel, g, h, none, out)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("keep", [1.0, 0.03])
def test_histogram_two_launches_bit_identical(dev, dp, keep):
    """The same inputs give the same bits: the kernel's fixed-point sums,
    and the float64 plain route (``gpu_use_dp``) on the card."""
    binned, panel, g, h, mask = _hist_inputs(dev, 100_000, 5, 254, keep)
    if dp:
        g, h = g.double(), h.double()
    before = hk.histogram.launches
    runs = [build_histogram(binned, g, h, mask, 254, binned_t=panel)
            for _ in range(3)]
    assert hk.histogram.launches == before + (0 if dp else 3)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    _assert_hist_close(runs[0], binned, g.float(), h.float(), mask, 254)


@pytest.mark.parametrize("big", [3.0e30, -1.0e25, 7.0])
def test_histogram_fixed_point_scale_at_its_overflow_edge(dev, big):
    """Every row in one bin, the largest |g| at the top of the fixed-point
    range (n max|g| scale just below 2^62, all of one sign): the sums stay
    finite and within tolerance."""
    n, F, B = 100_000, 3, 256
    binned, panel, g, h, mask = _hist_inputs(dev, n, F, B, 1.0)
    binned[:, 1] = 5
    panel[1] = 5
    g = torch.full((n,), big, dtype=torch.float32, device=dev)
    g[::7] *= 0.5
    h = g.abs() * 0.25
    scales = hk.fixed_point_scales(g, h)
    assert n * abs(big) * scales[0] < 2.0 ** 62 <= 2 * n * abs(big) * scales[0]
    got = hk.histogram(binned, g, h, mask, B, binned_t=panel, scales=scales)
    assert all(bool(a.isfinite().all()) for a in got)
    _assert_hist_close(got, binned, g, h, mask, B)
    assert float(got[2][1, 5]) == n

def test_histogram_kernel_one_bin_takes_every_row(dev):
    n, F, B = 50_000, 4, 256
    binned, panel, g, h, mask = _hist_inputs(dev, n, F, B, 1.0)
    binned[:, 2] = 255
    panel[2] = 255
    scales = hk.fixed_point_scales(g, h)
    got = hk.histogram(binned, g, h, mask, B, binned_t=panel, scales=scales)
    _assert_hist_close(got, binned, g, h, mask, B)
    assert float(got[2][2, 255]) == n
    # bins at or above num_bins are dropped, not written out of bounds
    low = hk.histogram(binned, g, h, mask, 200, binned_t=panel,
                       scales=scales)
    assert float(low[2][2].sum()) == 0.0
    assert float(low[2][0].sum()) == float((binned[:, 0] < 200).sum())


def test_histogram_cuda_tensors_that_the_kernel_does_not_take_raise(dev):
    binned, panel, g, h, mask = _hist_inputs(dev, 500, 3, 16, 0.5)
    bad = [
        ("grad", dict(grad=g.double())),
        ("hess", dict(hess=h.cpu())),
        ("hess", dict(hess=h[:-1])),
        ("row_mask", dict(row_mask=mask.to(torch.uint8))),
        ("binned_t", dict(binned_t=panel.int())),
        ("binned_t", dict(binned_t=panel[:, :-1])),
        ("binned_t", dict(binned_t=panel.t().contiguous().t())),
        ("num_bins", dict(num_bins=257)),
        ("num_bins", dict(num_bins=0)),
        ("scales", dict(scales=None)),
        ("scales", dict(scales=(3.0, 1.0))),
        ("scales", dict(scales=(1.0, -2.0))),
        ("scales", dict(scales=(1.0,))),
    ]
    scales = hk.fixed_point_scales(g, h)
    before = hk.histogram.launches
    for name, kw in bad:
        args = dict(grad=g, hess=h, row_mask=mask, num_bins=16,
                    binned_t=panel, scales=scales)
        args.update(kw)
        with pytest.raises(ValueError, match=f"^{name}:"):
            hk.histogram(binned, args["grad"], args["hess"],
                         args["row_mask"], args["num_bins"],
                         binned_t=args["binned_t"], scales=args["scales"])
    with pytest.raises(ValueError, match="^binned:"):
        hk.histogram(binned.cpu(), g, h, mask, 16, scales=scales)
    with pytest.raises(ValueError, match="^histogram: a gradient"):
        hk.fixed_point_scales(torch.full_like(g, float("nan")), h)
    assert hk.histogram.launches == before


def test_build_histogram_gate_on_the_card(dev):
    binned, panel, g, h, mask = _hist_inputs(dev, 2000, 4, 32, 0.6)
    before = hk.histogram.launches
    build_histogram(binned, g, h, mask, 32, binned_t=panel)
    assert hk.histogram.launches == before + 1
    # outside the gate: float64 gradients, or more than 256 bins — the plain
    # version on the card
    out = build_histogram(binned, g.double(), h.double(), mask, 32)
    assert out[0].dtype == torch.float64 and out[0].is_cuda
    wide = build_histogram(binned, g, h, mask, 300)
    assert wide[0].shape == (4, 300)
    assert hk.histogram.launches == before + 1


def test_boosting_on_the_card_goes_through_the_histogram_kernel(dev):
    import gpboost_tpu_torch as gpt
    rng = np.random.default_rng(4)
    n = 5000
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.3 * rng.standard_normal(n))
    # the host loop (a refit a round): "auto" takes the device loop for a
    # Gaussian GP on the card
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "device_resident_boosting": "false"}
    ds = gpt.Dataset(X, label=y)                             # device="cuda"
    hk.histogram.launches = 0
    vk.reset_launch_counts()
    b32 = gpt.train(params, ds, num_boost_round=3)
    launches = histogram_launches(b32.trees, params["num_leaves"])
    assert hk.histogram.launches == launches
    b64 = gpt.train(dict(params, gpu_use_dp=True), ds, num_boost_round=3)
    assert hk.histogram.launches == launches
    assert b32.trees[0].split_feature[0] == b64.trees[0].split_feature[0]
    assert b32.trees[0].threshold_bin[0] == b64.trees[0].threshold_bin[0]
    np.testing.assert_allclose(b32._score, b64._score, rtol=0, atol=1e-3)

    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=10,
                     dtype=torch.float32)
    gp.set_optim_params({"optimizer_cov": "lbfgs",
                         "init_cov_pars": [0.25, 1.0, 0.1]})
    hk.histogram.launches = 0
    bgp = gpt.train(params, ds, gp_model=gp, num_boost_round=3)
    assert hk.histogram.launches == histogram_launches(
        bgp.trees, params["num_leaves"])
    assert bgp.objective.num_fits == 4
    assert vk.launch_counts()["vecchia_nll_grad"] > 0
    out = bgp.predict(X[:200], gp_coords_pred=coords[:200] + 1e-3,
                      predict_var=True)
    assert np.all(np.isfinite(out["response_mean"]))
    assert np.all(out["response_var"] > 0)
    cpu_gp = gpt.GPModel(gp_coords=coords[:100], gp_approx="vecchia",
                         num_neighbors=5, device="cpu")
    with pytest.raises(ValueError, match="same device"):
        gpt.Booster(params=params, train_set=ds, gp_model=cpu_gp)


# ---------------------------------------------------------------------------
# gather-only B' v, and a GPBoost training twice
# ---------------------------------------------------------------------------

def test_gather_bt_bit_identical_and_matches_scatter(dev):
    n, m = 20_000, 15
    coords, r, nb = _problem(dev, n, m, 2)
    cp = _pars(dev, False, 2)
    a, _ = vk.vecchia_factors(cp[1:], coords, nb, cp[0], True, 0.5)
    slices = tv.build_incoming_sliced(nb)
    first = tv.apply_Bt_sliced(a, slices, r)
    for _ in range(3):
        assert torch.equal(tv.apply_Bt_sliced(a, slices, r), first)
    want = tv.apply_Bt(a, nb, r)
    assert float((first - want).abs().max()) <= 1e-5
    inc_row, inc_slot = tv.build_incoming(nb)
    padded = tv.apply_Bt_gather(a, inc_row, inc_slot, r)
    assert float((padded - want).abs().max()) <= 1e-5


def test_gpboost_training_on_the_card_is_bit_reproducible(dev):
    """Two ``train(..., gp_model=gp)`` runs on the same data: the same
    scores, covariance parameters and evaluation counts, to the bit — with
    the default optimizer (gradient descent on the device) and L-BFGS."""
    import gpboost_tpu_torch as gpt
    rng = np.random.default_rng(5)
    n = 5000
    X = rng.uniform(size=(n, 5))
    coords = rng.uniform(size=(n, 2))
    y = (2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + np.sin(6 * coords[:, 0])
         + 0.3 * rng.standard_normal(n))
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    ds = gpt.Dataset(X, label=y)
    for optim in ({}, {"optimizer_cov": "lbfgs"}):
        runs = []
        for _ in range(2):
            gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                             gp_approx="vecchia", num_neighbors=10,
                             dtype=torch.float32)
            gp.set_optim_params(dict(optim, init_cov_pars=[0.25, 1.0, 0.1]))
            bst = gpt.train(params, ds, gp_model=gp, num_boost_round=4)
            runs.append((bst._score.copy(), gp.get_cov_pars().copy(),
                         [f["num_evals"] for f in bst.objective.fits]))
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        np.testing.assert_array_equal(runs[0][1], runs[1][1])
        assert runs[0][2] == runs[1][2]
