"""PyTorch port vs the JAX package: Vecchia ordering, neighbor search,
factors, NLL and its gradient (plain versions, float64, CPU).

Tolerances: permutations and neighbor sets equal; A, D, NLL 1e-10 (batched
LAPACK Cholesky vs the reference's unrolled sweep: rounding only); autograd
gradient vs ``jax.grad`` 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.ops import vecchia as jv
from gpboost_tpu.ops.cov_fns import CovFunction as JCov
from gpboost_tpu_torch.ops import vecchia as tv
from gpboost_tpu_torch.ops.cov_fns import CovFunction as TCov


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


@pytest.mark.parametrize("ordering", ["none", "random", "time",
                                      "time_random_space"])
def test_apply_ordering_equal(ordering):
    rng = np.random.default_rng(0)
    tcol = rng.integers(0, 5, 200).astype(np.float64)
    np.testing.assert_array_equal(
        tv.apply_ordering(200, ordering, seed=7, time_col=tcol),
        jv.apply_ordering(200, ordering, seed=7, time_col=tcol))


def _sorted_rows(nb):
    return np.sort(np.asarray(nb), axis=1)


def test_find_neighbors_same_sets():
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(700, 2))
    want = jv.find_neighbors(jnp.asarray(coords), 10, method="exact")
    got = tv.find_neighbors(torch.tensor(coords), 10, chunk=256)
    assert got.dtype == torch.int32 and tuple(got.shape) == (700, 10)
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(want))
    # the first rows are padded: row i has i neighbors
    assert (np.asarray(got)[:10] >= 0).sum(1).tolist() == list(range(10))


def test_find_neighbors_cross_same_sets():
    rng = np.random.default_rng(2)
    obs = rng.uniform(size=(700, 2))
    pred = rng.uniform(size=(300, 2))
    want = jv.find_neighbors_cross(jnp.asarray(pred), jnp.asarray(obs), 10,
                                   method="exact")
    got = tv.find_neighbors_cross(torch.tensor(pred), torch.tensor(obs), 10,
                                  chunk=128)
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(want))
    # more neighbors asked for than observed points: width is capped
    few = tv.find_neighbors_cross(torch.tensor(pred), torch.tensor(obs[:6]),
                                  10)
    assert tuple(few.shape) == (300, 6)


def _fixture_problem(gp_fixture_data, m=30):
    coords = gp_fixture_data["coords"]
    y = gp_fixture_data["eps"] + gp_fixture_data["xi"]
    nb = np.asarray(jv.find_neighbors(jnp.asarray(coords), m, method="exact"))
    return coords, y, nb


def _random_problem(n=1500, m=12, seed=3):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = np.sin(4 * coords[:, 0]) + 0.4 * rng.standard_normal(n)
    nb = np.asarray(jv.find_neighbors(jnp.asarray(coords), m, method="exact"))
    return coords, y, nb


def _both_factors(name, shape, cp, coords, nb):
    jf = JCov.create(name, shape=shape)
    tf = TCov.create(name, shape=shape)
    a_j, d_j = jv.build_factors(jf, jnp.asarray(cp[1:]), jnp.asarray(coords),
                                jnp.asarray(nb), jnp.asarray(cp[0]), True)
    a_t, d_t = tv.build_factors(tf, torch.tensor(cp[1:]),
                                torch.tensor(coords), torch.tensor(nb),
                                torch.tensor(cp[0]), True)
    return (a_j, d_j), (a_t, d_t)


@pytest.mark.parametrize("name,shape,cp", [
    ("exponential", 0.0, [0.2, 1.1, 0.13]),
    ("matern", 1.5, [0.2, 1.1, 0.13]),
    ("matern", 2.5, [0.2, 1.1, 0.13]),
    ("gaussian", 0.0, [0.2, 1.1, 0.13]),
    ("matern_ard", 1.5, [0.2, 1.1, 0.13, 0.21]),
    ("gaussian_ard", 0.0, [0.2, 1.1, 0.13, 0.21]),
])
def test_build_factors_and_nll_fixture(gp_fixture_data, name, shape, cp):
    coords, y, nb = _fixture_problem(gp_fixture_data)
    cp = np.asarray(cp)
    (a_j, d_j), (a_t, d_t) = _both_factors(name, shape, cp, coords, nb)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-10)
    nll_j = float(jv.vecchia_nll(a_j, d_j, jnp.asarray(nb), jnp.asarray(y)))
    nll_t = float(tv.vecchia_nll(a_t, d_t, torch.tensor(nb), torch.tensor(y)))
    assert abs(nll_t - nll_j) < 1e-10


def test_build_factors_and_nll_n1500():
    coords, y, nb = _random_problem()
    cp = np.asarray([0.2, 1.1, 0.13])
    (a_j, d_j), (a_t, d_t) = _both_factors("exponential", 0.0, cp, coords, nb)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-10)
    nll_j = float(jv.vecchia_nll(a_j, d_j, jnp.asarray(nb), jnp.asarray(y)))
    nll_t = float(tv.vecchia_nll(a_t, d_t, torch.tensor(nb), torch.tensor(y)))
    assert abs(nll_t - nll_j) < 1e-10 * abs(nll_j)


def test_known_good_nll_anchor(gp_fixture_data):
    """Exponential-GP NLL 124.2549533 of the R-test LCG fixture: with
    num_neighbors = n - 1 and no reordering the Vecchia NLL is the exact
    one (the path ``tests/test_vecchia_golden.py`` anchors)."""
    coords = gp_fixture_data["coords"]
    y = gp_fixture_data["eps"] + gp_fixture_data["xi"]
    n = len(y)
    c = torch.tensor(coords)
    nb = tv.find_neighbors(c, n - 1)
    a, d = tv.build_factors(TCov.create("exponential"),
                            torch.tensor([1.6, 0.2]), c, nb,
                            torch.tensor(0.1), True)
    nll = float(tv.vecchia_nll(a, d, nb, torch.tensor(y)))
    assert abs(nll - 124.2549533) < 1e-6


@pytest.mark.parametrize("name,shape,cp", [
    ("exponential", 0.0, [0.2, 1.1, 0.13]),
    ("matern_ard", 2.5, [0.2, 1.1, 0.13, 0.21]),
])
def test_nll_gradient_matches_jax_grad(gp_fixture_data, name, shape, cp):
    coords, y, nb = _fixture_problem(gp_fixture_data, m=15)
    jf = JCov.create(name, shape=shape)
    tf = TCov.create(name, shape=shape)
    lp = np.log(np.asarray(cp))

    def nll_j(t):
        c = jnp.exp(t)
        a, d = jv.build_factors(jf, c[1:], jnp.asarray(coords),
                                jnp.asarray(nb), c[0], True)
        return jv.vecchia_nll(a, d, jnp.asarray(nb), jnp.asarray(y))

    v_j, g_j = jax.value_and_grad(nll_j)(jnp.asarray(lp))
    t = torch.tensor(lp, requires_grad=True)
    c = torch.exp(t)
    a, d = tv.build_factors(tf, c[1:], torch.tensor(coords), torch.tensor(nb),
                            c[0], True)
    v_t = tv.vecchia_nll(a, d, torch.tensor(nb), torch.tensor(y))
    (g_t,) = torch.autograd.grad(v_t, t)
    assert abs(float(v_t.detach()) - float(v_j)) < 1e-10
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-8)


def test_matvecs_and_prediction_match_jax(gp_fixture_data):
    coords, y, nb = _fixture_problem(gp_fixture_data, m=15)
    rng = np.random.default_rng(9)
    cp = np.asarray([0.2, 1.1, 0.13])
    (a_j, d_j), (a_t, d_t) = _both_factors("matern", 1.5, cp, coords, nb)
    v = rng.standard_normal(len(y))
    nb_j, nb_t = jnp.asarray(nb), torch.tensor(nb)
    for fj, ft in ((jv.apply_B, tv.apply_B), (jv.apply_Bt, tv.apply_Bt)):
        np.testing.assert_allclose(
            ft(a_t, nb_t, torch.tensor(v)).numpy(),
            np.asarray(fj(a_j, nb_j, jnp.asarray(v))), rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        tv.precision_matvec(a_t, nb_t, d_t, torch.tensor(v)).numpy(),
        np.asarray(jv.precision_matvec(a_j, nb_j, d_j, jnp.asarray(v))),
        rtol=0, atol=1e-9)
    pred = rng.uniform(size=(40, 2))
    nbp = np.asarray(jv.find_neighbors_cross(
        jnp.asarray(pred), jnp.asarray(coords), 12, method="exact"))
    for resp in (True, False):
        m_j, v_j = jv.predict_vecchia_response(
            JCov.create("matern", shape=1.5), jnp.asarray(cp[1:]),
            jnp.asarray(cp[0]), jnp.asarray(coords), jnp.asarray(pred),
            jnp.asarray(nbp), jnp.asarray(y), resp)
        m_t, v_t = tv.predict_vecchia_response(
            TCov.create("matern", shape=1.5), torch.tensor(cp[1:]),
            torch.tensor(cp[0]), torch.tensor(coords), torch.tensor(pred),
            torch.tensor(nbp), torch.tensor(y), resp)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("n,m", [(100, 30), (1500, 12)])
def test_incoming_structure_matches_jax(gp_fixture_data, n, m):
    """``build_incoming`` equals the JAX package's; the slices of
    ``build_incoming_sliced`` are its rows cut to their widths."""
    if n == 100:
        _, _, nb = _fixture_problem(gp_fixture_data, m=m)
    else:
        _, _, nb = _random_problem(n, m)
    want_row, want_slot = jv.build_incoming(nb)
    inc_row, inc_slot = tv.build_incoming(torch.tensor(nb))
    assert inc_row.dtype == inc_slot.dtype == torch.int32
    np.testing.assert_array_equal(inc_row.numpy(), want_row)
    np.testing.assert_array_equal(inc_slot.numpy(), want_slot)
    K = inc_row.shape[1]
    covered = np.zeros(n, bool)
    slices = tv.build_incoming_sliced(torch.tensor(nb))
    for targets, rows, slots in slices:
        w = rows.shape[1]
        assert w <= K
        np.testing.assert_array_equal(rows.numpy(), want_row[targets][:, :w])
        np.testing.assert_array_equal(slots.numpy(),
                                      want_slot[targets][:, :w])
        assert (want_row[targets][:, w:] == -1).all()
        covered[targets.numpy()] = True
    # every row that some row conditions on is in exactly one slice
    np.testing.assert_array_equal(covered, (want_row >= 0).any(1))
    assert sum(len(t) for t, _, _ in slices) == covered.sum()


def test_gather_transpose_matches_jax_apply_bt(gp_fixture_data):
    """``apply_Bt_gather`` (padded rows) and ``apply_Bt_sliced`` equal the
    JAX package's scatter ``apply_Bt`` at 1e-12 in float64; the gather
    precision product equals the plain one."""
    rng = np.random.default_rng(11)
    for coords, y, nb in (_fixture_problem(gp_fixture_data, m=15),
                          _random_problem(1500, 12)):
        cp = np.asarray([0.2, 1.1, 0.13])
        (a_j, d_j), (a_t, d_t) = _both_factors("exponential", 0.0, cp, coords,
                                               nb)
        v = rng.standard_normal(len(y))
        want = np.asarray(jv.apply_Bt(a_j, jnp.asarray(nb), jnp.asarray(v)))
        nb_t, v_t = torch.tensor(nb), torch.tensor(v)
        inc_row, inc_slot = tv.build_incoming(nb_t)
        assert bool((inc_row < 0).any())                  # padded rows
        got = tv.apply_Bt_gather(a_t, inc_row, inc_slot, v_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        slices = tv.build_incoming_sliced(nb_t)
        np.testing.assert_allclose(tv.apply_Bt_sliced(a_t, slices, v_t),
                                   want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            tv.precision_product(a_t, d_t, v_t, nb_t, slices).numpy(),
            tv.precision_matvec(a_t, nb_t, d_t, v_t).numpy(), rtol=0,
            atol=1e-12)
