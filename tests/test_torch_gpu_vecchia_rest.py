"""The rest of the Vecchia GP on the card: what the full-size run of
``chip_smoke.py`` (phase 11) does not hold at 1e-10. Needs an NVIDIA GPU;
skipped elsewhere. Run on the GPU machine with

    python -m pytest tests/test_torch_gpu_vecchia_rest.py --noconftest -q

At n = 2 000, float64, card vs CPU within 1e-10 relative (1e-8 for the
latent prediction types' CG to 1e-10):
- ``cluster_ids`` (20 clusters): NLL, gradient, prediction with an unseen
  cluster; GP random coefficients: NLL, gradient, prediction;
- the five prediction types (mean and full covariance);
- grouped effects beside the GP: the Cholesky NLL, gradient and Psi^-1 R,
  the iterative NLL with the same probes;
- the heteroscedastic and the latent model's NLLs.
Float32 with ``cluster_ids``: both Vecchia kernels against their plain
versions on the cluster-padded neighbour matrix, their counters above 0 in
a fit, two fits the same bits. Two GPBoost trainings with grouped effects
beside the GP the same bits. No ``index_add_`` / ``scatter_add_`` /
accumulating ``index_put_`` in the traced value-and-gradients of the
combined (both routes) and random-coefficient models.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

pytestmark = pytest.mark.gpu

N = 2_000
M = 20
CP = [0.25, 1.0, 0.1]
SCATTERS = ("index_add", "scatter_add", "index_put", "scatter_reduce",
            "indexFunc", "put_")
PRED_TYPES = ("order_obs_first_cond_obs_only", "order_obs_first_cond_all",
              "order_pred_first", "latent_order_obs_first_cond_obs_only",
              "latent_order_obs_first_cond_all")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2))
    x = rng.standard_normal(N)
    b = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    return dict(coords=coords, x=x, y=b + 0.5 * rng.standard_normal(N),
                ysvc=b + x * np.cos(4 * coords[:, 1])
                + 0.5 * rng.standard_normal(N),
                ids=np.repeat(np.arange(20), N // 20),
                group=rng.integers(0, 50, N),
                pred=rng.uniform(size=(100, 2)))


def _model(data, device, dtype=torch.float64, **kw):
    kw.setdefault("gp_approx", "vecchia")
    return gpt.GPModel(gp_coords=data["coords"], cov_function="exponential",
                       num_neighbors=M, device=device, dtype=dtype, **kw)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


def _vg(model, cp, y):
    th = torch.log(model._tensor(cp))
    v, g = model._approx._vg_gaussian(th, model._y_tensor(y), None)
    return float(v), g.cpu().numpy()


@pytest.mark.parametrize("case", ["cluster", "svc"])
def test_card_matches_cpu(dev, data, case):
    kw = (dict(cluster_ids=data["ids"]) if case == "cluster"
          else dict(gp_rand_coef_data=data["x"]))
    cp = CP if case == "cluster" else CP + [0.5, 0.2]
    y = data["y"] if case == "cluster" else data["ysvc"]
    pk = (dict(cluster_ids_pred=np.r_[data["ids"][:99], 99])
          if case == "cluster" else
          dict(gp_rand_coef_data_pred=data["x"][:100]))
    out = []
    for where in (dev, "cpu"):
        m = _model(data, where, **kw)
        v, g = _vg(m, cp, y)
        p = m.predict(y=y, gp_coords_pred=data["pred"], cov_pars=cp,
                      predict_var=True, **pk)
        out.append((v, g, p["mu"], p["var"]))
    for a, b in zip(*out):
        _close(a, b, 1e-10)


def test_prediction_types_card_matches_cpu(dev, data):
    out = {}
    for where in (dev, "cpu"):
        m = _model(data, where)
        for kind in PRED_TYPES:
            m.set_prediction_data(vecchia_pred_type=kind)
            out[(str(where), kind)] = m.predict(
                y=data["y"], gp_coords_pred=data["pred"], cov_pars=CP,
                predict_var=True, predict_cov_mat=True)
    for kind in PRED_TYPES:
        tol = 1e-8 if kind.startswith("latent") else 1e-10
        a, b = out[(str(dev), kind)], out[("cpu", kind)]
        _close(a["mu"], b["mu"], tol)
        _close(a["cov"], b["cov"], tol)


def test_combined_card_matches_cpu(dev, data):
    cp = [0.25, 0.3, 1.0, 0.1]
    R = np.random.default_rng(1).standard_normal((N, 3))
    out = []
    for where in (dev, "cpu"):
        m = _model(data, where, group_data=data["group"])
        v, g = _vg(m, cp, data["y"])
        pr = m._approx.psi_inv_mul(m._tensor(cp), m._tensor(R))
        it = _model(data, where, group_data=data["group"],
                    matrix_inversion_method="iterative")
        gen = np.random.default_rng(2)
        q = it._approx.q_total
        probes = (it._tensor(gen.standard_normal((q, 30))),
                  it._tensor(np.sign(gen.standard_normal((q, 30)))))
        vi = float(it._approx.nll_gaussian_iterative(
            it._tensor(cp), it._y_tensor(data["y"]), probes=probes))
        out.append((v, g, pr.cpu().numpy(), vi))
    for a, b in zip(*out):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("case", ["heteroscedastic", "vecchia_latent"])
def test_het_latent_card_matches_cpu(dev, data, case):
    k = 1_000
    sub = dict(data, coords=data["coords"][:k])
    kw = (dict(likelihood="gaussian_heteroscedastic")
          if case == "heteroscedastic" else dict(gp_approx="vecchia_latent"))
    cp = [1.0, 0.2, 0.5, 0.2] if case == "heteroscedastic" else [1.0, 0.2]
    aux = None if case == "heteroscedastic" else [0.3]
    vals = [_model(sub, where, **kw).neg_log_likelihood(
        cp, data["y"][:k], aux_pars=aux) for where in (dev, "cpu")]
    _close(vals[0], vals[1], 1e-10)


def test_kernels_on_cluster_padded_neighbours(dev, data):
    m = _model(data, dev, dtype=torch.float32, cluster_ids=data["ids"])
    vec = m._approx
    nb = vec.neighbors
    assert bool((nb < 0).any(1).float().mean() > 0.1)
    cp = torch.tensor(CP, dtype=torch.float32, device=dev)
    a_k, d_k = vk.vecchia_factors(cp[1:], vec.coords_perm, nb, cp[0], True,
                                  0.5)
    a_p, d_p = vk.vecchia_factors_plain(cp[1:], vec.coords_perm, nb, cp[0],
                                        True, 0.5)
    assert float((a_k - a_p).abs().max()) <= 2e-5
    assert float((d_k - d_p).abs().max()) <= 2e-5
    r = torch.as_tensor(data["y"], dtype=torch.float32,
                        device=dev)[vec._perm_t]
    v_k, g_k = vk.vecchia_nll_grad(torch.log(cp), vec.coords_perm, nb, r,
                                   0.5)
    v64, g64 = vk.vecchia_nll_grad_plain(
        torch.log(cp).double(), vec.coords_perm.double(), nb, r.double(),
        0.5)
    assert abs(float(v_k) - float(v64)) <= 1e-4 * abs(float(v64))
    assert float((g_k.double() - g64).abs().max()) <= 2e-2 * N / 1500 \
        + 1e-3 * float(g64.abs().max())


def test_clustered_fits_launch_kernels_and_repeat_bits(dev, data):
    fits = []
    for _ in range(2):
        vk.reset_launch_counts()
        m = _model(data, dev, dtype=torch.float32, cluster_ids=data["ids"])
        m.fit(data["y"], params={"optimizer_cov": "lbfgs"})
        counts = vk.launch_counts()
        assert counts["vecchia_nll_grad"] > 0 and counts["vecchia_factors"] > 0
        fits.append((m.get_cov_pars(), m.get_current_neg_log_likelihood()))
    assert np.array_equal(fits[0][0], fits[1][0]) and fits[0][1] == fits[1][1]


def test_combined_gpboost_repeats_bits(dev, data):
    X = np.random.default_rng(3).uniform(size=(N, 3))
    yb = data["y"] + 2 * np.sin(4 * X[:, 0])
    runs = []
    for _ in range(2):
        gp = _model(data, dev, group_data=data["group"])
        gp.set_optim_params({"optimizer_cov": "lbfgs",
                             "init_cov_pars": [0.25, 0.25, 1.0, 0.1]})
        bst = gpt.train({"objective": "regression", "num_leaves": 15,
                         "learning_rate": 0.1, "verbose": -1},
                        gpt.Dataset(X, label=yb, device=dev), gp_model=gp,
                        num_boost_round=3)
        runs.append((np.asarray(bst._score), gp.get_cov_pars()))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])


def test_no_scatter_in_traced_value_and_gradients(dev, data):
    from torch.profiler import ProfilerActivity, profile
    models = [(_model(data, dev, group_data=data["group"]),
               [0.25, 0.3, 1.0, 0.1]),
              (_model(data, dev, group_data=data["group"],
                      matrix_inversion_method="iterative"),
               [0.25, 0.3, 1.0, 0.1]),
              (_model(data, dev, gp_rand_coef_data=data["x"]),
               CP + [0.5, 0.2])]
    for m, cp in models:          # built structures (the dense Z) first
        _vg(m, cp, data["y"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for m, cp in models:
            _vg(m, cp, data["y"])
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert not [x for x in names if any(b in x for b in SCATTERS)], names
