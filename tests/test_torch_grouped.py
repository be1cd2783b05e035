"""Grouped random effects by Woodbury, the port against the JAX package
(``gpboost_tpu_torch/models/grouped.py`` vs ``gpboost_tpu/models/
grouped.py``; mirrors ``tests/test_grouped_woodbury.py``). CPU, float64,
n = 500 rows, two crossed grouping variables (20 and 7 levels) and a random
slope; the same numpy-seeded inputs go through both packages.

Both routes of the port are held to the JAX package: the plain one
(``index_add_``, what a CPU model runs) and the one a CUDA model runs
(:class:`SegmentPlan` sums in a fixed order), built here on the CPU.

Tolerances: the ops (Z' v, Z b, Z'Z, Z'WZ), the NLLs and their gradients
1e-10 relative; the Woodbury NLL against the JAX package's dense
``gaussian.neg_log_likelihood`` and a numpy dense computation 1e-8; the
q-space Fisher information against JAX's dense one 1e-8 relative;
prediction mean, variance and covariance (unseen levels included) 1e-10.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax
import jax.numpy as jnp
from gpboost_tpu.models import gaussian as jgauss
from gpboost_tpu.ops import cg as jcg
from gpboost_tpu.models import grouped as jg
from gpboost_tpu_torch.models import grouped as tg
from gpboost_tpu_torch.models import spec as tspec

ROUTES = ["index_add", "plan"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once, and PyTorch's default of a thread a core in
    each makes its small CPU ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def d():
    """The data of ``tests/test_grouped_woodbury.py::grouped_data``."""
    rng = np.random.default_rng(7)
    n, m = 500, 20
    groups = rng.integers(0, m, size=n)
    groups2 = rng.integers(0, 7, size=n)
    x_slope = rng.uniform(-1, 1, size=n)
    b1 = 0.8 * rng.standard_normal(m)
    b2 = 0.5 * rng.standard_normal(7)
    b3 = 0.4 * rng.standard_normal(m)
    y = b1[groups] + b2[groups2] + x_slope * b3[groups] \
        + 0.3 * rng.standard_normal(n)
    return dict(n=n, groups=groups, groups2=groups2, x_slope=x_slope, y=y,
                w=rng.uniform(0.2, 2.0, size=n),
                v=rng.standard_normal(n), V=rng.standard_normal((n, 3)))


def _kw(d):
    return dict(group_data=np.column_stack([d["groups"], d["groups2"]]),
                group_rand_coef_data=d["x_slope"],
                ind_effect_group_rand_coef=[1])


@pytest.fixture(scope="module")
def models(d):
    jm = gpb.GPModel(**_kw(d))
    tm = gpt.GPModel(device="cpu", **_kw(d))
    jd = jm._with_y(d["y"])
    return jm, tm, jd


def _Z(tm, route):
    if route == "index_add":
        assert not tm._Z.deterministic
        return tm._Z
    return tg.GroupedZ(tm.spec, tm.data, deterministic=True)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _close(got, want, rtol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= rtol * scale, (
        np.max(np.abs(got - want)) / scale)


def _dense_nll(groups, groups2, x_slope, y, cov_pars):
    """The numpy dense computation of ``test_grouped_woodbury.py``."""
    n = len(y)
    s2, v1, v2, v3 = cov_pars
    Z1 = (groups[:, None] == np.arange(groups.max() + 1)[None, :]).astype(
        float)
    Z2 = (groups2[:, None] == np.arange(groups2.max() + 1)[None, :]).astype(
        float)
    Z3 = Z1 * x_slope[:, None]
    psi = (s2 * np.eye(n) + v1 * Z1 @ Z1.T + v2 * Z2 @ Z2.T
           + v3 * Z3 @ Z3.T)
    L = np.linalg.cholesky(psi)
    al = np.linalg.solve(L, y)
    return 0.5 * (al @ al + 2 * np.log(np.diag(L)).sum()
                  + n * np.log(2 * np.pi))


def test_model_data_matches_jax(models):
    jm, tm, jd = models
    assert tm.spec.components == tuple(
        tspec.GroupedRESpec(**vars(c)) for c in jm.spec.components)
    np.testing.assert_array_equal(tm.data.group_codes.numpy(),
                                  np.asarray(jd.group_codes))
    for a, b in zip(tm._group_maps, jm._group_maps):
        np.testing.assert_array_equal(a, b)
    assert tg.grouped_layout(tm.spec) == jg.grouped_layout(jm.spec)
    assert tm._cov_par_names() == jm._cov_par_names() == [
        "Error_term", "Group_1", "Group_2", "Group_3_rand_coef"]
    assert tm.num_cov_pars == 4


def test_labels_are_coded_as_strings_like_jax():
    labels = np.array(["b", "10", "2", "a", "10", "b"])
    comps, data, info = tspec.make_model_data(labels)
    jcomps, jdata, jinfo = __import__(
        "gpboost_tpu.models.spec", fromlist=["x"]).make_model_data(
            group_data=labels)
    np.testing.assert_array_equal(data.group_codes.numpy()[:, 0],
                                  np.asarray(jdata.group_codes)[:, 0])
    np.testing.assert_array_equal(info["group_maps"][0],
                                  jinfo["group_maps"][0])


def test_drop_intercept_keeps_the_slope(d):
    kw = dict(_kw(d), drop_intercept_group_rand_effect=[True, False])
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    assert [(c.num_groups, c.is_slope, c.code_col)
            for c in tm.spec.components] == [
        (c.num_groups, c.is_slope, c.code_col) for c in jm.spec.components]
    assert tm._cov_par_names() == ["Error_term", "Group_1",
                                   "Group_2_rand_coef"]
    cp = [0.1, 0.3, 0.2]
    assert tm.neg_log_likelihood(cp, d["y"]) == pytest.approx(
        jm.neg_log_likelihood(cp, d["y"]), rel=1e-10)
    with pytest.raises(ValueError, match="Cannot drop intercept"):
        gpt.GPModel(device="cpu", **dict(
            _kw(d), drop_intercept_group_rand_effect=[False, True]))


@pytest.mark.parametrize("route", ROUTES)
def test_ops_match_jax(models, d, route):
    jm, tm, jd = models
    Z = _Z(tm, route)
    q = Z.q
    b = np.random.default_rng(1).standard_normal(q)
    _close(tg.zt_mul(Z, _t(d["v"])), jg.zt_mul(jm.spec, jd, d["v"]), 1e-10)
    _close(tg.z_mul(Z, _t(b)), jg.z_mul(jm.spec, jd, b), 1e-10)
    _close(tg.ztz_matrix(Z), jg.ztz_matrix(jm.spec, jd), 1e-10)
    _close(tg.ztw_z(Z, _t(d["w"])), jg.ztw_z(jm.spec, jd, d["w"]), 1e-10)
    # several right-hand sides at once: column by column
    got = tg.zt_mul(Z, _t(d["V"])).numpy()
    for k in range(3):
        _close(got[:, k], jg.zt_mul(jm.spec, jd, d["V"][:, k]), 1e-10)


def test_segment_plan_on_skewed_keys():
    """Zipf-skewed run lengths (one key holds a quarter of the entries),
    keys that never occur, [E] and [E, k] values: the plan's sums equal
    index_add_'s, and padding stays below the entries."""
    rng = np.random.default_rng(3)
    E, K = 5000, 400
    p = 1.0 / np.arange(1, K + 1) ** 1.1
    p[K // 2:] = 0.0                  # keys K/2.. never occur
    keys = rng.choice(K, size=E, p=p / p.sum())
    rows = rng.integers(0, 700, size=E)
    coef = rng.standard_normal(E)
    v = rng.standard_normal(700)
    V = rng.standard_normal((700, 4))
    plan = tg.SegmentPlan(torch.as_tensor(keys), torch.as_tensor(rows),
                          torch.as_tensor(coef), K)
    want = np.zeros(K)
    np.add.at(want, keys, coef * v[rows])
    np.testing.assert_allclose(plan.sums(_t(v)).numpy(), want, rtol=1e-12,
                               atol=1e-12)
    wantV = np.zeros((K, 4))
    np.add.at(wantV, keys, coef[:, None] * V[rows])
    np.testing.assert_allclose(plan.sums(_t(V)).numpy(), wantV, rtol=1e-12,
                               atol=1e-12)
    assert plan.rows.numel() < 2 * E + 8 * K
    assert sorted(np.asarray(plan.targets)) == sorted(np.unique(keys))
    # the same bits on every call
    assert torch.equal(plan.sums(_t(v)), plan.sums(_t(v)))


@pytest.mark.parametrize("route", ROUTES)
def test_backwards_are_the_transposes(models, d, route):
    """Z b's backward is Z' g and Z' v's is Z g, Z'WZ's a gather of G:
    ``gradcheck`` in float64."""
    _, tm, _ = models
    Z = _Z(tm, route)
    b = torch.randn(Z.q, dtype=torch.float64, requires_grad=True)
    v = torch.randn(Z.n, dtype=torch.float64, requires_grad=True)
    w = torch.rand(Z.n, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: tg.z_mul(Z, x), (b,))
    assert torch.autograd.gradcheck(lambda x: tg.zt_mul(Z, x), (v,))
    G = torch.randn(Z.q, Z.q, dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda x: (tg.ztw_z(Z, x) * G).sum(),
                                    (w,))


def test_logdet_quad_gradcheck():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((6, 6))
    base = torch.as_tensor(A @ A.T + np.eye(6), dtype=torch.float64
                           ).requires_grad_(True)
    dg = torch.as_tensor(rng.uniform(0.5, 2, 6)).requires_grad_(True)
    v = torch.as_tensor(rng.standard_normal(6)).requires_grad_(True)

    def f(b, dd, vv):
        bs = 0.5 * (b + b.T)
        ld, qd = tg.logdet_quad(bs, dd, vv)
        return ld + 0.3 * qd

    assert torch.autograd.gradcheck(f, (base, dg, v))
    M = (0.5 * (base + base.T) + torch.diag(dg)).detach()
    ld, qd = tg.logdet_quad(M, torch.zeros(6, dtype=torch.float64),
                            v.detach())
    assert float(ld) == pytest.approx(float(torch.logdet(M)), rel=1e-12)
    assert float(qd) == pytest.approx(
        float(v.detach() @ torch.linalg.solve(M, v.detach())), rel=1e-12)
    # not positive definite: NaN, no exception
    bad, _ = tg.logdet_quad(-M, torch.zeros(6, dtype=torch.float64))
    assert torch.isnan(bad)


def test_woodbury_nll_matches_dense(models, d):
    jm, tm, jd = models
    cov_pars = [0.1, 0.6, 0.3, 0.2]
    nll = tm.neg_log_likelihood(cov_pars=cov_pars, y=d["y"])
    ref = _dense_nll(d["groups"], d["groups2"], d["x_slope"], d["y"],
                     cov_pars)
    dense_jax = float(jgauss.neg_log_likelihood(
        jm.spec, jd, jnp.asarray(cov_pars)))
    assert abs(nll - ref) < 1e-8
    assert abs(nll - dense_jax) < 1e-8


@pytest.mark.parametrize("route", ROUTES)
def test_nlls_and_gradients_match_jax(models, d, route):
    jm, tm, jd = models
    Z = _Z(tm, route)
    cp = np.array([0.1, 0.6, 0.3, 0.2])
    r = _t(d["y"] - 0.2)
    fe = jnp.full(d["n"], 0.2)
    _close(tg.nll_gaussian(Z, _t(cp), r),
           jg.nll_gaussian(jm.spec, jd, jnp.asarray(cp), None, fe), 1e-10)
    th = np.log(cp[1:] / cp[0])
    v, g, s2 = tg.nll_profiled_value_and_grad(Z, _t(th), r)
    jv, jgr, js2 = jg.nll_profiled_value_and_grad(
        jm.spec, jd, jnp.asarray(th), None, fe)
    _close(v, jv, 1e-10)
    _close(g, jgr, 1e-10)
    _close(s2, js2, 1e-10)
    # the autograd gradient of the Function-based NLL against finite
    # differences of the value
    eps = 1e-6
    for k in range(3):
        tp, tn = th.copy(), th.copy()
        tp[k] += eps
        tn[k] -= eps
        fd = (float(tg.nll_profiled(Z, _t(np.exp(tp)), r)[0])
              - float(tg.nll_profiled(Z, _t(np.exp(tn)), r)[0])) / (2 * eps)
        assert float(g[k]) == pytest.approx(fd, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("route", ROUTES)
def test_psi_inv_mul_and_posterior_match_jax(models, d, route):
    jm, tm, jd = models
    Z = _Z(tm, route)
    cp = np.array([0.1, 0.6, 0.3, 0.2])
    _close(tg.psi_inv_mul(Z, _t(cp), _t(d["v"])),
           jg.psi_inv_mul(jm.spec, jd, jnp.asarray(cp), d["v"]), 1e-10)
    _close(tg.psi_inv_mul(Z, _t(cp), _t(d["V"])),
           jg.psi_inv_mul(jm.spec, jd, jnp.asarray(cp), d["V"]), 1e-10)
    mean, post = tg.posterior_b_gaussian(Z, _t(cp), _t(d["y"]))
    jmean, jpost = jg.posterior_b_gaussian(jm.spec, jd, jnp.asarray(cp),
                                           d["y"])
    _close(mean, jmean, 1e-10)
    _close(post, jpost, 1e-10)


@pytest.mark.parametrize("cov_pars", [[0.1, 0.6, 0.3, 0.2],
                                      [0.09, 0.5, 0.25, 0.15]])
def test_q_space_fisher_information_matches_jax_dense(models, cov_pars):
    jm, tm, jd = models
    fi = tg.fisher_information(tm._Z, _t(cov_pars))
    want = jgauss.fisher_information(jm.spec, jd,
                                     jnp.log(jnp.asarray(cov_pars)))
    _close(fi, want, 1e-8)
    fi_plan = tg.fisher_information(_Z(tm, "plan"), _t(cov_pars))
    _close(fi_plan, want, 1e-8)


def _pred_inputs(d):
    gp = np.column_stack([
        np.r_[d["groups"][:6], 99, 99, 100, 3],
        np.r_[d["groups2"][:6], 3, 55, 55, 77]])
    xs = np.r_[d["x_slope"][:6], 0.3, -0.2, 0.5, 0.7]
    return gp, xs


@pytest.mark.parametrize("response", [False, True])
def test_prediction_matches_jax_with_unseen_levels(models, d, response):
    """Mean and variance with a slope; rows 6-9 carry unseen levels in
    either column (a pair of equal unseen labels in each)."""
    jm, tm, _ = models
    cp = [0.1, 0.6, 0.3, 0.2]
    for m in (jm, tm):
        m.cov_pars_ = np.asarray(cp)
    gp, xs = _pred_inputs(d)
    kw = dict(y=d["y"], group_data_pred=gp, group_rand_coef_data_pred=xs,
              predict_var=True, predict_response=response)
    pj, pt = jm.predict(**kw), tm.predict(**kw)
    np.testing.assert_allclose(pt["mu"], pj["mu"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(pt["var"], pj["var"], rtol=0, atol=1e-10)
    assert pt["cov"] is None
    # an unseen level in both columns: mean 0, prior variances
    assert pt["mu"][7] == 0.0
    prior = 0.6 + 0.3 + 0.2 * xs[7] ** 2 + (0.1 if response else 0.0)
    assert pt["var"][7] == pytest.approx(prior, rel=1e-12)


@pytest.mark.parametrize("response", [False, True])
def test_prediction_covariance_matches_jax(d, response):
    """The full covariance (``predict_cov_mat``) of two crossed
    intercepts, unseen labels shared by some rows."""
    kw = dict(group_data=np.column_stack([d["groups"], d["groups2"]]))
    jm = gpb.GPModel(**kw)
    tm = gpt.GPModel(device="cpu", **kw)
    cp = [0.1, 0.6, 0.3]
    gp, _ = _pred_inputs(d)
    args = dict(y=d["y"], group_data_pred=gp, cov_pars=cp,
                predict_cov_mat=True, predict_response=response)
    pj, pt = jm.predict(**args), tm.predict(**args)
    for key in ("mu", "var", "cov"):
        np.testing.assert_allclose(pt[key], pj[key], rtol=0, atol=1e-10,
                                   err_msg=key)
    assert pt["cov"][7, 8] == pytest.approx(0.3, rel=1e-12)  # label 55


def test_woodbury_fit_and_predict_consistency(d):
    """As the JAX package's test: the posterior of b by brute force."""
    m = gpt.GPModel(group_data=d["groups"], device="cpu")
    m.fit(y=d["y"], params={"optimizer_cov": "lbfgs"})
    pred = m.predict(y=d["y"], group_data_pred=d["groups"][:10],
                     predict_var=True, predict_response=False)
    s2, v1 = m.get_cov_pars()
    mlev = d["groups"].max() + 1
    Z1 = (d["groups"][:, None] == np.arange(mlev)[None, :]).astype(float)
    M = Z1.T @ Z1 + (s2 / v1) * np.eye(mlev)
    b_post = np.linalg.solve(M, Z1.T @ d["y"])
    postcov = s2 * np.linalg.inv(M)
    np.testing.assert_allclose(pred["mu"], b_post[d["groups"][:10]],
                               atol=1e-10)
    np.testing.assert_allclose(
        pred["var"], np.diag(postcov)[d["groups"][:10]], atol=1e-10)


# ---------------------------------------------------------------------------
# what stays raising, each naming its ROADMAP.md item, and what the exact
# route made work (held to the JAX package's dense route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,item", [
    (dict(matrix_inversion_method="iterative"), "iterative"),
    (dict(weights=np.ones(500)), "item 11"),
    (dict(cluster_ids=np.zeros(500)), None),
    (dict(gp_coords=np.zeros((500, 2)), gp_approx="vecchia"), "vecchia"),
], ids=["iterative", "weights", "cluster_ids", "with_gp"])
def test_unported_grouped_structures_raise(d, kwargs, item):
    """The unported structures raise naming their item. ``cluster_ids``
    beside grouped effects is ported (the dense route with the
    block-diagonal mask, as in the JAX package): two clusters here, its NLL
    the JAX package's within 1e-10 relative. So is the iterative route
    (item 12): the public NLL is the Cholesky one, as in the JAX package
    (1e-10), and the profiled iterative value-and-gradient with the JAX
    package's probes equals its own at 1e-5
    (``tests/test_torch_grouped_iterative.py`` holds the route). So is a
    Vecchia GP beside grouped effects (ROADMAP.md item 15,
    ``models/vecchia_combined.py``): on the JAX package's neighbour
    structure (every point at one location, so the searches tie) its NLL
    is the JAX package's within 1e-10 relative. So are observation weights
    (item 11): the weighted NLL within 1e-10 relative."""
    if item == "vecchia":
        tm = gpt.GPModel(group_data=d["groups"], device="cpu", **kwargs)
        jm = gpb.GPModel(group_data=d["groups"], **kwargs)
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
        cp = [0.2, 0.6, 0.5, 0.1]
        nll_j = jm.neg_log_likelihood(cp, d["y"])
        assert abs(tm.neg_log_likelihood(cp, d["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    if item == "iterative":
        groups = np.column_stack([d["groups"], d["groups2"]])
        tm = gpt.GPModel(group_data=groups, device="cpu", **kwargs)
        jm = gpb.GPModel(group_data=groups, **kwargs)
        cp = [0.2, 0.6, 0.3]
        nll_j = jm.neg_log_likelihood(cp, d["y"])
        assert abs(tm.neg_log_likelihood(cp, d["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        th = np.log([3.0, 1.5])
        vj, gj, _ = jg.nll_profiled_iterative_value_and_grad(
            jm.spec, jm._with_y(d["y"]), jnp.asarray(th), None, None, 30, 20)
        k1, k2 = jax.random.split(jax.random.PRNGKey(1))
        q = tm._Z.q
        probes = (torch.tensor(np.asarray(jax.random.normal(
            k1, (q, 30), jnp.float64))), torch.tensor(np.asarray(
                jcg.rademacher_probes(k2, q, 30, jnp.float64))))
        vt, gt, _ = tg.nll_profiled_iterative_value_and_grad(
            tm._Z, torch.tensor(th), torch.tensor(d["y"]), lanczos_steps=20,
            probes=probes)
        assert abs(float(vt) - float(vj)) < 1e-5 * abs(float(vj))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
        return
    if item == "item 11":
        # observation weights are ported (ROADMAP.md item 11): the weighted
        # Woodbury NLL is the JAX package's within 1e-10 relative
        w = d["w"]
        tm = gpt.GPModel(group_data=d["groups"], weights=w, device="cpu")
        jm = gpb.GPModel(group_data=d["groups"], weights=w)
        cp = [0.2, 0.6]
        nll_j = jm.neg_log_likelihood(cp, d["y"])
        assert abs(tm.neg_log_likelihood(cp, d["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    if item is None:
        cid = np.where(np.arange(500) < 200, 3, 9)
        tm = gpt.GPModel(group_data=d["groups"], cluster_ids=cid,
                         device="cpu")
        jm = gpb.GPModel(group_data=d["groups"], cluster_ids=cid)
        assert tm._exact and not tm._grouped_only
        cp = [0.2, 0.6]
        nll_j = jm.neg_log_likelihood(cp, d["y"])
        assert abs(tm.neg_log_likelihood(cp, d["y"]) - nll_j) \
            < 1e-10 * abs(nll_j)
        return
    with pytest.raises(NotImplementedError, match=item):
        gpt.GPModel(group_data=d["groups"], device="cpu", **kwargs)


@pytest.mark.parametrize("params,item", [
    ({"optimizer_cov": "fisher_scoring"}, "item 16"),
    ({"optimizer_cov": "newton"}, "item 16"),
    ({"estimate_cov_par_index": [1, 0]}, "item 16"),
], ids=["fisher_scoring", "newton", "held_parameter"])
def test_unported_grouped_fits_raise(d, params, item):
    """Ported since the exact route: Fisher scoring (the q-space Fisher
    information), Newton (the Hessian of the q-space NLL) and a held
    parameter (L-BFGS on the free ones) on a grouped model, without an
    [n, n] matrix, reach the JAX package's dense route (n = 500, with X):
    cov_pars, coefficients and the NLL within 1e-6 relative. ``item`` is
    the ROADMAP item these fits were queued under."""
    X = np.column_stack([np.ones(500), d["x_slope"]])
    init = {"init_cov_pars": [0.2, 0.5]}
    m = gpt.GPModel(group_data=d["groups"], device="cpu")
    m.fit(y=d["y"], X=X, params=dict(params, **init))
    jm = gpb.GPModel(group_data=d["groups"])
    jm.fit(y=d["y"], X=X, params=dict(params, **init))
    assert m._grouped_only and item == "item 16"
    np.testing.assert_allclose(m.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(m.get_coef(), jm.get_coef(), rtol=1e-6)
    nll_j = jm.get_current_neg_log_likelihood()
    assert abs(m.get_current_neg_log_likelihood() - nll_j) \
        < 1e-6 * abs(nll_j)
    if "estimate_cov_par_index" in params:
        assert m.get_cov_pars()[1] == 0.5


def test_grouped_lagaboost_and_mesh_raise(d):
    """LaGaBoost with grouped effects is ported: one round of
    ``train({"objective": "binary"}, ..., gp_model=grouped)`` runs, and its
    gradient d NLL / dF in b-space (no [n, n]) is the JAX package's dense
    ``laplace.gradient_wrt_F`` within 1e-8 relative. Row sharding still
    raises naming item 20."""
    from gpboost_tpu.models import laplace as jl
    yb = (d["y"] > 0).astype(float)
    gp = gpt.GPModel(group_data=d["groups"], likelihood="bernoulli_logit",
                     device="cpu")
    ds = gpt.Dataset(np.column_stack([d["x_slope"], d["v"]]), label=yb,
                     device="cpu")
    bst = gpt.train({"objective": "binary", "verbose": -1}, ds, gp_model=gp,
                    num_boost_round=1)
    assert len(bst.trees) == 1 and np.isfinite(gp.get_cov_pars()).all()
    score = 0.3 * d["v"]
    g = gp._grad_F_laplace(yb, score).numpy()
    jm = gpb.GPModel(group_data=d["groups"], likelihood="bernoulli_logit")
    gj = np.asarray(jl.gradient_wrt_F(
        jm.spec, jm._with_y(yb), jnp.asarray(gp.get_cov_pars()), None,
        jnp.asarray(score)))
    np.testing.assert_allclose(g, gj, rtol=1e-8, atol=1e-12)
    with pytest.raises(NotImplementedError, match="item 20"):
        gp.use_mesh(None)


def test_iid_model_needs_num_data():
    with pytest.raises(ValueError, match="num_data"):
        gpt.GPModel(likelihood="gaussian", device="cpu")


def test_vecchia_training_data_random_effects_raise(d):
    """Ported since this case pinned the raise (items 15 and 17): a
    Vecchia model's training-data effects are the latent prediction at its
    coordinates, the JAX package's at 1e-8 relative on the same ordering
    and neighbours (``tests/test_torch_training_effects.py`` holds the
    other approximations); an unfitted model raises."""
    coords = np.random.default_rng(0).uniform(size=(50, 2))
    kw = dict(gp_coords=coords, gp_approx="vecchia", num_neighbors=5)
    m, jm = gpt.GPModel(device="cpu", **kw), gpb.GPModel(**kw)
    m._approx.load_structure(np.asarray(jm._approx.perm),
                             np.asarray(jm._approx.neighbors))
    with pytest.raises(ValueError, match="fit"):
        m.predict_training_data_random_effects()
    y = d["y"][:50]
    m.y, jm.data = m._y_tensor(y), jm._with_y(y)
    m.cov_pars_ = jm.cov_pars_ = np.array([0.2, 1.0, 0.3])
    got = m.predict_training_data_random_effects(predict_var=True)
    want = np.asarray(jm.predict_training_data_random_effects(
        predict_var=True))
    assert np.all(np.max(np.abs(got - want), 0)
                  < 1e-8 * np.max(np.abs(want), 0))
