"""Grouped random effects with ``matrix_inversion_method="iterative"``
(``models/grouped.py``: CG and stochastic Lanczos in b-space, Newton-CG
mode with an implicit backward, posterior draws for simulated variances)
against the JAX package, float64 on the CPU — the counterpart of
``tests/test_iterative.py``'s ``TestGroupedIterative``,
``TestGroupedIterativePrediction`` and ``test_get_num_cg_steps``, and of
the grouped cases of ``tests/test_preconditioners.py``.

With the JAX package's probes rebuilt (``jax.random.split(PRNGKey(seed))``:
normal value probes from the first key, Rademacher gradient probes from the
second) the profiled Gaussian and the Laplace NLL and their gradients equal
the JAX package's at 1e-5. With the port's own probes, the JAX tests' tiers
against the Cholesky route: the Gaussian fit rtol 0.1 / atol 0.02, the
Laplace fit rtol 0.15 / atol 0.03, the NLLs within 0.5, the predictions'
means 1e-5 (Gaussian) / 2 % (Laplace) and variances 12 % / 15 %.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import gpboost_tpu as gpb
from gpboost_tpu.models import grouped as jg
from gpboost_tpu.ops import cg as jcg

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import grouped as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, STEPS = 40, 30


def _crossed_data(seed=0, n=500, q1=40, q2=25):
    rng = np.random.default_rng(seed)
    g1, g2 = rng.integers(0, q1, size=n), rng.integers(0, q2, size=n)
    y = (0.8 * rng.standard_normal(q1)[g1] + 0.5 * rng.standard_normal(q2)[g2]
         + 0.6 * rng.standard_normal(n))
    return np.column_stack([g1, g2]), y


def _poisson_data(seed=3, n=400, q1=30, q2=20):
    rng = np.random.default_rng(seed)
    g1, g2 = rng.integers(0, q1, size=n), rng.integers(0, q2, size=n)
    lam = np.exp(0.5 * rng.standard_normal(q1)[g1]
                 + 0.3 * rng.standard_normal(q2)[g2])
    return np.column_stack([g1, g2]), rng.poisson(lam).astype(float)


def _jax_probes(q, k, seed=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (torch.tensor(np.asarray(jax.random.normal(k1, (q, k),
                                                      jnp.float64))),
            torch.tensor(np.asarray(jcg.rademacher_probes(k2, q, k,
                                                          jnp.float64))))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def test_profiled_nll_and_gradient_match_jax_with_its_probes():
    group, y = _crossed_data()
    jm = gpb.GPModel(group_data=group)
    tm = gpt.GPModel(group_data=group, device="cpu")
    th = np.log([0.9, 0.4])
    vj, gj, s2j = jg.nll_profiled_iterative_value_and_grad(
        jm.spec, jm._with_y(y), jnp.asarray(th), None, None, K, STEPS)
    vt, gt, s2t = tg.nll_profiled_iterative_value_and_grad(
        tm._Z, torch.tensor(th), torch.tensor(y),
        probes=_jax_probes(tm._Z.q, K), lanczos_steps=STEPS)
    assert abs(float(vt) - float(vj)) < 1e-5 * abs(float(vj))
    assert abs(float(s2t) - float(s2j)) < 1e-10
    assert _rel(gt.numpy(), gj) < 1e-5
    # the fixed-order plans of the card's route give the same on the CPU
    Zd = tg.GroupedZ(tm.spec, tm.data, deterministic=True)
    vd, gd, _ = tg.nll_profiled_iterative_value_and_grad(
        Zd, torch.tensor(th), torch.tensor(y),
        probes=_jax_probes(tm._Z.q, K), lanczos_steps=STEPS)
    assert abs(float(vd) - float(vt)) < 1e-12 * abs(float(vt))
    assert _rel(gd.numpy(), gt.numpy()) < 1e-10


def test_laplace_nll_and_gradient_match_jax_with_its_probes():
    group, y = _poisson_data()
    jm = gpb.GPModel(group_data=group, likelihood="poisson")
    tm = gpt.GPModel(group_data=group, likelihood="poisson", device="cpu")
    cov = np.array([0.4, 0.2])
    data = jm._with_y(y)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda c: jg.nll_laplace_iterative(jm.spec, data, c, None, None, None,
                                           K, STEPS)))(jnp.asarray(cov))
    c = torch.tensor(cov, requires_grad=True)
    vt = tg.nll_laplace_iterative(tm._Z, "poisson", c, None, torch.tensor(y),
                                  None, lanczos_steps=STEPS,
                                  probes=_jax_probes(tm._Z.q, K))
    (gt,) = torch.autograd.grad(vt, c)
    assert abs(float(vt.detach()) - float(vj)) < 1e-5 * abs(float(vj))
    assert _rel(gt.numpy(), gj) < 1e-5
    # and the b-space mode finders agree: Newton-CG with the Cholesky one
    b_cg = tg.find_mode_grouped_cg("poisson", tm._Z, tg._sigma_b_diag(
        tm._Z, torch.tensor(cov)), torch.zeros(len(y), dtype=torch.float64),
        None, torch.tensor(y))
    b_ch = tg.find_mode_grouped("poisson", tm._Z, tg._sigma_b_diag(
        tm._Z, torch.tensor(cov)), torch.zeros(len(y), dtype=torch.float64),
        None, torch.tensor(y))
    assert _rel(b_cg.numpy(), b_ch.numpy()) < 1e-6


def test_nlls_and_gradients_close_to_cholesky():
    """The JAX tests' tiers with the port's own probes (400, 60 Lanczos
    steps): the profiled Gaussian NLL within 0.5 (sigma2 exact to 1e-6),
    its gradient atol 0.05 / rtol 0.1; the Laplace NLL within 0.5, its
    gradient atol 0.5 / rtol 0.15."""
    group, y = _crossed_data()
    tm = gpt.GPModel(group_data=group, device="cpu")
    th, r = torch.log(torch.tensor([0.9, 0.4], dtype=torch.float64)), \
        torch.tensor(y)
    v_ex, g_ex, s2_ex = tg.nll_profiled_value_and_grad(tm._Z, th, r)
    v_it, g_it, s2_it = tg.nll_profiled_iterative_value_and_grad(
        tm._Z, th, r, num_rand_vec_trace=400, lanczos_steps=60)
    assert abs(float(s2_it) - float(s2_ex)) < 1e-6
    assert abs(float(v_it) - float(v_ex)) < 0.5
    np.testing.assert_allclose(g_it.numpy(), g_ex.numpy(), atol=0.05,
                               rtol=0.1)
    group, y = _poisson_data()
    tm = gpt.GPModel(group_data=group, likelihood="poisson", device="cpu")
    yt = torch.tensor(y)
    v_ex, g_ex, _ = tg.nll_laplace_value_and_grad(
        tm._Z, "poisson", torch.tensor([0.4, 0.2]).double(), None, yt)
    v_it, g_it, _ = tg.nll_laplace_iterative_value_and_grad(
        tm._Z, "poisson", torch.tensor([0.4, 0.2]).double(), None, yt,
        num_rand_vec_trace=400, lanczos_steps=60)
    assert abs(float(v_it) - float(v_ex)) < 0.5
    np.testing.assert_allclose(g_it.numpy(), g_ex.numpy(), atol=0.5,
                               rtol=0.15)


def test_gaussian_fits_match_cholesky():
    """``GPModel(group_data=..., matrix_inversion_method="iterative")``: the
    profiled fit (gradient descent, the default) and its GLS coefficients
    against the Cholesky route at the JAX tests' tiers."""
    group, y = _crossed_data(seed=1)
    m_ex = gpt.GPModel(group_data=group, device="cpu")
    m_ex.fit(y=y)
    m_it = gpt.GPModel(group_data=group, matrix_inversion_method="iterative",
                       device="cpu")
    m_it.fit(y=y, params={"num_rand_vec_trace": 500})
    np.testing.assert_allclose(m_it.get_cov_pars(), m_ex.get_cov_pars(),
                               rtol=0.1, atol=0.02)
    assert np.isfinite(m_it.get_current_neg_log_likelihood())
    rng = np.random.default_rng(2)
    group, eps = _crossed_data(seed=2)
    X = np.column_stack([np.ones(len(eps)), rng.uniform(size=len(eps))])
    y = X @ np.array([2.0, -1.5]) + eps
    m_ex = gpt.GPModel(group_data=group, device="cpu")
    m_ex.fit(y=y, X=X)
    m_it = gpt.GPModel(group_data=group, matrix_inversion_method="iterative",
                       device="cpu")
    m_it.fit(y=y, X=X, params={"num_rand_vec_trace": 500,
                               "optimizer_cov": "lbfgs"})
    np.testing.assert_allclose(m_it.get_coef(), m_ex.get_coef(), atol=0.05)
    np.testing.assert_allclose(m_it.get_cov_pars(), m_ex.get_cov_pars(),
                               rtol=0.1, atol=0.02)


def test_laplace_fit_matches_cholesky():
    rng = np.random.default_rng(4)
    n, q = 400, 40
    g = rng.integers(0, q, size=n)
    y = rng.poisson(np.exp(0.6 * rng.standard_normal(q)[g] - 0.2)
                    ).astype(float)
    m_ex = gpt.GPModel(group_data=g, likelihood="poisson", device="cpu")
    m_ex.fit(y=y)
    m_it = gpt.GPModel(group_data=g, likelihood="poisson",
                       matrix_inversion_method="iterative", device="cpu")
    m_it.fit(y=y, params={"num_rand_vec_trace": 400})
    np.testing.assert_allclose(m_it.get_cov_pars(), m_ex.get_cov_pars(),
                               rtol=0.15, atol=0.03)


def test_gaussian_prediction_matches_dense():
    rng = np.random.default_rng(10)
    n, q1, q2 = 600, 30, 20
    g1, g2 = rng.integers(0, q1, size=n), rng.integers(0, q2, size=n)
    y = (0.8 * rng.standard_normal(q1)[g1] + 0.5 * rng.standard_normal(q2)[g2]
         + 0.6 * rng.standard_normal(n))
    gp_pred = np.column_stack([np.array([0, 1, 2, q1 + 5]),   # last unseen
                               np.array([0, 1, 2, 3])])
    m_d = gpt.GPModel(group_data=np.column_stack([g1, g2]), device="cpu")
    m_d.fit(y=y)
    p_d = m_d.predict(y=y, group_data_pred=gp_pred, predict_var=True)
    m_i = gpt.GPModel(group_data=np.column_stack([g1, g2]),
                      matrix_inversion_method="iterative", device="cpu")
    m_i.set_prediction_data(nsim_var_pred=4000)
    p_i = m_i.predict(y=y, group_data_pred=gp_pred, predict_var=True,
                      cov_pars=m_d.get_cov_pars())
    np.testing.assert_allclose(p_i["mu"], p_d["mu"], atol=1e-5)
    np.testing.assert_allclose(p_i["var"], p_d["var"], rtol=0.12, atol=0.01)
    # the full covariance keeps the Cholesky route, as in the JAX package
    p_c = m_i.predict(y=y, group_data_pred=gp_pred, predict_cov_mat=True,
                      cov_pars=m_d.get_cov_pars())
    np.testing.assert_allclose(p_c["cov"], m_d.predict(
        y=y, group_data_pred=gp_pred, predict_cov_mat=True)["cov"],
        rtol=1e-10)


def test_laplace_prediction_matches_dense():
    rng = np.random.default_rng(11)
    n, q = 500, 40
    g = rng.integers(0, q, size=n)
    y = rng.poisson(np.exp(0.7 * rng.standard_normal(q)[g] - 0.2)
                    ).astype(float)
    gp_pred = np.array([0, 1, 2, q + 3])
    m_d = gpt.GPModel(group_data=g, likelihood="poisson", device="cpu")
    m_d.fit(y=y)
    p_d = m_d.predict(y=y, group_data_pred=gp_pred, predict_var=True,
                      predict_response=True)
    m_i = gpt.GPModel(group_data=g, likelihood="poisson",
                      matrix_inversion_method="iterative", device="cpu")
    m_i.set_prediction_data(nsim_var_pred=4000)
    p_i = m_i.predict(y=y, group_data_pred=gp_pred, predict_var=True,
                      predict_response=True, cov_pars=m_d.get_cov_pars())
    np.testing.assert_allclose(p_i["mu"], p_d["mu"], rtol=0.02)
    np.testing.assert_allclose(p_i["var"], p_d["var"], rtol=0.15, atol=0.02)


def test_get_num_cg_steps_matches_jax():
    """Counts equal the JAX package's (a Jacobi-preconditioned CG on the
    same system: deterministic), Gaussian and Laplace; unfitted and
    Cholesky models raise."""
    rng = np.random.default_rng(12)
    n, q = 400, 30
    g = rng.integers(0, q, size=n)
    y = 0.8 * rng.standard_normal(q)[g] + 0.5 * rng.standard_normal(n)
    m = gpt.GPModel(group_data=g, matrix_inversion_method="iterative",
                    device="cpu")
    with pytest.raises(ValueError):
        m.get_num_cg_steps()
    jm = gpb.GPModel(group_data=g, matrix_inversion_method="iterative")
    for model in (m, jm):
        model.cov_pars_ = np.array([0.3, 0.6])
    m.y, jm.data = m._y_tensor(y), jm._with_y(y)
    assert m.get_num_cg_steps() == jm.get_num_cg_steps() >= 1
    yb = (y > 0).astype(float)
    m = gpt.GPModel(group_data=g, likelihood="bernoulli_logit",
                    matrix_inversion_method="iterative", device="cpu")
    jm = gpb.GPModel(group_data=g, likelihood="bernoulli_logit",
                     matrix_inversion_method="iterative")
    for model in (m, jm):
        model.cov_pars_ = np.array([0.7])
    m.y, jm.data = m._y_tensor(yb), jm._with_y(yb)
    assert m.get_num_cg_steps() == jm.get_num_cg_steps() >= 1
    m2 = gpt.GPModel(group_data=g, device="cpu")
    m2.fit(y=y)
    with pytest.raises(ValueError):
        m2.get_num_cg_steps()


def test_preconditioner_names():
    """ssor (the default), incomplete_cholesky and jacobi are served by
    the Jacobi diagonal; another name raises, naming the structure."""
    rng = np.random.default_rng(0)
    n = 200
    groups = rng.integers(0, 20, size=n)
    y = (rng.uniform(size=n) < 0.5).astype(float)
    gp = gpt.GPModel(group_data=groups, likelihood="bernoulli_logit",
                     matrix_inversion_method="iterative", device="cpu")
    gp.set_optim_params({"maxit": 1,
                         "cg_preconditioner_type": "pivoted_cholesky"})
    with pytest.raises(ValueError, match="grouped random effects"):
        gp.fit(y=y)
    for name in ("ssor", "incomplete_cholesky"):
        gp.set_optim_params({"maxit": 2, "cg_preconditioner_type": name})
        gp.fit(y=y)
        assert gp.cov_pars_ is not None
    gauss = gpt.GPModel(group_data=groups, matrix_inversion_method="iterative",
                        device="cpu")
    gauss.set_optim_params({"cg_preconditioner_type": "fitc"})
    with pytest.raises(ValueError, match="grouped random effects"):
        gauss.fit(y=rng.standard_normal(n))
