"""``cluster_ids`` models, the port against the R goldens and the JAX
package (mirrors ``tests/test_clustered.py`` and ``TestCombinedClusterIds``
of ``tests/test_combined_golden.py``): the batched per-cluster blocks of
``models/clustered.py`` (a Gaussian GP alone) and the dense route with the
block-diagonal mask (grouped effects beside the GP). CPU, float64, the R
fixture (n = 100, two clusters) and 25 clusters of 3-29 points.

Tolerances: the R goldens at the JAX tests' own (Fisher scoring 1e-4
absolute; the batched L-BFGS fit 5e-3; predictions 1e-5 summed; the
combined model's prediction 1e-6 summed and its Fisher-scoring fit 2e-3);
the blocks against the dense masked NLL 1e-8 relative; block solves,
GLS coefficients and gradients against the JAX package 1e-10 relative.
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
import jax.numpy as jnp
from gpboost_tpu.models import clustered as jcl
from gpboost_tpu.models import gaussian as jga
from gpboost_tpu.utils.rng import sim_rand_normal
from gpboost_tpu_torch.models import clustered as tcl
from gpboost_tpu_torch.models import gaussian as tga

COORD_TEST = np.array([[0.1, 0.9], [0.2, 0.4], [0.7, 0.55]])


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
def cdata(gp_fixture_data):
    f = gp_fixture_data
    return f, f["eps"] + f["xi"]


def _model(f, **kw):
    return gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                       cluster_ids=f["cluster_ids"], device="cpu", **kw)


def test_fit_fisher_scoring_golden(cdata):
    """R:614-622: Fisher scoring (parameter criterion; the batched model's
    dense route, as in the JAX package) -> (0.05414149, 1.05789166,
    0.12702368), 1e-4."""
    f, y = cdata
    m = _model(f)
    m.fit(y=y, params={"optimizer_cov": "fisher_scoring",
                       "use_nesterov_acc": False, "delta_rel_conv": 1e-6,
                       "maxit": 100,
                       "convergence_criterion":
                           "relative_change_in_parameters"})
    np.testing.assert_allclose(
        m.get_cov_pars(), [0.05414149, 1.05789166, 0.12702368], atol=1e-4)


def test_fit_batched_path_matches(cdata):
    """The L-BFGS fit runs the batched [C, m, m] blocks; the R optimum to
    5e-3, the JAX package's batched fit 1e-6 relative."""
    f, y = cdata
    m = _model(f)
    assert m._clustered_batched and m.data.dists is None
    m.fit(y=y, params={"optimizer_cov": "lbfgs"})
    np.testing.assert_allclose(
        m.get_cov_pars(), [0.05414149, 1.05789166, 0.12702368], atol=5e-3)
    jm = gpb.GPModel(gp_coords=f["coords"], cov_function="exponential",
                     cluster_ids=f["cluster_ids"])
    jm.fit(y=y, params={"optimizer_cov": "lbfgs"})
    np.testing.assert_allclose(m.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)


def test_predict_golden(cdata):
    """R:624-643: predictions with an unseen cluster id (3: the prior),
    covariance and variances, 1e-5 summed; the block predictor against the
    dense one."""
    f, y = cdata
    m = _model(f)
    kw = dict(y=y, gp_coords_pred=COORD_TEST, cluster_ids_pred=[1, 3, 1],
              cov_pars=[0.1, 1.0, 0.15])
    pred = m.predict(predict_cov_mat=True, **kw)
    want_mu = [-0.01437506, 0.0, 0.93112902]
    want_cov = np.array([[0.743055189, 0.0, -0.000140644],
                         [0.0, 1.1, 0.0],
                         [-0.000140644, 0.0, 0.565243468]])
    assert np.sum(np.abs(pred["mu"] - want_mu)) < 1e-5
    assert np.sum(np.abs(pred["cov"] - want_cov)) < 1e-5
    pv = m.predict(predict_var=True, **kw)
    assert np.sum(np.abs(pv["mu"] - want_mu)) < 1e-5
    assert np.sum(np.abs(pv["var"] - np.diag(want_cov))) < 1e-5
    m._clustered_batched = False          # the dense masked predictor
    pd = m.predict(predict_cov_mat=True, **kw)
    np.testing.assert_allclose(pred["cov"], pd["cov"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(pred["mu"], pd["mu"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", ["fixture", "many_clusters"])
def test_blocks_match_dense_masked_and_jax(cdata, case):
    """The batched NLL equals the dense block-masked one (1e-8 relative:
    the blocks take distances by differences, the dense route by inner
    products; the JAX test holds 1e-5), for the R fixture and for 25
    clusters of unequal sizes; the profiled value, gradient and sigma2_hat, the block
    solve Psi^-1 V and the GLS coefficients equal the JAX package's
    (1e-10 relative)."""
    if case == "fixture":
        f, y = cdata
        coords, codes = f["coords"], f["cluster_ids"]
        cp = np.array([0.1, 1.0, 0.15])
    else:
        rng = np.random.default_rng(5)
        sizes = rng.integers(3, 30, size=25)
        n = int(sizes.sum())
        codes = np.repeat(np.arange(25), sizes)
        coords = rng.uniform(size=(n, 2))
        y = rng.normal(size=n)
        cp = np.array([0.2, 1.0, 0.2])
    kw = dict(gp_coords=coords, cov_function="exponential",
              cluster_ids=codes)
    tm = gpt.GPModel(device="cpu", **kw)
    jm = gpb.GPModel(**kw)
    nll_b = tm.neg_log_likelihood(cp, y)
    nll_d = float(tga.neg_log_likelihood(tm.spec, tm.data,
                                         torch.as_tensor(cp),
                                         torch.as_tensor(y)))
    assert abs(nll_b - nll_d) < 1e-8 * abs(nll_d)
    blocks = jm._get_cluster_blocks()
    cf = jm.spec.components[0].cov_fn
    th = np.log([cp[1] / cp[0], cp[2]])
    v_j, g_j, s_j = jcl.nll_profiled_value_and_grad(cf, jnp.asarray(th),
                                                    blocks, jnp.asarray(y))
    v_t, g_t, s_t = tcl.nll_profiled_value_and_grad(
        tm.cov_fn, torch.as_tensor(th), tm._blocks, torch.as_tensor(y))
    assert abs(float(v_t) - float(v_j)) < 1e-10 * abs(float(v_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-12)
    assert abs(float(s_t) - float(s_j)) < 1e-10 * float(s_j)
    V = np.random.default_rng(1).standard_normal((len(y), 2))
    sol_j = np.asarray(jcl.psi_inv_blocks_mul(cf, jnp.asarray(cp), blocks,
                                              jnp.asarray(V)))
    sol_t = tcl.psi_inv_blocks_mul(tm.cov_fn, torch.as_tensor(cp),
                                   tm._blocks, torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(sol_t, sol_j, rtol=1e-10, atol=1e-12)
    X = np.column_stack([np.ones(len(y)), V[:, 0]])
    b_j = np.asarray(jcl.wls_coefficients(cf, jnp.asarray(cp), blocks,
                                          jnp.asarray(y), jnp.asarray(X)))
    b_t = tcl.wls_coefficients(tm.cov_fn, torch.as_tensor(cp), tm._blocks,
                               torch.as_tensor(y), torch.as_tensor(X))
    np.testing.assert_allclose(b_t.numpy(), b_j, rtol=1e-10)


@pytest.fixture(scope="module")
def cc(gp_fixture_data):
    f = gp_fixture_data
    group = np.repeat(np.arange(1, 11), 10)
    y = f["eps"] + sim_rand_normal(10, 0.56)[group - 1] + f["xi"]
    return dict(f=f, group=group, y=y)


def test_combined_cluster_ids_prediction(cc):
    """``TestCombinedClusterIds.test_prediction`` (R:237-248): a GP and a
    grouped intercept with cluster_ids (the dense masked route), a new
    group level and a new cluster id; mu and the covariance 1e-6 summed."""
    f = cc["f"]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                    group_data=cc["group"], cluster_ids=f["cluster_ids"],
                    device="cpu")
    assert m._exact and not m._clustered_batched
    coord_test = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
    pred = m.predict(y=cc["y"], gp_coords_pred=coord_test,
                     group_data_pred=np.array([1, 1, 9999]),
                     cluster_ids_pred=np.array([1, 3, 1]),
                     cov_pars=[0.1, 1.5, 1.0, 0.15], predict_cov_mat=True)
    want_mu = np.array([0.1275193, 0.0, 0.5948827])
    want_cov = np.array([0.76147286, 0.0, -0.01260688, 0.0, 2.6, 0.0,
                         -0.01260688, 0.0, 2.15607110]).reshape(3, 3)
    assert np.sum(np.abs(pred["mu"] - want_mu)) < 1e-6
    assert np.sum(np.abs(pred["cov"] - want_cov)) < 1e-6


def test_combined_cluster_ids_fit_fisher(cc):
    """``TestCombinedClusterIds.test_fit_fisher`` (R:226-233): Fisher
    scoring -> (0.0053, 0.6150, 1.0430, 0.1137), 2e-3 absolute."""
    f = cc["f"]
    m = gpt.GPModel(gp_coords=f["coords"], cov_function="exponential",
                    group_data=cc["group"], cluster_ids=f["cluster_ids"],
                    device="cpu")
    m.fit(y=cc["y"], params={"optimizer_cov": "fisher_scoring"})
    np.testing.assert_allclose(
        m.get_cov_pars(),
        [0.005306836, 0.615012714, 1.043024690, 0.113716679], atol=2e-3)
