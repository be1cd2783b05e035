"""The likelihood tail of the PyTorch port: the two zero-one-censored
families, observation ``weights`` and ``GPModel.set_likelihood``.

Mirrors ``tests/test_censored_likelihoods.py`` (the reference suite's
censored blocks, ``test_GPModel_non_Gaussian_data.R:5527-5680``: the
transformed-beta values the JAX package verified independently, the
shifted-gamma R goldens at 1e-5) and ``tests/test_binomial_golden.py``
(trial counts as ``weights``, the R goldens at their tolerances), and holds
the port against the JAX package on the same inputs: NLLs 1e-10 relative,
the b-space Laplace gradients 1e-8 relative (their derivatives in the shapes
run through the incomplete-beta / -gamma quadratures), fits 1e-5,
predictions 1e-8.
CPU, float64, the R tests' fixture (n = 100, 10 groups).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import beta as sbeta
from scipy.stats import binom as sbinom
from scipy.stats import gamma as sgamma
from scipy.stats import poisson as spoisson

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.models import grouped as jg
from gpboost_tpu.utils.rng import sim_rand_normal, sim_rand_unif
from gpboost_tpu_torch.models import grouped as tg

TOL_STRICT = 1e-5
TOL_MEDIUM = 1e-3
GROUP_TEST = np.array([1, 3, 3, 9999])
X_TEST = np.column_stack([np.ones(4), [-0.5, 0.2, 0.4, 1.0]])
ZOCB = "zero_one_censored_transformed_beta"
ZOCG = "zero_one_censored_shifted_gamma"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base():
    n, m = 100, 10
    group = np.repeat(np.arange(1, m + 1), n // m)
    Z1b = sim_rand_normal(m, 0.565)[group - 1]
    X = np.column_stack([np.ones(n), np.sin(
        (np.arange(1, n + 1) - n / 2) ** 2 * 2 * np.pi / n)])
    beta = np.array([0.1, 2.0])
    eta = Z1b + 0.5 * (X @ beta)
    p = 1.0 / (1.0 + np.exp(-eta))
    y_beta = sbeta.ppf(sim_rand_unif(n, 0.23474), p * 20.0, (1 - p) * 20.0)
    y_beta = np.clip(-0.15 + 1.3 * y_beta, 0.0, 1.0)
    scale = np.exp(Z1b + 0.25 * (X @ beta)) / 5.0
    y_gamma = np.clip(sgamma.ppf(sim_rand_unif(n, 0.1346), 5.0, scale=scale)
                      - 0.1, 0.0, 1.0)
    ntrial = spoisson.ppf(sim_rand_unif(n, 0.9146), 5.0)
    y_cnt = sbinom.ppf(sim_rand_unif(n, 0.146), ntrial, p)
    y_bin = np.where(ntrial > 0, y_cnt / np.maximum(ntrial, 1.0), 0.0)
    return dict(n=n, group=group, X=X, y_beta=y_beta, y_gamma=y_gamma,
                ntrial=ntrial, y_bin=y_bin)


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("lik,ykey,aux,golden", [
    (ZOCB, "y_beta", [20.0, 0.15], 54.04808137),
    (ZOCG, "y_gamma", [5.0, 0.1], 76.53696381)])
def test_censored_nll(base, lik, ykey, aux, golden):
    """The NLL at cov_pars 0.9: the golden (R for the shifted gamma; the
    JAX package's independently verified value for the transformed beta,
    whose R golden carries the reference's broken incomplete beta) and
    the JAX package's value."""
    y = base[ykey]
    assert (y == 0).any() and (y == 1).any()
    tm = gpt.GPModel(group_data=base["group"], likelihood=lik, device="cpu")
    nll = tm.neg_log_likelihood([0.9], y, aux_pars=aux)
    assert abs(nll - golden) < TOL_STRICT
    jm = gpb.GPModel(group_data=base["group"], likelihood=lik)
    nll_j = jm.neg_log_likelihood(cov_pars=[0.9], y=y, aux_pars=aux)
    assert _rel(nll, nll_j) < 1e-10


def test_censored_interior_and_reference_optimum(base):
    """Censoring-free transformed-beta data meets the compiled reference
    (39.02433664); the shifted gamma at the R optimum 36.79381797."""
    y = base["y_beta"].copy()
    y[y == 0] = 0.02
    y[y == 1] = 0.98
    tm = gpt.GPModel(group_data=base["group"], likelihood=ZOCB, device="cpu")
    assert abs(tm.neg_log_likelihood([0.9], y, aux_pars=[20.0, 0.15])
               - 39.02433664) < 1e-6
    tg_ = gpt.GPModel(group_data=base["group"], likelihood=ZOCG,
                      device="cpu")
    nll = tg_.neg_log_likelihood(
        [0.4209158489], base["y_gamma"],
        aux_pars=[3.50495674874, 0.06611314103],
        fixed_effects=base["X"] @ np.array([-0.1713543234, 0.7616663663]))
    assert abs(nll - 36.79381797) < TOL_STRICT


@pytest.mark.parametrize("lik", [ZOCB, ZOCG])
def test_censored_labels_are_checked(base, lik):
    tm = gpt.GPModel(group_data=base["group"], likelihood=lik, device="cpu")
    for bad_value in (-1e-10, 1 + 1e-10):
        bad = base["y_beta"].copy()
        bad[0] = bad_value
        with pytest.raises(ValueError, match="0, 1"):
            tm.neg_log_likelihood([0.9], bad, aux_pars=[2.0, 0.1])


@pytest.mark.parametrize("lik,ykey,aux", [
    (ZOCB, "y_beta", [20.0, 0.15]), (ZOCG, "y_gamma", [5.0, 0.1])])
def test_censored_gradient_matches_jax(base, lik, ykey, aux):
    """d NLL / d (cov_pars, aux, beta) of the b-space Laplace NLL: through
    the mode's implicit backward, whose third location derivative runs
    through the incomplete functions' shape derivatives. The shifted gamma
    against ``jax.value_and_grad`` of the JAX package's NLL (1e-8); the
    transformed beta against central differences of the port's NLL, whose
    value is the JAX package's (``test_censored_nll``; the JAX package's
    compiled gradient here takes minutes to build)."""
    tm = gpt.GPModel(group_data=base["group"], likelihood=lik, device="cpu")
    y, X = torch.tensor(base[ykey]), torch.tensor(base["X"])
    cp, ap, beta = np.array([0.6]), np.array(aux), np.array([0.1, 0.4])
    cpt, apt, bt = (torch.tensor(v, requires_grad=True)
                    for v in (cp, ap, beta))
    v = tg.nll_laplace(tm._Z, lik, cpt, apt, y, X @ bt)
    grads = [g.numpy() for g in torch.autograd.grad(v, (cpt, apt, bt))]
    if lik == ZOCG:
        jm = gpb.GPModel(group_data=base["group"], likelihood=lik)
        jd = jm._with_y(base[ykey])
        jd.X = jnp.asarray(base["X"])
        jv, jgrads = jg.nll_laplace_value_and_grad(
            jm.spec, jd, jnp.asarray(cp), jnp.asarray(ap), jnp.asarray(beta),
            None)
        assert _rel(float(v.detach()), float(jv)) < 1e-10
        for got, want in zip(grads, jgrads):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8)
        return
    flat = np.concatenate([cp, ap, beta])

    def nll(x):
        with torch.no_grad():
            return float(tg.nll_laplace(
                tm._Z, lik, torch.tensor(x[:1]), torch.tensor(x[1:3]), y,
                X @ torch.tensor(x[3:])))

    # the mode finder stops at a 1e-9 relative change of its objective:
    # ~5e-8 of noise in each NLL, 3e-4 in a difference over 2h = 2e-4, so
    # 1e-3 (the building blocks' derivatives are held to the JAX package's
    # at 1e-7 in ``tests/test_torch_special.py``)
    h = 1e-4
    fd = [(nll(flat + h * e) - nll(flat - h * e)) / (2 * h)
          for e in np.eye(flat.size)]
    np.testing.assert_allclose(np.concatenate(grads), fd, rtol=1e-3,
                               atol=1e-3)


def test_censored_response_moments(base):
    """Response prediction of the shifted gamma at given parameters (the
    families' moments by quadrature over the latent posterior) against the
    JAX package (1e-8); the transformed beta's moments are held against
    the JAX family in ``tests/test_torch_likelihoods.py``."""
    preds = []
    for pkg, extra in ((gpt, {"device": "cpu"}), (gpb, {})):
        m = pkg.GPModel(group_data=base["group"], likelihood=ZOCG, **extra)
        m.set_optim_params(params={"init_coef": [-0.1713543234,
                                                 0.7616663663],
                                   "init_aux_pars": [5.0, 0.1]})
        m.cov_pars_ = np.array([0.4209158489])
        preds.append(m.predict(y=base["y_gamma"], group_data_pred=GROUP_TEST,
                               X_pred=X_TEST, predict_var=True,
                               predict_response=True))
    tp, jp = preds
    assert np.all((tp["mu"] >= 0) & (tp["mu"] <= 1)) and np.all(tp["var"] > 0)
    np.testing.assert_allclose(tp["mu"], np.asarray(jp["mu"]), atol=1e-8)
    np.testing.assert_allclose(tp["var"], np.asarray(jp["var"]), atol=1e-8)


def test_shifted_gamma_prediction_golden(base):
    m = gpt.GPModel(group_data=base["group"], likelihood=ZOCG, device="cpu")
    m.set_optim_params(params={
        "init_coef": [-0.1713543234, 0.7616663663],
        "init_aux_pars": [3.50495674874, 0.06611314103]})
    m.cov_pars_ = np.array([0.4209158489])
    pred = m.predict(y=base["y_gamma"], group_data_pred=GROUP_TEST,
                     X_pred=X_TEST, predict_var=True, predict_response=True)
    assert abs(pred["mu"][3] - 0.8658269508) < 1e-6
    assert abs(pred["var"][3] - 0.05815172162) < 1e-6
    assert np.sum(np.abs(pred["mu"] - [0.4938941250, 0.6200604917,
                                       0.6895052787, 0.8658269508])) < 0.1


def test_censored_short_fits(base):
    """Fits of both censored GLMMs with coefficients, cut to 3 L-BFGS
    iterations (a full one is ~60 s here; the objective and its gradient
    are held to the JAX package above): finite, lower than at the start,
    the response prediction in [0, 1]."""
    for lik, ykey in ((ZOCB, "y_beta"), (ZOCG, "y_gamma")):
        m = gpt.GPModel(group_data=base["group"], likelihood=lik,
                        device="cpu")
        y = base[ykey]
        start = m.neg_log_likelihood([np.var(y, ddof=1)], y)
        m.fit(y, X=base["X"], params={"optimizer_cov": "lbfgs", "maxit": 3})
        nll = m.get_current_neg_log_likelihood()
        assert np.isfinite(nll) and nll < start
        assert np.all(np.asarray(m.get_aux_pars()) > 0)
        pred = m.predict(y=y, group_data_pred=GROUP_TEST, X_pred=X_TEST,
                         predict_var=True, predict_response=True)
        assert np.all((pred["mu"] >= 0) & (pred["mu"] <= 1))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_binomial_trials_as_weights(base):
    """R: nll(0.9) = 164.4059537; the fit (cov 0.27446, coef (-0.00528,
    0.79835), nll 145.3393856) and its latent and response predictions at
    the R tests' tolerances; the NLL the JAX package's, 1e-10."""
    kw = dict(group_data=base["group"], likelihood="binomial_logit",
              weights=base["ntrial"])
    tm = gpt.GPModel(device="cpu", **kw)
    y = base["y_bin"]
    nll = tm.neg_log_likelihood([0.9], y)
    assert abs(nll - 164.4059537) < TOL_STRICT
    assert _rel(nll, gpb.GPModel(**kw).neg_log_likelihood(
        cov_pars=[0.9], y=y)) < 1e-10
    tm.fit(y, X=base["X"], params={"optimizer_cov": "lbfgs"})
    assert abs(tm.get_current_neg_log_likelihood() - 145.3393856) \
        < TOL_MEDIUM
    np.testing.assert_allclose(tm.get_cov_pars(), [0.2744642669], rtol=1e-3)
    np.testing.assert_allclose(tm.get_coef(), [-0.005279993048,
                                               0.798354476357], atol=1e-3)
    pred = tm.predict(y=y, group_data_pred=GROUP_TEST, X_pred=X_TEST,
                      predict_var=True, predict_response=False)
    np.testing.assert_allclose(pred["mu"], [-0.05764418646, -0.10010510651,
                                            0.05956578876, 0.79307448331],
                               atol=5e-3)
    np.testing.assert_allclose(pred["var"], [0.06017870123, 0.08217586719,
                                             0.08217586719, 0.27446426691],
                               atol=5e-3)
    pred_r = tm.predict(y=y, group_data_pred=GROUP_TEST, X_pred=X_TEST,
                        predict_var=True, predict_response=True)
    np.testing.assert_allclose(pred_r["mu"], [0.4858032665, 0.4754871830,
                                              0.5145933378, 0.6784515040],
                               atol=5e-3)


def test_beta_binomial_trials_as_weights(base):
    """R: nll(0.9) = 220.9211521 (the beta-binomial data of
    ``tests/test_binomial_golden.py``)."""
    n = base["n"]
    eta = (sim_rand_normal(10, 0.565)[base["group"] - 1]
           + 0.5 * (base["X"] @ np.array([0.1, 2.0])))
    mu = 1.0 / (1.0 + np.exp(-eta))
    p = sbeta.ppf(sim_rand_unif(n, 0.5940), mu * 2.0, (1.0 - mu) * 2.0)
    ntrial = spoisson.ppf(sim_rand_unif(n, 0.15468), 5.0) + 1.0
    y = sbinom.ppf(sim_rand_unif(n, 0.146), ntrial, p) / ntrial
    m = gpt.GPModel(group_data=base["group"], likelihood="beta_binomial",
                    weights=ntrial, device="cpu")
    assert abs(m.neg_log_likelihood([0.9], y) - 220.9211521) < TOL_STRICT


@pytest.mark.parametrize("route", ["grouped", "grouped_plan", "exact",
                                   "exact_poisson", "grouped_poisson"])
def test_weighted_nll_matches_jax(base, route):
    """Multiplicative weights: the Gaussian error variance sigma2 / w
    (grouped Woodbury on both of the port's routes, the dense exact GP)
    and the weighted log-likelihood of a non-Gaussian family (dense and
    b-space Laplace), each the JAX package's NLL within 1e-10."""
    rng = np.random.default_rng(4)
    n = base["n"]
    w = rng.uniform(0.3, 3.0, n)
    coords = rng.uniform(size=(n, 2))
    pois = route.endswith("poisson")
    y = (rng.poisson(2.0, n).astype(float) if pois
         else base["y_beta"] + rng.normal(0.0, 0.3, n))
    kw = dict(weights=w, likelihood="poisson" if pois else "gaussian")
    if route.startswith("grouped"):
        kw["group_data"] = base["group"]
        cp = [0.7] if pois else [0.4, 0.7]
    else:
        kw.update(gp_coords=coords, cov_function="exponential")
        cp = [0.7, 0.2] if pois else [0.4, 0.7, 0.2]
    tm = gpt.GPModel(device="cpu", **kw)
    if route == "grouped_plan":
        tm._Z = tg.GroupedZ(tm.spec, tm.data, deterministic=True)
    nll_j = gpb.GPModel(**kw).neg_log_likelihood(cov_pars=cp, y=y)
    assert _rel(tm.neg_log_likelihood(cp, y), nll_j) < 1e-10


def test_weighted_grouped_fit_matches_jax(base):
    """The default (gradient-descent, profiled) fit of a weighted grouped
    LMM without coefficients: the JAX package's optimum, 1e-5."""
    rng = np.random.default_rng(5)
    w = rng.uniform(0.3, 3.0, base["n"])
    y = base["y_beta"] + rng.normal(0.0, 0.3, base["n"])
    kw = dict(group_data=base["group"], weights=w)
    tm = gpt.GPModel(device="cpu", **kw).fit(y)
    jm = gpb.GPModel(**kw)
    jm.fit(y=y)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)


@pytest.mark.parametrize("approx", ["vecchia", "fitc"])
def test_weights_where_the_jax_package_drops_them_raise(base, approx):
    """The JAX package accepts ``weights`` under Vecchia and the low-rank
    approximations and never reads them; the port raises (ROADMAP.md,
    "Not faults")."""
    coords = np.random.default_rng(0).uniform(size=(base["n"], 2))
    with pytest.raises(NotImplementedError, match="Not faults"):
        gpt.GPModel(gp_coords=coords, gp_approx=approx,
                    weights=np.ones(base["n"]), device="cpu")


# ---------------------------------------------------------------------------
# set_likelihood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,second", [("gamma", "gaussian"),
                                          ("gaussian", "poisson")])
def test_set_likelihood(base, first, second):
    """The R tests switch the likelihood before a fit: the parameters and
    the optimizer default reset, the NLL and the fit are the new family's
    (the JAX package's after the same switch, 1e-10 / 1e-5)."""
    rng = np.random.default_rng(9)
    y = (rng.poisson(2.0, base["n"]).astype(float) if second == "poisson"
         else np.exp(base["y_beta"]))
    models = []
    for pkg, extra in ((gpt, {"device": "cpu"}), (gpb, {})):
        m = pkg.GPModel(group_data=base["group"], likelihood=first, **extra)
        m.set_likelihood(second)
        models.append(m)
    tm, jm = models
    assert tm.likelihood == jm.likelihood == second
    assert tm.num_cov_pars == jm.num_cov_pars
    assert tm.optim_cfg.optimizer_cov == jm.optim_cfg.optimizer_cov
    cp = [0.5, 0.8] if second == "gaussian" else [0.8]
    assert _rel(tm.neg_log_likelihood(cp, y),
                jm.neg_log_likelihood(cov_pars=cp, y=y)) < 1e-10
    tm.fit(y)
    jm.fit(y=y)
    np.testing.assert_allclose(tm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-5)


def test_set_likelihood_on_a_vecchia_gp(base):
    """A Vecchia GP switched from gaussian to ``bernoulli_logit`` takes the
    latent parametrisation (no nugget among its parameters) and is the
    model built with that likelihood: the same NLL (1e-12 relative)."""
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(base["n"], 2))
    y = (rng.uniform(size=base["n"]) < 0.4).astype(float)
    kw = dict(gp_coords=coords, gp_approx="vecchia", num_neighbors=8,
              device="cpu")
    switched = gpt.GPModel(**kw).set_likelihood("bernoulli_logit")
    built = gpt.GPModel(likelihood="bernoulli_logit", **kw)
    assert switched.num_cov_pars == built.num_cov_pars == 2
    assert not switched._approx.nugget_in_pars
    nll = built.neg_log_likelihood([0.8, 0.2], y)
    assert _rel(switched.neg_log_likelihood([0.8, 0.2], y), nll) < 1e-12
