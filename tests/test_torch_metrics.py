"""The port's metrics (``gpboost_tpu_torch/boosting/metrics.py``) against the
JAX package's on the same numpy-seeded inputs (n = 400): every metric of the
registry, its aliases and defaults, within 1e-12 absolute (both are the same
numpy arithmetic). The ranking metrics raise, naming item 18c.
"""
import numpy as np
import pytest
import torch

from gpboost_tpu.boosting import metrics as jm

from gpboost_tpu_torch.boosting import metrics as tm

TOL = 1e-12
N = 400


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(N)
    counts = rng.poisson(2.0, N).astype(float)
    prob = rng.uniform(0.01, 0.99, N)
    return dict(
        y=y, pred=y + 0.3 * rng.standard_normal(N), counts=counts,
        pos=rng.gamma(2.0, 1.0, N), rate=rng.gamma(2.0, 1.0, N),
        y01=(rng.uniform(size=N) < prob).astype(float), prob=prob,
        yfrac=rng.uniform(size=N), w=rng.uniform(0.5, 2.0, N),
        cls=rng.integers(0, 3, N).astype(float),
        scores=rng.standard_normal(3 * N),
        var=rng.uniform(0.1, 2.0, N))


def _softmax(s):
    s = s.reshape(3, -1)
    e = np.exp(s - s.max(0))
    return (e / e.sum(0)).reshape(-1)


CASES = {
    "l2": lambda d: (d["y"], d["pred"]),
    "rmse": lambda d: (d["y"], d["pred"]),
    "l1": lambda d: (d["y"], d["pred"]),
    "mape": lambda d: (d["y"], d["pred"]),
    "quantile": lambda d: (d["y"], d["pred"]),
    "huber": lambda d: (d["y"], d["pred"]),
    "poisson": lambda d: (d["counts"], d["rate"]),
    "gamma": lambda d: (d["pos"], d["rate"]),
    "gamma_deviance": lambda d: (d["pos"], d["rate"]),
    "tweedie": lambda d: (d["counts"], d["rate"]),
    "binary_logloss": lambda d: (d["y01"], d["prob"]),
    "binary_error": lambda d: (d["y01"], d["prob"]),
    "auc": lambda d: (d["y01"], d["prob"]),
    "cross_entropy": lambda d: (d["yfrac"], d["prob"]),
    "cross_entropy_lambda": lambda d: (d["yfrac"], d["rate"]),
    "kullback_leibler": lambda d: (d["yfrac"], d["prob"]),
    "multi_logloss": lambda d: (d["cls"], _softmax(d["scores"])),
    "multi_error": lambda d: (d["cls"], _softmax(d["scores"])),
    "auc_mu": lambda d: (d["cls"], d["scores"]),
}


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(data, name, weighted):
    y, pred = CASES[name](data)
    w = data["w"] if weighted else None
    kw = ({"num_class": 3} if name in ("multi_logloss", "multi_error",
                                       "auc_mu") else {})
    want = jm.METRICS[name].fn(y, pred, w, **kw)
    got = tm.METRICS[name].fn(y, pred, w, **kw)
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)
    assert tm.METRICS[name].higher_better == jm.METRICS[name].higher_better
    assert tm.METRICS[name].kind == jm.METRICS[name].kind


def test_metric_options_match_jax(data):
    y, pred, cls = data["y"], data["pred"], data["cls"]
    p = _softmax(data["scores"])
    for fn_j, fn_t, args, kw in (
            (jm.quantile, tm.quantile, (y, pred), {"alpha": 0.3}),
            (jm.huber, tm.huber, (y, pred), {"alpha": 0.5}),
            (jm.tweedie_metric, tm.tweedie_metric,
             (data["counts"], data["rate"]), {"rho": 1.2}),
            (jm.multi_error, tm.multi_error, (cls, p),
             {"num_class": 3, "top_k": 2}),
            (jm.auc_mu, tm.auc_mu, (cls, data["scores"]),
             {"num_class": 3,
              "class_weights": [0, 1, 2, 1, 0, 1, 2, 1, 0]}),
            (jm.crps_gaussian, tm.crps_gaussian, (y, pred, data["var"]), {}),
            (jm.crps_gaussian, tm.crps_gaussian, (y, pred, data["var"]),
             {"weight": data["w"]})):
        want, got = fn_j(*args, **kw), fn_t(*args, **kw)
        assert abs(got - want) <= TOL * max(1.0, abs(want)), fn_t.__name__


def test_crps_gaussian_orders_forecasts():
    """The JAX package's ``test_crps_gaussian_metric`` on the port: a tight
    forecast beats a calibrated one beats a wide one."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal(500)
    tight = tm.crps_gaussian(y, y, 0.01 * np.ones(500))
    calibrated = tm.crps_gaussian(y, np.zeros(500), np.ones(500))
    wide = tm.crps_gaussian(y, np.zeros(500), 25 * np.ones(500))
    assert tight < calibrated < wide


def test_registry_aliases_and_defaults_match_jax():
    assert set(tm.METRICS) == set(jm.METRICS)
    assert tm.METRIC_ALIASES == jm.METRIC_ALIASES
    assert tm.GP_METRICS == jm.GP_METRICS
    for name in ("l2_root", "mae", "ndcg@1,3", "map@5", "binary",
                 "multiclass", "xentlambda"):
        assert tm.resolve_metric_name(name) == jm.resolve_metric_name(name)
    for obj in ("regression", "regression_l1", "huber", "fair", "poisson",
                "gamma", "tweedie", "quantile", "mape", "binary",
                "cross_entropy", "cross_entropy_lambda", "multiclass",
                "multiclassova", "regression_gp", "tobit",
                "mean_scale_regression", "lambdarank"):
        assert tm.default_metric_for(obj) == jm.default_metric_for(obj)


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_raise(name):
    """Ported: the ranking metrics give the JAX package's values (1e-15;
    the same host loop) on queries of several sizes with tied scores."""
    rng = np.random.default_rng(12)
    group = [7, 1, 12, 5, 9]
    y = rng.integers(0, 4, sum(group)).astype(float)
    score = np.round(rng.normal(size=sum(group)), 1)
    ks = [1, 3, 5, 20]
    kw = {"label_gain": [0.0, 1.0, 3.0, 10.0]} if name == "ndcg" else {}
    want = jm.METRICS[name].fn(y, score, group, ks, **kw)
    got = tm.METRICS[name].fn(y, score, group, ks, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-15)
