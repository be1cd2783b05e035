"""``predict_training_data_random_effects`` of an approximated GP (ROADMAP.md
items 15 and 17): the JAX package returns the latent prediction at the
training coordinates with zero covariates (``gpboost_tpu/models/
gp_model.py:1742-1752``), and so does the port. At n = 200, at the same
covariance parameters and coefficients, the means and variances against
the JAX package's, relative to each column's largest entry:

- the Vecchia GP (on the JAX package's ordering and neighbours), Gaussian
  and ``bernoulli_logit``: 1e-8;
- FITC, Gaussian and ``bernoulli_logit``: 1e-7, the JAX package's own
  error there (its inner-product distances; ``tests/test_torch_fitc.py``
  holds its predictions so too), and the Gaussian case at 1e-12 against a
  dense float64 reference from coordinate differences;
- full-scale Vecchia: 5e-8 at points 1e-3 beside the training points, and
  2e-6 at the training points themselves, where the JAX package's
  inner-product distance of a point to itself is ~1e-8 instead of 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 200


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(N, 2))
    X = np.column_stack([np.ones(N), rng.uniform(size=N)])
    f = np.sin(5 * coords[:, 0]) + np.cos(3 * coords[:, 1])
    y = f + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(N)
    yb = (rng.uniform(size=N) < 1 / (1 + np.exp(-f))).astype(float)
    return dict(coords=coords, X=X, y=y, yb=yb)


CASES = [
    ("fitc", "gaussian", dict(num_ind_points=20), [0.1, 1.0, 0.2]),
    ("full_scale_vecchia", "gaussian",
     dict(num_ind_points=20, num_neighbors=10), [0.1, 1.0, 0.2]),
    ("vecchia", "gaussian", dict(num_neighbors=10), [0.1, 1.0, 0.2]),
    ("fitc", "bernoulli_logit", dict(num_ind_points=20), [1.0, 0.2]),
    ("vecchia", "bernoulli_logit", dict(num_neighbors=10), [1.0, 0.2]),
]


@pytest.mark.parametrize("approx,lik,kw,cp", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_training_effects_match_jax(data, approx, lik, kw, cp):
    args = dict(gp_coords=data["coords"], cov_function="exponential",
                gp_approx=approx, likelihood=lik, **kw)
    jm, tm = gpb.GPModel(**args), gpt.GPModel(device="cpu", **args)
    if approx == "vecchia":
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
    elif approx == "full_scale_vecchia":
        tm._approx.load_structure(np.asarray(jm._approx.perm),
                                  np.asarray(jm._approx.neighbors))
    y = data["y"] if lik == "gaussian" else data["yb"]
    X = data["X"] if lik == "gaussian" else None
    # the state a fit leaves, the same on both sides
    with pytest.raises(ValueError, match="fit"):
        tm.predict_training_data_random_effects()
    tm.y, tm.X = tm._y_tensor(y), None if X is None else tm._tensor(X)
    jm.data = dataclasses.replace(
        jm._with_y(y), X=None if X is None else jnp.asarray(X))
    for m in (tm, jm):
        m.cov_pars_ = np.asarray(cp)
        m.coefs_ = None if X is None else np.array([0.2, 0.5])
    got = tm.predict_training_data_random_effects(predict_var=True)
    want = np.asarray(jm.predict_training_data_random_effects(
        predict_var=True))
    assert got.shape == want.shape == (N, 2)
    tol = {"vecchia": 1e-8, "fitc": 1e-7, "full_scale_vecchia": 2e-6}[approx]
    err = np.max(np.abs(got - want), axis=0)
    assert np.all(err < tol * np.max(np.abs(want), axis=0)), err
    np.testing.assert_array_equal(
        tm.predict_training_data_random_effects(), got[:, :1])
    if approx == "fitc" and lik == "gaussian":
        ip = tm._approx.ind_points.numpy()
        psi, q_nn = _dense_fitc(data["coords"], ip, cp)
        r = y - X @ np.array([0.2, 0.5])
        np.testing.assert_allclose(got[:, 0], q_nn @ np.linalg.solve(psi, r),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[:, 1], cp[1] - np.einsum(
            "pn,np->p", q_nn, np.linalg.solve(psi, q_nn.T)), rtol=0,
            atol=1e-12)
    if approx == "full_scale_vecchia":
        kw = dict(gp_coords_pred=data["coords"] + 1e-3, predict_var=True,
                  predict_response=False, X_pred=np.zeros((N, 2)))
        pt, pj = tm.predict(**kw), jm.predict(**kw)
        for key in ("mu", "var"):
            assert np.max(np.abs(pt[key] - pj[key])) < 5e-8 * np.max(
                np.abs(pj[key]))


def _dense_fitc(coords, ip, cp):
    """(Psi, Q_nn) of FITC from coordinate differences (numpy)."""
    def cov(a, b):
        d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
        return cp[1] * np.exp(-d / cp[2])
    c_mm = cov(ip, ip) + 1e-8 * cp[1] * np.eye(len(ip))
    c_nm = cov(coords, ip)
    Q = c_nm @ np.linalg.solve(c_mm, c_nm.T)
    return Q + np.diag(cp[1] - np.diag(Q) + cp[0]), Q
