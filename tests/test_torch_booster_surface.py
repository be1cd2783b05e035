"""The rest of the Booster's surface in the port against the JAX package
(CPU, float64): ``refit``, ``rollback_one_iter``, ``get_leaf_output``,
``trees_to_dataframe``, ``feature_name``, ``lower_bound`` / ``upper_bound``,
``get_split_value_histogram``, ``shuffle_models``, ``set_attr`` / ``attr``,
``reset_parameter``, ``free_dataset``, ``free_network`` / ``set_network``,
``Dataset.get_ref_chain``, and the keywords the JAX signatures take and
drop. Mirrors ``test_boosting_variants.py::test_refit`` of the JAX package.

Tolerances: scores and predictions 1e-12 absolute (the same trees; a
refit's leaf sums are host numpy in the JAX package's order).
"""
import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once (see tests/test_torch_boosting.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PARAMS = {"objective": "regression", "num_leaves": 15, "verbose": -1,
          "seed": 4}


def _data(n=400, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 6))
    y = (2 * X[:, 0] + np.sin(5 * X[:, 1]) + (X[:, 2] > 0.5)
         + 0.1 * rng.standard_normal(n))
    return X, y


def _pair(rounds=10, valid=False):
    X, y = _data()
    names = [f"f{i}" for i in range(6)]
    jd = gpb.Dataset(X, label=y, feature_name=names)
    td = gpt.Dataset(X, label=y, feature_name=names, device="cpu")
    kw_j, kw_t = {}, {}
    if valid:
        kw_j["valid_sets"] = [jd.create_valid(X[:100], label=y[:100])]
        kw_t["valid_sets"] = [td.create_valid(X[:100], label=y[:100])]
    jb = gpb.train(dict(PARAMS), jd, num_boost_round=rounds,
                   verbose_eval=False, **kw_j)
    tb = gpt.train(dict(PARAMS), td, num_boost_round=rounds,
                   verbose_eval=False, **kw_t)
    return jb, tb, X, y


def test_refit():
    jb, tb, X, y = _pair(20)
    rng = np.random.default_rng(9)
    X2 = rng.uniform(size=(300, 6))
    y2 = (2 * X2[:, 0] + np.sin(5 * X2[:, 1]) + (X2[:, 2] > 0.5)
          + 0.1 * rng.standard_normal(300)) + 1.0     # a shifted target
    before = np.mean((tb.predict(X2) - y2) ** 2)
    assert tb.refit(X2, y2, decay_rate=0.5) is tb
    jb.refit(X2, y2, decay_rate=0.5)
    assert np.mean((tb.predict(X2) - y2) ** 2) < before
    np.testing.assert_allclose(tb.predict(X2), jb.predict(X2), rtol=0,
                               atol=1e-12)


def test_rollback_one_iter():
    jb, tb, X, _ = _pair(6, valid=True)
    for b in (jb, tb):
        b.rollback_one_iter().rollback_one_iter()
    assert tb.current_iteration() == jb.current_iteration() == 4
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb._valid_scores[0], jb._valid_scores[0],
                               rtol=0, atol=1e-12)
    # the scores are the four-round model's
    np.testing.assert_allclose(tb._score, tb.predict(X, raw_score=True),
                               rtol=0, atol=1e-12)


def test_tree_queries():
    jb, tb, X, _ = _pair()
    assert tb.feature_name() == jb.feature_name() == [f"f{i}"
                                                      for i in range(6)]
    for tid in (0, 3, 9):
        for leaf in (0, 4):
            assert tb.get_leaf_output(tid, leaf) == pytest.approx(
                jb.get_leaf_output(tid, leaf), abs=1e-12)
    assert tb.lower_bound() == pytest.approx(jb.lower_bound(), abs=1e-12)
    assert tb.upper_bound() == pytest.approx(jb.upper_bound(), abs=1e-12)
    raw = tb.predict(X, raw_score=True)
    # (a row in every tree's extreme leaf reaches the bound, summed in
    # another order)
    assert tb.lower_bound() <= raw.min() + 1e-12
    assert raw.max() <= tb.upper_bound() + 1e-12
    for feat in (1, "f0"):
        hj, ej = jb.get_split_value_histogram(feat)
        ht, et = tb.get_split_value_histogram(feat, bins=None)
        np.testing.assert_array_equal(ht, hj)
        np.testing.assert_allclose(et, ej, rtol=1e-12)
    dt, dj = tb.trees_to_dataframe(), jb.trees_to_dataframe()
    assert list(dt.columns) == list(dj.columns) and len(dt) == len(dj)
    np.testing.assert_allclose(dt["value"].to_numpy(float),
                               dj["value"].to_numpy(float), atol=1e-12)
    assert dt["split_feature"].tolist() == dj["split_feature"].tolist()


def test_shuffle_models_and_attributes(tmp_path):
    jb, tb, X, _ = _pair()
    for b in (jb, tb):
        b.shuffle_models(start_iteration=2)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-12)
    assert [t.split_feature[0] for t in tb.trees] == \
        [t.split_feature[0] for t in jb.trees]
    tb.set_attr(note="x", other=3)
    assert tb.attr("note") == "x" and tb.attr("other") == "3"
    tb.set_attr(other=None)
    assert tb.attr("other") is None
    tb.save_model(str(tmp_path / "m.json"))
    back = gpt.Booster(model_file=str(tmp_path / "m.json"), device="cpu")
    assert back.attr("note") == "x"
    assert gpb.Booster(model_file=str(tmp_path / "m.json")).attr("note") \
        == "x"


def test_reset_parameter_free_dataset_and_network():
    jb, tb, X, y = _pair(3)
    for b in (jb, tb):
        b.reset_parameter({"eta": 0.05, "min_data_in_leaf": 5})
    assert tb.learning_rate == jb.learning_rate == 0.05
    assert tb.params["min_data_in_leaf"] == 5
    for b in (jb, tb):
        b.update()
    np.testing.assert_allclose(tb._score, jb._score, rtol=0, atol=1e-12)
    want = tb.predict(X)
    assert tb.free_network() is tb
    with pytest.raises(NotImplementedError, match="item 20"):
        tb.set_network(["127.0.0.1:1"])
    assert tb.free_dataset().train_set is None
    np.testing.assert_array_equal(tb.predict(X), want)
    # update(train_set=) takes the booster's own Dataset only
    _, tb2, _, _ = _pair(1)
    tb2.update(train_set=tb2.train_set)
    with pytest.raises(ValueError, match="own training Dataset"):
        tb2.update(train_set=gpt.Dataset(X, label=y, device="cpu"))


def test_ref_chain():
    X, y = _data(100)
    td = gpt.Dataset(X, label=y, device="cpu")
    jd = gpb.Dataset(X, label=y)
    ts, js = td.subset(np.arange(50)), jd.subset(np.arange(50))
    tss, jss = ts.subset(np.arange(20)), js.subset(np.arange(20))
    assert tss.get_ref_chain() == {tss, ts, td}
    assert len(jss.get_ref_chain()) == 3
    assert tss.get_ref_chain(ref_limit=2) == {tss, ts}
    other = gpt.Dataset(X[:30], label=y[:30], device="cpu")
    other.set_reference(td)
    assert other.get_ref_chain() == {other, td}


def test_keywords_taken_and_dropped():
    """``train(keep_training_booster=)`` changes nothing, and
    ``Booster.predict``, ``GPModel.predict`` and
    ``GPModel.set_prediction_data`` drop keywords they do not know, as the
    JAX package's do; ``init_model`` still raises."""
    X, y = _data(200)
    ds = gpt.Dataset(X, label=y, device="cpu")
    a = gpt.train(dict(PARAMS), ds, num_boost_round=2)
    b = gpt.train(dict(PARAMS), ds, num_boost_round=2,
                  keep_training_booster=True)
    np.testing.assert_array_equal(a._score, b._score)
    np.testing.assert_array_equal(a.predict(X, data_has_header=True),
                                  a.predict(X))
    coords = np.random.default_rng(0).uniform(size=(200, 2))
    gp = gpt.GPModel(gp_coords=coords, gp_approx="vecchia", num_neighbors=5,
                     device="cpu")
    gp.set_prediction_data(gp_coords_pred=coords[:5], unknown_key=1)
    gp.fit(y, params={"maxit": 5})
    got = gp.predict(gp_coords_pred=coords[:5], unknown_key=1)
    np.testing.assert_array_equal(
        got["mu"], gp.predict(gp_coords_pred=coords[:5])["mu"])
    for fn in (gpt.train, gpt.cv):
        with pytest.raises(NotImplementedError, match="never reads it"):
            fn(dict(PARAMS), ds, num_boost_round=1, init_model="m.json")
