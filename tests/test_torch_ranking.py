"""Ranking in the port against the JAX package (CPU, float64): the
``lambdarank`` and ``rank_xendcg`` objectives, the ``ndcg`` / ``map``
metrics at the ``eval_at`` positions, ``Dataset(group=)`` and its ``.bin``
round trip. Mirrors the ranking parts of the JAX package's
``tests/test_ranking_tail.py`` (with ``tests/data/ranking_goldens.json``, the
reference GPBoost's values), ``test_config_tail_r4.py::
test_lambdarank_label_gain_and_norm``, ``test_parity_extras.py::
test_rank_xendcg_trains_and_improves_ndcg`` and the lambdarank half of
``test_boosting_variants.py::test_lambdarank_and_ndcg``.

Tolerances: the metrics 1e-15 relative to the JAX package's (the same host
loop) and 1e-12 absolute to the reference's goldens; ``lambdarank``'s
gradients and hessians 1e-12 relative (the port sums a row's pairs in
another order), ``rank_xendcg``'s the same bits; trainings' scores 1e-10
absolute and their metric curves 1e-12.
"""
import json
import os

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting import metrics as jmet
from gpboost_tpu.boosting import objectives as jobj

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import metrics as tmet
from gpboost_tpu_torch.boosting import objectives as tobj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes at once (see tests/test_torch_boosting.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                       "ranking_goldens.json")


def _rank_data(nq=30, per=12, seed=1):
    rng = np.random.default_rng(seed)
    n = nq * per
    X = rng.uniform(size=(n, 4))
    rel = np.clip(np.round(2 * X[:, 0] + X[:, 1]
                           + 0.5 * rng.standard_normal(n)), 0, 4)
    return X, rel, np.full(nq, per)


def test_map_at_ks_hand_computed():
    # one query: labels ordered by score = [1, 0, 1, 0, 1]
    y = np.array([1.0, 0.0, 1.0, 0.0, 1.0])
    score = np.array([5.0, 4.0, 3.0, 2.0, 1.0])
    m1, m3, m5 = tmet.map_at_ks(y, score, [5], [1, 3, 5])
    assert m1 == pytest.approx(1.0)
    assert m3 == pytest.approx((1.0 + 2.0 / 3.0) / 3.0)
    assert m5 == pytest.approx((1.0 + 2.0 / 3.0 + 3.0 / 5.0) / 3.0)
    # a query without positives counts 1.0
    vals = tmet.map_at_ks(np.array([0.0, 0.0, 1.0, 0.0]),
                          np.array([1.0, 0.5, 2.0, 0.2]), [2, 2], [1])
    assert vals[0] == pytest.approx(1.0)


def test_ndcg_multi_position_and_all_negative_query():
    y = np.array([3.0, 2.0, 0.0, 0.0, 0.0])
    score = np.array([1.0, 2.0, 0.0, 1.0, 0.5])
    ndcgs = tmet.ndcg_at_ks(y, score, [2, 3], [1, 2])
    d1 = 3.0 / 7.0
    d2 = (3.0 + 7.0 / np.log2(3.0)) / (7.0 + 3.0 / np.log2(3.0))
    assert ndcgs[0] == pytest.approx((d1 + 1.0) / 2)
    assert ndcgs[1] == pytest.approx((d2 + 1.0) / 2)


def test_rank_metrics_match_reference_exactly():
    with open(_GOLDEN) as f:
        G = json.load(f)
    rng2 = np.random.default_rng(7)
    nq, qs = 12, 10
    rng2.normal(0, 1, (nq * qs, 3))  # keep the stream aligned with the goldens
    rel = rng2.integers(0, 3, nq * qs).astype(float)
    group = [qs] * nq
    score = np.array(G["rank_score"])
    nd = tmet.ndcg_at_ks(rel, score, group, [1, 3, 5])
    mp = tmet.map_at_ks(rel, score, group, [1, 3, 5])
    for i, k in enumerate([1, 3, 5]):
        assert nd[i] == pytest.approx(G[f"rank_ndcg@{k}"][-1], abs=1e-12)
        assert mp[i] == pytest.approx(G[f"rank_map@{k}"][-1], abs=1e-12)


def test_lambdarank_label_gain_and_norm():
    rng = np.random.default_rng(0)
    n, q = 40, 4
    label = rng.integers(0, 3, size=n).astype(float)
    group = [10] * q
    score = rng.normal(size=n)
    out = {}
    for key, kw in (("base", dict(norm=False)), ("normed", dict(norm=True)),
                    ("custom", dict(norm=False,
                                    label_gain=[0.0, 1.0, 10.0]))):
        t = tobj.LambdaRank(**kw)
        j = jobj.LambdaRank(**kw)
        t.init(label, None, group=group)
        j.init(label, None, group=group)
        out[key] = t.get_gradients(score)
        gj, hj = j.get_gradients(score)
        np.testing.assert_allclose(out[key][0], gj, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(out[key][1], hj, rtol=1e-12)
    # normalisation shrinks the per-query lambdas (log2(1 + s) / s < 1)
    assert np.sum(np.abs(out["normed"][0])) < np.sum(np.abs(out["base"][0]))
    assert not np.allclose(out["custom"][0], out["base"][0])


def test_lambdarank_blocks_of_queries_give_the_same_bits(monkeypatch):
    """Queries of unequal sizes (a single-row query, one without a relevant
    row), each padded to its own ladder length, in one block a length or
    split into many: the same lambdas to the bit, and the JAX package's."""
    rng = np.random.default_rng(4)
    group = np.array([1, 7, 15, 3, 9, 4, 16, 10])
    label = rng.integers(0, 4, group.sum()).astype(float)
    label[1:8] = 0.0
    score = rng.normal(size=group.sum())
    one = tobj.LambdaRank(truncation_level=5)
    one.init(label, None, group=group)
    monkeypatch.setattr(tobj, "RANK_BLOCK_PAIRS", 300)
    many = tobj.LambdaRank(truncation_level=5)
    many.init(label, None, group=group)
    # the two pairless queries are left out; 15 and 16 pad to 16, 9 and 10
    # to 10, 3 and 4 stay: one block a length, or more under the budget
    assert [tobj.rank_pad_length(k) for k in (1, 8, 9, 14, 100, 1250)] == [
        1, 8, 10, 14, 112, 1280]
    assert [tuple(b["valid_t"].shape) for b in one._blocks] == [
        (1, 3), (1, 4), (2, 10), (2, 16)]
    assert len(many._blocks) > len(one._blocks)
    assert one.padded_pairs() == (9 + 16 + 200 + 512,
                                  9 + 16 + 81 + 100 + 225 + 256)
    g1, h1 = one.get_gradients(score)
    g2, h2 = many.get_gradients(score)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(h1, h2)
    assert np.all(g1[:8] == 0.0)          # no pair in those queries
    j = jobj.LambdaRank(truncation_level=5)
    j.init(label, None, group=group)
    gj, hj = j.get_gradients(score)
    np.testing.assert_allclose(g1, gj, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(h1, hj, rtol=1e-12)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_training_as_jax(objective):
    """Eight rounds with a validation set scored by ndcg and map at three
    positions: the same trees (scores 1e-10) and metric curves (1e-12)."""
    X, rel, group = _rank_data()
    params = {"objective": objective, "num_leaves": 7, "min_data_in_leaf": 5,
              "verbose": -1, "metric": ["ndcg", "map"], "eval_at": [1, 3, 5]}
    ev_j, ev_t = {}, {}
    jd = gpb.Dataset(X, label=rel, group=group)
    jv = gpb.Dataset(X[:120], label=rel[:120], group=group[:10],
                     reference=jd)
    jb = gpb.train(params, jd, num_boost_round=8, valid_sets=[jv],
                   evals_result=ev_j, verbose_eval=False)
    td = gpt.Dataset(X, label=rel, group=group, device="cpu")
    tv = gpt.Dataset(X[:120], label=rel[:120], group=group[:10],
                     reference=td, device="cpu")
    tb = gpt.train(params, td, num_boost_round=8, valid_sets=[tv],
                   evals_result=ev_t, verbose_eval=False)
    np.testing.assert_allclose(tb._score, np.asarray(jb._score), rtol=0,
                               atol=1e-10)
    assert set(ev_t["valid_0"]) == set(ev_j["valid_0"]) == {
        "ndcg@1", "ndcg@3", "ndcg@5", "map@1", "map@3", "map@5"}
    for key, curve in ev_j["valid_0"].items():
        np.testing.assert_allclose(ev_t["valid_0"][key], curve, rtol=0,
                                   atol=1e-12)
    # lambdarank learns the ranking (test_boosting_variants.py)
    if objective == "lambdarank":
        assert tmet.ndcg_at_ks(rel, tb.predict(X), group, [5])[0] > 0.9


def test_rank_xendcg_trains_and_improves_ndcg():
    X, rel, group = _rank_data(seed=5)
    ds = gpt.Dataset(X, label=rel, group=group, device="cpu")
    evals = {}
    bst = gpt.train({"objective": "rank_xendcg", "metric": "ndcg",
                     "min_data_in_leaf": 5, "verbose": -1,
                     "learning_rate": 0.2}, ds, num_boost_round=12,
                    valid_sets=[gpt.Dataset(X, label=rel, group=group,
                                            reference=ds, device="cpu")],
                    evals_result=evals, verbose_eval=False)
    # ndcg reports every default eval_at position (rank_metric.hpp)
    assert set(evals["valid_0"]) == {f"ndcg@{k}" for k in range(1, 6)}
    curve = evals["valid_0"]["ndcg@5"]
    assert curve[-1] > curve[0]
    # distinct from lambdarank (other lambdas)
    bst2 = gpt.train({"objective": "lambdarank", "min_data_in_leaf": 5,
                      "verbose": -1, "learning_rate": 0.2},
                     gpt.Dataset(X, label=rel, group=group, device="cpu"),
                     num_boost_round=5)
    assert not np.allclose(bst.predict(X, raw_score=True)[:50],
                           bst2.predict(X, raw_score=True)[:50])


def test_group_in_a_binary_file(tmp_path):
    """``group`` goes into a ``.bin`` file and comes back, in both
    packages' files; ``set_group`` / ``get_group`` as in the JAX package."""
    X, rel, group = _rank_data(nq=6, per=10)
    td = gpt.Dataset(X, label=rel, group=group, device="cpu")
    td.save_binary(str(tmp_path / "port.bin"))
    back = gpt.Dataset(str(tmp_path / "port.bin"), device="cpu")
    np.testing.assert_array_equal(back.get_group(), group)
    jd = gpb.Dataset(str(tmp_path / "port.bin"))
    np.testing.assert_array_equal(jd.get_group(), group)
    gpb.Dataset(X, label=rel, group=group).save_binary(
        str(tmp_path / "jax.bin"))
    from_jax = gpt.Dataset(str(tmp_path / "jax.bin"), device="cpu")
    np.testing.assert_array_equal(from_jax.get_group(), group)
    # a group given beside the file wins, as in the JAX package
    other = gpt.Dataset(str(tmp_path / "jax.bin"), group=[30, 30],
                        device="cpu")
    np.testing.assert_array_equal(other.get_group(), [30, 30])
    td.set_group([20, 40])
    np.testing.assert_array_equal(td.get_group(), [20, 40])
    with pytest.raises(ValueError, match="group"):
        gpt.train({"objective": "lambdarank", "verbose": -1},
                  gpt.Dataset(X, label=rel, device="cpu"), num_boost_round=1)
