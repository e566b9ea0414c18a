"""wiser_tpu_torch's ShardedStagedEngine (engine/staged_shard.py) against
wiser_tpu.engine.staged_shard and OracleEngine on the conftest's 8
virtual CPU devices (the port: devices=["cpu"] * 8), mirroring
tests/test_staged_shard.py: the same hot mask under a quarter budget,
identical (doc, f64 score) lists on hot, cold and mixed conjunctions and
phrases, and equal snippets across the tiers.

The deep-k question of the JAX cold path (its merge keeps the local M =
min(L, k + margin) lanes, no M_out): a cold term with 394 postings over
four shards, k = 200. The JAX engine returns 128 results, the oracle
200; the port's cold merge keeps k + margin lanes and equals the
oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.engine.staged import BYTES_PER_POSTING
from wiser_tpu.engine.staged_shard import ShardedStagedEngine as JStaged
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.shard import ShardedIndex
from wiser_tpu_torch.engine.staged_shard import (ShardedStagedEngine,
                                                 full_residency_bytes)
from wiser_tpu_torch.types import SearchQuery


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores, and these
    small-tensor steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def entries(r):
    return [(e.doc_id, e.doc_score, e.snippet) for e in r.entries]


def jq(q):
    return JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase,
                  return_snippets=q.return_snippets)


@pytest.fixture(scope="module")
def setup():
    docs = synth_docinfos(n_docs=500, vocab_size=120, mean_len=35, seed=13)
    jp, oracle = build_index(docs)
    port = to_port(jp)
    # ~25% of posting bytes resident: a real hot / cold split
    budget = int(jp.n_postings) * BYTES_PER_POSTING // 4
    je = JStaged(jp, n_shards=8, hbm_budget_bytes=budget,
                 doc_bodies=oracle.doc_bodies)
    te = ShardedStagedEngine(port, 8, budget, devices=["cpu"] * 8,
                             doc_bodies=oracle.doc_bodies)
    return jp, port, oracle, je, te


def three_way(te, je, oracle, qs):
    got = [entries(r) for r in te.search_batch(qs)]
    assert got == [entries(r) for r in je.search_batch([jq(q) for q in qs])]
    assert got == [entries(oracle.search(jq(q))) for q in qs]
    return got


def test_split_and_hot_mask_equal_jax(setup):
    _, _, _, je, te = setup
    assert 0.0 < te.hot_fraction < 1.0
    np.testing.assert_array_equal(te.hot_mask, je.hot_mask)
    assert te.hot_bytes_used == je.hot_bytes_used
    assert te.hot._dense_H == je.hot._dense_H
    assert te.device_bytes()["total"] > 0


def test_hot_and_cold_parity_mixed_batch(setup):
    jp, port, oracle, je, te = setup
    rng = np.random.default_rng(7)
    hot = [port.terms[r] for r in np.nonzero(te.hot_mask)[0][:20]]
    cold = [port.terms[r] for r in np.nonzero(~te.hot_mask)[0][:20]]
    qs = [SearchQuery([t], n_results=10) for t in hot[:5] + cold[:5]]
    for _ in range(8):
        for a, b in ((hot, hot), (cold, cold), (hot, cold)):
            qs.append(SearchQuery([str(rng.choice(a)), str(rng.choice(b))],
                                  n_results=10))
    qs.append(SearchQuery([str(rng.choice(hot)), str(rng.choice(cold)),
                           str(rng.choice(hot))], n_results=7))
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_hot"] > 0 and st["route_cold"] > 0
    assert st["cold_chunks"] > 0


def test_random_aol_shaped_parity(setup):
    jp, port, oracle, je, te = setup
    rng = np.random.default_rng(29)
    qs = []
    for _ in range(60):
        nt = int(rng.choice([1, 2, 3, 4], p=[0.43, 0.29, 0.20, 0.08]))
        qs.append(SearchQuery([str(t) for t in rng.choice(port.terms, nt,
                                                          replace=False)],
                              n_results=10))
    three_way(te, je, oracle, qs)


def test_phrase_parity_both_tiers(setup):
    jp, port, oracle, je, te = setup
    rng = np.random.default_rng(31)
    qs = [SearchQuery([str(t) for t in rng.choice(port.terms, 2,
                                                  replace=False)],
                      n_results=10, is_phrase=True) for _ in range(12)]
    hot = [port.terms[r] for r in np.nonzero(te.hot_mask)[0][:10]]
    qs += [SearchQuery([a, b], n_results=10, is_phrase=True)
           for a, b in zip(hot, hot[1:])]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["route_cold_phrase_host"] > 0


def test_snippets_cross_tier(setup):
    jp, port, oracle, je, te = setup
    cold = [port.terms[r] for r in np.nonzero(~te.hot_mask)[0][:3]]
    hot = [port.terms[r] for r in np.nonzero(te.hot_mask)[0][:2]]
    qs = [SearchQuery([t], n_results=3, return_snippets=True)
          for t in cold + hot]
    qs.append(SearchQuery(hot[:2], n_results=3, return_snippets=True))
    got = three_way(te, je, oracle, qs)
    assert any(s for rows in got for _, _, s in rows)


def test_deep_k_cold_query_spans_shards(setup):
    """A cold term whose per-shard runs are one 128-lane bucket, k = 200:
    the JAX cold merge stops at 128 results; the port's equals the
    oracle."""
    jp, port, oracle, je, te = setup
    cold = np.nonzero(~te.hot_mask)[0]
    r = int(cold[np.argmax(port.df[cold])])
    assert port.df[r] > 200 and te._lens_sh[:, r].max() == 128
    q = SearchQuery([port.terms[r]], n_results=200)
    want = entries(oracle.search(jq(q)))
    assert len(want) == 200
    assert len(je.search(jq(q)).entries) == 128  # the reference's shortfall
    assert entries(te.search(q)) == want
    # and in a batch beside other cold conjunctions
    others = [SearchQuery([port.terms[int(c)]], n_results=200)
              for c in cold[np.argsort(port.df[cold])[::-1][1:4]]]
    got = te.search_batch([q] + others)
    assert [entries(x) for x in got] == \
        [entries(oracle.search(jq(x))) for x in [q] + others]


def test_full_index_reused_and_budget_base(setup):
    jp, port, oracle, je, te = setup
    full = ShardedIndex.from_packed(port, 8)
    again = ShardedStagedEngine(port, 8, full_residency_bytes(port, 8) // 4,
                                devices=["cpu"] * 8, full=full)
    assert again.full is full
    assert again.total_full == full_residency_bytes(port, 8) == te.total_full
    qs = [SearchQuery([port.terms[r]], n_results=10)
          for r in np.nonzero(~again.hot_mask)[0][:5]]
    assert [entries(r) for r in again.search_batch(qs)] == \
        [entries(oracle.search(jq(q))) for q in qs]
