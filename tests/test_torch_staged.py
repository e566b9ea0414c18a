"""The port's StagedEngine against wiser_tpu's StagedEngine (same budget,
same cold transport, device cold path) and OracleEngine: identical
(doc, f64 score) lists and the same hot/cold split, at budget 0 and a
partial budget, packed and raw cold transport, with PACK_WIDTH = 4 so
runs spill into the raw scratch segment, and at a budget that admits
dense head-term rows. The port serves its own copy of each index
(convert.packed_from_arrays)."""

import dataclasses

import numpy as np
import pytest

import wiser_tpu.engine.staged as JS
import wiser_tpu_torch.engine.staged as TS
from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch.convert import packed_from_arrays


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.fixture(scope="module")
def corpus():
    docs = synth_docinfos(n_docs=500, vocab_size=120, mean_len=35, seed=33)
    return build_index(docs, with_blooms=True)


@pytest.fixture
def device_cold(monkeypatch):
    monkeypatch.setattr(JS.StagedEngine, "COLD_COMPUTE", "device")
    monkeypatch.setattr(TS.StagedEngine, "COLD_COMPUTE", "device")


def queries(packed, n=60, seed=4):
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        rows = rng.integers(0, packed.n_terms, size=int(rng.integers(1, 5)))
        qs.append(SearchQuery([packed.terms[r] for r in rows],
                              n_results=int(rng.integers(1, 12))))
    # head-term conjunctions and deep single terms (past the impact table)
    by_df = np.argsort(packed.df)[::-1]
    qs += [SearchQuery([packed.terms[by_df[i]], packed.terms[by_df[j]]],
                       n_results=10) for i, j in ((0, 1), (2, 9), (5, 40))]
    qs += [SearchQuery([packed.terms[by_df[0]]], n_results=100)]
    return qs


def _three_way(packed, oracle, te, je):
    qs = queries(packed)
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert sum(map(len, got)) > 100


@pytest.mark.parametrize("cold_transfer", ["packed", "raw"])
@pytest.mark.parametrize("budget_div", [0, 4])  # budget 0 / ~25% hot
def test_device_cold_three_way(corpus, device_cold, budget_div, cold_transfer):
    packed, oracle = corpus
    budget = packed.n_postings * 12 // budget_div if budget_div else 0
    te = TS.StagedEngine(to_port(packed), budget, device="cpu",
                         cold_transfer=cold_transfer)
    je = JS.StagedEngine(packed, budget, cold_transfer=cold_transfer)
    np.testing.assert_array_equal(te.hot_mask, je.hot_mask)
    np.testing.assert_array_equal(te.phrase_hot_mask, je.phrase_hot_mask)
    assert te.hot_bytes_used == je.hot_bytes_used
    assert (te.hot_fraction == 0.0) == (budget == 0)
    assert 0.0 <= te.hot_fraction < 1.0
    _three_way(packed, oracle, te, je)
    st = te.stats_take()
    assert st["route_cold_device"] > 0
    if cold_transfer == "packed":
        assert st["cold_packed_blocks"] > 0


def test_pack_width_4_spills_to_raw_segment(corpus, device_cold, monkeypatch):
    packed, oracle = corpus
    monkeypatch.setattr(JS, "PACK_WIDTH", 4)
    monkeypatch.setattr(TS, "PACK_WIDTH", 4)
    budget = packed.n_postings * 12 // 4
    te = TS.StagedEngine(to_port(packed), budget, device="cpu", cold_transfer="packed")
    je = JS.StagedEngine(packed, budget, cold_transfer="packed")
    np.testing.assert_array_equal(te._pack16, je._pack16)
    assert te._pack16.any() and not te._pack16.all()
    _three_way(packed, oracle, te, je)
    st = te.stats_take()
    assert st["cold_raw_postings"] > 0 and st["cold_packed_blocks"] > 0


def test_host_cold_compute_default(corpus):
    """The default cold backend stays the memoized exact host search."""
    packed, oracle = corpus
    assert TS.StagedEngine.COLD_COMPUTE == JS.StagedEngine.COLD_COMPUTE == "host"
    te = TS.StagedEngine(to_port(packed), 0, device="cpu")
    _three_way(packed, oracle, te, JS.StagedEngine(packed, 0))
    assert te.stats_take()["route_cold_host"] > 0


def test_many_cold_chunks(corpus, device_cold, monkeypatch):
    """A small chunk limit splits one batch's cold set into many staged
    scratch chunks (each its own decode)."""
    packed, oracle = corpus
    monkeypatch.setattr(TS, "CHUNK_LIMIT", 8192 + 3000)
    te = TS.StagedEngine(to_port(packed), 0, device="cpu")
    qs = queries(packed)
    assert lists(te.search_batch(qs)) == lists(oracle.search(q) for q in qs)
    assert te.stats_take()["cold_chunks"] > 3


def test_more_than_eight_terms_cold(corpus, device_cold):
    """Cold long-tail queries run with the exact slot count (the oracle is
    the reference: the JAX staged engine's 8-slot cold arrays cannot hold
    them)."""
    packed, oracle = corpus
    te = TS.StagedEngine(to_port(packed), 0, device="cpu")
    by_df = np.argsort(packed.df)[::-1]
    qs = [SearchQuery([packed.terms[r] for r in by_df[:n]], n_results=10)
          for n in (9, 11)]
    got = lists(te.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert any(got)


@pytest.mark.parametrize("split", [False, True])
def test_per_term_device_cost_matches(corpus, split):
    packed, _ = corpus
    got = TS.per_term_device_cost(to_port(packed), split=split)
    want = JS.per_term_device_cost(packed, split=split)
    for a, b in zip(got if split else [got], want if split else [want]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def head_corpus():
    """Three head terms (df > 1024) over 1600 docs: dense-eligible."""
    rng = np.random.default_rng(17)
    docs = []
    for _ in range(1600):
        toks = [t for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7))
                if rng.random() < p]
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        docs.append(make_docinfo(toks, with_blooms=False))
    return build_index(docs)


@pytest.mark.parametrize("frac", [0.5, 0.9])
def test_dense_rows_at_a_partial_budget(head_corpus, device_cold, frac):
    """A fraction of the full-residency bytes admits dense rows: the hot,
    phrase-hot and dense masks equal the JAX engine's at the same budget,
    head terms are served dense-only while their runs are cold, and the
    results equal both references."""
    packed, oracle = head_corpus
    port = to_port(packed)
    total = TS.full_residency_bytes(port)
    budget = int(total * frac)
    te = TS.StagedEngine(port, budget, device="cpu")
    je = JS.StagedEngine(packed, budget)
    assert te.total_full == total
    for mask in ("hot_mask", "phrase_hot_mask", "dense_mask"):
        np.testing.assert_array_equal(getattr(te, mask), getattr(je, mask))
    assert te.dense_mask.any() and te.hot_bytes_used == je.hot_bytes_used
    assert (te.dense_mask & ~te.hot_mask).any()  # dense-only head terms
    by_df = np.argsort(packed.df)[::-1]
    heads = [packed.terms[r] for r in by_df[:3]]
    qs = queries(packed, seed=11)
    qs += [SearchQuery(heads[:n], n_results=k) for n in (2, 3) for k in (3, 10)]
    qs += [SearchQuery([heads[0], packed.terms[by_df[j]]], n_results=10)
           for j in (5, 30, 90)]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    assert st.get("hot_route_dense", 0) + st.get("hot_route_semidense", 0) > 0


def test_phrase_query_raises(corpus):
    """A phrase query does not raise: at budget 0 the staged engine
    answers it (cold, memoized exact host phrase search) beside a term
    query and the AND query over the same terms, as the JAX staged engine
    and the oracle do."""
    packed, oracle = corpus
    te = TS.StagedEngine(to_port(packed), 0, device="cpu")
    je = JS.StagedEngine(packed, 0)
    qs = [SearchQuery(["t0"], n_results=3),
          SearchQuery(["t0", "t1"], n_results=3, is_phrase=True),
          SearchQuery(["t0", "t1"], n_results=3)]
    qs += [SearchQuery(list(t), n_results=5, is_phrase=True)
           for t in (("t1", "t0"), ("t2", "t5", "t7"))]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert te.stats_take()["route_cold_host"] == len(qs) - 1
