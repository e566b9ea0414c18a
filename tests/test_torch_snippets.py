"""Snippets in wiser_tpu_torch against wiser_tpu: the highlighter (the
test_highlighter.py cases and random offset tables, string for string),
the doc stores (a store either package wrote read by the other, with the
LZ4 and the zlib codec) and the engines: TorchEngine(doc_bodies=) on raw
and tc columns and StagedEngine(doc_bodies=) at budget 0 and full, whose
(doc, f64 score, snippet) lists must equal TpuEngine's, the JAX
StagedEngine's and the OracleEngine's. The queries reach every route
that finalizes results: the single-term impact table, bs, the pruned
dense scan with its rescue, semidense, the list-chain, compact and
semidense phrase routes, the full-scan and block-pruned mega phrase with
their rescue, the host merge, the host phrase search, the guard's host
fallback, the long tail, and the staged hot, cold (host and device) and
saturated paths. A batch that holds one query with and without
return_snippets gets snippets only where they were asked for.
"""

import dataclasses

import numpy as np
import pytest

import wiser_tpu.engine.staged as JS
import wiser_tpu.index.doc_store as j_store
import wiser_tpu_torch.engine.staged as TS
import wiser_tpu_torch.index.doc_store as store
from wiser_tpu.data.synth import make_docinfo, synth_docinfos
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.highlighter import SimpleHighlighter as JHighlighter
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import StagedEngine, TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.staged import full_residency_bytes
from wiser_tpu_torch.highlighter import SimpleHighlighter, _BreakIterator
from wiser_tpu_torch.types import SearchQuery


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def triples(results):
    return [[(e.doc_id, e.doc_score, e.snippet) for e in r.entries]
            for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase,
                   return_snippets=q.return_snippets,
                   n_snippet_passages=q.n_snippet_passages) for q in qs]


def three_way(te, je, oracle, qs, jax_too=None, jax_unsnipped=None):
    """te's triples equal the oracle's, and je's on the queries jax_too
    selects (all by default); on those jax_unsnipped selects, je leaves
    the snippets empty and only (doc, score) is compared."""
    got = triples(te.search_batch(qs))
    assert got == triples(oracle.search(q) for q in jq(qs))
    keep = [i for i, q in enumerate(qs) if jax_too is None or jax_too(q)]
    want = triples(je.search_batch(jq([qs[i] for i in keep])))
    for i, w in zip(keep, want):
        if jax_unsnipped is not None and jax_unsnipped(qs[i]):
            assert [e[:2] for e in got[i]] == [e[:2] for e in w]
            assert not any(e[2] for e in w)
        else:
            assert got[i] == w
    n = sum(bool(r) and q.return_snippets for q, r in zip(qs, got))
    assert n > len(qs) // 4
    assert all("<b>" in e[2] for q, r in zip(qs, got) if q.return_snippets
               for e in r)
    assert not any(e[2] for q, r in zip(qs, got) if not q.return_snippets
                   for e in r)
    return got


def snippeted(term_lists, ks=(3, 10), phrase=False):
    """Every other query asks for 1-3 snippet passages."""
    qs = []
    for i, terms in enumerate(term_lists):
        for k in ks:
            qs.append(SearchQuery(list(terms), n_results=k, is_phrase=phrase,
                                  return_snippets=(i + k) % 2 == 0,
                                  n_snippet_passages=1 + i % 3))
    return qs


# -- the highlighter -----------------------------------------------------------


HIGHLIGHT_CASES = [
    ([[(6, 10)]], 3, "hello world. goodbye moon."),
    ([[(0, 4)], [(11, 15)]], 3, "alpha beta gamma. delta."),
    ([[(0, 0), (7, 7), (14, 14), (23, 23)]], 2, "t one. t two. t three. t four."),
    ([], 3, "doc"),
    ([[], [(2, 3)]], 1, "a bc d. e"),
    ([[(0, 2)]], 3, "abc"),
]


@pytest.mark.parametrize("case", range(len(HIGHLIGHT_CASES)))
def test_highlighter_cases_equal_the_jax_package(case):
    table, n, doc = HIGHLIGHT_CASES[case]
    got = SimpleHighlighter().highlight(table, n, doc)
    assert got == JHighlighter().highlight(table, n, doc)
    if case == 0:
        assert "<b>world<\\b>" in got and got.startswith("hello")
    elif case == 1:
        assert "<b>alpha<\\b>" in got and "<b>gamma<\\b>" in got
    elif case == 2:
        assert got.count("<b>") == 2  # two passages survive
    elif case == 3:
        assert got == ""


def test_break_iterator():
    doc = "First one. Second two. Third three."
    b = _BreakIterator(doc)
    assert b.next_containing(0)
    assert doc[b.startoffset : b.endoffset + 1] == "First one."
    assert b.next_containing(12)
    assert doc[b.startoffset : b.endoffset + 1] == " Second two."
    b = _BreakIterator("no periods here at all")
    assert b.next_containing(3) and b.endoffset == 21
    assert not b.next_containing(22)


def test_random_offset_tables_equal_the_jax_package():
    rng = np.random.default_rng(5)
    for _ in range(200):
        words = [f"w{rng.integers(6)}" + ("." if rng.random() < 0.15 else "")
                 for _ in range(int(rng.integers(1, 40)))]
        doc = " ".join(words)
        starts = np.cumsum([0] + [len(w) + 1 for w in words[:-1]])
        table = []
        for _ in range(int(rng.integers(1, 4))):
            pick = np.sort(rng.choice(len(words), int(rng.integers(0, 6)),
                                      replace=True))
            table.append([(int(starts[j]), int(starts[j] + len(words[j]) - 1))
                          for j in np.unique(pick)])
        n = int(rng.integers(1, 4))
        assert SimpleHighlighter().highlight(table, n, doc) == \
            JHighlighter().highlight(table, n, doc)


# -- the doc stores ------------------------------------------------------------


def _bodies(n=500):
    rng = np.random.default_rng(0)
    docs = [f"doc {i} " + " ".join(f"w{rng.integers(0, 50)}"
                                   for _ in range(int(rng.integers(1, 200))))
            for i in range(n)]
    docs[3] = ""
    docs[7] = "naïve café — 搜索引擎 🚀"
    return docs


@pytest.mark.parametrize("codec", ["lz4", "zlib"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunked_store_both_ways(tmp_path, monkeypatch, writer, codec):
    """A store either package writes reads back in both, through the LRU
    chunk pool and LazyDocBodies; big chunks start 4 KB-aligned."""
    if codec == "zlib":
        def no_lz4(data):
            raise RuntimeError("no compiler")

        monkeypatch.setattr(store.native, "lz4_compress", no_lz4)
        monkeypatch.setattr(j_store.native, "available", lambda: False)
    docs = _bodies()
    mod = store if writer == "port" else j_store
    w = mod.ChunkedDocStoreWriter(str(tmp_path / "s"))
    assert [w.add(d) for d in docs] == list(range(len(docs)))
    w.close()
    readers = (store.ChunkedDocStoreReader(str(tmp_path / "s"), pool_size=4),
               j_store.ChunkedDocStoreReader(str(tmp_path / "s")))
    for r in readers:
        assert r.codec == codec and r.n_docs == len(docs)
        order = np.random.default_rng(1).permutation(len(docs))
        assert [r.get(int(i)) for i in order] == [docs[i] for i in order]
        for off, clen in zip(r.chunk_file_off, r.chunk_comp_len):
            assert clen <= 3 * 1024 or off % 4096 == 0
    lazy = store.LazyDocBodies(readers[0])
    assert len(lazy) == len(docs) and lazy[np.int64(7)] == docs[7]
    for r in readers:
        r.close()


@pytest.mark.parametrize("codec", ["lz4", "zlib"])
def test_compressed_store_and_codec_bytes(monkeypatch, codec):
    raw = " ".join(_bodies(50)).encode()
    assert store.native.lz4_compress(raw) == j_store.native.lz4_compress(raw)
    if codec == "zlib":
        monkeypatch.setattr(store.native, "lz4_compress",
                            lambda d: (_ for _ in ()).throw(RuntimeError()))
    s = store.CompressedDocStore()
    for i, body in enumerate(_bodies(20)):
        s.add(i * 3, body)
    assert s.size() == 20 and s.get(21) == _bodies(20)[7]
    assert s._blobs[0][2] == codec
    s.remove(0)
    assert not s.has(0) and s.has(3)
    with pytest.raises(RuntimeError):
        store.native.lz4_decompress(b"\xf0", 10)


# -- the engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def synth():
    """test_engine_parity.py's corpus (300 docs, blooms)."""
    jp, oracle = build_index(synth_docinfos(n_docs=300, vocab_size=120,
                                            mean_len=40, seed=7),
                             with_blooms=True)
    return jp, to_port(jp), oracle


@pytest.fixture(scope="module")
def heads():
    """The flat head-term corpus of test_torch_tc.py (h0..h2 dense at the
    default floor over 1600 docs), with blooms."""
    rng = np.random.default_rng(23)
    docs = []
    for _ in range(1600):
        toks = [t for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7))
                if rng.random() < p]
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


def pair(jp, port, oracle, columns, over=None, **kw):
    te = TorchEngine(port, device="cpu", columns=columns,
                     doc_bodies=oracle.doc_bodies, **kw)
    je = TpuEngine(jp, columns=columns, doc_bodies=oracle.doc_bodies, **kw)
    for e in (te, je):
        for k, v in (over or {}).items():
            setattr(e, k, v)
    return te, je


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_resident_host_and_list_routes(synth, columns):
    """Single terms (table and deep k), bs, the list chain, the host merge
    and host phrase search (thresholds lowered) and the long tail (> 8
    terms: the oracle only, TpuEngine cannot run it)."""
    jp, port, oracle = synth
    te, je = pair(jp, port, oracle, columns,
                  over=dict(HOST_MERGE_MIN_L=512, PHRASE_MAX_L=64))
    by_df = [jp.terms[r] for r in np.argsort(-jp.df, kind="stable")]
    qs = snippeted([[by_df[0]], [by_df[40]]], ks=(5, 100))
    qs += snippeted([[by_df[0], by_df[1]], [by_df[2], by_df[50]],
                     [by_df[60], by_df[61], by_df[70]], [by_df[80], by_df[3]]])
    qs += snippeted([[by_df[0], by_df[1]], [by_df[30], by_df[31]],
                     [by_df[5], by_df[45]], [by_df[45], by_df[5]],
                     ["t0", "t1", "t2"]], phrase=True)
    qs += snippeted([by_df[:9]], ks=(10,))
    three_way(te, je, oracle, qs, jax_too=lambda q: len(q.terms) <= 8)
    st = te.stats_take()
    for route in ("single_table", "bs", "host_merge", "phrase_host",
                  "phrase_list", "long_tail"):
        assert st.get(f"route_{route}", 0) > 0, route


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_guard_fallback(columns):
    """margin 0 over a 150-doc exact tie class: the truncated class reaches
    the k-th place, so the rows take the exact host path after the
    device finalize (tie_class_cut)."""
    docs = [make_docinfo("a b c. d".split()) for _ in range(150)]
    docs += [make_docinfo(["a", "b"] + ["f"] * (5 + i % 4)) for i in range(80)]
    jp, oracle = build_index(docs)
    te, je = pair(jp, to_port(jp), oracle, columns, margin=0,
                  single_term_depth=0, dense_budget_bytes=0)
    qs = snippeted([["a", "b"], ["b", "a", "c."], ["a"]], ks=(1, 3, 10))
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["forced_host_tie_cut"] > 0 and st["host_fallback_q"] > 0


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_dense_and_mega_routes(heads, columns):
    """The pruned dense scan with its rescue, semidense, the compact and
    semidense phrase routes, and the full-scan then the block-pruned mega
    phrase with their rescue, on a 13-block doc space."""
    jp, port, oracle = heads
    te, je = pair(jp, port, oracle, columns, over=dict(
        PRUNED_DENSE_MIN_NB=8, PRUNED_DENSE_C=4, PRUNED_PHRASE_C=4,
        PHRASE_MAX_L=64, PRUNED_PHRASE_KV=16))
    assert te._dense_H == je._dense_H == 3
    qs = snippeted([["h0", "h1"], ["h1", "h2", "h0"], ["r5", "h1"],
                    ["h2", "r9", "h0"], ["r3", "r7"]])
    phrases = snippeted([["h0", "h1"], ["h1", "h2"], ["h0", "h1", "h2"],
                         ["r5", "h1"], ["h2", "r9"], ["r3", "r7"]],
                        phrase=True)
    three_way(te, je, oracle, qs + phrases)
    st = te.stats_take()
    for route in ("pruned", "semidense", "phrase_full", "phrase_semidense",
                  "phrase_compact"):
        assert st.get(f"route_{route}", 0) > 0, route
    assert st["prune_rescued"] > 0
    for e in (te, je):
        e.FULL_PHRASE_SCAN = False
    three_way(te, je, oracle, phrases[:6])
    assert te.stats_take()["route_phrase_pruned"] > 0


def test_coalesced_duplicates_keep_their_own_snippets(synth):
    """The coalescing key carries return_snippets and n_snippet_passages:
    one query with and without snippets in a batch gets them only where
    it asked, and the passage count is its own."""
    jp, port, oracle = synth
    te, je = pair(jp, port, oracle, "raw")
    qs = []
    for terms in (["t0"], ["t0", "t1"], ["t3", "t1", "t2"]):
        for phrase in (False, True):
            base = dict(n_results=5, is_phrase=phrase)
            qs += [SearchQuery(list(terms), **base),
                   SearchQuery(list(terms), return_snippets=True, **base),
                   SearchQuery(list(terms), **base),
                   SearchQuery(list(terms), return_snippets=True,
                               n_snippet_passages=1, **base),
                   SearchQuery(list(terms), return_snippets=True, **base)]
    got = three_way(te, je, oracle, qs)
    for i in range(0, len(qs), 5):
        assert [d for d, _, _ in got[i]] == [d for d, _, _ in got[i + 1]]
        assert got[i + 1] == got[i + 4]
    assert te.stats_take()["q_coalesced"] == 2 * 6


@pytest.fixture(scope="module")
def staged_corpus():
    jp, oracle = build_index(
        synth_docinfos(n_docs=500, vocab_size=120, mean_len=35, seed=33),
        with_blooms=True)
    return jp, to_port(jp), oracle


def _staged_queries(jp):
    by_df = [jp.terms[r] for r in np.argsort(-jp.df, kind="stable")]
    return (snippeted([[by_df[0]], [by_df[70]]], ks=(5, 100))
            + snippeted([[by_df[0], by_df[1]], [by_df[2], by_df[50]],
                         [by_df[60], by_df[61], by_df[70]]])
            + snippeted([[by_df[0], by_df[1]], [by_df[4], by_df[40]],
                         ["t0", "t1", "t2"]], phrase=True))


@pytest.mark.parametrize("cold", ["device", "host"])
@pytest.mark.parametrize("full", [False, True])
def test_staged_hot_cold_and_saturated(staged_corpus, monkeypatch, cold, full):
    """Budget 0 (every query cold but the impact table's; multi-term
    queries over df > 100 saturated) and the full-residency budget (every
    query hot), on the device and the host cold path."""
    jp, port, oracle = staged_corpus
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "COLD_L_BUCKETS", [1024] + mod.COLD_L_BUCKETS)
        monkeypatch.setattr(mod, "COLD_L_MAX_MULTI", 100)
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", cold)
    budget = full_residency_bytes(port) if full else 0
    te = StagedEngine(port, budget, device="cpu", doc_bodies=oracle.doc_bodies)
    je = JS.StagedEngine(jp, budget, doc_bodies=oracle.doc_bodies)
    qs = _staged_queries(jp)

    def saturated(q):
        # the JAX staged engine fills no snippets on its saturated path
        # (a gap in the reference); the port does, as the oracle
        dfs = [int(jp.df[jp.lookup(t)]) for t in q.terms]
        return (not full and cold == "device" and len(dfs) > 1
                and min(dfs) > 100)

    three_way(te, je, oracle, qs, jax_unsnipped=saturated)
    st = te.stats_take()
    assert st["route_single_table"] > 0
    if full:
        assert te.hot_fraction == 1.0
        assert not any(k.startswith("route_cold") for k in st)
    elif cold == "device":
        assert st["route_cold_sat_host"] > 0
        assert st["route_cold_phrase"] > 0 and st["cold_chunks"] > 0
    else:
        assert st["route_cold_host"] > 0
    # a cold answer is memoized (host path) or shared by coalesced keys:
    # the same query without snippets stays without them
    again = te.search_batch([dataclasses.replace(q, return_snippets=False)
                             for q in qs])
    assert not any(e.snippet for r in again for e in r.entries)
