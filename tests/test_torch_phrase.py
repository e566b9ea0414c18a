"""The resident phrase path of wiser_tpu_torch against wiser_tpu, at the
engine level.

TorchEngine(device="cpu") == TpuEngine == OracleEngine on synth corpora
with blooms, every route spied on: list chain, compact, semidense,
full-scan mega with and without the rescue, and exact host (saturated
and over the lane budget). The host search's bi-bloom gate is held
against the JAX host search with its gate switched off. The step-level
tests are in test_torch_phrase_kernels.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import wiser_tpu.engine.device as JD
import wiser_tpu.engine.staged as JS
import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo, synth_docinfos, synth_query_terms
from wiser_tpu.engine.device import TpuEngine, _PlannedQuery
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import StagedEngine, TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.host import host_exact_search
from wiser_tpu_torch.types import SearchQuery


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase)
            for q in qs]


def pq_group(jp, term_lists, k=5):
    group = []
    for i, terms in enumerate(term_lists):
        rows = [jp.lookup(t) for t in terms]
        pq = _PlannedQuery(i, rows, JQuery(terms, n_results=k, is_phrase=True))
        pq.plan_slots(jp.df)
        group.append(pq)
    return group


def spy(monkeypatch, name):
    calls = []
    orig = getattr(TK, name)

    def wrapped(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(TK, name, wrapped)
    return calls


def spy_host(engine, monkeypatch):
    calls = []
    orig = engine._host_exact

    def wrapped(rows, k, is_phrase=False):
        calls.append((tuple(rows), is_phrase))
        return orig(rows, k, is_phrase)

    monkeypatch.setattr(engine, "_host_exact", wrapped)
    return calls


def three_way(te, je, oracle, qs):
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    return got


@pytest.fixture(scope="module")
def synth():
    """test_engine_parity.py's corpus (300 docs, blooms)."""
    jp, oracle = build_index(synth_docinfos(n_docs=300, vocab_size=120,
                                            mean_len=40, seed=7),
                             with_blooms=True)
    return jp, to_port(jp), oracle


def test_two_and_three_term_phrases(synth, monkeypatch):
    jp, port, oracle = synth
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    match = spy(monkeypatch, "make_match_kernel")
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(30, 30, n_terms=2, seed=13)]
    qs += [SearchQuery(t, n_results=k, is_phrase=True)
           for t in synth_query_terms(10, 20, n_terms=3, seed=3)
           for k in (1, 10)]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 100 and match
    st = te.stats_take()
    assert st["route_phrase_list"] == len({(tuple(q.terms), q.n_results)
                                           for q in qs})


def test_three_term_phrase_small():
    docs = [make_docinfo("x a b c y".split()), make_docinfo("a c b".split()),
            make_docinfo("a b c a b c".split()), make_docinfo("b c a".split())]
    jp, oracle = build_index(docs, with_blooms=True)
    te, je = TorchEngine(to_port(jp), device="cpu"), TpuEngine(jp)
    q = SearchQuery(["a", "b", "c"], n_results=10, is_phrase=True)
    got = three_way(te, je, oracle, [q])
    assert {d for d, _ in got[0]} == {0, 2}


def test_phrase_without_blooms():
    docs = [make_docinfo("p q r".split(), with_blooms=False)] * 3
    jp, oracle = build_index(docs, with_blooms=False)
    te, je = TorchEngine(to_port(jp), device="cpu"), TpuEngine(jp)
    assert te.device_bytes()["blooms"] == je.device_bytes()["blooms"]
    got = three_way(te, je, oracle,
                    [SearchQuery(["p", "q"], n_results=5, is_phrase=True),
                     SearchQuery(["q", "p"], n_results=5, is_phrase=True)])
    assert len(got[0]) == 3 and got[1] == []


@pytest.mark.parametrize("factor", [1, 10, None])
def test_phrase_bloom_factor_sides(factor):
    """One frequent and one rare term: the cost-aware side choice probes
    either side (or none), with identical probes to TpuEngine's."""
    docs = [make_docinfo(("f " * 5).split() + ["r"]) for _ in range(20)]
    docs += [make_docinfo(["f", "other"]) for _ in range(50)]
    docs += [make_docinfo(["r", "f", "x"]) for _ in range(5)]
    jp, oracle = build_index(docs, with_blooms=True)
    te = TorchEngine(to_port(jp), device="cpu", bloom_enable_factor=factor)
    je = TpuEngine(jp, bloom_enable_factor=factor)
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in (["f", "r"], ["r", "f"], ["f", "other"], ["x", "r"],
                    ["x", "other"])]
    three_way(te, je, oracle, qs)
    group = pq_group(jp, [q.terms for q in qs])
    want = je._assemble_bloom_probes(group, 2, 8)
    got = te._assemble_bloom_probes(group, 2, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[3].any() == (factor is not None)


def test_phrase_and_conjunction_over_the_same_terms(synth):
    """The coalescing key and the host memo key carry is_phrase: a phrase
    and an AND query over the same terms in one batch keep their own
    answers."""
    jp, port, oracle = synth
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    pairs = synth_query_terms(12, 20, n_terms=2, seed=21)
    qs = []
    for t in pairs:
        qs += [SearchQuery(t, n_results=10, is_phrase=True),
               SearchQuery(t, n_results=10),
               SearchQuery(t, n_results=10, is_phrase=True)]
    got = three_way(te, je, oracle, qs)
    assert any(got[i] != got[i + 1] for i in range(0, len(qs), 3))
    assert te.stats_take()["q_coalesced"] >= len(pairs)
    # the host memo: a phrase answer never serves the AND query
    rows = [jp.lookup(t) for t in pairs[0]]
    p = te._host_exact(rows, 10, True)
    a = te._host_exact(rows, 10, False)
    assert len(te._host_cache) >= 2
    d, _ = host_exact_search(port, te.cache64, rows, 10, is_phrase=True)
    assert p[0].tolist() == d.tolist() and a[0] is not p[0]


def test_phrase_host_routes(synth, monkeypatch):
    """Saturated candidates (PHRASE_MAX_L lowered) take the exact host
    phrase search, as in TpuEngine."""
    jp, port, oracle = synth
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    for e in (te, je):
        e.PHRASE_MAX_L = 64
    host = spy_host(te, monkeypatch)
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(20, 10, n_terms=2, seed=5)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_phrase_host"] > 0 and host
    assert all(is_phrase for _, is_phrase in host)
    assert st["route_phrase_host"] + st.get("route_phrase_list", 0) == len(
        {tuple(q.terms) for q in qs})


@pytest.fixture(scope="module")
def sd_corpus():
    """test_semidense_phrase.py's corpus: head pair (h0, h1) adjacent only
    sometimes; pure pair (p0, p1) always adjacent when co-present; mid pair
    (m0, m1) below the dense floor."""
    rng = np.random.default_rng(71)
    docs = []
    for i in range(1600):
        toks = [f"r{rng.integers(300)}" for _ in range(rng.integers(4, 9))]
        u = rng.random()
        if u < 0.12:
            toks.insert(rng.integers(len(toks) + 1), "h0")
            toks.insert(rng.integers(len(toks) + 1), "h1")
        elif u < 0.45:
            for _ in range(1 + (rng.random() < 0.2)):
                j = rng.integers(len(toks) + 1)
                toks[j:j] = ["h0", "h1"]
        if rng.random() < 0.004:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["p0", "p1"]
        elif rng.random() < 0.15:
            toks.insert(rng.integers(len(toks) + 1),
                        "p0" if rng.random() < 0.5 else "p1")
        if rng.random() < 0.025:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["m0", "m1"]
        if rng.random() < 0.06:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["h0", "h1", "h2"]
        docs.append(make_docinfo(toks, with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


def _sd_pair(jp, port, monkeypatch, kv=16):
    monkeypatch.setattr(TpuEngine, "DENSE_MIN_DF_FLOOR", 64)
    monkeypatch.setattr(TorchEngine, "DENSE_MIN_DF_FLOOR", 64)
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    for e in (te, je):
        e.PRUNED_PHRASE_KV = kv  # toy candidate lists exceed KV
    return te, je


def test_semidense_head_pair_both_outcomes(sd_corpus, monkeypatch):
    jp, port, oracle = sd_corpus
    te, je = _sd_pair(jp, port, monkeypatch)
    called = spy(monkeypatch, "make_semidense_phrase_kernel")
    qs = [SearchQuery(t, n_results=k, is_phrase=True)
          for t, k in ((["h0", "h1"], 10), (["h1", "h0"], 5),
                       (["h0", "h1", "h2"], 10))]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert called and st["route_phrase_semidense"] == 3
    assert st["flag_prune_miss"] > 0  # the guard decides some


def test_semidense_provable_pair_no_host(sd_corpus, monkeypatch):
    jp, port, oracle = sd_corpus
    te, je = _sd_pair(jp, port, monkeypatch)
    called = spy(monkeypatch, "make_semidense_phrase_kernel")
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle,
              [SearchQuery(["p0", "p1"], n_results=5, is_phrase=True)])
    assert called and not host


def test_non_dense_other_keeps_compact_route(sd_corpus, monkeypatch):
    jp, port, oracle = sd_corpus
    te, je = _sd_pair(jp, port, monkeypatch)
    semi = spy(monkeypatch, "make_semidense_phrase_kernel")
    compact = spy(monkeypatch, "make_compact_phrase_kernel")
    got = three_way(te, je, oracle,
                    [SearchQuery(["m0", "m1"], n_results=5, is_phrase=True),
                     SearchQuery(["r3", "r7"], n_results=5, is_phrase=True)])
    assert got[0] and not semi and compact
    assert te.stats_take()["route_phrase_compact"] >= 1


def test_semidense_mixed_batch_and_zero_matches(sd_corpus, monkeypatch):
    jp, port, oracle = sd_corpus
    te, je = _sd_pair(jp, port, monkeypatch)
    rng = np.random.default_rng(9)
    pool = (["h0", "h1"], ["p0", "p1"], ["m0", "m1"], ["h0", "h1", "h2"],
            ["p1", "p0"], ["h2", "r5"], ["r5", "h1"])
    qs = [SearchQuery(list(pool[rng.integers(len(pool))]),
                      n_results=int(rng.integers(1, 12)), is_phrase=True)
          for _ in range(40)]
    qs.append(SearchQuery(["p1", "p0"], n_results=5, is_phrase=True))
    qs.append(SearchQuery(["h0", "h1"], n_results=5))  # AND, same terms
    got = three_way(te, je, oracle, qs)
    assert got[-2] == []  # co-present, never adjacent
    st = te.stats_take()
    assert st["route_phrase_semidense"] and st["route_phrase_compact"]


@pytest.fixture(scope="module")
def flat_corpus():
    """test_pruned_dense.py's flat head-term corpus, with blooms: the
    mega route's top-KV candidates rarely hold k phrase matches."""
    rng = np.random.default_rng(23)
    docs = []
    for _ in range(1600):
        toks = []
        if rng.random() < 0.9:
            toks.append("h0")
        if rng.random() < 0.8:
            toks.append("h1")
        if rng.random() < 0.7:
            toks.append("h2")
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


@pytest.fixture(scope="module")
def skewed_corpus():
    """The phrase h0 h1 opens every doc; the first two blocks hold
    high-tf short docs, so the top KV candidates prove the top-k."""
    docs = []
    for i in range(1600):
        if i < 256:
            toks = ["h0", "h1"] * 4 + [f"f{j}" for j in range(i % 5)]
        else:
            toks = ["h0", "h1"] + [f"g{i}_{j}" for j in range(28 + i % 7)]
        docs.append(make_docinfo(toks, with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


def _mega_pair(jp, port, **over):
    """Engines with the mega route engaged on a 13-block doc space."""
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    for e in (te, je):
        e.PRUNED_DENSE_MIN_NB = 8
        e.PRUNED_DENSE_C = 4
        e.PRUNED_PHRASE_C = 4
        e.PHRASE_MAX_L = 64
        for k, v in over.items():
            setattr(e, k, v)
    return te, je


MEGA = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h0", "h1", "h2"],
        ["h2", "h1", "h0"])


def test_full_scan_mega_with_rescue(flat_corpus, monkeypatch):
    """A narrow KV cannot certify: the misses re-run on the batch's
    rescue at PRUNED_PHRASE_RETRY_KV, which covers the doc space."""
    jp, port, oracle = flat_corpus
    te, je = _mega_pair(jp, port, PRUNED_PHRASE_KV=16)
    full = spy(monkeypatch, "make_full_phrase_kernel")
    qs = [SearchQuery(t, n_results=10, is_phrase=True) for t in MEGA]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_phrase_full"] == len(qs)
    assert st["flag_prune_miss"] > 0 and st["prune_rescued"] > 0
    assert st["forced_host_after_rescue"] == 0
    # KV, then the rescue's: PRUNED_PHRASE_RETRY_KV capped at N_pad - 1
    assert {a[2] for a in full} == {16, te._n_pad_docs - 1}


def test_full_scan_mega_rescue_then_host(flat_corpus, monkeypatch):
    """A rescue too narrow to certify leaves the exact host phrase path."""
    jp, port, oracle = flat_corpus
    te, je = _mega_pair(jp, port, PRUNED_PHRASE_KV=8,
                        PRUNED_PHRASE_RETRY_KV=16)
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle,
              [SearchQuery(t, n_results=10, is_phrase=True) for t in MEGA])
    st = te.stats_take()
    assert st["forced_host_after_rescue"] > 0
    assert host and all(p for _, p in host)


def test_full_scan_mega_default_kv(flat_corpus, monkeypatch):
    jp, port, oracle = flat_corpus
    te, je = _mega_pair(jp, port)
    full = spy(monkeypatch, "make_full_phrase_kernel")
    three_way(te, je, oracle,
              [SearchQuery(t, n_results=k, is_phrase=True)
               for t in MEGA for k in (1, 10, 37)])
    assert full and full[0][2] == 511  # min(KV, C*128 - 1)


def test_full_scan_mega_provable_no_host(skewed_corpus, monkeypatch):
    jp, port, oracle = skewed_corpus
    te, je = _mega_pair(jp, port)
    full = spy(monkeypatch, "make_full_phrase_kernel")
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle,
              [SearchQuery(["h0", "h1"], n_results=10, is_phrase=True)])
    st = te.stats_take()
    assert full and not host
    assert st.get("flag_prune_miss", 0) == 0 and "prune_rescued" not in st


def test_full_scan_mega_zero_matches(skewed_corpus):
    """h1 h0 only across doc-internal boundaries of repeated pairs in the
    first blocks; elsewhere never: the guard flags, the rescue and then
    the host confirm the exact answer."""
    jp, port, oracle = skewed_corpus
    te, je = _mega_pair(jp, port)
    got = three_way(te, je, oracle,
                    [SearchQuery(["h1", "h0"], n_results=10, is_phrase=True),
                     SearchQuery(["g300_1", "g300_0"], n_results=5,
                                 is_phrase=True)])
    assert got[1] == []


def test_full_scan_mega_mixed_batch(flat_corpus):
    """Mega phrases with AND, dense, semidense and list phrases in one
    batch, duplicates included."""
    jp, port, oracle = flat_corpus
    te, je = _mega_pair(jp, port, PRUNED_PHRASE_KV=16)
    qs = [SearchQuery(["h0", "h1"], n_results=10, is_phrase=True),
          SearchQuery(["h1", "h2"], n_results=3, is_phrase=True),
          SearchQuery(["h0", "h2"], n_results=10),
          SearchQuery(["h0", "r7"], n_results=10),
          SearchQuery(["r7", "h0"], n_results=10, is_phrase=True),
          SearchQuery(["h0", "h1"], n_results=10)]
    qs += qs[:3]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_phrase_full"] == 2 and st["q_coalesced"] == 3


def test_phrase_columns_equal_tpu_engine(flat_corpus, synth):
    """Positions (2-byte bits + POS_PAD pad), pos_starts and the sparse
    folded bloom columns are TpuEngine's, and device_bytes reports them as
    it does."""
    for jp, port, _ in (flat_corpus, synth):
        te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
        assert te.d_positions.dtype == torch.int16
        np.testing.assert_array_equal(te.d_positions.numpy().view(np.uint16),
                                      je._h_positions)
        np.testing.assert_array_equal(te.d_pos_starts.numpy(),
                                      np.asarray(je.d_pos_starts))
        for mine, ref in ((te.d_bloom_rows, je._h_bloom_rows),
                          (te.d_bloom_bitmap, je._h_bloom_bitmap),
                          (te.d_bloom_rank, je._h_bloom_rank)):
            np.testing.assert_array_equal(
                mine.numpy().view(ref.dtype), ref)
        tb, jb = te.device_bytes(), je.device_bytes()
        for fam in ("positions", "blooms", "postings", "dense_tier", "total"):
            assert tb[fam] == jb[fam], fam
        assert tb["positions"] > 0 and tb["blooms"] > 0


def test_last_bags_of_the_positions_column(monkeypatch):
    """The top phrase match holds the last posting bags of the column
    (zz1 sorts last; doc 199 is its last posting and the shortest, top
    scored doc): its verify window starts within PW of the column's end
    and reads right only because of the POS_PAD trailing pad."""
    rng = np.random.default_rng(3)
    docs = []
    for i in range(199):
        toks = [f"f{rng.integers(30)}" for _ in range(rng.integers(6, 12))]
        if i % 2:
            j = int(rng.integers(len(toks) + 1))
            toks[j:j] = ["zz0", "zz1"]
        else:
            toks += ["zz1", "f1", "zz0"]
        docs.append(make_docinfo(toks, with_blooms=True))
    docs.append(make_docinfo(["zz0", "zz1"], with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    assert jp.terms[-1] == "zz1"
    te, je = TorchEngine(to_port(jp), device="cpu"), TpuEngine(jp)
    for e in (te, je):
        e.PRUNED_PHRASE_KV = 4  # the compact route's window verify
    compact = spy(monkeypatch, "make_compact_phrase_kernel")
    host = spy_host(te, monkeypatch)
    got = three_way(te, je, oracle,
                    [SearchQuery(["zz0", "zz1"], n_results=1, is_phrase=True)])
    assert got[0][0][0] == 199 and compact and not host


def test_host_bloom_gate_exact_at_full_depth():
    """test_host_bloom_gate.py: the port's host phrase search (gate always
    on) equals the JAX host search with its gate off, at k = n_docs, and
    the port's search on an index without blooms."""
    docs = synth_docinfos(n_docs=800, vocab_size=100, mean_len=50, seed=5)
    jp, _ = build_index(docs, with_blooms=True)
    port = to_port(jp)
    bare = dataclasses.replace(port, bloom_ends=None, bloom_begins=None)
    cache64 = TorchEngine(port, device="cpu", dense_budget_bytes=0).cache64
    rng = np.random.default_rng(13)
    live = [t for t in jp.terms if jp.df[jp.lookup(t)] > 0]
    old = JD.HOST_BLOOM_GATE
    n = 0
    try:
        JD.HOST_BLOOM_GATE = False
        for _ in range(60):
            terms = list(dict.fromkeys(rng.choice(live, size=2).tolist()))
            if len(terms) < 2:
                continue
            rows = [jp.lookup(t) for t in terms]
            d_off, s_off = JD.host_exact_search(jp, cache64, rows, jp.n_docs,
                                                is_phrase=True)
            for pk in (port, bare):
                d, s = host_exact_search(pk, cache64, rows, jp.n_docs,
                                         is_phrase=True)
                np.testing.assert_array_equal(d, d_off)
                np.testing.assert_array_equal(s, s_off)
            n += d_off.size
    finally:
        JD.HOST_BLOOM_GATE = old
    assert n > 0


def test_staged_engine_still_refuses_phrases(synth):
    """The staged engine answers phrases: at a budget past full residency
    every term is phrase-hot, so the hot engine's phrase routes serve
    them, with the JAX staged engine's and the oracle's answers."""
    jp, port, oracle = synth
    te = StagedEngine(port, 1 << 30, device="cpu")
    je = JS.StagedEngine(jp, 1 << 30)
    assert te.phrase_hot_mask.all()
    qs = [SearchQuery(t, n_results=5, is_phrase=True)
          for t in synth_query_terms(12, 20, n_terms=2, seed=13)]
    qs.append(SearchQuery(["t0", "t1"], n_results=5, is_phrase=True))
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    st = te.stats_take()
    assert st["hot_route_phrase_list"] == len({tuple(q.terms) for q in qs})
    assert not any(k.startswith("route_cold") for k in st)
