"""TorchEngine(columns="tc") and StagedEngine(columns="tc") against
wiser_tpu's tc engines and OracleEngine, at the engine level.

TorchEngine(device="cpu", columns="tc") == TpuEngine(columns="tc") ==
OracleEngine: identical (doc, f64 score) lists, with every route spied
on — bs, dense, pruned with and without the rescue, semidense, the
list-chain, compact and semidense phrase routes and the full-scan mega
phrase with its rescue — and on tests/test_tc_columns.py's saturation
corpus (tf 400 and 300: kept saturated lanes raise FLAG_TF_SAT and take
the exact host path). The host bakes (the tc column, the uint8 tf
plane, the len-code row and the block planes) are byte-equal to
TpuEngine's, postings take at most 0.51 of the raw bytes and a budget
holds more tc dense rows than raw ones. The staged engine's tc cost
model, planner and hot/cold/mixed batches (packed and raw transport,
device cold path) equal JAX's. The step-level tests are in
test_torch_tc_kernels.py.
"""

import dataclasses

import numpy as np
import pytest

import wiser_tpu.engine.staged as JS
import wiser_tpu_torch.engine.kernels as TK
import wiser_tpu_torch.engine.staged as TS
from wiser_tpu.data.synth import make_docinfo, synth_docinfos, synth_query_terms
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.types import SearchQuery


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase)
            for q in qs]


def three_way(te, je, oracle, qs):
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    return got


def spy(monkeypatch, name):
    calls = []
    orig = getattr(TK, name)

    def wrapped(*a, **kw):
        calls.append((a, kw))
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


def pair(jp, port, **kw):
    """TpuEngine and TorchEngine over tc columns with the same options;
    class-level overrides go through kw's `over` dict."""
    over = kw.pop("over", {})
    je = TpuEngine(jp, columns="tc", **kw)
    te = TorchEngine(port, device="cpu", columns="tc", **kw)
    for e in (je, te):
        for k, v in over.items():
            setattr(e, k, v)
    return te, je


# -- corpora -------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth():
    """test_engine_parity.py's corpus (300 docs, blooms)."""
    jp, oracle = build_index(synth_docinfos(n_docs=300, vocab_size=120,
                                            mean_len=40, seed=7),
                             with_blooms=True)
    return jp, to_port(jp), oracle


@pytest.fixture(scope="module")
def heads():
    """test_pruned_dense.py's flat head-term corpus (h0..h2 over 1600
    docs), with blooms: the dense tier, the pruned scan and the mega
    phrase route."""
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


@pytest.fixture(scope="module")
def saturated():
    """tests/test_tc_columns.py's saturation corpus: "mega" 400 times in
    doc 0 and 300 times in doc 1 (tf bytes saturate)."""
    rng = np.random.default_rng(23)
    docs = [make_docinfo(["mega"] * 400 + ["pair"] * 3, with_blooms=True),
            make_docinfo(["mega"] * 300 + ["solo"], with_blooms=True)]
    for _ in range(200):
        toks = (["mega"] * int(rng.integers(1, 4))
                + ["pair"] * int(rng.integers(0, 3))
                + [f"w{rng.integers(40)}" for _ in range(int(rng.integers(4, 12)))])
        docs.append(make_docinfo(toks, with_blooms=True))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


# -- columns, planes and bytes ---------------------------------------------------


def test_host_bakes_and_planes_equal_tpu_engine(heads):
    jp, port, _ = heads
    te, je = pair(jp, port)
    assert te.rel_eps == je.rel_eps == 1e-5
    np.testing.assert_array_equal(te._h_tc, je._h_tc)
    assert te.d_postings_tc.numpy().view(np.uint16).tobytes() == \
        je._h_tc.tobytes()
    np.testing.assert_array_equal(te._h_doc, je._h_doc)
    assert te._dense_H == je._dense_H == 3
    np.testing.assert_array_equal(te._dense_slot, je._dense_slot)
    for mine, ref in ((te.d_dense_tf8, je._h_dense_tf_rows),
                      (te.d_len_code, je._h_len_code),
                      (te.d_dense_blockmax, je._h_dense_blockmax),
                      (te.d_dense_blockmax2, je._h_dense_blockmax2),
                      (te.d_dense_argpos, je._h_dense_argpos)):
        got = mine.numpy()
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    tb, jb = te.device_bytes(), je.device_bytes()
    for fam in ("postings", "positions", "dense_tier", "blooms", "total"):
        assert tb[fam] == jb[fam], fam
    assert te.d_postings_score is None and te.d_postings_tf is None


def test_bytes_halved_and_budget_holds_more_tc_rows(heads):
    jp, port, _ = heads
    raw = TorchEngine(port, device="cpu", dense_budget_bytes=0)
    tc = TorchEngine(port, device="cpu", columns="tc", dense_budget_bytes=0)
    r, t = raw.device_bytes(), tc.device_bytes()
    assert t["postings"] <= 0.51 * r["postings"]
    assert t["total"] < r["total"]
    n_pad = (jp.n_docs + 127) // 128 * 128
    budget = 2 * (n_pad * 8 + (n_pad // 128) * 9)  # two raw rows
    raw = TorchEngine(port, device="cpu", dense_budget_bytes=budget)
    te, je = pair(jp, port, dense_budget_bytes=budget)
    assert raw._dense_H == 2 < te._dense_H == je._dense_H == 3


def test_unknown_columns_mode_raises(synth):
    _, port, _ = synth
    with pytest.raises(ValueError):
        TorchEngine(port, device="cpu", columns="packed")
    with pytest.raises(ValueError):
        TS.StagedEngine(port, 0, device="cpu", columns="packed")


# -- conjunctive routes ------------------------------------------------------------


def test_bs_routes(synth, monkeypatch):
    """1-4-term conjunctions and deep single terms (no impact table):
    the tc bs step at T = 1..4."""
    jp, port, oracle = synth
    te, je = pair(jp, port, single_term_depth=0)
    bs = spy(monkeypatch, "make_search_kernel")
    rng = np.random.default_rng(4)
    qs = [SearchQuery([str(t) for t in rng.choice(jp.terms, int(rng.integers(1, 5)),
                                                  replace=False)],
                      n_results=int(rng.integers(1, 30))) for _ in range(80)]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 300
    assert {a[0] for a, kw in bs if kw.get("mode") == "tc"} >= {1, 2, 3, 4}
    assert te.stats_take()["route_bs"] > 0


def test_long_queries_and_coalescing(synth):
    """More than 8 terms (the exact slot count; the oracle is the
    reference) and duplicates in one batch."""
    jp, port, oracle = synth
    te, _ = pair(jp, port)
    by_df = [jp.terms[r] for r in np.argsort(jp.df)[::-1]]
    qs = [SearchQuery(by_df[i : i + n], n_results=10)
          for i, n in ((0, 9), (1, 11), (2, 3))]
    qs += qs[:2]
    got = lists(te.search_batch(qs))
    assert got == lists(oracle.search(q) for q in jq(qs))
    assert any(got[:2]) and te.stats_take()["q_coalesced"] == 2


HEAD_TERMS = (["h0", "h1"], ["h1", "h2"], ["h0", "h1", "h2"], ["h2", "h0"])


def test_dense_route(heads, monkeypatch):
    """13 doc blocks < PRUNED_DENSE_MIN_NB: all-head queries take the full
    doc-space tc scan."""
    jp, port, oracle = heads
    te, je = pair(jp, port)
    dense = spy(monkeypatch, "make_dense_search_kernel_tc")
    qs = [SearchQuery(t, n_results=k) for t in HEAD_TERMS for k in (1, 5, 37)]
    three_way(te, je, oracle, qs)
    assert dense and te.stats_take()["route_dense"] == len(qs)


def test_pruned_with_rescue(heads, monkeypatch):
    """Flat bounds: the tc prune guard cannot certify; the flagged rows
    re-run on the batched full tc scan."""
    jp, port, oracle = heads
    te, je = pair(jp, port, over=dict(PRUNED_DENSE_C=4, PRUNED_DENSE_MIN_NB=8))
    pruned = spy(monkeypatch, "make_pruned_dense_kernel_tc")
    full = spy(monkeypatch, "make_dense_search_kernel_tc")
    qs = [SearchQuery(t, n_results=10) for t in HEAD_TERMS]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert pruned and full and st["route_pruned"] == len(qs)
    assert st["flag_prune_miss"] > 0 and st["prune_rescued"] > 0
    assert st["forced_host_after_rescue"] == 0


def test_pruned_without_rescue_goes_host(heads, monkeypatch):
    jp, port, oracle = heads
    te, je = pair(jp, port, over=dict(PRUNED_DENSE_C=4, PRUNED_DENSE_MIN_NB=8,
                                      DENSE_RESCUE=False))
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle,
              [SearchQuery(t, n_results=10) for t in HEAD_TERMS[:3]])
    st = te.stats_take()
    assert st["flag_prune_miss"] > 0 and "prune_rescued" not in st and host


def test_semidense_routes(heads, monkeypatch):
    """Tail candidate x dense others, with and without non-dense (bs)
    others: the len code of a dense lane comes from the candidate's tc
    lane."""
    jp, port, oracle = heads
    te, je = pair(jp, port)
    semi = spy(monkeypatch, "make_semidense_kernel_tc")
    qs = [SearchQuery(t, n_results=10) for t in (
        ["r5", "h0"], ["h0", "r5", "h1"], ["r3", "h2", "h0"],
        ["r5", "r9", "h0"], ["h0", "r5", "h1", "r9"], ["r3", "h2", "r7"])]
    three_way(te, je, oracle, qs)
    assert {a[4] for a, _ in semi} >= {0, 1}  # n_bs = 0 and > 0 groups
    assert te.stats_take()["route_semidense"] == len(qs)


def test_mixed_batch_every_conjunctive_route(heads):
    jp, port, oracle = heads
    te, je = pair(jp, port, over=dict(PRUNED_DENSE_C=4, PRUNED_DENSE_MIN_NB=8))
    rng = np.random.default_rng(9)
    vocab = ["h0", "h1", "h2"] + [f"r{i}" for i in range(0, 200, 3)]
    p = np.r_[[0.2] * 3, [0.4 / (len(vocab) - 3)] * (len(vocab) - 3)]
    qs = [SearchQuery([vocab[i] for i in rng.choice(len(vocab),
                                                     size=int(rng.integers(1, 5)),
                                                     replace=False, p=p)],
                      n_results=int(rng.choice([1, 3, 10, 40])))
          for _ in range(120)]
    qs += qs[:20]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 500
    st = te.stats_take()
    assert st["route_pruned"] and st["route_semidense"] and st["route_bs"]


# -- phrase routes -------------------------------------------------------------------


def test_phrase_list_chain(synth, monkeypatch):
    jp, port, oracle = synth
    te, je = pair(jp, port)
    match = spy(monkeypatch, "make_match_kernel_tc")
    select = spy(monkeypatch, "make_select_topk_kernel_tc")
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(30, 30, n_terms=2, seed=13)]
    qs += [SearchQuery(t, n_results=k, is_phrase=True)
           for t in synth_query_terms(10, 20, n_terms=3, seed=3)
           for k in (1, 10)]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 100 and match and select
    assert te.stats_take()["route_phrase_list"] > 0


@pytest.fixture(scope="module")
def sd_corpus():
    """test_semidense_phrase.py's corpus: head pair (h0, h1) adjacent only
    sometimes; pure pair (p0, p1); mid pair (m0, m1) below the dense
    floor."""
    rng = np.random.default_rng(71)
    docs = []
    for _ in range(1600):
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


def sd_pair(jp, port, monkeypatch):
    monkeypatch.setattr(TpuEngine, "DENSE_MIN_DF_FLOOR", 64)
    monkeypatch.setattr(TorchEngine, "DENSE_MIN_DF_FLOOR", 64)
    return pair(jp, port, over=dict(PRUNED_PHRASE_KV=16))


def test_phrase_semidense_and_compact(sd_corpus, monkeypatch):
    jp, port, oracle = sd_corpus
    te, je = sd_pair(jp, port, monkeypatch)
    semi = spy(monkeypatch, "make_semidense_phrase_kernel")
    compact = spy(monkeypatch, "make_compact_phrase_kernel")
    rng = np.random.default_rng(9)
    pool = (["h0", "h1"], ["p0", "p1"], ["m0", "m1"], ["h0", "h1", "h2"],
            ["p1", "p0"], ["h2", "r5"], ["r5", "h1"], ["r3", "r7"],
            ["h1", "h0"])
    qs = [SearchQuery(list(pool[rng.integers(len(pool))]),
                      n_results=int(rng.integers(1, 12)), is_phrase=True)
          for _ in range(40)]
    qs.append(SearchQuery(["h0", "h1"], n_results=5))  # AND, same terms
    got = three_way(te, je, oracle, qs)
    assert any(got)
    assert any(kw.get("mode") == "tc" for _, kw in semi)
    assert any(kw.get("mode") == "tc" for _, kw in compact)
    st = te.stats_take()
    assert st["route_phrase_semidense"] and st["route_phrase_compact"]


def mega_pair(jp, port, **over):
    """Engines with the mega route engaged on a 13-block doc space."""
    return pair(jp, port, over=dict(PRUNED_DENSE_MIN_NB=8, PRUNED_DENSE_C=4,
                                    PRUNED_PHRASE_C=4, PHRASE_MAX_L=64,
                                    **over))


MEGA = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h0", "h1", "h2"],
        ["h2", "h1", "h0"])


def test_full_scan_mega_with_rescue(heads, monkeypatch):
    """A narrow KV cannot certify: the misses re-run at
    PRUNED_PHRASE_RETRY_KV on the tc full scan."""
    jp, port, oracle = heads
    te, je = mega_pair(jp, port, PRUNED_PHRASE_KV=16)
    full = spy(monkeypatch, "make_full_phrase_kernel_tc")
    qs = [SearchQuery(t, n_results=10, is_phrase=True) for t in MEGA]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_phrase_full"] == len(qs)
    assert st["flag_prune_miss"] > 0 and st["prune_rescued"] > 0
    assert st["forced_host_after_rescue"] == 0
    assert {a[2] for a, _ in full} == {16, te._n_pad_docs - 1}


def test_full_scan_mega_default_kv_and_host(heads, monkeypatch):
    """The default KV (min(KV, C * 128 - 1) = 511), and a rescue too
    narrow to certify, which leaves the exact host phrase path."""
    jp, port, oracle = heads
    te, je = mega_pair(jp, port)
    full = spy(monkeypatch, "make_full_phrase_kernel_tc")
    three_way(te, je, oracle,
              [SearchQuery(t, n_results=k, is_phrase=True)
               for t in MEGA for k in (1, 10, 37)])
    assert full and full[0][0][2] == 511
    te, je = mega_pair(jp, port, PRUNED_PHRASE_KV=8,
                       PRUNED_PHRASE_RETRY_KV=16)
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle,
              [SearchQuery(t, n_results=10, is_phrase=True) for t in MEGA])
    assert te.stats_take()["forced_host_after_rescue"] > 0
    assert host and all(p for _, p in host)


# -- saturation ---------------------------------------------------------------------


def test_saturated_single_term(saturated):
    """No impact table, no dense tier: the tc bs step sees the saturated
    lanes."""
    jp, port, oracle = saturated
    te, je = pair(jp, port, single_term_depth=0, dense_budget_bytes=0)
    three_way(te, je, oracle,
              [SearchQuery(["mega"], n_results=k) for k in (1, 3, 10, 50)])
    assert te.stats_take()["flag_tf_sat"] > 0


def test_saturated_pairs_and_phrase(saturated):
    jp, port, oracle = saturated
    te, je = pair(jp, port, single_term_depth=0, dense_budget_bytes=0)
    qs = [SearchQuery(t, n_results=10)
          for t in (["mega", "pair"], ["pair", "mega"], ["mega", "solo"])]
    qs += [SearchQuery(["mega", "pair"], n_results=k, is_phrase=True)
           for k in (1, 10)]
    qs += [SearchQuery(["mega", "mega"], n_results=5, is_phrase=True)]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["flag_tf_sat"] > 0


def test_saturation_flag_forces_host(saturated, monkeypatch):
    """Bit 2 (FLAG_TF_SAT) must reach _flags_to_force and force the exact
    host path for the query that keeps a saturated lane."""
    jp, port, oracle = saturated
    te, je = pair(jp, port, single_term_depth=0, dense_budget_bytes=0)
    seen = []
    orig = te._flags_to_force

    def spy_force(flags, rescue=False):
        force = orig(flags, rescue)
        seen.append((np.asarray(flags), np.asarray(force)))
        return force

    monkeypatch.setattr(te, "_flags_to_force", spy_force)
    host = spy_host(te, monkeypatch)
    three_way(te, je, oracle, [SearchQuery(["mega"], n_results=3)])
    assert any((f & TK.FLAG_TF_SAT).any() and fo.any() for f, fo in seen)
    assert host == [((jp.lookup("mega"),), False)]
    st = te.stats_take()
    assert st["flag_tf_sat"] == st["forced_host"] == 1


# -- the staged engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def staged_corpus():
    docs = synth_docinfos(n_docs=500, vocab_size=120, mean_len=35, seed=33)
    return build_index(docs, with_blooms=True)


@pytest.fixture
def device_cold(monkeypatch):
    monkeypatch.setattr(JS.StagedEngine, "COLD_COMPUTE", "device")
    monkeypatch.setattr(TS.StagedEngine, "COLD_COMPUTE", "device")


@pytest.mark.parametrize("split", [False, True])
def test_staged_cost_model_matches(staged_corpus, split):
    jp, _ = staged_corpus
    got = TS.per_term_device_cost(to_port(jp), "tc", split=split)
    want = JS.per_term_device_cost(jp, "tc", split=split)
    for a, b in zip(got if split else [got], want if split else [want]):
        np.testing.assert_array_equal(a, b)
    raw = TS.per_term_device_cost(to_port(jp), "raw")
    assert (got if not split else got[0] + got[1]).sum() < raw.sum()


def jax_total_full(jp, columns):
    """JAX StagedEngine's full-residency byte count (the planner's local
    total_full, wiser_tpu/engine/staged.py:420-436), from its own cost
    model and TpuEngine's dense-tier constants."""
    core, phr = JS.per_term_device_cost(jp, columns, split=True)
    n_pad = (jp.n_docs + 127) // 128 * 128
    per_row = n_pad * (1 if columns == "tc" else 8) + (n_pad // 128) * 9
    eligible = jp.df >= max(TpuEngine.DENSE_MIN_DF_FLOOR,
                            jp.n_docs // TpuEngine.DENSE_ELIGIBLE_FRACTION)
    h_cap = max(0, (2**31 - 1) // max(n_pad // 128, 1) - 1)
    dense = min(int(eligible.sum()), h_cap) * per_row \
        + (n_pad if columns == "tc" else 0)
    return max(1, dense + int(core.sum()) + int(phr.sum()))


def staged_queries(jp, n=60, seed=4):
    rng = np.random.default_rng(seed)
    qs = [SearchQuery([jp.terms[r] for r in rng.integers(
        0, jp.n_terms, size=int(rng.integers(1, 5)))],
        n_results=int(rng.integers(1, 12))) for _ in range(n)]
    by_df = np.argsort(jp.df)[::-1]
    qs += [SearchQuery([jp.terms[by_df[i]], jp.terms[by_df[j]]],
                       n_results=10) for i, j in ((0, 1), (2, 9), (5, 40))]
    qs += [SearchQuery([jp.terms[by_df[0]]], n_results=100)]
    return qs


@pytest.mark.parametrize("cold_transfer", ["packed", "raw"])
def test_staged_tc_three_way(staged_corpus, device_cold, cold_transfer):
    """A quarter of the tc full-residency bytes: the same hot/cold split
    and planner as JAX, and hot, cold and mixed batches three-way equal
    through the tc hot tier and the tc cold scratch."""
    jp, oracle = staged_corpus
    port = to_port(jp)
    budget = TS.full_residency_bytes(port, "tc") // 4
    te = TS.StagedEngine(port, budget, device="cpu", columns="tc",
                         cold_transfer=cold_transfer)
    je = JS.StagedEngine(jp, budget, columns="tc", cold_transfer=cold_transfer)
    assert te.total_full == jax_total_full(jp, "tc") \
        == TS.full_residency_bytes(port, "tc")
    np.testing.assert_array_equal(te.hot_mask, je.hot_mask)
    np.testing.assert_array_equal(te.phrase_hot_mask, je.phrase_hot_mask)
    assert te.hot_bytes_used == je.hot_bytes_used
    assert 0.0 < te.hot_fraction < 1.0 and te.hot.tc
    qs = staged_queries(jp)
    hot = [q for q in qs if all(te.hot_mask[jp.lookup(t)] for t in q.terms)]
    cold = [q for q in qs if not any(te.hot_mask[jp.lookup(t)]
                                     for t in q.terms)]
    for batch in (hot, cold, qs):
        assert batch
        three_way(te, je, oracle, batch)
    st = te.stats_take()
    assert st["route_cold_device"] > 0 and st["cold_chunks"] > 0
    if cold_transfer == "packed":
        assert st["cold_packed_blocks"] > 0


def test_staged_tc_holds_more_hot_terms(staged_corpus):
    """test_tc_columns.py's check: at an equal byte budget the tc hot
    tier holds a larger share of the terms."""
    jp, _ = staged_corpus
    port = to_port(jp)
    budget = int(jp.n_postings) * TS.BYTES_PER_POSTING // 4
    raw = TS.StagedEngine(port, budget, device="cpu")
    tc = TS.StagedEngine(port, budget, device="cpu", columns="tc")
    assert tc.hot_fraction > raw.hot_fraction
    assert tc.hot_fraction == JS.StagedEngine(jp, budget,
                                              columns="tc").hot_fraction


@pytest.mark.parametrize("frac", [0.5, 0.9])
def test_staged_tc_dense_rows_at_a_partial_budget(device_cold, frac):
    """Head terms dense-only while their runs are cold, at a fraction of
    the tc full-residency bytes: masks equal JAX's, results three-way."""
    rng = np.random.default_rng(17)
    docs = []
    for _ in range(1600):
        toks = [t for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7))
                if rng.random() < p]
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        docs.append(make_docinfo(toks, with_blooms=False))
    jp, oracle = build_index(docs)
    port = to_port(jp)
    budget = int(TS.full_residency_bytes(port, "tc") * frac)
    te = TS.StagedEngine(port, budget, device="cpu", columns="tc")
    je = JS.StagedEngine(jp, budget, columns="tc")
    assert te.total_full == jax_total_full(jp, "tc")
    for mask in ("hot_mask", "phrase_hot_mask", "dense_mask"):
        np.testing.assert_array_equal(getattr(te, mask), getattr(je, mask))
    assert te.dense_mask.any() and te.hot_bytes_used == je.hot_bytes_used
    assert (te.dense_mask & ~te.hot_mask).any()
    by_df = np.argsort(jp.df)[::-1]
    h = [jp.terms[r] for r in by_df[:3]]
    qs = staged_queries(jp, seed=11)
    qs += [SearchQuery(h[:n], n_results=k) for n in (2, 3) for k in (3, 10)]
    qs += [SearchQuery([h[0], jp.terms[by_df[j]]], n_results=10)
           for j in (5, 30, 90)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st.get("hot_route_dense", 0) + st.get("hot_route_semidense", 0) > 0


@pytest.mark.parametrize("budget_div", [0, 3])
def test_staged_tc_saturated_cold(saturated, device_cold, budget_div):
    """Saturated tf bytes in the cold tc scratch: the cold finalizer sends
    rows keeping such a lane to the exact host path."""
    jp, port, oracle = saturated
    budget = (TS.full_residency_bytes(port, "tc") // budget_div
              if budget_div else 0)
    te = TS.StagedEngine(port, budget, device="cpu", columns="tc")
    je = JS.StagedEngine(jp, budget, columns="tc")
    qs = [SearchQuery(t, n_results=k)
          for t in (["mega", "pair"], ["pair", "mega"], ["mega", "solo"])
          for k in (1, 10)]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["cold_host_fallback_q"] > 0


def test_staged_tc_still_refuses_phrases(staged_corpus):
    """The tc staged engine answers phrases: past full residency through
    the tc hot engine's phrase routes, with the JAX tc staged engine's and
    the oracle's answers."""
    jp, oracle = staged_corpus
    te = TS.StagedEngine(to_port(jp), 1 << 30, device="cpu", columns="tc")
    je = JS.StagedEngine(jp, 1 << 30, columns="tc")
    qs = [SearchQuery([jp.terms[0], jp.terms[1]], n_results=5,
                      is_phrase=True)]
    qs += [SearchQuery(t, n_results=k, is_phrase=True)
           for t in synth_query_terms(10, 20, n_terms=2, seed=31)
           for k in (3, 10)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["hot_route_phrase_list"] > 0
    assert not any(k.startswith("route_cold") for k in st)
