"""The port's StagedEngine on phrase queries, against wiser_tpu's
StagedEngine and OracleEngine: identical (doc, f64 score) lists and the
same hot/cold split (hot, phrase-hot masks and per-query routes).

A phrase query goes hot only when every term is CSR-hot and phrase-hot;
otherwise it is cold: the memoized exact host phrase search
(COLD_COMPUTE = "host") or, on the device cold path, the bloomless
phrase_body over the staged scratch columns and position bags. Covered:
budget 0, a partial budget and full residency; both cold backends; packed
and raw cold transport (PACK_WIDTH = 4, so runs spill into the raw
segment); raw and tc columns (a tc chunk holding phrases also stages the
raw score / tf scratch); one batch mixing hot, phrase-cold and cold
phrases with AND and term queries; a truncated tie class at the k-th
place (tie_class_cut sends it to the host); and a cold phrase key over
the lane budget, which takes the exact host search. The step itself is
held against the JAX phrase_body in test_torch_phrase_kernels.py and
test_torch_tc_kernels.py.
"""

import dataclasses

import numpy as np
import pytest

import wiser_tpu.engine.staged as JS
import wiser_tpu_torch.engine.staged as TS
from wiser_tpu.data.synth import make_docinfo, synth_docinfos, synth_query_terms
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch.convert import packed_from_arrays


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.fixture(scope="module")
def corpus():
    jp, oracle = build_index(
        synth_docinfos(n_docs=500, vocab_size=120, mean_len=35, seed=33),
        with_blooms=True)
    return jp, to_port(jp), oracle


@pytest.fixture(autouse=True)
def small_cold_l_bucket(monkeypatch):
    """A 1,024-lane cold L bucket ahead of the smallest one (8,192), in
    both engines: every term here has df <= 500, so each cold group then
    holds an eighth of the lanes and the plain steps run that much less."""
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "COLD_L_BUCKETS", [1024] + mod.COLD_L_BUCKETS)


def phrase_queries(n=40, seed=5):
    """2- and 3-term phrases over head and mid terms (head pairs meet
    adjacently), a few AND twins and term queries."""
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(n, 40, n_terms=2, seed=seed)]
    qs += [SearchQuery(t, n_results=10, is_phrase=True)
           for t in synth_query_terms(n // 4, 12, n_terms=3, seed=seed + 1)]
    qs += [SearchQuery(q.terms, n_results=10) for q in qs[:6]]
    qs += [SearchQuery(["t3"], n_results=10), SearchQuery(["t0"], n_results=80)]
    return qs


def engines(jp, port, budget_of, columns="raw", **kw):
    """Port and JAX staged engines at the same budget; budget_of maps the
    port's full-residency bytes to the budget."""
    budget = budget_of(TS.full_residency_bytes(port, columns))
    te = TS.StagedEngine(port, budget, device="cpu", columns=columns, **kw)
    je = JS.StagedEngine(jp, budget, columns=columns, **kw)
    for mask in ("hot_mask", "phrase_hot_mask", "dense_mask"):
        np.testing.assert_array_equal(getattr(te, mask), getattr(je, mask))
    assert te.hot_bytes_used == je.hot_bytes_used
    return te, je


def n_cold(te, jp, qs):
    """Queries the JAX masks send cold (phrases need every term CSR-hot
    and phrase-hot, the rest CSR-hot or dense), distinct, multi-term or
    past the impact table."""
    cold = 0
    for q in qs:
        rows = [jp.lookup(t) for t in q.terms]
        if len(rows) == 1 and (q.n_results <= te._st_depth
                               or jp.df[rows[0]] <= te._st_depth):
            continue  # the impact table answers it
        if q.is_phrase:
            hot = all(te.hot_mask[r] and te.phrase_hot_mask[r] for r in rows)
        else:
            hot = all(te.hot_mask[r] or te.dense_mask[r] for r in rows)
        cold += not hot
    return cold


def three_way(te, je, oracle, qs, vs_jax=True):
    """The port's lists equal the oracle's and, with vs_jax, the JAX staged
    engine's (whose jitted steps compile per shape on the CPU, so only
    some cases run them; every case holds the masks against JAX's)."""
    got = lists(te.search_batch(qs))
    if vs_jax:
        assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    return got


def full(total):
    return total


def quarter(total):
    return total // 4


def zero(total):
    return 0


@pytest.mark.parametrize("columns,budget_of,compute,transport,vs_jax", [
    ("raw", zero, "device", "packed", True),
    ("raw", quarter, "device", "raw", False),
    ("raw", quarter, "host", "packed", True),
    ("raw", full, "device", "packed", False),
    ("tc", zero, "device", "packed", True),
    ("tc", quarter, "device", "raw", False),
    ("tc", quarter, "host", "packed", False),
])
def test_staged_phrases_three_way(corpus, monkeypatch, columns, budget_of,
                                  compute, transport, vs_jax):
    jp, port, oracle = corpus
    monkeypatch.setattr(JS.StagedEngine, "COLD_COMPUTE", compute)
    monkeypatch.setattr(TS.StagedEngine, "COLD_COMPUTE", compute)
    te, je = engines(jp, port, budget_of, columns, cold_transfer=transport)
    qs = phrase_queries()
    got = three_way(te, je, oracle, qs, vs_jax)
    assert sum(len(g) for g, q in zip(got, qs) if q.is_phrase) > 50
    st = te.stats_take()
    cold = n_cold(te, jp, qs)
    if budget_of is full:
        assert te.phrase_hot_mask.all() and cold == 0
        assert not any(k.startswith("route_cold") for k in st)
    elif compute == "host":
        assert st["route_cold_host"] == cold > 0
    else:
        assert (st["route_cold_device"] + st.get("route_cold_sat_host", 0)
                == cold > 0)
        assert st["route_cold_phrase"] > 0
        if transport == "packed":
            assert st["cold_packed_blocks"] > 0
    if budget_of is quarter:
        assert st.get("hot_route_phrase_list", 0) > 0


def test_pack_width_4_phrases(corpus, monkeypatch):
    """Runs that do not pack at 4 bits ship raw behind the packed ones;
    the position bags are indexed by scratch posting either way."""
    jp, port, oracle = corpus
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "PACK_WIDTH", 4)
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", "device")
    te, je = engines(jp, port, quarter)
    assert te._pack16.any() and not te._pack16.all()
    three_way(te, je, oracle, phrase_queries(seed=9), vs_jax=False)
    st = te.stats_take()
    assert st["cold_raw_postings"] > 0 and st["cold_packed_blocks"] > 0
    assert st["route_cold_phrase"] > 0


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_mixed_hot_phrase_cold_and_cold(corpus, monkeypatch, columns):
    """One batch: phrases whose terms are all phrase-hot (hot engine),
    phrases over CSR-hot terms of which one is phrase-cold (its bags and
    bloom rows are zeroed in the hot view: routing must send them cold),
    phrases over a CSR-cold term, and the AND queries over the same
    terms (which stay hot where every term is CSR-hot)."""
    jp, port, oracle = corpus
    for mod in (JS, TS):
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", "device")
    te, je = engines(jp, port, lambda t: t * 3 // 5, columns)
    hot_ph = [jp.terms[r] for r in np.nonzero(te.phrase_hot_mask)[0]]
    hot_only = [jp.terms[r] for r in
                np.nonzero(te.hot_mask & ~te.phrase_hot_mask)[0]]
    cold = [jp.terms[r] for r in np.nonzero(~te.hot_mask)[0]]
    assert hot_ph and hot_only and cold
    rng = np.random.default_rng(3)
    pairs = ([list(rng.choice(hot_ph, 2, replace=False)) for _ in range(8)]
             + [[rng.choice(hot_ph), rng.choice(hot_only)] for _ in range(8)]
             + [[rng.choice(hot_only), rng.choice(cold)] for _ in range(8)])
    qs = [SearchQuery(list(p), n_results=10, is_phrase=True) for p in pairs]
    qs += [SearchQuery(list(p), n_results=10) for p in pairs]
    three_way(te, je, oracle, qs, vs_jax=columns == "raw")
    st = te.stats_take()
    assert st["route_cold_phrase"] == 16  # phrase-cold and cold phrases
    assert 0 < st["hot_route_phrase_list"] <= 8  # coalesced on the hot side
    assert st["route_cold_device"] == 16 + 8  # the cold ANDs too


def tie_corpus():
    """Identical docs and equal-score bands: the phrase "a b" matches 150
    identical docs (one f32 class) and near-tie variants."""
    rng = np.random.default_rng(0)
    docs = [make_docinfo("a b c".split(), with_blooms=True)
            for _ in range(150)]
    for _ in range(150):
        docs.append(make_docinfo(["a", "b"] + ["f"] * int(rng.integers(5, 9)),
                                 with_blooms=True))
    for i in range(60):
        docs.append(make_docinfo(["b", "a", f"u{i % 17}"], with_blooms=True))
    return build_index(docs, with_blooms=True)


def test_cold_phrase_tie_class_cut(monkeypatch):
    """margin 0: the M-lane buffer ends inside a 150-doc tie class that
    reaches the k-th place. torch.topk keeps arbitrary tied lanes, so
    tie_class_cut sends those rows to the exact host phrase search."""
    jp, oracle = tie_corpus()
    port = to_port(jp)
    for mod in (JS, TS):
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", "device")
    cut = []
    orig = TS.tie_class_cut

    def spy(*a):
        out = orig(*a)
        cut.append(int(out.sum()))
        return out

    monkeypatch.setattr(TS, "tie_class_cut", spy)
    te = TS.StagedEngine(port, 0, device="cpu", margin=0)
    je = JS.StagedEngine(jp, 0, margin=0)
    qs = [SearchQuery(t, n_results=k, is_phrase=True)
          for t in (["a", "b"], ["b", "c"], ["b", "a"]) for k in (1, 3, 10)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_cold_phrase"] == len(qs)
    assert sum(cut) > 0 and st["cold_host_fallback_q"] >= sum(cut)


def test_cold_phrase_over_the_lane_budget_takes_the_host(corpus, monkeypatch):
    """A key whose smallest B bucket times max(T, PP) x L exceeds the lane
    budget runs on the exact host phrase search (memoized); the rest of
    the batch stays on the device. Answers are unchanged."""
    jp, port, oracle = corpus
    for mod in (JS, TS):
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", "device")
    # L 1024 x PP 8 x B 8 fits; a 3-term L 1024 group at PP 32 does not
    monkeypatch.setattr(TS, "PHRASE_LANE_BUDGET", 8 * 8 * 1024)
    te, je = engines(jp, port, zero)
    qs = phrase_queries(seed=11)
    three_way(te, je, oracle, qs, vs_jax=False)
    st = te.stats_take()
    assert st["route_cold_phrase_host"] > 0 and st["route_cold_phrase"] > 0
    assert any(is_phrase for _, _, is_phrase in te._cold_host_cache)
