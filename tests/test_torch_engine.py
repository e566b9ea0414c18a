"""TorchEngine (wiser_tpu_torch, CPU tensors) against TpuEngine with the
same configuration (raw columns) and OracleEngine: identical (doc, f64
score) lists, including ties, several k, missing terms, duplicate
queries and queries of more than 8 terms. The port serves its own copy
of each index (convert.packed_from_arrays)."""

import dataclasses

import numpy as np
import pytest

from wiser_tpu.data.synth import make_docinfo, synth_docinfos
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.fixture(scope="module")
def corpus():
    packed, oracle = build_index(synth_docinfos(n_docs=500, vocab_size=120,
                                                mean_len=40, seed=7))
    return packed, oracle


@pytest.fixture(scope="module")
def engines(corpus):
    packed, _ = corpus
    return (TorchEngine(to_port(packed), device="cpu"),
            TpuEngine(packed, dense_budget_bytes=0))


def _random_queries(packed, n, seed, max_terms=8):
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        nt = int(rng.integers(1, max_terms + 1))
        # Zipf-ish term picks: head terms meet often, so AND results are
        # non-empty and tie classes large
        rows = np.minimum(rng.zipf(1.3, size=nt) - 1, packed.n_terms - 1)
        qs.append(SearchQuery([packed.terms[r] for r in rows],
                              n_results=int(rng.choice([1, 3, 10, 40, 100]))))
    return qs


def test_padded_columns_equal_tpu_engine(engines):
    te, je = engines
    for mine, ref in ((te._h_doc, je._h_doc), (te._h_score, je._h_score),
                      (te._h_tf, je._h_tf)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)


def test_batch_three_way(corpus, engines):
    packed, oracle = corpus
    te, je = engines
    qs = _random_queries(packed, 150, seed=1)
    qs += [SearchQuery(["t0", "nope"], n_results=5),  # missing term
           SearchQuery(["nope"], n_results=5),
           SearchQuery(["t0", "t1"], n_results=0),
           SearchQuery([], n_results=5)]
    qs += qs[:20]  # duplicates in one batch (coalesced)
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert sum(map(len, got)) > 500


@pytest.mark.parametrize("k", [1, 10, 63, 64, 65, 200])
def test_single_term_depths(corpus, engines, k):
    """The impact table answers k <= depth; deeper k takes the T=1 bs
    kernel."""
    packed, oracle = corpus
    te, je = engines
    head = packed.terms[int(np.argmax(packed.df))]
    tail = packed.terms[int(np.argmin(packed.df))]
    qs = [SearchQuery([head], n_results=k), SearchQuery([tail], n_results=k)]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)


def test_more_than_eight_terms(corpus, engines):
    """The long tail runs the bs kernel with the exact slot count. The
    oracle is the reference here: TpuEngine's long-tail assembly indexes
    past its 8-slot arrays on such queries."""
    packed, oracle = corpus
    te, _ = engines
    by_df = np.argsort(packed.df)[::-1]
    qs = [SearchQuery([packed.terms[r] for r in by_df[:n]], n_results=k)
          for n, k in ((9, 10), (12, 5), (10, 100))]
    qs.append(SearchQuery([packed.terms[r] for r in by_df[3:13]][::-1],
                          n_results=10))
    got = lists(te.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert any(got)
    assert te.stats_take().get("route_long_tail", 0) == len(qs)


def _tie_heavy_corpus():
    """Giant exact-tie classes and near-tie bands (identical docs; equal
    tfs with lengths straddling length-code boundaries)."""
    rng = np.random.default_rng(0)
    docs = [make_docinfo("a b c".split()) for _ in range(150)]
    for _ in range(150):
        docs.append(make_docinfo(["a", "b"] + ["f"] * int(rng.integers(5, 9))))
    for i in range(60):
        docs.append(make_docinfo(["a", f"u{i % 17}", f"v{i % 5}"]))
    return build_index(docs)


@pytest.mark.parametrize("margin", [0, 1, 3, 54])
def test_tie_classes_at_the_buffer_boundary(margin):
    """With a small margin the candidate buffer's boundary sits inside a
    tie class; torch.topk keeps arbitrary tied lanes, and the FLAG_TRUNC
    tie-class guard must still give the exact answer."""
    packed, oracle = _tie_heavy_corpus()
    te = TorchEngine(to_port(packed), device="cpu", margin=margin,
                     single_term_depth=0)
    je = TpuEngine(packed, margin=margin, single_term_depth=0,
                   dense_budget_bytes=0)
    qs = [SearchQuery(terms, n_results=k)
          for terms in (["a"], ["a", "b"], ["b", "a", "c"], ["a", "f"])
          for k in (1, 3, 10, 40)]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    if margin <= 3:
        assert st["flag_trunc"] > 0


def test_strict_parity_forces_truncated_rows():
    packed, oracle = _tie_heavy_corpus()
    te = TorchEngine(to_port(packed), device="cpu", margin=0,
                     strict_parity=True, single_term_depth=0)
    qs = [SearchQuery(["a", "b"], n_results=k) for k in (1, 5, 20)]
    assert lists(te.search_batch(qs)) == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    assert st["forced_host"] >= st["flag_trunc"] > 0


def test_host_merge_and_windowed_routes(corpus):
    """Lower the route thresholds so this small corpus exercises the host
    merge and the windowed block intersection."""
    packed, oracle = corpus
    te = TorchEngine(to_port(packed), device="cpu")
    te.HOST_MERGE_MIN_L = 128
    te.WINDOWED_MIN_L = 128
    te.WINDOWED_MAX_L = 128
    qs = _random_queries(packed, 80, seed=3, max_terms=4)
    got = lists(te.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    assert st["route_host_merge"] > 0 and st["route_windowed"] > 0


def test_phrase_query_raises(corpus, engines):
    """A phrase query does not raise: TorchEngine answers 2- and 3-term
    phrases (and the AND query over the same terms, in the same batch) as
    TpuEngine and the oracle do."""
    packed, oracle = corpus
    te, je = engines
    qs = [SearchQuery(["t0", "t1"], n_results=5, is_phrase=True),
          SearchQuery(["t0", "t1"], n_results=5),
          SearchQuery(["t1", "t0"], n_results=10, is_phrase=True),
          SearchQuery(["t0", "t2", "t1"], n_results=10, is_phrase=True),
          SearchQuery(["t3"], n_results=5, is_phrase=True)]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    assert got[0] and got[0] != got[1]


def test_dense_budget_admitting_rows_raises():
    """A budget that admits a dense row builds the tier as TpuEngine does
    and answers through it; a budget under one row, or a corpus with no
    dense-eligible term, builds none."""
    docs = [make_docinfo(["h", f"x{i % 7}"]) for i in range(1100)]
    packed, oracle = build_index(docs)  # "h": df 1100 >= DENSE_MIN_DF_FLOOR
    te = TorchEngine(to_port(packed), device="cpu", dense_budget_bytes=1 << 30)
    je = TpuEngine(packed, dense_budget_bytes=1 << 30)
    assert te._dense_H == je._dense_H == 1
    qs = [SearchQuery(["h", f"x{i}"], n_results=5) for i in range(7)]
    assert lists(te.search_batch(qs)) == lists(oracle.search(q) for q in qs)
    assert te.stats_take()["route_semidense"] == 7
    assert TorchEngine(to_port(packed), device="cpu",
                       dense_budget_bytes=8)._dense_H == 0  # < one row
    small, _ = build_index(synth_docinfos(200, 50, 20, seed=1))
    assert TorchEngine(to_port(small), device="cpu",
                       dense_budget_bytes=1 << 30)._dense_H == 0


def test_device_bytes(engines):
    """Posting columns, position bags and bloom columns, as TpuEngine
    counts them (no dense tier at budget 0)."""
    te, je = engines
    b = te.device_bytes()
    assert b["postings"] == te._h_doc.nbytes * 3
    assert b == je.device_bytes()
    assert b["positions"] > 0 and b["dense_tier"] == 0
    assert b["total"] == b["postings"] + b["positions"] + b["blooms"]
