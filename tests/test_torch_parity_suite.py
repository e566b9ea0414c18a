"""The JAX package's parity suites, ported to TorchEngine (device "cpu"):
test_fuzz_parity.py (random corpora and query mixes against the oracle
and TpuEngine), test_two_level_topk.py (two_level_top_m against
lax.top_k, and the engine on a corpus whose dense, single-term and
forced pruned scans take the two-level branch), test_truncation_guard.py
(the suspect detector, its wiring to the exact host search, the host
search itself), test_saturation.py (L buckets shrunk below the head
terms' df, so saturated candidates take the host) and
test_adversarial_ties.py's tc margin stress, strict-parity sweep and
decomposition units. Each holds the port where the JAX file holds
TpuEngine: to the OracleEngine's (doc, f64 score) lists, bit for bit.

Where the JAX file compares lanes with lax.top_k's index order, the port
compares the kept set and the values: torch.topk orders equal values
freely, and the engine's answer does not depend on that order
(test_torch_ties.py runs the engine under a tie-adversarial top-k).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu_torch.engine.device as device_mod
import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo, synth_docinfos, synth_query_terms
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.host import host_exact_search
from wiser_tpu_torch.engine.topk import truncation_suspects
from wiser_tpu_torch.types import SearchQuery


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def pairs(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(q):
    return JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase)


def assert_same(oracle, engine, qs, msg=""):
    got = pairs(engine.search_batch(qs))
    want = pairs(oracle.search(jq(q)) for q in qs)
    for q, g, w in zip(qs, got, want):
        assert g == w, f"{msg} {q.terms} phrase={q.is_phrase} k={q.n_results}"
    return got


# -- test_fuzz_parity.py ---------------------------------------------------------


def random_corpus(rng):
    n_docs = int(rng.integers(30, 400))
    vocab = int(rng.integers(5, 150))
    docs = []
    for _ in range(n_docs):
        n_tok = int(rng.integers(1, 60))
        ranks = np.minimum(rng.zipf(float(rng.uniform(1.1, 2.0)), n_tok) - 1,
                           vocab - 1)
        docs.append(make_docinfo([f"v{r}" for r in ranks]))
    return docs, vocab


def random_queries(rng, vocab, n=60):
    out = []
    for _ in range(n):
        nt = int(rng.integers(1, 5))
        terms = [f"v{rng.integers(0, vocab)}" for _ in range(nt)]
        out.append(SearchQuery(terms, n_results=int(rng.integers(1, 15)),
                               is_phrase=bool(rng.random() < 0.25 and nt >= 2)))
    return out


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_equivalence(seed):
    """The JAX file's draws, call for call: the same corpus, bloom factor
    and queries; the port against the oracle and TpuEngine."""
    rng = np.random.default_rng(seed)
    docs, vocab = random_corpus(rng)
    jp, oracle = build_index(docs, with_blooms=True)
    factor = int(rng.integers(1, 11))
    engine = TorchEngine(to_port(jp), device="cpu", bloom_enable_factor=factor)
    queries = random_queries(rng, vocab)
    got = assert_same(oracle, engine, queries, f"seed={seed}")
    je = TpuEngine(jp, bloom_enable_factor=factor)
    assert got == pairs(je.search_batch([jq(q) for q in queries]))


# -- test_two_level_topk.py --------------------------------------------------------


def flat_vs_two_level(score, M):
    """Values equal lax.top_k's exactly; the kept valid lanes are its set
    wherever the boundary class fits the buffer, and the row flags where
    it does not."""
    t = torch.from_numpy(score)
    got_s, got_l = TK.two_level_top_m(t, M)
    want_s, want_l = jax.lax.top_k(jnp.asarray(score), M)
    want_l = np.asarray(want_l)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        np.take_along_axis(score, got_l.numpy(), 1), got_s.numpy())
    trunc = TK.boundary_truncated(t, got_s, M).numpy()
    n_ge = (score >= got_s.numpy()[:, M - 1 : M]).sum(axis=1)
    np.testing.assert_array_equal(trunc, (got_s.numpy()[:, M - 1] > JK.NEG_INF)
                                  & (n_ge > M))
    for b in np.nonzero(~trunc)[0]:
        live = got_s[b].numpy() > JK.NEG_INF
        assert sorted(got_l[b][live].tolist()) == sorted(want_l[b][live].tolist())
    return trunc


def test_two_level_random_with_ties():
    rng = np.random.default_rng(3)
    B, NBLK, M = 4, 96, 64  # NBLK >= M + 1: the two-level branch
    score = rng.integers(0, 40, size=(B, NBLK * 128)).astype(np.float32)
    score[0, :5000] = JK.NEG_INF
    score[1] = 7.0  # one tie class across every block
    assert flat_vs_two_level(score, M)[1]


def test_two_level_single_hot_block():
    B, NBLK, M = 2, 70, 64
    score = np.zeros((B, NBLK * 128), dtype=np.float32)
    score[:, 128 * 33 : 128 * 34] = np.arange(128, dtype=np.float32) + 1
    score[:, 0] = 1.0  # ties block 33's lowest lane from block 0
    assert not flat_vs_two_level(score, M).any()
    # M = 128 reaches the 1.0 lanes: two tie for the last place
    assert flat_vs_two_level(score, 128).all()


def test_two_level_fallback_small():
    B, NBLK, M = 2, 16, 64  # NBLK < M + 1: the flat selection
    rng = np.random.default_rng(4)
    assert not flat_vs_two_level(
        rng.random((B, NBLK * 128)).astype(np.float32), M).any()


@pytest.fixture(scope="module")
def big_corpus():
    """12k docs: N_pad / 128 ~ 94 blocks >= M + 1 = 65, so the dense scan,
    the single-term L = 32768 bucket and a forced pruned C = 80 scan take
    the two-level branch."""
    rng = np.random.default_rng(17)
    docs = []
    for _ in range(12000):
        toks = []
        if rng.random() < 0.85:
            toks.append("h0")
        if rng.random() < 0.75:
            toks.append("h1")
        if rng.random() < 0.6:
            toks.append("h2")
        toks += [f"m{rng.integers(12)}" for _ in range(2)]
        toks += [f"r{rng.integers(400)}" for _ in range(rng.integers(2, 7))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=False))
    jp, oracle = build_index(docs)
    return to_port(jp), oracle


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_engine_parity_two_level(big_corpus, columns):
    port, oracle = big_corpus
    engine = TorchEngine(port, device="cpu", columns=columns)
    assert engine._n_pad_docs // 128 >= 65, "corpus too small for the branch"
    engine.PRUNED_DENSE_MIN_NB = 8
    engine.PRUNED_DENSE_C = 80
    queries = [SearchQuery(["h0"], n_results=10),  # L = 32768 single
               SearchQuery(["h0", "h1"], n_results=10),  # pruned pair
               SearchQuery(["h0", "h1", "h2"], n_results=10),
               SearchQuery(["m3", "h0"], n_results=10),  # semidense
               SearchQuery(["r7", "h1"], n_results=10),
               SearchQuery(["h1"], n_results=10),
               SearchQuery(["h0", "h2"], n_results=13)]
    assert_same(oracle, engine, queries, columns)
    st = engine.stats_take()
    assert st["route_pruned"] > 0 and st["route_semidense"] > 0


# -- test_truncation_guard.py ------------------------------------------------------


@pytest.fixture(scope="module")
def tied_corpus():
    # 200 identical docs: one exact tie class larger than M = k + margin
    docs = [make_docinfo("w w q".split()) for _ in range(200)]
    docs += [make_docinfo(["q", f"u{i}"]) for i in range(20)]
    jp, oracle = build_index(docs)
    return to_port(jp), oracle


class TestSuspectDetector:
    def test_near_tie_not_equal_flags(self):
        score = np.full((1, 8), 1.0)
        score[0, 7] = 1.0 - 1e-9  # distinct, inside f32 resolution
        assert truncation_suspects(score, np.array([8]), np.array([2]))[0]

    def test_exact_tie_is_safe(self):
        score = np.full((1, 8), 1.0)
        assert not truncation_suspects(score, np.array([8]), np.array([2]))[0]

    def test_partial_buffer_is_safe(self):
        score = np.full((1, 8), 1.0)
        assert not truncation_suspects(score, np.array([5]), np.array([2]))[0]

    def test_well_separated_is_safe(self):
        score = np.linspace(2.0, 1.0, 8)[None, :]
        assert not truncation_suspects(score, np.array([8]), np.array([2]))[0]


def _spy_host(monkeypatch):
    calls = []
    orig = device_mod.host_exact_search

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(device_mod, "host_exact_search", spy)
    return calls


class TestGuardWiring:
    def test_exact_ties_correct(self, tied_corpus, monkeypatch):
        """A 200-doc exact tie class: the impact table answers without the
        host. Without the table the bs buffer truncates the class and the
        k-th place reaches it; the JAX engine keeps lax.top_k's lowest
        lanes there, the port sends the row to the exact host search
        (tie_class_cut: torch.topk keeps arbitrary tied lanes). Both
        answers are the oracle's."""
        port, oracle = tied_corpus
        calls = _spy_host(monkeypatch)
        q = SearchQuery(["w"], n_results=10)
        for depth in (64, 0):
            eng = TorchEngine(port, device="cpu", single_term_depth=depth)
            r = eng.search(q)
            assert pairs([r]) == pairs([oracle.search(jq(q))])
            assert [e.doc_id for e in r.entries] == list(range(10))
            st = eng.stats_take()
            assert len(calls) == st.get("forced_host_tie_cut", 0) == (
                0 if depth else 1)

    def test_strict_parity_flags_truncated_class(self, tied_corpus,
                                                 monkeypatch):
        """strict_parity: the device's truncated-class flag sends the
        200-doc class (> M = 64 lanes) to the exact host path."""
        port, oracle = tied_corpus
        engine = TorchEngine(port, device="cpu", single_term_depth=0,
                             strict_parity=True)
        calls = _spy_host(monkeypatch)
        q = SearchQuery(["w", "q"], n_results=10)
        r = engine.search(q)
        assert calls, "strict mode must re-run truncated-class queries"
        assert pairs([r]) == pairs([oracle.search(jq(q))])

    def test_flag_routes_to_host_exact(self, tied_corpus, monkeypatch):
        port, oracle = tied_corpus
        engine = TorchEngine(port, device="cpu")
        calls = _spy_host(monkeypatch)
        monkeypatch.setattr(device_mod, "truncation_suspects",
                            lambda s, n, k, **kw: np.ones(len(s), dtype=bool))
        # multi-term: single terms come from the exact impact table
        q = SearchQuery(["w", "q"], n_results=10)
        r = engine.search(q)
        assert calls, "a forced suspect must take the exact path"
        assert pairs([r]) == pairs([oracle.search(jq(q))])


class TestHostExact:
    def test_matches_oracle_and(self, tied_corpus):
        port, oracle = tied_corpus
        rows = [port.term_to_row["w"], port.term_to_row["q"]]
        cache64 = TorchEngine(port, device="cpu").cache64
        d, s = host_exact_search(port, cache64, rows, 10)
        o = oracle.search(JQuery(["w", "q"], n_results=10))
        assert list(d) == [e.doc_id for e in o.entries]
        np.testing.assert_array_equal(s, [e.doc_score for e in o.entries])

    def test_matches_oracle_phrase(self):
        docs = [make_docinfo("a b c".split()), make_docinfo("b a c".split()),
                make_docinfo("a b".split())]
        jp, oracle = build_index(docs)
        port = to_port(jp)
        rows = [port.term_to_row["a"], port.term_to_row["b"]]
        d, s = host_exact_search(port, TorchEngine(port, device="cpu").cache64,
                                 rows, 10, is_phrase=True)
        o = oracle.search(JQuery(["a", "b"], n_results=10, is_phrase=True))
        assert list(d) == [e.doc_id for e in o.entries]
        assert sorted(d) == [0, 2]
        np.testing.assert_array_equal(s, [e.doc_score for e in o.entries])


# -- test_saturation.py --------------------------------------------------------------


@pytest.fixture(scope="module")
def sat_corpus():
    docs = synth_docinfos(n_docs=600, vocab_size=60, mean_len=30, seed=5,
                          with_blooms=True)
    jp, oracle = build_index(docs, with_blooms=True)
    return to_port(jp), oracle


@pytest.fixture()
def tiny_buckets(sat_corpus, monkeypatch):
    """L buckets capped below the head terms' df, so saturation routing
    fires as it would at corpus scale."""
    port, _ = sat_corpus
    assert int(port.df.max()) > 128, "the corpus needs df > 128 terms"
    monkeypatch.setattr(device_mod, "L_BUCKETS", [128])
    return TorchEngine(port, device="cpu")


def test_saturated_single_term(sat_corpus, tiny_buckets):
    port, oracle = sat_corpus
    head = int(np.argmax(port.df))
    for k in (10, 100):
        assert_same(oracle, tiny_buckets,
                    [SearchQuery([port.terms[head]], n_results=k)])


def test_saturated_and_and_phrase(sat_corpus, tiny_buckets):
    port, oracle = sat_corpus
    order = np.argsort(port.df)[::-1]
    heads = [port.terms[int(r)] for r in order[:2]]
    assert_same(oracle, tiny_buckets,
                [SearchQuery(heads, n_results=10, is_phrase=p)
                 for p in (False, True)])
    st = tiny_buckets.stats_take()
    assert st["route_host_merge"] > 0 and st["route_phrase_host"] > 0


def test_saturated_mixed_batch(sat_corpus, tiny_buckets):
    port, oracle = sat_corpus
    queries = [SearchQuery(t, n_results=10)
               for t in synth_query_terms(30, 60, n_terms=2, seed=9)]
    queries += [SearchQuery([port.terms[int(r)]], n_results=10)
                for r in np.argsort(port.df)[::-1][:3]]
    assert_same(oracle, tiny_buckets, queries)


# -- test_adversarial_ties.py ------------------------------------------------------


@pytest.fixture(scope="module")
def tie_corpus():
    """Exact-tie classes (identical docs, over any buffer) and near-tie
    bands (equal tfs, lengths straddling length-code boundaries)."""
    rng = np.random.default_rng(0)
    docs = [make_docinfo("a b c".split()) for _ in range(150)]
    for _ in range(150):
        docs.append(make_docinfo(["a", "b"] + ["f"] * int(rng.integers(5, 9))))
    for i in range(60):
        docs.append(make_docinfo(["a", f"u{i % 17}", f"v{i % 5}"]))
    jp, oracle = build_index(docs)
    return to_port(jp), oracle


@pytest.mark.parametrize("margin", [0, 1, 3, 16])
@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_margin_stress_bit_parity(tie_corpus, margin, columns):
    port, oracle = tie_corpus
    eng = TorchEngine(port, device="cpu", margin=margin, columns=columns,
                      single_term_depth=0, dense_budget_bytes=0)
    rng = np.random.default_rng(margin * 7 + 1)
    queries = []
    for k in (1, 3, 10, 40):
        for terms in (["a"], ["a", "b"], ["b", "a", "c"], ["a", "f"]):
            queries.append(SearchQuery(terms, n_results=k))
    for _ in range(20):
        nt = int(rng.integers(1, 4))
        terms = list(rng.choice(port.terms, nt, replace=False))
        queries.append(SearchQuery([str(t) for t in terms],
                                   n_results=int(rng.integers(1, 30))))
    assert_same(oracle, eng, queries, f"margin={margin} cols={columns}")


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_strict_parity_margin_zero(tie_corpus, columns):
    """strict_parity at margin 0: every boundary sits inside a tie class,
    most rows take the exact host path, and the answers stay exact."""
    port, oracle = tie_corpus
    eng = TorchEngine(port, device="cpu", margin=0, columns=columns,
                      strict_parity=True, single_term_depth=0,
                      dense_budget_bytes=0)
    assert_same(oracle, eng, [SearchQuery(t, n_results=k)
                              for t in (["a"], ["a", "b"], ["a", "b", "c"],
                                        ["a", "f"]) for k in (1, 5, 20)])
    assert eng.stats_take()["forced_host"] > 0


class TestDecompositionUnits:
    """Constructed score arrays at the exact edges of the two-check guard
    (FLAG_TRUNC for exact ties, truncation_suspects for near ties)."""

    def test_f32_collision_across_boundary_is_flagged(self):
        hi = np.float64(1.0)
        lo = np.float64(1.0) - np.float64(2.0) ** -30  # the same f32 value
        assert np.float32(hi) == np.float32(lo)
        score_f = np.array([[hi, hi, lo]])  # kept buffer M = 3, k = 2
        assert truncation_suspects(score_f, np.array([3]), np.array([2]))[0]

    def test_gap_outside_bound_not_flagged(self):
        score_f = np.array([[1.0, 0.999, 0.9]])  # a 10% gap at the boundary
        assert not truncation_suspects(score_f, np.array([3]),
                                       np.array([2]))[0]

    def test_tc_rel_eps_covers_reconstruction_error(self):
        # the tc reconstruction bound (~4.8e-6 at T = 8) is inside the tc
        # engine's rel_eps (1e-5), and outside the raw one's (1e-6)
        score_f = np.array([[1.0, 1.0, 1.0 - 4.8e-6]])
        assert truncation_suspects(score_f, np.array([3]), np.array([2]),
                                   rel_eps=1e-5)[0]
        assert not truncation_suspects(score_f, np.array([3]), np.array([2]),
                                       rel_eps=1e-6)[0]
        port = to_port(build_index([make_docinfo(["a"])])[0])
        assert TorchEngine(port, device="cpu", columns="tc").rel_eps == 1e-5
        assert TorchEngine(port, device="cpu").rel_eps == 1e-6
