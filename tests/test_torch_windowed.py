"""The windowed block intersection of wiser_tpu_torch against wiser_tpu.

Step level: the same seeded numpy inputs (sorted random doc runs padded
to 128, tie-free random f32 partial scores, random tfs; hard tc lanes
with saturated bytes) go through the JAX windowed_search_body and the
port's. Raw packed outputs (docs, per-slot tfs, flag word) are equal with
tolerance 0 once the reference's tfs of unkept lanes are zeroed (its
other-slot tfs there are sums over the sentinel lanes of the equality
contraction; the port writes 0); tc outputs as the tc kernel tests
compare them (test_torch_tc_kernels.assert_packed_match), the JAX step
compiled without FMA contraction. FLAG_OVERFLOW, which comes from the
block summaries alone, is equal per query, including a skewed layout
where a candidate block overlaps more blocks than its window holds.

Engine level: TorchEngine and TpuEngine (no dense tier, raw and tc) on
tests/test_windowed.py's corpora and a skewed one route the same number
of queries to the windowed kernel and answer as the oracle does;
overflowing queries take the exact host path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu_torch.engine.kernels as TK
from test_torch_tc_kernels import T_, assert_packed_match, jref, rand_lanes
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays

INT32_MAX = 2**31 - 1


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def runs(seed, doc_sets, tc=False):
    """CSR columns of the given sorted doc runs, each padded to 128 with
    the sentinel, plus slack: (doc, score, tf) or (doc, tc), starts,
    dfs."""
    rng = np.random.default_rng(seed)
    docs, scores, tfs, tcs, starts, dfs = [], [], [], [], [], []
    pos = 0
    for d in doc_sets:
        df = len(d)
        pad = (-df) % 128
        starts.append(pos)
        dfs.append(df)
        docs.append(np.concatenate([np.asarray(d, np.int32),
                                    np.full(pad, INT32_MAX, np.int32)]))
        scores.append(np.concatenate([
            (rng.random(df) * 4 + 0.01).astype(np.float32),
            np.zeros(pad, np.float32)]))
        tfs.append(np.concatenate([rng.integers(1, 9, df).astype(np.int32),
                                   np.zeros(pad, np.int32)]))
        tcs.append(np.concatenate([rand_lanes(rng, df),
                                   np.zeros(pad, np.uint16)]))
        pos += df + pad
    slack = 8192
    doc = np.concatenate(docs + [np.full(slack, INT32_MAX, np.int32)])
    if tc:
        return (doc, np.concatenate(tcs + [np.zeros(slack, np.uint16)])), \
            np.asarray(starts), np.asarray(dfs)
    return (doc, np.concatenate(scores + [np.zeros(slack, np.float32)]),
            np.concatenate(tfs + [np.zeros(slack, np.int32)])), \
        np.asarray(starts), np.asarray(dfs)


def random_sets(seed, n_terms, lo, hi, n_docs):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(n_docs, size=int(rng.integers(lo, hi)),
                               replace=False)) for _ in range(n_terms)]


def group(seed, T, t_starts, t_dfs, B=12, n_pad_rows=2, tc=False):
    """Slot-ordered starts/ends (slot 0 the shortest run) and use_score or
    idf32 (0 on padded slots); the last rows are batch padding."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    w = np.zeros((B, T), dtype=np.float32)
    for b in range(B - n_pad_rows):
        n = int(rng.integers(2, T + 1))
        terms = sorted(rng.choice(len(t_starts), size=n, replace=False),
                       key=lambda t: t_dfs[t])
        for s in range(T):
            t = terms[s] if s < n else terms[0]
            starts[b, s] = t_starts[t]
            ends[b, s] = t_starts[t] + t_dfs[t]
            if s < n:
                w[b, s] = np.float32(rng.random() * 8 + 0.1) if tc else 1.0
    return starts, ends, w


def zero_unkept_tfs(packed_out, T):
    out = packed_out.copy()
    kept = out[:, 0, :] >= 0
    out[:, 1 : T + 1, :] = np.where(kept[:, None, :], out[:, 1 : T + 1, :], 0)
    return out


@pytest.mark.parametrize("T,L,M,span", [(2, 1024, 20, 4), (3, 2048, 20, 8),
                                        (4, 2048, 64, 4)])
def test_windowed_search_kernel_raw(T, L, M, span):
    """Runs of L/2..L docs spread over span * L doc ids; G blocks cover
    the longest run."""
    sets = random_sets(T * L, 6, L // 2, L, span * L)
    (doc, score, tf), t_starts, t_dfs = runs(T + span, sets)
    G = (max(t_dfs) + 127) // 128
    starts, ends, use = group(T, T, t_starts, t_dfs)
    args = (doc, score, tf, starts, ends, use)
    want = np.asarray(JK.make_windowed_search_kernel(T, L, G, M)(
        *(jnp.asarray(a) for a in args)))
    got = TK.make_windowed_search_kernel(T, L, G, M)(
        *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, zero_unkept_tfs(want, T))
    assert (got[:, 0] >= 0).sum() > 20


def skewed_runs(tc=False):
    """Candidate 'a' every 16th doc (a 128-doc block spans 2,048 docs),
    other 'b' dense over docs 0..4095: a's first two blocks overlap 16
    of b's blocks, more than WIN = default_win(2048, 32) = 6 holds."""
    a = np.arange(0, 16 * 1024, 16)
    b = np.arange(4096)
    c = np.arange(1, 16 * 1024, 4)[:3000]  # spread like a: no overflow
    return runs(7, [a, b, c], tc)


@pytest.mark.parametrize("tc", [False, True])
def test_windowed_overflow_flag_per_query(tc):
    cols, t_starts, t_dfs = skewed_runs(tc)
    T, L, G, M = 2, 2048, 32, 20
    assert TK.default_win(L, G) == JK.default_win(L, G) == 6
    B = 4
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    for b, (c, o) in enumerate(((0, 1), (0, 2), (2, 0))):
        starts[b] = t_starts[[c, o]]
        ends[b] = t_starts[[c, o]] + t_dfs[[c, o]]
    w = (np.where(ends > starts, 1.5, 0).astype(np.float32) if tc
         else np.where(ends > starts, 1, 0).astype(np.float32))
    if tc:
        args = (cols[0], cols[1], np.float32(31.5), starts, ends, w)
        want = np.asarray(jref(JK.make_windowed_search_kernel(
            T, L, G, M, mode="tc"), *args))
        got = TK.make_windowed_search_kernel(T, L, G, M, mode="tc")(
            *(T_(a) for a in args)).numpy()
    else:
        args = cols + (starts, ends, w)
        want = zero_unkept_tfs(np.asarray(JK.make_windowed_search_kernel(
            T, L, G, M)(*(jnp.asarray(a) for a in args))), T)
        got = TK.make_windowed_search_kernel(T, L, G, M)(
            *(torch.from_numpy(a) for a in args)).numpy()
    flags = got[:, T + 1, 0]
    np.testing.assert_array_equal(flags & TK.FLAG_OVERFLOW,
                                  want[:, T + 1, 0] & TK.FLAG_OVERFLOW)
    assert ((flags & TK.FLAG_OVERFLOW) != 0).tolist() == [True, False, False,
                                                          False]
    if not tc:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [2, 3, 4])
def test_windowed_search_kernel_tc(T):
    L, G, M = 2048, 32, 20
    sets = random_sets(T, 6, 1200, 2048, 8 * 2048)
    (doc, tc), t_starts, t_dfs = runs(T + 1, sets, tc=True)
    starts, ends, idf32 = group(T + 9, T, t_starts, t_dfs, tc=True)
    args = (doc, tc, np.float32(57.25), starts, ends, idf32)
    want = np.asarray(jref(JK.make_windowed_search_kernel(T, L, G, M,
                                                          mode="tc"), *args))
    got = TK.make_windowed_search_kernel(T, L, G, M, mode="tc")(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > 10
    assert ((got[:, T + 1, 0] & TK.FLAG_TF_SAT) != 0).any()


# -- engine level ------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_corpus():
    """test_windowed.py's corpus: a 10-term vocabulary, so every list is
    long and lists are of similar length."""
    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(10)]
    docs = [make_docinfo(list(rng.choice(vocab, size=rng.integers(3, 12))),
                         with_blooms=False) for _ in range(3000)]
    return build_index(docs)


@pytest.fixture(scope="module")
def skewed_corpus():
    """The overflow layout at engine level: 'a' in every 16th of 16,384
    docs (df 1,024), 'b' in docs 0..4095, 'c' every 4th doc from 1."""
    docs = []
    for i in range(16384):
        toks = [f"f{i % 50}"]
        if i % 16 == 0:
            toks.append("a")
        if i < 4096:
            toks.append("b")
        if i % 4 == 1 and i < 12000:
            toks.append("c")
        docs.append(make_docinfo(toks, with_blooms=False))
    return build_index(docs)


def windowed_count(je, monkeypatch):
    """Queries TpuEngine dispatches to its windowed kernel (L2 != 0)."""
    n = [0]
    orig = je._dispatch_flat

    def spy(T, L, L2, *a, **kw):
        if L2:
            n[0] += len(a[6])  # qis
        return orig(T, L, L2, *a, **kw)

    monkeypatch.setattr(je, "_dispatch_flat", spy)
    return n


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_engines_route_windowed_alike(dense_corpus, monkeypatch, columns):
    jp, oracle = dense_corpus
    te = TorchEngine(to_port(jp), device="cpu", dense_budget_bytes=0,
                     columns=columns)
    je = TpuEngine(jp, dense_budget_bytes=0, columns=columns)
    n_j = windowed_count(je, monkeypatch)
    rng = np.random.default_rng(1)
    qs = [SearchQuery([f"w{i}" for i in rng.choice(10, size=n,
                                                   replace=False)],
                      n_results=k)
          for n in (2, 3, 4) for k in (1, 10, 40) for _ in range(3)]
    qs += [SearchQuery(["w3"], n_results=10), SearchQuery(["w0", "w0"])]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    assert st["route_windowed"] == n_j[0] > 20
    assert st.get("flag_overflow", 0) == 0


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_engines_overflow_takes_the_host(skewed_corpus, monkeypatch,
                                         columns):
    jp, oracle = skewed_corpus
    te = TorchEngine(to_port(jp), device="cpu", dense_budget_bytes=0,
                     columns=columns)
    je = TpuEngine(jp, dense_budget_bytes=0, columns=columns)
    n_j = windowed_count(je, monkeypatch)
    host = []
    orig = te._host_exact
    monkeypatch.setattr(te, "_host_exact", lambda rows, k, p=False: (
        host.append(tuple(rows)), orig(rows, k, p))[1])
    qs = [SearchQuery(t, n_results=k) for t in (["a", "b"], ["b", "a"],
                                                ["a", "c"], ["c", "b"])
          for k in (5, 10)]
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    st = te.stats_take()
    assert st["route_windowed"] == n_j[0] == len(qs)
    assert st["flag_overflow"] > 0
    assert {jp.lookup("a"), jp.lookup("b")} in [set(rows) for rows in host]
