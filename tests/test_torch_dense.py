"""The dense head-term tier of wiser_tpu_torch against wiser_tpu.

Kernel level: the same seeded numpy inputs go through the JAX function
and the port's (make_dense_search_kernel, make_semidense_kernel at
n_bs in {0, 1, 2}, _select_ub_blocks with and without the second-order
planes, prune_guard_flag, make_pruned_dense_kernel). On tie-free inputs
(random f32 planes) the packed (B, T+2, M) outputs and next_ub must be
equal exactly (tolerance 0): both sum in slot order, one addend per
slot, and f32 adds round the same everywhere. On tied inputs (BM25
planes of a real corpus) the flag words must be equal, and rows without
FLAG_TRUNC equal after the f64 re-rank (torch.topk has no index
tie-break, so a truncated tie class may keep other lanes).

Engine level: TorchEngine == TpuEngine == OracleEngine at the default
dense budget on the 1600-doc head-term corpora of test_dense_path.py /
test_pruned_dense.py, with PRUNED_DENSE_MIN_NB / PRUNED_DENSE_C lowered
per instance so the pruned scan engages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.topk import rescore_sorted_arrays
from wiser_tpu_torch.types import SearchQuery


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results) for q in qs]


def T_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):
    return jnp.asarray(a)


# -- kernel level: random (tie-free) planes ---------------------------------

H, NB = 7, 40
N_PAD = NB * 128


def _random_planes(seed: int, density: float = 0.7):
    """(H, N_pad) f32 scores (0 = absent) and int32 tfs, with the
    engine's block planes: max, second max with multiplicity, argmax."""
    rng = np.random.default_rng(seed)
    present = rng.random((H, N_PAD)) < density
    sc = np.where(present, rng.random((H, N_PAD)) * 4 + 0.01, 0).astype(np.float32)
    tf = np.where(present, rng.integers(1, 20, (H, N_PAD)), 0).astype(np.int32)
    sc3 = sc.reshape(H, NB, 128)
    top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
    return (sc, tf, top2[:, :, 1].copy(), top2[:, :, 0].copy(),
            np.argmax(sc3, axis=2).astype(np.uint8))


def _slots(seed: int, B: int, T: int):
    """Random distinct dense rows per query; some queries pad slots
    (repeat slot 0, use 0). No all-padding rows: their lanes all tie at
    0, and which tied lanes top-k keeps is free."""
    rng = np.random.default_rng(seed)
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    ks = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(1 if T == 1 else 2, T + 1))
        rows = rng.choice(H, size=n, replace=False)
        slots[b] = np.concatenate([rows, np.full(T - n, rows[0])])
        use[b, :n] = 1.0
        ks[b] = int(rng.choice([1, 5, 10, 30]))
    return slots, use, ks


@pytest.fixture(scope="module")
def planes():
    return _random_planes(seed=3)


@pytest.mark.parametrize("T,M", [(2, 20), (3, 20), (4, 64)])
def test_dense_search_kernel_exact(planes, T, M):
    sc, tf, *_ = planes
    slots, use, _ = _slots(10 + T, 12, T)
    want = np.asarray(JK.make_dense_search_kernel(T, N_PAD, M)(
        J(sc), J(tf), J(slots), J(use)))
    got = TK.make_dense_search_kernel(T, N_PAD, M)(
        T_(sc), T_(tf), T_(slots), T_(use)).numpy()
    assert got.shape == want.shape == (12, T + 2, M)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).sum() > 12  # real matches


@pytest.mark.parametrize("second_order", [False, True])
@pytest.mark.parametrize("T", [1, 2, 3])
def test_select_ub_blocks_exact(planes, T, second_order):
    _, _, bm, bm2, ap = planes
    slots, use, _ = _slots(20 + T, 16, T)
    C = 9
    kw = dict(blockmax2=bm2, argpos=ap) if second_order else {}
    jb, jn = JK._select_ub_blocks(
        J(bm), J(slots), J(use), T=T, NB=NB, C=C,
        **{k: J(v) for k, v in kw.items()})
    tb, tn = TK._select_ub_blocks(
        T_(bm), T_(slots), T_(use), T=T, NB=NB, C=C,
        **{k: T_(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (np.diff(tb.numpy(), axis=1) > 0).all()  # ascending block ids


def test_select_ub_blocks_joint_presence_mask():
    """A block missing a live term has bound 0; a padded slot (weight 0)
    does not constrain feasibility (test_pruned_dense.py's case)."""
    bm = np.array([[9.0, 0.0, 1.0, 0.0], [0.0, 9.0, 1.0, 0.0]], dtype=np.float32)
    slots = np.array([[0, 1]], dtype=np.int32)
    blk, nxt = TK._select_ub_blocks(T_(bm), T_(slots), torch.ones(1, 2),
                                    T=2, NB=4, C=1)
    assert int(blk[0, 0]) == 2 and float(nxt[0]) == 0.0
    w_pad = np.array([[1.0, 0.0]], dtype=np.float32)
    blk, nxt = TK._select_ub_blocks(T_(bm), T_(slots), T_(w_pad),
                                    T=2, NB=4, C=1)
    assert int(blk[0, 0]) == 0 and float(nxt[0]) == 1.0


def test_prune_guard_flag_exact():
    rng = np.random.default_rng(5)
    B, M = 64, 16
    top = -np.sort(-rng.random((B, M)).astype(np.float32), axis=1)
    top[rng.random((B, M)) < 0.2] = -np.inf  # fewer than k matches
    top = -np.sort(-top, axis=1)
    ks = rng.integers(0, M + 4, size=B).astype(np.int32)  # ks-1 clipped
    kth = top[np.arange(B), np.clip(ks - 1, 0, M - 1)]
    nxt = np.where(rng.random(B) < 0.5, kth, rng.random(B)).astype(np.float32)
    nxt[:4] = 0.0
    # right at the (1 - eps3) edge, both sides
    edge = (kth * np.float32(1.0 - 3e-6)).astype(np.float32)
    nxt[4:8] = np.where(np.isfinite(edge[4:8]), edge[4:8], 1.0)
    nxt[8:12] = np.nextafter(nxt[4:8], np.float32(0))
    want = np.asarray(JK.prune_guard_flag(J(top), J(nxt), J(ks), M=M, eps3=3e-6))
    got = TK.prune_guard_flag(T_(top), T_(nxt), T_(ks), M=M, eps3=3e-6).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got != 0).sum() < B


@pytest.mark.parametrize("T,C,M", [(2, 6, 20), (3, 8, 16), (2, 12, 64)])
def test_pruned_dense_kernel_exact(planes, T, C, M):
    sc, tf, bm, bm2, ap = planes
    slots, use, ks = _slots(30 + T + C, 16, T)
    want = np.asarray(JK.make_pruned_dense_kernel(T, NB, C, M, 3e-6)(
        J(sc), J(tf), J(bm), J(bm2), J(ap), J(slots), J(use), J(ks)))
    got = TK.make_pruned_dense_kernel(T, NB, C, M, 3e-6)(
        T_(sc), T_(tf), T_(bm), T_(bm2), T_(ap), T_(slots), T_(use),
        T_(ks)).numpy()
    np.testing.assert_array_equal(got, want)
    flags = got[:, T + 1, 0]
    assert ((flags & TK.FLAG_PRUNE_MISS) != 0).any()


def _random_postings(seed: int, n_terms: int = 6, L: int = 1024):
    """Random CSR posting columns over the N_PAD doc space: sorted doc
    runs padded to 128 with the sentinel, random f32 scores and tfs, and
    one max-L of slack past the data."""
    rng = np.random.default_rng(seed)
    docs, scores, tfs, starts, dfs = [], [], [], [], []
    pos = 0
    for t in range(n_terms):
        df = int(rng.integers(L // 2, L))
        d = np.sort(rng.choice(N_PAD - 64, size=df, replace=False)).astype(np.int32)
        pad = (-df) % 128
        starts.append(pos)
        dfs.append(df)
        docs.append(np.concatenate([d, np.full(pad, 2**31 - 1, np.int32)]))
        scores.append(np.concatenate([
            (rng.random(df) * 3 + 0.01).astype(np.float32),
            np.zeros(pad, np.float32)]))
        tfs.append(np.concatenate([rng.integers(1, 9, df).astype(np.int32),
                                   np.zeros(pad, np.int32)]))
        pos += df + pad
    slack = L + 4096
    return (np.concatenate(docs + [np.full(slack, 2**31 - 1, np.int32)]),
            np.concatenate(scores + [np.zeros(slack, np.float32)]),
            np.concatenate(tfs + [np.zeros(slack, np.int32)]),
            np.asarray(starts), np.asarray(dfs))


@pytest.mark.parametrize("T,n_bs", [(2, 0), (3, 0), (3, 1), (4, 2)])
def test_semidense_kernel_exact(planes, T, n_bs):
    sc, tf, *_ = planes
    p_doc, p_sc, p_tf, t_starts, t_dfs = _random_postings(40 + T + n_bs)
    L, M, B = 1024, 24, 12
    rng = np.random.default_rng(50 + T + n_bs)
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    slots = np.zeros((B, T), dtype=np.int32)
    for b in range(B):
        terms = rng.choice(len(t_starts), size=1 + n_bs, replace=False)
        for s, t in enumerate(terms):  # candidate + bs slots
            starts[b, s] = t_starts[t]
            ends[b, s] = t_starts[t] + t_dfs[t]
        n_dense = int(rng.integers(1, T - n_bs + 1))
        rows = rng.choice(H, size=n_dense, replace=False)
        for j in range(T - 1 - n_bs):
            slots[b, 1 + n_bs + j] = rows[min(j, n_dense - 1)]
        use[b, : 1 + n_bs + n_dense] = 1.0
    n_it = TK.n_iters_for(L)
    args = (p_doc, p_sc, p_tf, sc, tf, starts, ends, use, slots)
    want = np.asarray(JK.make_semidense_kernel(T, L, M, N_PAD, n_bs, n_it)(
        *(J(a) for a in args)))
    got = TK.make_semidense_kernel(T, L, M, N_PAD, n_bs, n_it)(
        *(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).sum() > B  # real intersections


# -- kernel level: BM25 planes with exact ties --------------------------------


def _head_docs(seed: int):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(1600):
        toks = [t for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7))
                if rng.random() < p]
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=False))
    return docs


def _varied_docs(seed: int):
    """Head terms with varied tfs and doc lengths: many distinct f32
    score classes, so some rows keep their boundary class whole."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(1600):
        toks = []
        for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7)):
            if rng.random() < p:
                toks += [t] * int(rng.integers(1, 6))
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 40))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=False))
    return docs


@pytest.fixture(scope="module")
def flat_corpus():
    """The head-term corpus of test_dense_path.py / test_pruned_dense.py
    (seed 23): flat block bounds, so the prune guard cannot certify."""
    jp, oracle = build_index(_head_docs(23))
    return jp, to_port(jp), oracle


def _rerank(packed_out, T, idf64, port):
    return rescore_sorted_arrays(
        packed_out[:, 0, :], packed_out[:, 1 : T + 1, :], idf64,
        port.doc_len_code, TorchEngine(port, device="cpu",
                                       dense_budget_bytes=0).cache64)


@pytest.mark.parametrize("pruned", [False, True])
def test_tied_planes_flags_and_reranked_results(pruned):
    jp, _ = build_index(_varied_docs(31))
    port = to_port(jp)
    je = TpuEngine(jp)
    rows = [jp.lookup(t) for t in ("h0", "h1", "h2")]
    slot = [int(je._dense_slot[r]) for r in rows]
    combos = [(0, 1), (1, 2), (0, 2), (1, 0), (0, 1, 2), (2, 1, 0)]
    T, M = 3, (6 if pruned else 24)
    B = len(combos) * 2
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf64 = np.zeros((B, T))
    ks = np.zeros(B, dtype=np.int32)
    for b in range(B):
        c = combos[b % len(combos)]
        slots[b] = [slot[i] for i in c] + [slot[c[0]]] * (T - len(c))
        use[b, : len(c)] = 1
        idf64[b, : len(c)] = jp.idf64[[rows[i] for i in c]]
        ks[b] = 1 if b < len(combos) else 5
    planes = (je._h_dense_sc, je._h_dense_tf)
    NBj = je._n_pad_docs // 128
    if pruned:
        extra = (je._h_dense_blockmax, je._h_dense_blockmax2,
                 je._h_dense_argpos, slots, use, ks)
        want = np.asarray(JK.make_pruned_dense_kernel(T, NBj, 4, M, 3e-6)(
            *(J(a) for a in planes + extra)))
        got = TK.make_pruned_dense_kernel(T, NBj, 4, M, 3e-6)(
            *(T_(a) for a in planes + extra)).numpy()
    else:
        want = np.asarray(JK.make_dense_search_kernel(T, je._n_pad_docs, M)(
            *(J(a) for a in planes + (slots, use))))
        got = TK.make_dense_search_kernel(T, je._n_pad_docs, M)(
            *(T_(a) for a in planes + (slots, use))).numpy()
    flags = got[:, T + 1, 0]
    np.testing.assert_array_equal(flags, want[:, T + 1, 0])
    assert ((flags & TK.FLAG_TRUNC) != 0).any()  # ties reach the buffer
    clean = (flags & TK.FLAG_TRUNC) == 0
    assert clean.any()
    gd, gs, gn = _rerank(got[clean], T, idf64[clean], port)
    wd, ws, wn = _rerank(want[clean], T, idf64[clean], port)
    np.testing.assert_array_equal(gn, wn)
    for i in range(int(clean.sum())):
        k = min(int(ks[clean][i]), int(gn[i]))
        np.testing.assert_array_equal(gd[i, :k], wd[i, :k])
        np.testing.assert_array_equal(gs[i, :k], ws[i, :k])


# -- engine level ------------------------------------------------------------


def _pair(jp, port, C=None, min_nb=None, **kw):
    je = TpuEngine(jp, **kw)
    te = TorchEngine(port, device="cpu", **kw)
    for e in (je, te):
        if C is not None:
            e.PRUNED_DENSE_C = C
            e.PRUNED_DENSE_MIN_NB = min_nb
    return je, te


def test_dense_planes_equal_tpu_engine(flat_corpus):
    jp, port, _ = flat_corpus
    je, te = _pair(jp, port)
    assert te._dense_H == je._dense_H >= 3
    np.testing.assert_array_equal(te._dense_slot, je._dense_slot)
    for mine, ref in ((te.d_dense_sc, je._h_dense_sc),
                      (te.d_dense_tf, je._h_dense_tf),
                      (te.d_dense_blockmax, je._h_dense_blockmax),
                      (te.d_dense_blockmax2, je._h_dense_blockmax2),
                      (te.d_dense_argpos, je._h_dense_argpos)):
        assert mine.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(mine.numpy(), ref)
    per_row = te._n_pad_docs * 8 + (te._n_pad_docs // 128) * 9
    assert te.device_bytes()["dense_tier"] == je.device_bytes()["dense_tier"] \
        == te._dense_H * per_row


@pytest.mark.parametrize("budget_rows", [0, 1, 2])
def test_budget_caps_rows_like_tpu_engine(flat_corpus, budget_rows):
    jp, port, _ = flat_corpus
    n_pad = (jp.n_docs + 127) // 128 * 128
    budget = budget_rows * (n_pad * 8 + (n_pad // 128) * 9) + 7
    je, te = _pair(jp, port, dense_budget_bytes=budget)
    assert te._dense_H == je._dense_H == budget_rows
    np.testing.assert_array_equal(te._dense_slot, je._dense_slot)


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
        calls.append(tuple(rows))
        return orig(rows, k, is_phrase)

    monkeypatch.setattr(engine, "_host_exact", wrapped)
    return calls


HEAD_TERMS = (["h0", "h1"], ["h1", "h2"], ["h0", "h1", "h2"], ["h2", "h0"])


def _three_way(jp, oracle, te, je, qs):
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    return got


def test_plain_dense_route(flat_corpus, monkeypatch):
    """13 doc blocks < PRUNED_DENSE_MIN_NB: all-head queries take the
    full doc-space scan."""
    jp, port, oracle = flat_corpus
    je, te = _pair(jp, port)
    called = spy(monkeypatch, "make_dense_search_kernel")
    qs = [SearchQuery(t, n_results=k) for t in HEAD_TERMS for k in (1, 5, 37)]
    _three_way(jp, oracle, te, je, qs)
    assert called
    st = te.stats_take()
    assert st["route_dense"] == len(qs) and "route_pruned" not in st


def test_guard_fires_and_rescue_restores_parity(flat_corpus, monkeypatch):
    """Flat bounds: the prune guard cannot certify; the flagged rows are
    rescued by the batched full scan, with no host fallback."""
    jp, port, oracle = flat_corpus
    je, te = _pair(jp, port, C=4, min_nb=8)
    pruned = spy(monkeypatch, "make_pruned_dense_kernel")
    host = spy_host(te, monkeypatch)
    qs = [SearchQuery(t, n_results=10) for t in HEAD_TERMS]
    _three_way(jp, oracle, te, je, qs)
    st = te.stats_take()
    assert pruned and st["route_pruned"] == len(qs)
    assert st["flag_prune_miss"] > 0 and st["prune_rescued"] > 0
    assert st["forced_host_after_rescue"] == 0
    # the only host runs are rows whose k-th place reaches a truncated
    # f32 tie class (which tied lanes torch.topk kept is free)
    assert len(host) == st.get("forced_host_tie_cut", 0)


def test_guard_fires_host_fallback_without_rescue(flat_corpus, monkeypatch):
    jp, port, oracle = flat_corpus
    je, te = _pair(jp, port, C=4, min_nb=8)
    for e in (je, te):
        monkeypatch.setattr(e, "DENSE_RESCUE", False)
    host = spy_host(te, monkeypatch)
    qs = [SearchQuery(t, n_results=10) for t in HEAD_TERMS[:3]]
    _three_way(jp, oracle, te, je, qs)
    st = te.stats_take()
    assert st["flag_prune_miss"] > 0 and "prune_rescued" not in st
    assert host


@pytest.fixture(scope="module")
def skewed_corpus():
    """The first two 128-doc blocks hold high-tf short docs: the top-C
    bound blocks provably hold the whole top-k."""
    docs = []
    for i in range(1600):
        if i < 256:
            toks = ["h0"] * 4 + ["h1"] * 4 + [f"f{j}" for j in range(i % 5)]
        else:
            toks = ["h0", "h1"] + [f"g{i}_{j}" for j in range(28 + i % 7)]
        docs.append(make_docinfo(toks, with_blooms=False))
    jp, oracle = build_index(docs)
    return jp, to_port(jp), oracle


def test_prune_proves_exact_without_fallback(skewed_corpus, monkeypatch):
    jp, port, oracle = skewed_corpus
    je, te = _pair(jp, port, C=4, min_nb=8)
    pruned = spy(monkeypatch, "make_pruned_dense_kernel")
    host = spy_host(te, monkeypatch)
    qs = [SearchQuery(["h0", "h1"], n_results=k) for k in (1, 10)]
    _three_way(jp, oracle, te, je, qs)
    st = te.stats_take()
    assert pruned and st.get("flag_prune_miss", 0) == 0
    assert "prune_rescued" not in st and not host


def test_prune_mask_proves_disjoint_support(monkeypatch):
    """h0-only and h1-only blocks outscore the joint ones: without the
    joint-presence mask the guard would flag every query."""
    docs = []
    for i in range(1600):
        if i < 256:
            toks = ["h0"] * 6 + [f"f{i % 17}"]
        elif i < 512:
            toks = ["h1"] * 6 + [f"f{i % 13}"]
        elif i < 608 and i % 2 == 0:
            toks = ["h0", "h1"] + [f"g{i % 11}"] * 3
        else:
            toks = [f"g{i % 23}"] * 5
        docs.append(make_docinfo(toks, with_blooms=False))
    jp, oracle = build_index(docs)
    port = to_port(jp)
    # h0/h1 have df ~300: lower the eligibility floor for construction
    monkeypatch.setattr(TpuEngine, "DENSE_MIN_DF_FLOOR", 64)
    monkeypatch.setattr(TorchEngine, "DENSE_MIN_DF_FLOOR", 64)
    je, te = _pair(jp, port, C=4, min_nb=8)
    for e in (je, te):
        e.SEMI_FROM_DENSE_MAX_CAND_L = 0  # all-dense -> pruned
    host = spy_host(te, monkeypatch)
    qs = [SearchQuery(["h0", "h1"], n_results=k) for k in (5, 10)]
    _three_way(jp, oracle, te, je, qs)
    st = te.stats_take()
    assert st["route_pruned"] == 2 and st.get("flag_prune_miss", 0) == 0
    assert not host


def test_semidense_routes(flat_corpus, monkeypatch):
    """Tail candidate x dense others, with and without non-dense (bs)
    others."""
    jp, port, oracle = flat_corpus
    je, te = _pair(jp, port)
    called = spy(monkeypatch, "make_semidense_kernel")
    qs = [SearchQuery(t, n_results=10) for t in (
        ["r5", "h0"], ["h0", "r5", "h1"], ["r3", "h2", "h0"],
        ["r5", "r9", "h0"], ["h0", "r5", "h1", "r9"], ["r3", "h2", "r7"])]
    _three_way(jp, oracle, te, je, qs)
    assert {a[4] for a in called} >= {0, 1}  # n_bs = 0 and > 0 groups
    assert te.stats_take()["route_semidense"] == len(qs)


def test_mixed_batch_duplicates_and_long_queries(flat_corpus):
    """One batch over every route: dense, pruned with rescue, semidense,
    bs, single terms, duplicates (coalesced, some rescued) and queries of
    more than 8 terms (oracle only: TpuEngine's long-tail assembly cannot
    hold them)."""
    jp, port, oracle = flat_corpus
    je, te = _pair(jp, port, C=4, min_nb=8)
    rng = np.random.default_rng(9)
    vocab = ["h0", "h1", "h2"] + [f"r{i}" for i in range(0, 200, 3)]
    qs = []
    for _ in range(120):
        n = int(rng.integers(1, 5))
        picks = rng.choice(len(vocab), size=n, replace=False,
                           p=np.r_[[0.2] * 3, [0.4 / (len(vocab) - 3)]
                                   * (len(vocab) - 3)])
        qs.append(SearchQuery([vocab[p] for p in picks],
                              n_results=int(rng.choice([1, 3, 10, 40]))))
    qs += qs[:30]  # duplicates
    short = _three_way(jp, oracle, te, je, qs)
    assert sum(map(len, short)) > 500
    st = te.stats_take()
    assert st["route_pruned"] and st["route_semidense"] and st["route_bs"]
    assert st["prune_rescued"] > 0 and st["q_coalesced"] >= 30
    long_qs = [SearchQuery(["h0", "h1", "h2"] + [f"r{i}" for i in range(j, j + 7)],
                           n_results=10) for j in range(0, 40, 4)]
    long_qs += [SearchQuery(["h1", "h0", "h2", "h1", "h0", "h2", "h1", "h0",
                             "h2"], n_results=5)] * 2
    got = lists(te.search_batch(long_qs + qs[:10]))
    assert got == lists(oracle.search(q) for q in jq(long_qs + qs[:10]))
    assert any(got[-12:-10])


def test_default_budget_is_the_reference_default(flat_corpus):
    jp, port, _ = flat_corpus
    import inspect

    je, te = TpuEngine(jp), TorchEngine(port, device="cpu")
    assert inspect.signature(TorchEngine).parameters[
        "dense_budget_bytes"].default == 7 << 29
    assert te._dense_H == je._dense_H > 0
