"""The resident phrase path's steps in wiser_tpu_torch against wiser_tpu.

The same seeded numpy inputs (real index columns, bloom columns and
probes of a synth corpus, assembled by TpuEngine's own helpers) go
through the JAX step and the port's: _bloom_gate, the list chain
(make_match_kernel, make_phrase_verify_kernel, make_select_topk_kernel),
_verify_pos_windows, the compact, semidense and full-scan phrase
kernels. With tie-free scores (random f32 partial scores or dense rows)
outputs are equal with tolerance 0. Compaction keeps lax.top_k's
index-ascending tie order (a stable sort), so with tied scores the
compacted set is still the reference's: flags and unseen bounds are
equal, and each packed row holds the same (doc, tfs) lanes (compared in
doc order, since the final top-M, torch.topk, orders equal scores
freely). On the tied BM25 dense planes of a real corpus the full-scan
flags are equal and the re-ranked unflagged rows equal the exact host
phrase answer. The engine-level tests are in test_torch_phrase.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo, synth_docinfos
from wiser_tpu.engine.device import TpuEngine, _PlannedQuery
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.host import PP_BUCKETS, _bucket, host_exact_search
from wiser_tpu_torch.engine.topk import rescore_sorted_arrays


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def T_(a):
    """numpy -> torch; unsigned columns travel as their signed bits, as
    the engine holds them on the device."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def J(a):
    return jnp.asarray(a)


def pq_group(jp, term_lists, k=5):
    group = []
    for i, terms in enumerate(term_lists):
        rows = [jp.lookup(t) for t in terms]
        pq = _PlannedQuery(i, rows, JQuery(terms, n_results=k, is_phrase=True))
        pq.plan_slots(jp.df)
        group.append(pq)
    return group


@pytest.fixture(scope="module")
def kcorpus():
    """A bloom index, its TpuEngine's device columns, and a tie-free
    random partial-score column on the same postings."""
    jp, _ = build_index(synth_docinfos(900, 60, 30, seed=3), with_blooms=True)
    je = TpuEngine(jp, dense_budget_bytes=0)
    rng = np.random.default_rng(0)
    score = je._h_score.copy()
    live = score > 0
    score[live] = (rng.random(int(live.sum())) + 0.01).astype(np.float32)
    return jp, je, score


def _phrase_terms(seed, n, T, n_vocab=40):
    rng = np.random.default_rng(seed)
    return [[f"t{r}" for r in rng.choice(n_vocab, size=T, replace=False)]
            for _ in range(n)]


def _group_inputs(jp, je, T, seed, n=24):
    # head terms meet: the longer the phrase, the fewer terms to draw from
    group = pq_group(jp, _phrase_terms(seed, n, T, n_vocab=48 // T))
    L = max(_bucket(int(jp.df[pq.slot_rows[0]]), je._lb) for pq in group)
    starts, ends, use, _, _, slot_of, ks = je._assemble(
        group, T, buckets=je.PHRASE_B_BUCKETS)
    probes = je._assemble_bloom_probes(group, T, starts.shape[0])
    PP = max(_bucket(int(jp.max_tf[pq.rows[0]]), PP_BUCKETS) for pq in group)
    PW = max(_bucket(int(max(jp.max_tf[pq.rows])), PP_BUCKETS)
             for pq in group)
    return L, PP, PW, starts, ends, use, slot_of.astype(np.int32), ks, probes


def _blooms(je):
    return (je._h_bloom_rows, je._h_bloom_bitmap, je._h_bloom_rank)


def test_bloom_gate_exact(kcorpus):
    """Random posting indices over the whole column (every bit position of
    the presence words, both sides) against the real sparse bloom
    columns and real probe masks, some inactive."""
    jp, je, _ = kcorpus
    rng = np.random.default_rng(4)
    B, T, L, C = 16, 3, 512, 2
    pidx = rng.integers(0, jp.n_postings, size=(B, T, L)).astype(np.int32)
    probe_slot = rng.integers(0, T, size=(B, C)).astype(np.int32)
    probe_begins = rng.random((B, C)) < 0.5
    probe_mask = np.array([[jp.bloom_cfg.probe_mask_folded(f"t{rng.integers(40)}")
                            for _ in range(C)] for _ in range(B)],
                          dtype=np.uint32)
    probe_active = rng.random((B, C)) < 0.8
    args = (pidx,) + _blooms(je) + (probe_slot, probe_begins, probe_mask,
                                    probe_active)
    want = np.asarray(JK._bloom_gate(*(J(a) for a in args), B=B, L=L))
    got = TK._bloom_gate(*(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size  # the gate both passes and prunes


def test_popcount32_is_the_bit_count():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.integers(0, 2**32, size=2000, dtype=np.uint64),
                        [0, 1, 2**31, 2**32 - 1, 0x55555555, 0xAAAAAAAA]])
    got = TK._popcount32(torch.from_numpy(v.astype(np.int64))).numpy()
    want = [bin(int(x)).count("1") for x in v]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [2, 3, 4])
def test_list_chain_exact(kcorpus, T):
    """match -> verify (query-term order) -> select, tolerance 0."""
    jp, je, score = kcorpus
    L, PP, _, starts, ends, use, slot_of, ks, probes = _group_inputs(
        jp, je, T, seed=10 + T)
    n_it = JK.n_iters_for(je._max_df)
    margs = (je._h_doc, score, starts, ends, use) + _blooms(je) + probes
    want = JK.make_match_kernel(T, L, n_it)(*(J(a) for a in margs))
    got = TK.make_match_kernel(T, L, n_it)(*(T_(a) for a in margs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    match, bloom_pass, cdocs, pidx, sc = (np.asarray(w) for w in want)
    active = match & bloom_pass
    assert active.sum() > 0 and (match & ~bloom_pass).sum() > 0
    pidx_q = np.take_along_axis(pidx, slot_of[:, :, None].repeat(L, 2), 1)
    n_pos = JK.n_iters_for(int(jp.max_tf.max()))
    pos = je._h_positions
    pstarts = jp.pos_starts.astype(np.int32)
    vargs = (pos, pstarts, pidx_q, active)
    want_n = np.asarray(JK.make_phrase_verify_kernel(T, L, PP, n_pos)(
        *(J(a) for a in vargs)))
    got_n = TK.make_phrase_verify_kernel(T, L, PP, n_pos)(
        *(T_(a) for a in vargs)).numpy()
    np.testing.assert_array_equal(got_n, want_n)
    final = active & (want_n > 0)
    M = 20
    sargs = (je._h_tf, cdocs, pidx, sc, final)
    want_s = np.asarray(JK.make_select_topk_kernel(T, L, M)(
        *(J(a) for a in sargs)))
    got_s = TK.make_select_topk_kernel(T, L, M)(*(T_(a) for a in sargs)).numpy()
    np.testing.assert_array_equal(got_s, want_s)
    if T == 2:
        assert (got_s[:, 0] >= 0).sum() > 0  # real phrase matches


def test_verify_pos_windows_exact(kcorpus):
    """Random bags of the real positions column, every anchor, bags
    shorter and longer than the windows, starts up to the column end."""
    jp, je, _ = kcorpus
    rng = np.random.default_rng(6)
    B, T, NL, PP, PW = 8, 3, 200, 8, 32
    P = jp.n_postings
    pidx = rng.integers(0, P, size=(B, T, NL))
    pidx[:, :, :4] = P - 1 - np.arange(4)  # the last bags of the column
    ps = jp.pos_starts[pidx].astype(np.int32)
    pe = jp.pos_starts[pidx + 1].astype(np.int32)
    anchor = rng.integers(0, T, size=B).astype(np.int32)
    args = (je._h_positions, ps, pe, anchor)
    want = np.asarray(JK._verify_pos_windows(*(J(a) for a in args), T=T,
                                             NL=NL, PP=PP, PW=PW))
    got = TK._verify_pos_windows(*(T_(a) for a in args), T=T, NL=NL, PP=PP,
                                 PW=PW).numpy()
    np.testing.assert_array_equal(got, want)
    # adjacent bags of one doc: the phrase "t_i t_j" where it occurs
    assert want.dtype == got.dtype == np.int32


@pytest.mark.parametrize("T,KV", [(2, 4), (3, 4), (2, 16), (2, 64)])
def test_compact_phrase_kernel_exact(kcorpus, T, KV):
    jp, je, score = kcorpus
    L, PP, PW, starts, ends, use, slot_of, ks, probes = _group_inputs(
        jp, je, T, seed=20 + T + KV)
    assert L > KV
    n_it = JK.n_iters_for(je._max_df)
    M = min(KV, 10)
    if KV == 4:  # k = KV: a row with fewer verified lanes must flag
        ks = np.where(ks > 0, KV, 0).astype(np.int32)
    args = ((je._h_doc, score, je._h_tf, je._h_positions,
             jp.pos_starts.astype(np.int32), starts, ends, use, slot_of, ks)
            + _blooms(je) + probes)
    want = np.asarray(JK.make_compact_phrase_kernel(
        T, L, KV, PP, PW, M, n_it, 3e-6)(*(J(a) for a in args)))
    got = TK.make_compact_phrase_kernel(T, L, KV, PP, PW, M, n_it, 3e-6)(
        *(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    flags = got[:, T + 1, 0]
    assert (got[:, 0] >= 0).any()
    assert ((flags & TK.FLAG_PRUNE_MISS) != 0).any() == (KV == 4)


def _rows_by_doc(packed_out, T):
    """Each row's (doc, tfs...) lanes sorted by doc, plus the flags."""
    lanes = np.concatenate([packed_out[:, 0:1], packed_out[:, 1 : T + 1]],
                           axis=1)  # (B, 1+T, M)
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return (np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2),
            packed_out[:, T + 1, 0])


def test_compaction_ties_keep_the_canonical_set(kcorpus):
    """Scores from 3 levels: compaction cuts through tie classes. The
    stable sort keeps lax.top_k's choice (lowest lanes), so the verified
    lanes, the unseen bound and the flags are the reference's."""
    jp, je, score = kcorpus
    T, KV, M = 2, 16, 16
    tied = np.where(score > 0, np.floor(score * 3).astype(np.float32) + 1, 0)
    tied = tied.astype(np.float32)
    L, PP, PW, starts, ends, use, slot_of, ks, probes = _group_inputs(
        jp, je, T, seed=31)
    n_it = JK.n_iters_for(je._max_df)
    args = ((je._h_doc, tied, je._h_tf, je._h_positions,
             jp.pos_starts.astype(np.int32), starts, ends, use, slot_of, ks)
            + _blooms(je) + probes)
    want = np.asarray(JK.make_compact_phrase_kernel(
        T, L, KV, PP, PW, M, n_it, 3e-6)(*(J(a) for a in args)))
    got = TK.make_compact_phrase_kernel(T, L, KV, PP, PW, M, n_it, 3e-6)(
        *(T_(a) for a in args)).numpy()
    g_lanes, g_flags = _rows_by_doc(got, T)
    w_lanes, w_flags = _rows_by_doc(want, T)
    np.testing.assert_array_equal(g_flags, w_flags)
    np.testing.assert_array_equal(g_lanes, w_lanes)
    assert (got[:, 0] >= 0).sum() > 0


# dense-plane kernels: a corpus whose head terms form a dense tier


def _head_phrase_docs(seed, n=1600):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        toks = [f"r{rng.integers(120)}" for _ in range(rng.integers(3, 9))]
        for h in ("h0", "h1", "h2"):
            if rng.random() < 0.75:
                toks.insert(rng.integers(len(toks) + 1), h)
        if rng.random() < 0.3:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["h0", "h1"]
        if rng.random() < 0.1:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["h1", "h2", "h0"]
        docs.append(make_docinfo(toks, with_blooms=True))
    return docs


class _Floor(TpuEngine):
    DENSE_MIN_DF_FLOOR = 64


@pytest.fixture(scope="module")
def dcorpus():
    jp, oracle = build_index(_head_phrase_docs(5), with_blooms=True)
    je = _Floor(jp)
    rng = np.random.default_rng(8)
    sc = je._h_dense_sc.copy()
    live = sc > 0
    sc[live] = (rng.random(int(live.sum())) * 3 + 0.01).astype(np.float32)
    return jp, oracle, je, sc


HEADS = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h0", "h1", "h2"],
         ["h1", "h2", "h0"], ["h2", "h0"])


def _full_inputs(jp, je, term_lists, ks_val):
    T = len(term_lists[0])
    B = 8
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    anchor = np.zeros(B, dtype=np.int32)
    ks = np.zeros(B, dtype=np.int32)
    idf64 = np.zeros((B, T))
    for i, terms in enumerate(term_lists):
        r = [jp.lookup(t) for t in terms]
        starts[i] = je._starts32[r]
        ends[i] = je._starts32[r] + je._df32[r]
        slots[i] = je._dense_slot[r]
        use[i] = 1
        anchor[i] = int(np.argmin(jp.max_tf[r]))
        ks[i] = ks_val
        idf64[i] = jp.idf64[r]
    PP = _bucket(int(jp.max_tf[[jp.lookup(t) for t in term_lists[0]]].min()),
                 PP_BUCKETS)
    PW = 32
    return T, starts, ends, slots, use, anchor, ks, idf64, PP, PW


@pytest.mark.parametrize("T,KV,k", [(2, 40, 5), (3, 40, 5), (2, 300, 10),
                                    (2, 1663, 10)])
def test_full_phrase_kernel_exact(dcorpus, T, KV, k):
    """Random dense rows (tie-free) on the real presence pattern; KV from
    well inside the doc space (misses flag) to all of it (the flat
    selection)."""
    jp, _, je, sc = dcorpus
    n_pad = je._n_pad_docs
    KV = min(KV, n_pad - 1)
    terms = [t for t in HEADS if len(t) == T]
    T, starts, ends, slots, use, anchor, ks, _, PP, PW = _full_inputs(
        jp, je, terms, k)
    M = min(KV, k + 6)
    n_it = JK.n_iters_for(je._max_df)
    args = (sc, je._h_dense_tf, je._h_doc, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, slots, use, anchor,
            ks)
    want = np.asarray(JK.make_full_phrase_kernel(
        T, n_pad, KV, PP, PW, M, n_it, 3e-6)(*(J(a) for a in args)))
    got = TK.make_full_phrase_kernel(T, n_pad, KV, PP, PW, M, n_it, 3e-6)(
        *(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any()


def test_full_phrase_kv_plus_first_lane_stays_in_the_band(dcorpus):
    """Three verified phrase docs A > B > C fill KV = 3; the (KV+1)-th
    lane D scores just under C, inside the eps3 band, and is never
    verified: it alone must raise FLAG_PRUNE_MISS."""
    jp, _, je, sc = dcorpus
    port = to_port(jp)
    cache64 = TorchEngine(port, device="cpu", dense_budget_bytes=0).cache64
    r0, r1 = jp.lookup("h0"), jp.lookup("h1")
    phrase, _ = host_exact_search(port, cache64, [r0, r1], jp.n_docs,
                                  is_phrase=True)
    both, _ = host_exact_search(port, cache64, [r0, r1], jp.n_docs)
    A, B, C = (int(d) for d in phrase[:3])
    D = int(next(d for d in both if d not in phrase))
    s0, s1 = int(je._dense_slot[r0]), int(je._dense_slot[r1])
    planes = sc.copy()
    for s_ in (s0, s1):
        live = planes[s_] > 0
        planes[s_, live] = planes[s_, live] * np.float32(0.01)
    for doc, total in ((A, 10.0), (B, 9.0), (C, 8.0), (D, 8.0 * (1 - 1e-6))):
        planes[s0, doc] = np.float32(total - 0.5)
        planes[s1, doc] = np.float32(0.5)
    c_sc = planes[s0, C] + planes[s1, C]
    d_sc = planes[s0, D] + planes[s1, D]
    assert c_sc * np.float32(1 - 3e-6) <= d_sc < c_sc
    T, starts, ends, slots, use, anchor, ks, _, PP, PW = _full_inputs(
        jp, je, [["h0", "h1"]], 3)
    n_it = JK.n_iters_for(je._max_df)
    args = (planes, je._h_dense_tf, je._h_doc, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, slots, use, anchor,
            ks)
    want = np.asarray(JK.make_full_phrase_kernel(
        T, je._n_pad_docs, 3, PP, PW, 3, n_it, 3e-6)(*(J(a) for a in args)))
    got = TK.make_full_phrase_kernel(T, je._n_pad_docs, 3, PP, PW, 3, n_it,
                                     3e-6)(*(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].tolist() == [A, B, C]
    assert got[0, T + 1, 0] & TK.FLAG_PRUNE_MISS


def test_full_phrase_tied_planes_flags_and_reranked_rows(dcorpus):
    """The real (tied) BM25 dense rows: flags equal; unflagged rows
    re-rank to the oracle's phrase answer."""
    jp, oracle, je, _ = dcorpus
    port = to_port(jp)
    cache64 = TorchEngine(port, device="cpu",
                          dense_budget_bytes=0).cache64
    n_pad = je._n_pad_docs
    checked = 0
    for T in (2, 3):
        terms = [t for t in HEADS if len(t) == T]
        for KV, k in ((40, 5), (600, 10)):
            T, starts, ends, slots, use, anchor, ks, idf64, PP, PW = \
                _full_inputs(jp, je, terms, k)
            M = k + 6
            n_it = JK.n_iters_for(je._max_df)
            args = (je._h_dense_sc, je._h_dense_tf, je._h_doc,
                    je._h_positions, jp.pos_starts.astype(np.int32), starts,
                    ends, slots, use, anchor, ks)
            want = np.asarray(JK.make_full_phrase_kernel(
                T, n_pad, KV, PP, PW, M, n_it, 3e-6)(*(J(a) for a in args)))
            got = TK.make_full_phrase_kernel(
                T, n_pad, KV, PP, PW, M, n_it, 3e-6)(
                *(T_(a) for a in args)).numpy()
            flags = got[: len(terms), T + 1, 0]
            np.testing.assert_array_equal(flags, want[: len(terms), T + 1, 0])
            docs_f, score_f, n_valid = rescore_sorted_arrays(
                got[:, 0, :], got[:, 1 : T + 1, :], idf64, port.doc_len_code,
                cache64)
            for i, t in enumerate(terms):
                if flags[i]:
                    continue
                checked += 1
                want_r = oracle.search(JQuery(t, n_results=k, is_phrase=True))
                n = min(k, int(n_valid[i]))
                assert list(zip(docs_f[i, :n].tolist(),
                                score_f[i, :n].tolist())) == [
                    (e.doc_id, e.doc_score) for e in want_r.entries]
    assert checked >= 3


def _postings_inputs(jp, je, term_lists, k):
    """Slot-ordered inputs of a semidense phrase group: candidate (least
    df) first; dense slots of the other terms."""
    group = pq_group(jp, term_lists, k)
    T = len(term_lists[0])
    starts, ends, use, _, _, slot_of, ks = je._assemble(
        group, T, buckets=je.PHRASE_B_BUCKETS)
    slots = np.zeros(starts.shape, dtype=np.int32)
    for i, pq in enumerate(group):
        slots[i, 1:] = je._dense_slot[pq.slot_rows[1:]]
    L = max(_bucket(int(jp.df[pq.slot_rows[0]]), je._lb) for pq in group)
    PP = max(_bucket(int(jp.max_tf[pq.rows[0]]), PP_BUCKETS) for pq in group)
    return T, L, PP, starts, ends, use, slots, slot_of.astype(np.int32), ks


@pytest.mark.parametrize("KV", [16, 64])
def test_semidense_phrase_kernel_exact(dcorpus, KV):
    """Candidate runs of mid-df terms x random dense rows (tie-free, real
    presence), 2- and 3-term groups."""
    jp, _, je, sc = dcorpus
    rng = np.random.default_rng(KV)
    mids = [t for t in (f"r{i}" for i in range(120)) if jp.lookup(t) >= 0]
    rng.shuffle(mids)
    for T in (2, 3):
        term_lists = []
        for i in range(10):
            heads = list(rng.choice(["h0", "h1", "h2"], size=T - 1,
                                    replace=False))
            pos = int(rng.integers(T))
            term_lists.append(heads[:pos] + [mids[i]] + heads[pos:])
        T, L, PP, starts, ends, use, slots, slot_of, ks = _postings_inputs(
            jp, je, term_lists, 5)
        n_it = JK.n_iters_for(je._max_df)
        score_col = je._h_score.copy()
        live = score_col > 0
        score_col[live] = (rng.random(int(live.sum())) + 0.01).astype(np.float32)
        args = (je._h_doc, score_col, je._h_tf, sc, je._h_positions,
                jp.pos_starts.astype(np.int32), starts, ends, use, slots,
                slot_of, ks)
        M = min(KV, 12)
        want = np.asarray(JK.make_semidense_phrase_kernel(
            T, L, KV, PP, 32, M, je._n_pad_docs, n_it, 3e-6)(
            *(J(a) for a in args)))
        got = TK.make_semidense_phrase_kernel(
            T, L, KV, PP, 32, M, je._n_pad_docs, n_it, 3e-6)(
            *(T_(a) for a in args)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] >= 0).any()


@pytest.mark.parametrize("T", [2, 3])
def test_phrase_body_exact(kcorpus, T):
    """The bloomless phrase pipeline (the staged cold tier's step) on the
    real columns with tie-free scores: packed output and the top-M score
    plane equal, tolerance 0."""
    jp, je, score = kcorpus
    L, PP, _, starts, ends, use, slot_of, ks, _ = _group_inputs(
        jp, je, T, seed=40 + T)
    n_it = JK.n_iters_for(je._max_df)
    n_pos = JK.n_iters_for(int(jp.max_tf.max()))
    M = 20
    args = (je._h_doc, score, je._h_tf, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, use, slot_of)
    kw = dict(T=T, L=L, PP=PP, M=M, n_bs_iters=n_it, n_pos_iters=n_pos)
    want, want_s = jax.jit(lambda *a: JK.phrase_body(*a, **kw))(
        *(J(a) for a in args))
    got, got_s = TK.phrase_body(*(T_(a) for a in args), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    kern = TK.make_phrase_kernel(T, L, PP, M, n_it, n_pos)
    np.testing.assert_array_equal(kern(*(T_(a) for a in args)).numpy(),
                                  np.asarray(want))
    if T == 2:
        assert (got.numpy()[:, 0] >= 0).sum() > 0  # real phrase matches


def _block_planes(sc):
    """Block max, second max (with multiplicity) and argmax lane of
    (H, N_pad) dense score rows, as the engines build them."""
    H, n_pad = sc.shape
    sc3 = sc.reshape(H, n_pad // 128, 128)
    top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
    return (top2[:, :, 1].copy(), top2[:, :, 0].copy(),
            np.argmax(sc3, axis=2).astype(np.uint8))


@pytest.mark.parametrize("T,C,KV,k", [(2, 4, 40, 5), (3, 4, 40, 5),
                                      (2, 6, 300, 10), (2, 12, 1535, 10)])
def test_pruned_phrase_kernel_exact(dcorpus, T, C, KV, k):
    """The block-pruned mega phrase over random dense rows (tie-free) on
    the real presence pattern, with their block planes: a few blocks (the
    guard flags), more, and all but one."""
    jp, _, je, sc = dcorpus
    NB = je._n_pad_docs // 128
    KV = min(KV, C * 128 - 1)
    terms = [t for t in HEADS if len(t) == T]
    T, starts, ends, slots, use, anchor, ks, _, PP, PW = _full_inputs(
        jp, je, terms, k)
    M = min(KV, k + 6)
    n_it = JK.n_iters_for(je._max_df)
    bm, bm2, ap = _block_planes(sc)
    args = (sc, je._h_dense_tf, bm, bm2, ap, je._h_doc, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, slots, use, anchor,
            ks)
    want = np.asarray(JK.make_pruned_phrase_kernel(
        T, NB, C, KV, PP, PW, M, n_it, 3e-6)(*(J(a) for a in args)))
    got = TK.make_pruned_phrase_kernel(T, NB, C, KV, PP, PW, M, n_it, 3e-6)(
        *(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any()
    if C == 4:
        assert (got[:, T + 1, 0] & TK.FLAG_PRUNE_MISS).any()
