"""The tc (compressed column) steps of wiser_tpu_torch against wiser_tpu.

The same seeded numpy inputs go through the JAX step (on the CPU) and the
port's: tc_score over all 65,536 lanes, the f64 block bound
_tc_score64_ub, tc_saturated, make_search_kernel(mode="tc") at T in {1,
2, 3, 4, 8}, the tc list chain (make_match_kernel_tc,
make_phrase_verify_kernel, make_select_topk_kernel_tc), the tc compact
and semidense phrase kernels, make_semidense_kernel_tc at n_bs in {0, 1,
2}, make_dense_search_kernel_tc, make_pruned_dense_kernel_tc and
make_full_phrase_kernel_tc, with its exact payload-tie refinement.

Hard inputs everywhere: the tc lanes carry random len codes over 0..231
(so codes >= 128, whose uint16 lanes are negative int16 bits on the
device) and random tf bytes with 255 (saturated) among them.

Each JAX step runs as one jitted program compiled with XLA's backend
optimization level 0 (jref): at its default level XLA's CPU compiler
contracts a multiply and an add into an FMA, which the reference's op
order does not ask for and the port, one torch op per operation, never
does (on the card an FMA would round differently from the f32 order the
guards' rel_eps and the pruned proof assume). test_tc_score_exhaustive
holds the level-0 program bit-equal to the op-by-op (jax.disable_jit)
result, and the default-level program within 4 ulps of it.

Tolerances: tc_score and the f64 bound are bit-equal (tolerance 0), and
so is every f32 score the steps compute, since both sum in the same
fixed order. tc scores are quantized, so lanes tie: flag words' FLAG_TRUNC
bits are equal on every row (the count runs over the full plane), whole
flag words are equal on rows without FLAG_TRUNC, and there the kept
(doc, per-slot tf) lanes are equal, compared in doc order (torch.topk
orders equal scores freely). The bs step's top-M score values are equal
as sorted lists on every row. The engine-level tests are in
test_torch_tc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo, synth_docinfos
from wiser_tpu.engine.device import TpuEngine, _PlannedQuery
from wiser_tpu.engine.device import _tc_score64_ub as j_score64_ub
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch.engine.host import PP_BUCKETS, _bucket
from wiser_tpu_torch.engine.host import _tc_score64_ub as t_score64_ub


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


NO_FMA = {"xla_backend_optimization_level": 0}


def jref(fn, *args):
    """fn(*args) as one JAX program without XLA's FMA contraction (module
    docstring); numpy arguments go in as arrays, None as is."""
    args = [None if a is None else J(a) for a in args]
    return jax.jit(fn).lower(*args).compile(NO_FMA)(*args)


def rand_lanes(rng, n, sat=0.03):
    """n uint16 tc lanes: len codes over the valid 0..231, tf bytes 1..254
    with a `sat` share of 255."""
    code = rng.integers(0, 232, size=n).astype(np.uint16)
    tf = rng.integers(1, 255, size=n)
    tf[rng.random(n) < sat] = 255
    return (code << 8) | tf.astype(np.uint16)


def randomize_tc(tc_col, rng, sat=0.03):
    """The real lanes (tf byte > 0) of a tc column replaced by random
    hard lanes; pads stay 0."""
    out = tc_col.copy()
    live = out > 0
    out[live] = rand_lanes(rng, int(live.sum()), sat)
    return out


def rows_by_doc(packed_out, T):
    """Each row's (doc, tfs...) lanes sorted by doc."""
    lanes = np.concatenate([packed_out[:, 0:1], packed_out[:, 1 : T + 1]],
                           axis=1)
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2)


def assert_packed_match(got, want, T):
    """The module docstring's tolerance. Returns the clean-row mask."""
    gf, wf = got[:, T + 1, 0], want[:, T + 1, 0]
    np.testing.assert_array_equal(gf & TK.FLAG_TRUNC, wf & TK.FLAG_TRUNC)
    clean = (wf & TK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(gf[clean], wf[clean])
    np.testing.assert_array_equal(rows_by_doc(got[clean], T),
                                  rows_by_doc(want[clean], T))
    assert clean.any()
    return clean


# -- the decode ----------------------------------------------------------------


@pytest.mark.parametrize("idf,avg", [(0.37, 120.3), (7.9, 3.25),
                                     (12.5, 1000.7)])
def test_tc_score_exhaustive(idf, avg):
    """Every uint16 lane (len codes 0..255, tf bytes 0..255): the f32
    score bit-equal to JAX's op by op and to jref's program; the f64 bound
    bit-equal to the reference's host bound and never below the score."""
    lanes = np.arange(65536, dtype=np.int32)
    idf32, avg32 = np.float32(idf), np.float32(avg)
    with jax.disable_jit():
        want = np.asarray(JK.tc_score(J(lanes), J(idf32), J(avg32)))
    got = TK.tc_score(torch.from_numpy(lanes), torch.tensor(idf32),
                      torch.tensor(avg32)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    level0 = np.asarray(jref(JK.tc_score, lanes, idf32, avg32))
    np.testing.assert_array_equal(level0.view(np.int32), want.view(np.int32))
    assert (got[lanes & 0xFF == 0] == 0).all()
    np.testing.assert_array_equal(got[lanes & 0xFF == 255],
                                  idf32 * np.float32(2.2))
    ub_want = j_score64_ub(lanes.astype(np.uint16), np.float64(idf32),
                           float(avg32))
    ub_got = t_score64_ub(
        torch.from_numpy(lanes), torch.tensor(np.float64(idf32)),
        torch.tensor(float(avg32), dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(ub_got.view(np.int32), ub_want.view(np.int32))
    assert (ub_got >= got).all()
    jitted = np.asarray(jax.jit(JK.tc_score)(J(lanes), J(idf32), J(avg32)))
    ulps = np.abs(jitted.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


def test_tc_saturated_exact():
    rng = np.random.default_rng(1)
    for shape in ((16, 24), (16, 3, 24)):
        lanes = rand_lanes(rng, int(np.prod(shape)), sat=0.02).reshape(shape)
        lanes = lanes.astype(np.int32)
        docs = np.where(rng.random((16, 24)) < 0.8,
                        rng.integers(0, 1000, (16, 24)), -1).astype(np.int32)
        want = np.asarray(jref(JK.tc_saturated, lanes, docs))
        got = TK.tc_saturated(T_(lanes), T_(docs)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)


def test_u16_widens_negative_bits():
    lanes = np.array([0, 0x7FFF, 0x8000, 0xE7FF, 0xFFFF], dtype=np.uint16)
    got = TK._u16(T_(lanes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lanes.astype(np.int32))


# -- the bs step -----------------------------------------------------------------


N_DOCS = 40 * 128


def random_tc_postings(seed, n_terms=6, L=1024):
    """Sorted random doc runs over N_DOCS, padded to 128 with the
    sentinel, hard random tc lanes (0 on pads), one max-L of slack."""
    rng = np.random.default_rng(seed)
    docs, tcs, starts, dfs = [], [], [], []
    pos = 0
    for _ in range(n_terms):
        df = int(rng.integers(L // 2, L))
        d = np.sort(rng.choice(N_DOCS - 64, size=df, replace=False))
        pad = (-df) % 128
        starts.append(pos)
        dfs.append(df)
        docs.append(np.concatenate([d.astype(np.int32),
                                    np.full(pad, 2**31 - 1, np.int32)]))
        tcs.append(np.concatenate([rand_lanes(rng, df),
                                   np.zeros(pad, np.uint16)]))
        pos += df + pad
    slack = L + 4096
    return (np.concatenate(docs + [np.full(slack, 2**31 - 1, np.int32)]),
            np.concatenate(tcs + [np.zeros(slack, np.uint16)]),
            np.asarray(starts), np.asarray(dfs))


def bs_inputs(seed, T, t_starts, t_dfs, B=12, n_pad_rows=2):
    """Slot-ordered starts/ends and idf32 (0 on padded slots, which
    repeat slot 0); the last n_pad_rows rows are batch padding."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    idf32 = np.zeros((B, T), dtype=np.float32)
    for b in range(B - n_pad_rows):
        n = int(rng.integers(1 if T == 1 else 2, min(T, len(t_starts)) + 1))
        terms = rng.choice(len(t_starts), size=n, replace=False)
        for s in range(T):
            t = terms[s] if s < n else terms[0]
            starts[b, s] = t_starts[t]
            ends[b, s] = t_starts[t] + t_dfs[t]
            if s < n:
                idf32[b, s] = np.float32(rng.random() * 8 + 0.1)
    return starts, ends, idf32


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8])
def test_search_kernel_tc(T):
    # 8 terms over a dense doc range: 8-way intersections are non-empty
    n_terms = 9 if T == 8 else 6
    doc, tc, t_starts, t_dfs = random_tc_postings(60 + T, n_terms,
                                                  L=4096 if T == 8 else 1024)
    L = 4096 if T == 8 else 1024
    M = 20
    avg32 = np.float32(57.25)
    starts, ends, idf32 = bs_inputs(70 + T, T, t_starts, t_dfs)
    n_it = TK.n_iters_for(L)
    args = (doc, tc, avg32, starts, ends, idf32)
    want = np.asarray(jref(JK.make_search_kernel(T, L, M, n_it, mode="tc"),
                           *args))
    got = TK.make_search_kernel(T, L, M, n_it, mode="tc")(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > 10
    flags = got[:, T + 1, 0]
    if T <= 2:  # saturated lanes reach the top
        assert ((flags & TK.FLAG_TF_SAT) != 0).any()
    # the f32 top scores themselves, in sorted order
    _, ws, *_ = jref(lambda d, s, e, c, i, a: JK.search_body(
        d, None, None, s, e, None, T=T, L=L, M=M, n_bs_iters=n_it, tc=c,
        idf32=i, avg32=a), doc, starts, ends, tc, idf32, avg32)
    _, gs, *_ = TK.search_body(T_(doc), None, None, T_(starts), T_(ends),
                               None, T=T, L=L, M=M, n_bs_iters=n_it,
                               tc=T_(tc), idf32=T_(idf32), avg32=T_(avg32))
    np.testing.assert_array_equal(np.sort(gs.numpy(), axis=1),
                                  np.sort(np.asarray(ws), axis=1))


# -- phrase steps over a real index with hard tc lanes --------------------------


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
    """A bloom index, its tc TpuEngine's columns, and the tc column with
    hard random lanes on the same postings."""
    jp, _ = build_index(synth_docinfos(900, 60, 30, seed=3), with_blooms=True)
    je = TpuEngine(jp, dense_budget_bytes=0, columns="tc")
    tc = randomize_tc(je._h_tc, np.random.default_rng(0))
    return jp, je, tc


def group_inputs(jp, je, T, seed, n=24):
    rng = np.random.default_rng(seed)
    terms = [[f"t{r}" for r in rng.choice(48 // T, size=T, replace=False)]
             for _ in range(n)]
    group = pq_group(jp, terms)
    L = max(_bucket(int(jp.df[pq.slot_rows[0]]), je._lb) for pq in group)
    starts, ends, _, idf32, _, slot_of, ks = je._assemble(
        group, T, buckets=je.PHRASE_B_BUCKETS)
    probes = je._assemble_bloom_probes(group, T, starts.shape[0])
    PP = max(_bucket(int(jp.max_tf[pq.rows[0]]), PP_BUCKETS) for pq in group)
    PW = max(_bucket(int(max(jp.max_tf[pq.rows])), PP_BUCKETS)
             for pq in group)
    return L, PP, PW, starts, ends, idf32, slot_of.astype(np.int32), ks, probes


def blooms(je):
    return (je._h_bloom_rows, je._h_bloom_bitmap, je._h_bloom_rank)


@pytest.mark.parametrize("T", [2, 3])
def test_list_chain_tc(kcorpus, T):
    """match (with sat_lane) -> verify -> select, over hard lanes: the
    match outputs tolerance 0; sat_lane carried to the select's flag."""
    jp, je, tc = kcorpus
    L, PP, _, starts, ends, idf32, slot_of, ks, probes = group_inputs(
        jp, je, T, seed=10 + T)
    n_it = JK.n_iters_for(je._max_df)
    margs = (je._h_doc, tc, je._avg32, starts, ends, idf32) + blooms(je) \
        + probes
    want = jref(JK.make_match_kernel_tc(T, L, n_it), *margs)
    got = TK.make_match_kernel_tc(T, L, n_it)(*(T_(a) for a in margs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    match, bloom_pass, cdocs, pidx, sc, sat_lane = (np.asarray(w)
                                                    for w in want)
    active = match & bloom_pass
    assert (sat_lane & active).any()
    pidx_q = np.take_along_axis(pidx, slot_of[:, :, None].repeat(L, 2), 1)
    n_pos = JK.n_iters_for(int(jp.max_tf.max()))
    n_match = np.asarray(jref(JK.make_phrase_verify_kernel(T, L, PP, n_pos),
                              je._h_positions, jp.pos_starts.astype(np.int32),
                              pidx_q, active))
    final = active & (n_match > 0)
    if T == 2:
        # every lane's sat flag set: a kept lane must flag FLAG_TF_SAT
        sat_lane = sat_lane | final
    M = 20
    sargs = (tc, cdocs, pidx, sc, final, sat_lane)
    want_s = np.asarray(jref(JK.make_select_topk_kernel_tc(T, L, M), *sargs))
    got_s = TK.make_select_topk_kernel_tc(T, L, M)(
        *(T_(a) for a in sargs)).numpy()
    assert_packed_match(got_s, want_s, T)
    if T == 2:
        assert (got_s[:, 0] >= 0).any()
        assert ((got_s[:, T + 1, 0] & TK.FLAG_TF_SAT) != 0).any()


@pytest.mark.parametrize("T,KV", [(2, 4), (2, 16), (3, 16)])
def test_compact_phrase_kernel_tc(kcorpus, T, KV):
    jp, je, tc = kcorpus
    L, PP, PW, starts, ends, idf32, slot_of, ks, probes = group_inputs(
        jp, je, T, seed=20 + T + KV)
    assert L > KV
    n_it = JK.n_iters_for(je._max_df)
    M = min(KV, 10)
    if KV == 4:  # k = KV: a row with fewer verified lanes must flag
        ks = np.where(ks > 0, KV, 0).astype(np.int32)
    args = ((je._h_doc, tc, je._avg32, je._h_positions,
             jp.pos_starts.astype(np.int32), starts, ends, idf32, slot_of, ks)
            + blooms(je) + probes)
    want = np.asarray(jref(JK.make_compact_phrase_kernel(
        T, L, KV, PP, PW, M, n_it, 3e-5, mode="tc"), *args))
    got = TK.make_compact_phrase_kernel(
        T, L, KV, PP, PW, M, n_it, 3e-5, mode="tc")(
        *(T_(a) for a in args)).numpy()
    assert_packed_match(got, want, T)
    assert (got[:, 0] >= 0).any()


# -- dense-plane steps ------------------------------------------------------------


def head_phrase_docs(seed, n=1600):
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
    """Head terms h0..h2 (and mid r-terms) in a tc dense tier, with hard
    random tf bytes on the real presence pattern, a random len-code row
    and hard lanes in the posting column."""
    jp, oracle = build_index(head_phrase_docs(5), with_blooms=True)
    je = _Floor(jp, columns="tc")
    rng = np.random.default_rng(8)
    tf8 = je._h_dense_tf_rows.copy()
    live = tf8 > 0
    tf = rng.integers(1, 255, size=int(live.sum()))
    tf[rng.random(len(tf)) < 0.01] = 255
    tf8[live] = tf.astype(np.uint8)
    code = rng.integers(0, 232, size=je._n_pad_docs).astype(np.uint8)
    tc = randomize_tc(je._h_tc, rng)
    return jp, je, tf8, code, tc


HEADS = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h0", "h1", "h2"],
         ["h1", "h2", "h0"], ["h2", "h0"])


def dense_slots(je, term_lists, T, B=8):
    """Query-order dense slots and idf32 (padded slots repeat the first
    term with idf 0)."""
    slots = np.zeros((B, T), dtype=np.int32)
    idf32 = np.zeros((B, T), dtype=np.float32)
    for i, terms in enumerate(term_lists):
        r = [je.packed.lookup(t) for t in terms]
        r = r + [r[0]] * (T - len(r))
        slots[i] = je._dense_slot[r]
        idf32[i, : len(terms)] = je.packed.idf64[r[: len(terms)]]
    return slots, idf32


@pytest.mark.parametrize("T,M", [(2, 20), (3, 20), (4, 64)])
def test_dense_search_kernel_tc(dcorpus, T, M):
    jp, je, tf8, code, _ = dcorpus
    pool = [["h0", "h1"], ["h1", "h2"], ["h2", "h0"], ["h0", "h1", "h2"],
            ["h2", "h1", "h0"], ["h0"], ["h1"]]
    terms = [t for t in pool if len(t) <= T][:8]
    slots, idf32 = dense_slots(je, terms, T)
    args = (tf8, code, je._avg32, slots, idf32)
    want = np.asarray(jref(JK.make_dense_search_kernel_tc(T, je._n_pad_docs,
                                                          M), *args))
    got = TK.make_dense_search_kernel_tc(T, je._n_pad_docs, M)(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > 2 * M
    assert ((got[:, T + 1, 0] & TK.FLAG_TF_SAT) != 0).any()


def bound_planes(je, tf8, code):
    """The reference's host block planes (tc) of given tf and code rows."""
    n_pad = je._n_pad_docs
    rows = np.argsort(je._dense_slot)[-je._dense_H:]
    rows = rows[np.argsort(je._dense_slot[rows])]
    idf = je.packed.idf64[rows].astype(np.float32).astype(np.float64)
    lanes = np.where(tf8 > 0, (code.astype(np.uint16) << 8)[None, :] | tf8,
                     np.uint16(0))
    ub3 = j_score64_ub(lanes, idf[:, None], float(je._avg32)).reshape(
        je._dense_H, n_pad // 128, 128)
    top2 = np.partition(ub3, 126, axis=2)[:, :, 126:]
    return (top2[:, :, 1].copy(), top2[:, :, 0].copy(),
            np.argmax(ub3, axis=2).astype(np.uint8))


@pytest.mark.parametrize("T,C,M", [(2, 3, 20), (3, 4, 16), (2, 6, 64)])
def test_pruned_dense_kernel_tc(dcorpus, T, C, M):
    jp, je, tf8, code, _ = dcorpus
    NB = je._n_pad_docs // 128
    bm, bm2, ap = bound_planes(je, tf8, code)
    # quantized scores tie block bounds at the C-th pick, where either
    # engine may keep either block; a jitter above the bound makes the
    # pick unique (the kernels are compared, not the bound's tightness)
    rng = np.random.default_rng(T * C)
    bm, bm2 = (np.where(p > 0, p * (1 + rng.random(p.shape) * 1e-3), 0)
               .astype(np.float32) for p in (bm, bm2))
    terms = [t for t in HEADS if len(t) <= T] + [["h0"], ["h2"]]
    slots, idf32 = dense_slots(je, terms[:8], T)
    ks = np.array([1, 5, 10, 3, 10, 5, 1, 10], dtype=np.int32)
    args = (tf8, code, je._avg32, bm, bm2, ap, slots, idf32, ks)
    want = np.asarray(jref(JK.make_pruned_dense_kernel_tc(T, NB, C, M, 3e-5),
                           *args))
    got = TK.make_pruned_dense_kernel_tc(T, NB, C, M, 3e-5)(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > M
    flags = got[:, T + 1, 0]
    assert ((flags & TK.FLAG_PRUNE_MISS) != 0).any()


@pytest.mark.parametrize("T,n_bs", [(2, 0), (3, 0), (3, 1), (4, 2)])
def test_semidense_kernel_tc(dcorpus, T, n_bs):
    """Mid-df candidates (r-terms) x n_bs other mid terms by binary search
    x dense heads, over hard lanes."""
    jp, je, tf8, _, tc = dcorpus
    rng = np.random.default_rng(50 + T + n_bs)
    mids = [t for t in (f"r{i}" for i in range(120)) if jp.lookup(t) >= 0]
    B = 12
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    idf32 = np.zeros((B, T), dtype=np.float32)
    slots = np.zeros((B, T), dtype=np.int32)
    for b in range(B - 2):
        terms = [jp.lookup(t) for t in
                 rng.choice(mids, size=1 + n_bs, replace=False)]
        for s, r in enumerate(terms):
            starts[b, s] = je._starts32[r]
            ends[b, s] = je._starts32[r] + je._df32[r]
            idf32[b, s] = jp.idf64[r]
        n_dense = int(rng.integers(1, T - n_bs + 1))
        heads = [jp.lookup(h) for h in rng.choice(["h0", "h1", "h2"],
                                                   size=n_dense,
                                                   replace=False)]
        for j in range(T - 1 - n_bs):
            r = heads[min(j, n_dense - 1)]
            slots[b, 1 + n_bs + j] = je._dense_slot[r]
            if j < n_dense:
                idf32[b, 1 + n_bs + j] = jp.idf64[r]
    L = 512
    M = 24
    n_it = TK.n_iters_for(L)
    args = (je._h_doc, tc, je._avg32, tf8, starts, ends, idf32, slots)
    want = np.asarray(jref(JK.make_semidense_kernel_tc(
        T, L, M, je._n_pad_docs, n_bs, n_it), *args))
    got = TK.make_semidense_kernel_tc(T, L, M, je._n_pad_docs, n_bs, n_it)(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > 0


def postings_inputs(jp, je, term_lists, k):
    group = pq_group(jp, term_lists, k)
    T = len(term_lists[0])
    starts, ends, _, idf32, _, slot_of, ks = je._assemble(
        group, T, buckets=je.PHRASE_B_BUCKETS)
    slots = np.zeros(starts.shape, dtype=np.int32)
    for i, pq in enumerate(group):
        slots[i, 1:] = je._dense_slot[pq.slot_rows[1:]]
    L = max(_bucket(int(jp.df[pq.slot_rows[0]]), je._lb) for pq in group)
    PP = max(_bucket(int(jp.max_tf[pq.rows[0]]), PP_BUCKETS) for pq in group)
    return T, L, PP, starts, ends, idf32, slots, slot_of.astype(np.int32), ks


@pytest.mark.parametrize("KV", [16, 64])
def test_semidense_phrase_kernel_tc(dcorpus, KV):
    """Mid-df candidates x dense heads, 2- and 3-term groups: dense lanes
    recomposed with the candidate lane's len code."""
    jp, je, tf8, _, tc = dcorpus
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
        T, L, PP, starts, ends, idf32, slots, slot_of, ks = postings_inputs(
            jp, je, term_lists, 5)
        n_it = JK.n_iters_for(je._max_df)
        args = (je._h_doc, tc, je._avg32, tf8, je._h_positions,
                jp.pos_starts.astype(np.int32), starts, ends, idf32, slots,
                slot_of, ks)
        M = min(KV, 12)
        want = np.asarray(jref(JK.make_semidense_phrase_kernel(
            T, L, KV, PP, 32, M, je._n_pad_docs, n_it, 3e-5, mode="tc"),
            *args))
        got = TK.make_semidense_phrase_kernel(
            T, L, KV, PP, 32, M, je._n_pad_docs, n_it, 3e-5, mode="tc")(
            *(T_(a) for a in args)).numpy()
        assert_packed_match(got, want, T)
        assert (got[:, 0] >= 0).any()


def full_inputs(jp, je, term_lists, ks_val):
    T = len(term_lists[0])
    B = 8
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    slots = np.zeros((B, T), dtype=np.int32)
    idf32 = np.zeros((B, T), dtype=np.float32)
    anchor = np.zeros(B, dtype=np.int32)
    ks = np.zeros(B, dtype=np.int32)
    for i, terms in enumerate(term_lists):
        r = [jp.lookup(t) for t in terms]
        starts[i] = je._starts32[r]
        ends[i] = je._starts32[r] + je._df32[r]
        slots[i] = je._dense_slot[r]
        idf32[i] = jp.idf64[r]
        anchor[i] = int(np.argmin(jp.max_tf[r]))
        ks[i] = ks_val
    PP = _bucket(int(jp.max_tf[[jp.lookup(t) for t in term_lists[0]]].min()),
                 PP_BUCKETS)
    return T, starts, ends, slots, idf32, anchor, ks, PP, 32


@pytest.mark.parametrize("T,KV,k", [(2, 40, 5), (3, 40, 5), (2, 300, 10),
                                    (2, 1663, 10)])
def test_full_phrase_kernel_tc(dcorpus, T, KV, k):
    jp, je, tf8, code, _ = dcorpus
    n_pad = je._n_pad_docs
    KV = min(KV, n_pad - 1)
    terms = [t for t in HEADS if len(t) == T]
    T, starts, ends, slots, idf32, anchor, ks, PP, PW = full_inputs(
        jp, je, terms, k)
    M = min(KV, k + 6)
    n_it = JK.n_iters_for(je._max_df)
    args = (tf8, code, je._avg32, je._h_doc, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, slots, idf32,
            anchor, ks)
    want = np.asarray(jref(JK.make_full_phrase_kernel_tc(
        T, n_pad, KV, PP, PW, M, n_it, 3e-5), *args))
    got = TK.make_full_phrase_kernel_tc(T, n_pad, KV, PP, PW, M, n_it, 3e-5)(
        *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).any()


@pytest.mark.parametrize("band_side", ["above", "below", "other_payload"])
def test_full_phrase_payload_tie(dcorpus, band_side):
    """Phrase docs A > B > C fill KV = 3 (k = 3, C the k-th kept); one
    unselected AND-only doc D sits in C's eps3 band. With D's payload
    equal to C's on every term, D flags only when its doc id is below
    C's (it could displace C by the doc-asc canon): "above" does not
    flag, "below" does, and a band lane with another payload flags
    wherever it sits. The score planes and the payload planes are given
    separately, so the rule is held on its own, as in JAX."""
    from wiser_tpu.engine.device import host_exact_search as j_host

    jp, je, *_ = dcorpus
    cache64 = je.cache64
    r0, r1 = jp.lookup("h0"), jp.lookup("h1")
    phrase, _ = j_host(jp, cache64, [r0, r1], jp.n_docs, is_phrase=True)
    both, _ = j_host(jp, cache64, [r0, r1], jp.n_docs)
    phrase = sorted(int(d) for d in phrase)
    only_and = sorted(int(d) for d in both if int(d) not in set(phrase))
    A, B, C = phrase[-1], phrase[-2], phrase[len(phrase) // 2]
    D = (next(d for d in only_and if d > C) if band_side == "above"
         else next(d for d in only_and if d < C))
    s0, s1 = int(je._dense_slot[r0]), int(je._dense_slot[r1])
    n_pad = je._n_pad_docs
    H = je._dense_H
    present = je._h_dense_tf_rows > 0
    sc = np.where(present, np.float32(0.01), np.float32(0)).astype(np.float32)
    pay = np.where(present, 1, 0).astype(np.int32)
    for doc, total in ((A, 10.0), (B, 9.0), (C, 8.0), (D, 8.0 * (1 - 1e-6))):
        sc[s0, doc] = np.float32(total - 0.5)
        sc[s1, doc] = np.float32(0.5)
    for doc in (C, D):
        pay[s0, doc], pay[s1, doc] = 0x2A07, 0x2A03
    if band_side == "other_payload":
        pay[s1, D] = 0x2A04
    T, starts, ends, slots, _, anchor, ks, PP, PW = full_inputs(
        jp, je, [["h0", "h1"]], 3)
    n_it = JK.n_iters_for(je._max_df)
    common = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
              starts, ends, anchor, ks)
    kw = dict(T=T, N_pad=n_pad, KV=3, PP=PP, PW=PW, M=3, n_bs_iters=n_it,
              eps3=3e-5)
    w_docs, w_flags = jref(
        lambda sc_, pay_, sl, *c: JK._full_phrase_body(
            lambda t: sc_[sl[:, t]], lambda t: pay_[sl[:, t]], *c,
            payload_tie_exact=True, **kw), sc, pay, slots, *common)
    tsl = torch.from_numpy(slots).long()
    g_docs, g_flags = TK._full_phrase_body(
        lambda t: T_(sc)[tsl[:, t]], *(T_(a) for a in common),
        rows_payload=lambda t: T_(pay)[tsl[:, t]], **kw)
    np.testing.assert_array_equal(g_flags.numpy(), np.asarray(w_flags))
    assert sorted(g_docs[0].tolist()) == sorted(np.asarray(w_docs)[0].tolist())
    assert sorted(g_docs[0].tolist()) == sorted([A, B, C])
    miss = bool(g_flags[0] & TK.FLAG_PRUNE_MISS)
    assert miss == (band_side != "above")
    assert H >= 2


def test_full_phrase_payload_tie_across_k(dcorpus):
    """Kept phrase docs a < c tie at places k-1 and k (k = 3, A first), so
    the canonical k-th kept doc is c; an unselected AND-only doc u with
    a < u < c and the payload of a and c sits in the band. u could
    displace c by the doc-asc canon, so the row flags, as in JAX; a top-M
    that put c before a would read a as the k-th and miss it. 13 AND-only
    fillers above them fill KV = 16 so that u is the (KV+1)-th lane."""
    from wiser_tpu.engine.device import host_exact_search as j_host

    jp, je, *_ = dcorpus
    r0, r1 = jp.lookup("h0"), jp.lookup("h1")
    phrase, _ = j_host(jp, je.cache64, [r0, r1], jp.n_docs, is_phrase=True)
    both, _ = j_host(jp, je.cache64, [r0, r1], jp.n_docs)
    phrase = sorted(int(d) for d in phrase)
    only_and = sorted(int(d) for d in both if int(d) not in set(phrase))
    A, a, c = phrase[-1], phrase[0], phrase[-2]
    u = next(d for d in only_and if a < d < c)
    fillers = [d for d in only_and if d != u][:13]
    assert len(fillers) == 13
    s0, s1 = int(je._dense_slot[r0]), int(je._dense_slot[r1])
    present = je._h_dense_tf_rows > 0
    sc = np.where(present, np.float32(0.01), np.float32(0)).astype(np.float32)
    pay = np.where(present, 1, 0).astype(np.int32)
    totals = [(A, 10.0), (a, 8.0), (c, 8.0), (u, 8.0 * (1 - 1e-6))]
    for doc, total in totals + [(f, 9.0) for f in fillers]:
        sc[s0, doc] = np.float32(total - 0.5)
        sc[s1, doc] = np.float32(0.5)
    for doc in (a, c, u):
        pay[s0, doc], pay[s1, doc] = 0x2A07, 0x2A03
    T, starts, ends, slots, _, anchor, ks, PP, PW = full_inputs(
        jp, je, [["h0", "h1"]], 3)
    n_it = JK.n_iters_for(je._max_df)
    common = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
              starts, ends, anchor, ks)
    kw = dict(T=T, N_pad=je._n_pad_docs, KV=16, PP=PP, PW=PW, M=3,
              n_bs_iters=n_it, eps3=3e-5)
    w_docs, w_flags = jref(
        lambda sc_, pay_, sl, *c: JK._full_phrase_body(
            lambda t: sc_[sl[:, t]], lambda t: pay_[sl[:, t]], *c,
            payload_tie_exact=True, **kw), sc, pay, slots, *common)
    tsl = torch.from_numpy(slots).long()
    g_docs, g_flags = TK._full_phrase_body(
        lambda t: T_(sc)[tsl[:, t]], *(T_(x) for x in common),
        rows_payload=lambda t: T_(pay)[tsl[:, t]], **kw)
    np.testing.assert_array_equal(g_flags.numpy(), np.asarray(w_flags))
    np.testing.assert_array_equal(g_docs[0].numpy(), np.asarray(w_docs)[0])
    assert g_docs[0].tolist() == [A, a, c]
    assert g_flags[0] & TK.FLAG_PRUNE_MISS


# -- the bloomless phrase pipeline and the block-pruned mega phrase ---------------


@pytest.mark.parametrize("T", [2, 3])
def test_phrase_body_tc(kcorpus, T):
    """phrase_body's tc mode (the mesh's phrase step) over hard lanes:
    the others' tc scores sum first, then the candidate's; a kept lane
    with a saturated tf byte in a matched slot raises FLAG_TF_SAT. The
    top-M score planes are equal as sorted rows."""
    jp, je, tc = kcorpus
    L, PP, _, starts, ends, idf32, slot_of, ks, _ = group_inputs(
        jp, je, T, seed=50 + T)
    n_it = JK.n_iters_for(je._max_df)
    n_pos = JK.n_iters_for(int(jp.max_tf.max()))
    M = 20
    kw = dict(T=T, L=L, PP=PP, M=M, n_bs_iters=n_it, n_pos_iters=n_pos)
    args = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
            starts, ends, slot_of, tc, idf32, je._avg32)

    def jax_body(doc, pos, ps, s, e, so, c, i, a):
        return JK.phrase_body(doc, None, None, pos, ps, s, e, None, so,
                              tc=c, idf32=i, avg32=a, **kw)

    want, want_s = (np.asarray(x) for x in jref(jax_body, *args))
    doc, pos, ps, s, e, so, c, i, a = (T_(x) for x in args)
    got, got_s = TK.phrase_body(doc, None, None, pos, ps, s, e, None, so,
                                tc=c, idf32=i, avg32=a, **kw)
    got, got_s = got.numpy(), got_s.numpy()
    clean = assert_packed_match(got, want, T)
    np.testing.assert_array_equal(np.sort(got_s, axis=1),
                                  np.sort(want_s, axis=1))
    assert (got[clean, 0] >= 0).any()
    if T == 2:
        assert ((got[:, T + 1, 0] & TK.FLAG_TF_SAT) != 0).any()


@pytest.mark.parametrize("T,C,KV,k", [(2, 4, 40, 5), (3, 4, 40, 5),
                                      (2, 6, 300, 10), (2, 12, 1535, 10)])
def test_pruned_phrase_kernel_tc(dcorpus, T, C, KV, k):
    """The tc block-pruned mega phrase: quantized block bounds tie at the
    C-th pick, so the planes are jittered above the bound (as in
    test_pruned_dense_kernel_tc); both stages of the selection keep the
    (score desc, index asc) canon, so the packed output is equal whole."""
    jp, je, tf8, code, _ = dcorpus
    NB = je._n_pad_docs // 128
    KV = min(KV, C * 128 - 1)
    bm, bm2, ap = bound_planes(je, tf8, code)
    rng = np.random.default_rng(T * C + KV)
    bm, bm2 = (np.where(p > 0, p * (1 + rng.random(p.shape) * 1e-3), 0)
               .astype(np.float32) for p in (bm, bm2))
    terms = [t for t in HEADS if len(t) == T]
    T, starts, ends, slots, idf32, anchor, ks, PP, PW = full_inputs(
        jp, je, terms, k)
    M = min(KV, k + 6)
    n_it = JK.n_iters_for(je._max_df)
    args = (tf8, code, je._avg32, bm, bm2, ap, je._h_doc, je._h_positions,
            jp.pos_starts.astype(np.int32), starts, ends, slots, idf32,
            anchor, ks)
    want = np.asarray(jref(JK.make_pruned_phrase_kernel_tc(
        T, NB, C, KV, PP, PW, M, n_it, 3e-5), *args))
    got = TK.make_pruned_phrase_kernel_tc(T, NB, C, KV, PP, PW, M, n_it,
                                          3e-5)(*(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any()
    if C == 4:
        assert (got[:, T + 1, 0] & TK.FLAG_PRUNE_MISS).any()
