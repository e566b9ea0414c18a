"""The full-scan mega phrase's two passes on the CPU (engine/kernels.
full_phrase_select / full_phrase_band and their plain versions, the
kernels' entries in ops/dense.py).

The split plain versions, composed by make_full_phrase_kernel{,_tc} and
by _full_phrase_body, against the JAX package's full-scan phrase
(make_full_phrase_kernel{,_tc}, _full_phrase_body) on a head-term corpus
with blooms: packed outputs bit for bit, raw and tc, at KV 8 (the
two-level selection), 1,024 and 4,096 (reduced to the corpus: the flat
one). The selection against the canonical top KV + 1 by (score desc, doc
asc), which the kernel keeps, on tie-heavy synthetic planes wide enough
for the two-level selection at KV 1,024 and on planes built so that a
tie class straddles the (KV+1)-th place across blocks: equal at every
place. The band: empty wherever the (KV+1)-th score is below thr (the
kernel's `need`), and in raw columns set exactly there; its key-order
membership (the kernel's) equal to the plain scatter. An exact tie
across the (KV+1)-th place on the real BM25 planes: the canonical passes
give the plain flags, and every unflagged row re-ranks to the oracle's
phrase answer. The argument checks (the same ValueError from the
dispatchers on the CPU and from the kernels' entries before any launch),
the launch plans at K 1,025 and 4,097, and the engines end to end.

Tolerances: none. The JAX tc programs run without XLA's FMA contraction
(xla_backend_optimization_level 0, as test_torch_tc_kernels.jref). The
card's own check (the kernels against these plain versions) is marked
cuda and skips here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.host import PP_BUCKETS, _bucket
from wiser_tpu_torch.engine.topk import rescore_sorted_arrays
from wiser_tpu_torch.ops import dense as D
from wiser_tpu_torch.tools import dense_bench as DB
from wiser_tpu_torch.types import SearchQuery

NO_FMA = {"xla_backend_optimization_level": 0}
NEG = -np.inf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jref(fn, *args):
    """fn(*args) as one JAX program without FMA contraction."""
    args = [None if a is None else jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(NO_FMA)(*args)


def T_(a):
    """numpy -> torch; unsigned columns travel as their signed bits, as
    the engine holds them on the device."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _docs(seed: int, n: int = 1600):
    """Head terms h0..h2 in most docs, short doc lengths (so BM25 scores
    tie in large classes), and the phrases h0 h1 and h1 h2 h0 planted."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        toks = [f"r{rng.integers(150)}" for _ in range(rng.integers(3, 9))]
        for h in ("h0", "h1", "h2"):
            if rng.random() < 0.8:
                toks.insert(rng.integers(len(toks) + 1), h)
        if rng.random() < 0.3:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["h0", "h1"]
        if rng.random() < 0.1:
            j = rng.integers(len(toks) + 1)
            toks[j:j] = ["h1", "h2", "h0"]
        docs.append(make_docinfo(toks, with_blooms=True))
    return docs


@pytest.fixture(scope="module")
def corpus():
    """The index, its oracle, the port's copy and the raw and tc
    TpuEngines (their dense tiers hold h0..h2)."""
    jp, oracle = build_index(_docs(11), with_blooms=True)
    port = packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})
    return jp, oracle, port, TpuEngine(jp), TpuEngine(jp, columns="tc")


HEADS = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h2", "h0"],
         ["h0", "h1", "h2"], ["h1", "h2", "h0"], ["h2", "h1", "h0"])


def _inputs(jp, je, T: int, k: int, B: int = 8):
    """The engine's group arrays for HEADS's T-term phrases (query-term
    order; batch padding rows: slot 0, weights 0): starts, ends, slots,
    weights (use_score raw, idf32 tc), anchor, ks, idf64, PP, PW."""
    terms = [t for t in HEADS if len(t) == T]
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    slots = np.zeros((B, T), dtype=np.int32)
    w = np.zeros((B, T), dtype=np.float32)
    anchor = np.zeros(B, dtype=np.int32)
    ks = np.zeros(B, dtype=np.int32)
    idf64 = np.zeros((B, T))
    for i, t in enumerate(terms):
        r = [jp.lookup(x) for x in t]
        starts[i] = je._starts32[r]
        ends[i] = je._starts32[r] + je._df32[r]
        slots[i] = je._dense_slot[r]
        w[i] = jp.idf64[r] if je.columns == "tc" else 1.0
        anchor[i] = int(np.argmin(jp.max_tf[r]))
        ks[i] = k
        idf64[i] = jp.idf64[r]
    rows = [jp.lookup(x) for x in terms[0]]
    PP = _bucket(int(jp.max_tf[rows].min()), PP_BUCKETS)
    return terms, starts, ends, slots, w, anchor, ks, idf64, PP, 32


def _planes(je):
    """The engine's dense planes as the full phrase takes them: raw (the
    f32 score plane, the int32 tf plane), tc (the uint8 tf plane, the
    len-code row, avg32)."""
    if je.columns == "tc":
        return (je._h_dense_tf_rows, je._h_len_code,
                np.float32(je._avg32))
    return je._h_dense_sc, je._h_dense_tf


def _kernel_args(jp, je, T, k):
    terms, starts, ends, slots, w, anchor, ks, idf64, PP, PW = _inputs(
        jp, je, T, k)
    tail = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
            starts, ends, slots, w, anchor, ks)
    return terms, _planes(je) + tail, idf64, PP, PW


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T,KV,k", [(2, 8, 5), (2, 1024, 10),
                                    (2, 4096, 10), (3, 1024, 5)])
def test_split_plain_passes_match_jax_full_phrase(corpus, mode, T, KV, k):
    """make_full_phrase_kernel{,_tc} through the dispatching passes (on
    the CPU the plain versions) give the JAX program's packed output bit
    for bit on the real planes, ties and all; KV reduced to the corpus
    (N_pad - 1) as the engine reduces it."""
    jp, _, _, je_raw, je_tc = corpus
    je = je_tc if mode == "tc" else je_raw
    n_pad = je._n_pad_docs
    KV = min(KV, n_pad - 1)
    _, args, _, PP, PW = _kernel_args(jp, je, T, k)
    M = min(KV, k + 6)
    n_it = JK.n_iters_for(je._max_df)
    make_j = (JK.make_full_phrase_kernel_tc if mode == "tc"
              else JK.make_full_phrase_kernel)
    make_t = (TK.make_full_phrase_kernel_tc if mode == "tc"
              else TK.make_full_phrase_kernel)
    eps3 = 3e-5 if mode == "tc" else 3e-6
    want = np.asarray(jref(make_j(T, n_pad, KV, PP, PW, M, n_it, eps3),
                           *args))
    got = make_t(T, n_pad, KV, PP, PW, M, n_it, eps3)(
        *(T_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any()


@pytest.mark.parametrize("KV", [8, 1024])
def test_full_phrase_body_matches_jax_over_row_functions(corpus, KV):
    """_full_phrase_body (the plain passes over row functions, tc's
    payload rule included) against the JAX _full_phrase_body on the tc
    engine's rows: top docs and flags bit for bit."""
    jp, _, _, _, je = corpus
    n_pad = je._n_pad_docs
    KV = min(KV, n_pad - 1)
    _, starts, ends, slots, idf32, anchor, ks, _, PP, PW = _inputs(
        jp, je, 2, 5)
    tf8, code, avg32 = _planes(je)
    pay = np.where(tf8 > 0, (code.astype(np.int32) << 8)[None, :]
                   | tf8.astype(np.int32), 0).astype(np.int32)
    common = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
              starts, ends, anchor, ks)
    kw = dict(T=2, N_pad=n_pad, KV=KV, PP=PP, PW=PW, M=8,
              n_bs_iters=JK.n_iters_for(je._max_df), eps3=3e-5)
    w_docs, w_flags = jref(
        lambda pay_, idf, a32, sl, *c: JK._full_phrase_body(
            lambda t: JK.tc_score(pay_[sl[:, t]], idf[:, t : t + 1], a32),
            lambda t: pay_[sl[:, t]], *c, payload_tie_exact=True, **kw),
        pay, idf32, avg32, slots, *common)
    tsl = torch.from_numpy(slots).long()
    tpay, tidf = T_(pay), T_(idf32)
    a32 = torch.tensor(avg32)
    g_docs, g_flags = TK._full_phrase_body(
        lambda t: TK.tc_score(tpay[tsl[:, t]], tidf[:, t : t + 1], a32),
        *(T_(a) for a in common),
        rows_payload=lambda t: tpay[tsl[:, t]], **kw)
    np.testing.assert_array_equal(g_flags.numpy(), np.asarray(w_flags))
    np.testing.assert_array_equal(g_docs.numpy(), np.asarray(w_docs))


# -- the selection against the canonical top KV + 1 ---------------------------


def _canonical(rows_f32, T: int, KV: int):
    """The kernel's selection, emulated: each row's top KV + 1 lanes of
    the score plane by (score desc, lane asc); -inf and -1 past the
    matched lanes. Also returns the score plane."""
    score = TK._phrase_score(rows_f32, T).numpy()
    order = np.lexsort((np.broadcast_to(np.arange(score.shape[1]),
                                        score.shape), -score),
                       axis=1)[:, : KV + 1]
    cs = np.take_along_axis(score, order, axis=1)
    return cs, np.where(cs > NEG, order, -1).astype(np.int32), score


def _straddles(score, cs, KV: int):
    """(B,) bool: the tie class of the (KV+1)-th value holds more lanes
    than the places left for it (a finite value)."""
    v = cs[:, KV]
    return np.isfinite(v) & ((score >= v[:, None]).sum(axis=1) > KV + 1)


def _wide_call(p, q, mode, KV):
    """full_phrase_select's arguments on synthetic planes p, slots q."""
    T = q["slots"].shape[1]
    if mode == "tc":
        args = (T_(p["tf8"]), T_(q["slots"]), T_(q["idf32"]))
        kw = dict(len_code=T_(p["code"]), avg32=torch.tensor(p["avg32"]))
    else:
        args = (T_(p["sc"]), T_(q["slots"]), T_(q["use"]))
        kw = {}
    return args, dict(kw, T=T, N_pad=p["sc"].shape[1], KV=KV)


@pytest.fixture(scope="module")
def wide():
    """Synthetic planes of 8 rows over 1,100 blocks: every other row
    draws its scores from four values (sums tie in classes of thousands),
    row 2 is sparse; the queries of the batch, as pairs (their first two
    rows) and triples: plain, tied, tied, sparse (fewer than KV + 1
    matches), disjoint (none) and a padding row (weights 0)."""
    p = DB.synth_planes(8, 1100, seed=4)
    rows = [[4, 6, 3], [3, 5, 7], [5, 7, 3], [2, 4, 6], [0, 1, 4],
            [3, 6, 5]]
    q = DB.synth_slots(6, 3, 8, 5, rows=rows, n_pad_rows=0)
    q2 = DB.synth_slots(6, 2, 8, 5, rows=[r[:2] for r in rows],
                        n_pad_rows=0)
    for qq in (q, q2):
        qq["use"][5] = 0.0
        qq["idf32"][5] = 0.0
    return p, q, q2


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T,KV", [(2, 1024), (3, 1024), (2, 4096)])
def test_selection_is_the_canonical_top(wide, mode, T, KV):
    """The plain selection (two-level at KV 1,024 over 1,100 blocks, flat
    at 4,096) equals the canonical top KV + 1 at every place, on rows
    whose (KV+1)-th tie class straddles the boundary too (raw: the tied
    rows' sums); padding and disjoint rows keep nothing."""
    p, q3, q2 = wide
    args, kw = _wide_call(p, q3 if T == 3 else q2, mode, KV)
    top_cs, top_cl, _ = TK.full_phrase_select(*args, **kw)
    rows_f32, _ = TK._phrase_rows(*args, len_code=kw.get("len_code"),
                                  avg32=kw.get("avg32"))
    cs, cl, score = _canonical(rows_f32, T, KV)
    np.testing.assert_array_equal(top_cs.numpy().view(np.int32),
                                  cs.astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(top_cl.numpy(), cl)
    assert top_cl.dtype == torch.int32 and top_cs.is_contiguous()
    assert (top_cl[4:] == -1).all()  # disjoint and padding rows
    assert (top_cl[3] == -1).any() and (top_cl[3] >= 0).any()  # sparse
    if (mode, T, KV) == ("raw", 2, 1024):  # tc: tf bytes and codes vary
        assert _straddles(score, cs, KV).any()


def test_selection_keeps_the_lowest_docs_of_a_straddling_class():
    """A tie class at the (KV+1)-th value spread over blocks whose maximum
    is that value and a block whose maximum is above it, the latter at
    the highest id (KV 3 over 6 blocks: the two-level selection gathers
    4 of them): the plain selection keeps the class's lowest docs, as
    the canonical one does."""
    NB = 6
    sc = np.zeros((2, NB * 128), dtype=np.float32)
    sc[1] = 1.0
    v, hi = np.float32(2.0), np.float32(7.0)
    for blk, lane in ((0, 100), (1, 5), (2, 77), (3, 30), (4, 2)):
        sc[0, blk * 128 + lane] = v
    sc[0, 5 * 128 + 1] = hi
    sc[0, 5 * 128 + 0] = v  # below the high lane, in the last block
    sc[0, 5 * 128 + 9] = hi
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    w = torch.ones((1, 2), dtype=torch.float32)
    top_cs, top_cl, _ = TK.full_phrase_select(T_(sc), slots, w, T=2,
                                              N_pad=NB * 128, KV=3)
    assert top_cl[0].tolist() == [5 * 128 + 1, 5 * 128 + 9, 100, 128 + 5]
    assert top_cs[0].tolist() == [8.0, 8.0, 3.0, 3.0]
    cs, cl, score = _canonical(TK._phrase_rows(T_(sc), slots, w)[0], 2, 3)
    assert top_cl.numpy().tolist() == cl.tolist()
    assert _straddles(score, cs, 3).all()


# -- the band and its need predicate ------------------------------------------


def _key_order_band(score, cs, cl, thr, KV, pay=None, kth_doc=None):
    """The kernel's band word, emulated on a canonical selection: a
    matched lane at or above thr that ranks after the KV-th selected key
    (score desc, lane asc), and, tc, no payload tie above kth_doc."""
    B, N = score.shape
    lane = np.arange(N)[None, :]
    s_kv, l_kv = cs[:, KV - 1 : KV], cl[:, KV - 1 : KV]
    after = (l_kv >= 0) & ((score < s_kv) | ((score == s_kv) & (lane > l_kv)))
    band = np.isfinite(score) & (score >= thr[:, None]) & after
    if pay is not None:
        kd = kth_doc[:, None]
        bad = (lane < kd) | (pay != np.take_along_axis(pay, kd[:, :, None]
                                                        .repeat(pay.shape[1],
                                                                1), 2)
                             ).any(axis=1)
        band &= bad
    return band.any(axis=1).astype(np.int32)


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_band_is_empty_unless_the_kv1_score_reaches_thr(wide, mode):
    """thr swept from above every (KV+1)-th score to below: the band word
    is 0 wherever that score is below thr (the kernel's need), set
    wherever need holds in raw columns (the (KV+1)-th lane flags itself),
    and equal to the key-order emulation; both need cases occur; tc with
    kth_doc at the (KV+1)-th lane itself (its own payload tie), at lane 0
    and past every lane."""
    p, _, q2 = wide
    KV = 1024
    args, kw = _wide_call(p, q2, mode, KV)
    top_cs, top_cl, _ = TK.full_phrase_select(*args, **kw)
    rows_f32, payload = TK._phrase_rows(*args, len_code=kw.get("len_code"),
                                        avg32=kw.get("avg32"))
    score = TK._phrase_score(rows_f32, 2).numpy()
    cs, cl = top_cs.numpy(), top_cl.numpy()
    unseen = cs[:, KV]
    pay = (np.stack([payload(t).numpy() for t in range(2)], axis=1)
           if mode == "tc" else None)
    seen = {True: 0, False: 0}
    top = np.float32(np.nanmax(np.where(np.isfinite(unseen), unseen, 0)))
    for thr_v in (np.inf, top * 2, top, top * np.float32(0.999), 1e-3):
        thr = np.full(unseen.shape, thr_v, dtype=np.float32)
        thr[1] = unseen[1]  # exactly at a row's (KV+1)-th score
        kds = ([np.maximum(cl[:, KV], 0), np.zeros_like(cl[:, KV]),
                np.full_like(cl[:, KV], score.shape[1] + 5)]
               if mode == "tc" else [None])
        for kd in kds:
            kth = None if kd is None else T_(kd.astype(np.int32))
            got = TK.full_phrase_band(*args, top_cs, top_cl, T_(thr),
                                      kth_doc=kth, **kw).numpy()
            need = unseen >= thr
            assert not got[~need].any()
            if mode == "raw":
                np.testing.assert_array_equal(got, need.astype(np.int32))
            kd_c = (None if kd is None
                    else np.clip(kd, 0, score.shape[1] - 1))
            np.testing.assert_array_equal(
                got, _key_order_band(score, cs, cl, thr, KV, pay, kd_c))
            for n in need:
                seen[bool(n)] += 1
    assert seen[True] and seen[False]


# -- an exact tie across the (KV+1)-th place: unflagged rows ------------------


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_straddling_tie_unflagged_rows_equal_the_oracle(corpus, mode):
    """The real BM25 planes (short docs: scores tie in large classes) at
    KV values whose (KV+1)-th place cuts a tie class on some row: the
    canonical passes (the kernels' rules: the canonical selection, the
    key-order band) give the plain flags and top docs bit for bit, and
    every unflagged row re-ranks to the oracle's phrase answer."""
    jp, oracle, port, je_raw, je_tc = corpus
    je = je_tc if mode == "tc" else je_raw
    cache64 = TorchEngine(port, device="cpu", dense_budget_bytes=0).cache64
    n_pad = je._n_pad_docs
    straddled = checked = 0
    for T in (2, 3):
        for KV, k in ((8, 5), (40, 5), (200, 10)):
            terms, args, idf64, PP, PW = _kernel_args(jp, je, T, k)
            M = min(KV, k + 6)
            kw = dict(T=T, N_pad=n_pad, KV=KV, PP=PP, PW=PW, M=M,
                      n_bs_iters=JK.n_iters_for(je._max_df),
                      eps3=3e-5 if mode == "tc" else 3e-6)
            t = [T_(a) for a in args]
            if mode == "tc":
                planes, rest = (t[0], t[8], t[9]), t[3:]
                pk = dict(len_code=t[1], avg32=torch.tensor(args[2]))
            else:
                planes, rest = (t[0], t[7], t[8]), t[2:]
                pk = {}
            rows_f32, payload = TK._phrase_rows(*planes, **pk)
            cs, cl, score = _canonical(rows_f32, T, KV)
            straddled += int(_straddles(score, cs, KV)[: len(terms)].sum())
            pay = (np.stack([payload(x).numpy() for x in range(T)], axis=1)
                   if mode == "tc" else None)

            def band(top_cs, top_cl, thr, kth_doc):
                return torch.from_numpy(_key_order_band(
                    score, top_cs.numpy(), top_cl.numpy(), thr.numpy(), KV,
                    pay, None if pay is None else kth_doc.numpy()))

            post = (rest[0], rest[1], rest[2], rest[3], rest[4],
                    rest[-2], rest[-1])
            docs_c, flags_c = TK._full_phrase_run(
                lambda: (torch.from_numpy(cs.astype(np.float32)),
                         torch.from_numpy(cl)), band, *post,
                **{x: kw[x] for x in ("T", "KV", "PP", "PW", "M",
                                      "n_bs_iters", "eps3")})
            docs_p, flags_p = TK._full_phrase_planes(
                *planes, *post, **kw, **pk)
            np.testing.assert_array_equal(flags_c.numpy(), flags_p.numpy())
            np.testing.assert_array_equal(docs_c.numpy(), docs_p.numpy())
            make = (TK.make_full_phrase_kernel_tc if mode == "tc"
                    else TK.make_full_phrase_kernel)
            got = make(T, n_pad, KV, PP, PW, M, kw["n_bs_iters"],
                       kw["eps3"])(*t).numpy()
            flags = got[: len(terms), T + 1, 0]
            docs_f, score_f, n_valid = rescore_sorted_arrays(
                got[:, 0, :], got[:, 1 : T + 1, :], idf64,
                port.doc_len_code, cache64)
            for i, q in enumerate(terms):
                if flags[i]:
                    continue
                checked += 1
                want = oracle.search(JQuery(q, n_results=k, is_phrase=True))
                n = min(k, int(n_valid[i]))
                assert list(zip(docs_f[i, :n].tolist(),
                                score_f[i, :n].tolist())) == [
                    (e.doc_id, e.doc_score) for e in want.entries]
    assert straddled >= 1 and checked >= 3


# -- the argument checks ------------------------------------------------------


def _good(mode: str, NB: int = 4, B: int = 3, T: int = 2, KV: int = 20):
    rng = np.random.default_rng(1)
    N = NB * 128
    slots = torch.tensor(rng.integers(0, 3, size=(B, T)), dtype=torch.int32)
    w = torch.ones((B, T), dtype=torch.float32)
    if mode == "tc":
        plane = torch.from_numpy(rng.integers(0, 4, size=(3, N))
                                 .astype(np.uint8))
        kw = dict(len_code=torch.from_numpy(rng.integers(0, 256, size=N)
                                            .astype(np.uint8)),
                  avg32=torch.tensor([7.5], dtype=torch.float32))
    else:
        plane = torch.from_numpy(rng.random((3, N)).astype(np.float32))
        kw = {}
    band = (torch.zeros((B, KV + 1), dtype=torch.float32),
            torch.zeros((B, KV + 1), dtype=torch.int32),
            torch.zeros(B, dtype=torch.float32),
            torch.zeros(B, dtype=torch.int32) if mode == "tc" else None)
    return [plane, slots, w], dict(kw, T=T, N_pad=N, KV=KV), band


BAD = [("plane_f64", "raw"), ("plane_u8_raw", "raw"), ("plane_strided", "tc"),
       ("slots_int64", "raw"), ("weights_rows", "tc"), ("code_short", "tc"),
       ("avg_two", "tc"), ("KV_zero", "raw"), ("KV_at_N_pad", "tc"),
       ("N_pad_ragged", "raw"), ("T_zero", "raw"), ("cs_width", "raw"),
       ("cl_int64", "tc"), ("thr_rows", "raw"), ("kth_missing", "tc"),
       ("kth_raw", "raw"), ("T_over_band", "raw")]


def _bad(case, args, kw, band):
    args, kw, band = list(args), dict(kw), list(band)
    if case == "plane_f64":
        args[0] = args[0].to(torch.float64)
    elif case == "plane_u8_raw":
        args[0] = args[0].to(torch.uint8)
    elif case == "plane_strided":
        args[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    elif case == "slots_int64":
        args[1] = args[1].to(torch.int64)
    elif case == "weights_rows":
        args[2] = args[2][1:].contiguous()
    elif case == "code_short":
        kw["len_code"] = kw["len_code"][:128].contiguous()
    elif case == "avg_two":
        kw["avg32"] = torch.cat([kw["avg32"], kw["avg32"]])
    elif case == "KV_zero":
        kw["KV"] = 0
    elif case == "KV_at_N_pad":
        kw["KV"] = kw["N_pad"]
    elif case == "N_pad_ragged":
        kw["N_pad"] -= 64
    elif case == "T_zero":
        kw["T"] = 0
    elif case == "cs_width":
        band[0] = band[0][:, 1:].contiguous()
    elif case == "cl_int64":
        band[1] = band[1].to(torch.int64)
    elif case == "thr_rows":
        band[2] = band[2][1:].contiguous()
    elif case == "kth_missing":
        band[3] = None
    elif case == "kth_raw":
        band[3] = torch.zeros(args[1].shape[0], dtype=torch.int32)
    elif case == "T_over_band":
        T = D.BAND_MAX_T + 1
        args[1] = torch.zeros((args[1].shape[0], T), dtype=torch.int32)
        args[2] = torch.ones((args[1].shape[0], T), dtype=torch.float32)
        kw["T"] = T
    return args, kw, tuple(band)


SELECT_ONLY_OK = {"cs_width", "cl_int64", "thr_rows", "kth_missing",
                  "kth_raw", "T_over_band"}


@pytest.mark.parametrize("case,mode", BAD)
def test_checks_refuse_the_same_on_either_entry(case, mode):
    """Each bad argument: check_phrase_inputs raises ValueError and
    phrase_args_ok is False; the dispatchers raise it on the CPU, and the
    kernels' entries raise check_phrase_inputs's ValueError (not the
    CUDA one) before any launch or count. The band's own arguments leave
    the selection's checks alone."""
    args, kw, band = _bad(case, *_good(mode))
    D.reset_launch_counts()
    for which, b in (("select", None), ("band", band)):
        if which == "select" and case in SELECT_ONLY_OK:
            D.check_phrase_inputs(*args, **kw)
            assert D.phrase_args_ok(*args, **kw)
            continue
        with pytest.raises(ValueError):
            D.check_phrase_inputs(*args, band=b, **kw)
        assert not D.phrase_args_ok(*args, band=b, **kw)
        kth = None if b is None else b[3]
        with pytest.raises(ValueError) as err:
            if b is None:
                D.phrase_select(*args, **kw)
            else:
                D.phrase_band(*args, *b[:3], kth_doc=kth, **kw)
        assert "CUDA tensors" not in str(err.value)
        with pytest.raises(ValueError):
            if b is None:
                TK.full_phrase_select(*args, **kw)
            else:
                TK.full_phrase_band(*args, *b[:3], kth_doc=kth, **kw)
    assert not any(D.launch_counts.values())


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_cpu_tensors_take_the_plain_passes(mode):
    """Good arguments pass both checks; the dispatchers return the plain
    versions' outputs; the kernels' entries refuse CPU tensors."""
    args, kw, band = _good(mode)
    D.check_phrase_inputs(*args, **kw)
    D.check_phrase_inputs(*args, band=band, **kw)
    assert D.phrase_args_ok(*args, **kw)
    assert D.phrase_args_ok(*args, band=band, **kw)
    top_cs, top_cl, _ = TK.full_phrase_select(*args, **kw)
    rows_f32, payload = TK._phrase_rows(*args, len_code=kw.get("len_code"),
                                        avg32=kw.get("avg32"))
    want = TK.full_phrase_select_torch(rows_f32, T=2, N_pad=kw["N_pad"],
                                       KV=kw["KV"])
    for a, b in zip((top_cs, top_cl), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    thr = top_cs[:, kw["KV"]].clone()
    kth = band[3]
    got = TK.full_phrase_band(*args, top_cs, top_cl, thr, kth_doc=kth, **kw)
    plain = TK.full_phrase_band_torch(rows_f32, top_cl, thr, T=2,
                                      N_pad=kw["N_pad"], KV=kw["KV"],
                                      rows_payload=payload, kth_doc=kth)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert got.dtype == torch.int32 and got.shape == (3,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.phrase_select(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.phrase_band(*args, top_cs, top_cl, thr, kth_doc=kth, **kw)


# -- the launch plans at the phrase's K ---------------------------------------


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("KV", [1024, 4096])
def test_plan_at_the_phrase_keys(mode, KV):
    """The selection at K = KV + 1 (1,025 and the rescue's 4,097), its
    sweep and the band over the 1M index's 7,816 blocks and a small doc
    space, B 8 to 128, T 2 to 4 and 8, three resident counts: within the
    H100's shared bytes and equal to dense.cu's layout, with room for two
    CTAs an SM; the selection's keys in one shared buffer of KP + 2
    steps' keys at either K (KP 8,192 is past KEY_SMEM_CAP, where the
    dense scan's running lists leave shared memory: no scratch here), a
    query's segments at most one cluster and no merge launch or scratch
    (one pass over every block, or the listed selection over K ranks of
    at most IDS_CAP a segment, which reads its sweep's tc table); the
    sweep with no keys, no merge, the (B, NB) block keys out; the band
    with no keys, no merge, no table and one word a query; the band's
    words within the flush's scratch."""
    assert 8 + 4 * 4 + 4 * D.BAND_MAX_T <= D.FLUSH_BYTES
    tc = mode == "tc"
    for B in (8, 32, 128):
        for T in (2, 3, 4, 8):
            for NB in (7816, 157):
                for resident in (264, 396, 528):
                    for listed in (False, True):
                        if listed and NB < KV + 1:
                            continue
                        s = D.plan(B, T, KV + 1 if listed else NB, KV, mode,
                                   resident, listed, kind="select")
                        assert s.K == KV + 1 and s.KP == 1 << KV.bit_length()
                        assert s.smem == D.scan_bytes(T, s.KP, mode, s.NS,
                                                      s.step_blocks, listed,
                                                      kind="select")
                        assert s.smem <= D.SMEM_TWO_CTAS
                        assert (s.merge_smem, s.part_words, s.r_words) == (
                            0, 0, 0)
                        assert s.out_words == 2 * B * s.K
                        assert 1 <= s.nseg <= D.MAX_CLUSTER
                        assert not listed or s.bps <= D.IDS_CAP
                        assert s.launches == 1 + (tc and not listed)
                        n = KV + 1 if listed else NB
                        assert (s.nseg - 1) * s.bps < n <= s.nseg * s.bps
                    w = D.plan(B, T, NB, KV, mode, resident, kind="sweep")
                    assert w.KP == 0 and w.smem == D.scan_bytes(
                        T, 0, mode, w.NS, w.step_blocks)
                    assert (w.merge_smem, w.part_words, w.r_words,
                            w.out_words, w.launches) == (
                        0, 0, 0, 2 * B * NB, 1 + tc)
                    assert (w.nseg - 1) * w.bps < NB <= w.nseg * w.bps
                    b = D.plan(B, T, NB, KV, mode, resident, kind="band")
                    assert b.K == KV + 1 and b.KP == 0
                    assert b.smem == D.scan_bytes(T, 0, mode, b.NS,
                                                  b.step_blocks)
                    assert b.smem < s.smem and b.smem <= D.MAX_SMEM
                    assert (b.merge_smem, b.part_words, b.r_words,
                            b.table_words, b.out_words, b.launches) == (
                        0, 0, 0, 0, B, 1)
                    assert (b.nseg - 1) * b.bps < NB <= b.nseg * b.bps
    # the key regions: the scan's R and R2 in shared memory up to the
    # cap and X always; the selection's buffer; none for the band
    F = D.FLUSH_BYTES
    base = 48 + 16 + F + 16 + 16 + 16 + 2 * 2 * 4096
    assert D.scan_bytes(2, 2048, "raw", 2, 8) == base + 16 * 2048 + 16 * 1024
    assert D.scan_bytes(2, 8192, "raw", 2, 8) == base + 16 * 1024
    assert D.scan_bytes(2, 2048, "raw", 2, 8, kind="select") == (
        base + 8 * (2048 + 2 * 1024))
    assert D.scan_bytes(2, 8192, "raw", 2, 8, kind="select") == (
        base + 8 * (8192 + 2 * 1024))
    assert D.scan_bytes(2, 0, "raw", 2, 8) == base
    assert D.scan_bytes(2, 0, "raw", 2, 8, kind="sweep") == base


# -- the slice end to end -----------------------------------------------------


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(TK, name)

    def wrapped(*a, **kw):
        calls.append(kw.get("KV"))
        return orig(*a, **kw)

    monkeypatch.setattr(TK, name, wrapped)
    return calls


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_engines_take_the_passes(corpus, monkeypatch, columns):
    """TorchEngine with the mega route engaged (small doc space: the
    thresholds lowered on both engines) answers the head phrases as
    TpuEngine and the oracle do, through full_phrase_select and
    full_phrase_band at KV and at the rescue's KV."""
    jp, oracle, port, _, _ = corpus
    te = TorchEngine(port, device="cpu", columns=columns)
    je = TpuEngine(jp, columns=columns)
    for e in (te, je):
        e.PRUNED_DENSE_MIN_NB = 8
        e.PRUNED_DENSE_C = 4
        e.PRUNED_PHRASE_C = 4
        e.PHRASE_MAX_L = 64
        e.PRUNED_PHRASE_KV = 16
    sel = _spy(monkeypatch, "full_phrase_select")
    band = _spy(monkeypatch, "full_phrase_band")
    qs = [SearchQuery(t, n_results=k, is_phrase=True)
          for t in HEADS for k in (3, 10)]
    got = [[(e.doc_id, e.doc_score) for e in r.entries]
           for r in te.search_batch(qs)]
    jqs = [JQuery(q.terms, n_results=q.n_results, is_phrase=True)
           for q in qs]
    assert got == [[(e.doc_id, e.doc_score) for e in r.entries]
                   for r in je.search_batch(jqs)]
    assert got == [[(e.doc_id, e.doc_score) for e in oracle.search(q).entries]
                   for q in jqs]
    st = te.stats_take()
    assert st["route_phrase_full"] == len(qs)
    assert sel and len(sel) == len(band)
    assert 16 in sel and (st.get("prune_rescued", 0) == 0
                          or te._n_pad_docs - 1 in sel)


@pytest.mark.cuda
def test_phrase_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = DB.check_phrase_cases(torch.device("cuda", 0))
    assert out["cases"] > 0 and out["max_abs_err"] == 0.0
