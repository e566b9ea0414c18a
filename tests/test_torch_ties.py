"""Tie order in wiser_tpu_torch: every test here runs with torch.topk
replaced by a tie-adversarial top-k, which returns tied values highest
index first (a stable sort of the input flipped along dim, its first k,
indices mapped back). On the CPU torch.topk happens to keep the lowest-index
ties, as lax.top_k does; a CUDA card promises no order. A selection that
relies on topk's tie order then shows here as it would on the card.

Kernel level (the same numpy inputs through the JAX step and the
port's): two_level_top_m keeps lax.top_k's set wherever the boundary
class fits and flags it where it does not; _select_ub_blocks, the pruned
dense kernel and the block-pruned and full-scan mega phrase kernels on
tied planes (the corpus's own BM25 rows, quantized) give the JAX
output exactly; the compact and semidense phrase kernels give JAX's
flags and, on unflagged rows, its (doc, tfs) lanes. Engine level:
TorchEngine == TpuEngine == OracleEngine over duplicate-doc corpora
through bs (flat and two-level), the pruned dense pick with its rescue,
semidense, the compact, semidense, full-scan and block-pruned mega
phrase routes, and the staged engine's cold finalizer (flat and phrase,
margin 0). The mesh (engine/shard.py, 4 shards): merge_shards keeps
lax.top_k's order over gathered shard-major lanes full of ties (a stable
sort: swapping in torch.topk fails here, ROADMAP C.3), and ShardedEngine
== the JAX ShardedEngine == OracleEngine over bs (margin 0), the dense
scan, the pruned pick, semidense and both phrase routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu.engine.staged as JS
import wiser_tpu_torch.engine.kernels as TK
import wiser_tpu_torch.engine.staged as TS
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.engine.shard import ShardedEngine as JShardedEngine
from wiser_tpu.engine.shard import ShardedIndex as JShardedIndex
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine import shard_steps as SS
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
from wiser_tpu_torch.types import SearchQuery


def adversarial_topk(input, k, dim=-1, largest=True, sorted=True):
    """torch.topk, with equal values in descending index order: a stable
    sort of the input flipped along dim, its first k, indices mapped
    back."""
    d = dim % input.dim()
    vals, idx = torch.sort(torch.flip(input, dims=[d]), dim=d,
                           descending=largest, stable=True)
    vals, idx = vals.narrow(d, 0, k), idx.narrow(d, 0, k)
    return torch.return_types.topk((vals, input.shape[d] - 1 - idx))


@pytest.fixture(autouse=True)
def tie_adversarial(monkeypatch):
    monkeypatch.setattr(torch, "topk", adversarial_topk)
    monkeypatch.setattr(torch.Tensor, "topk", adversarial_topk)


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def T_(a):
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def J(a):
    return jnp.asarray(a)


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase)
            for q in qs]


def three_way(te, je, oracle, qs):
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    assert sum(map(len, got)) > 0
    return got


def test_the_fixture_reverses_ties():
    x = torch.tensor([[3.0, 5.0, 5.0, 1.0, 5.0, 3.0]])
    vals, idx = torch.topk(x, 4, dim=1)
    assert vals.tolist() == [[5.0, 5.0, 5.0, 3.0]]
    assert idx.tolist() == [[4, 2, 1, 5]]
    assert x.topk(2).indices.tolist() == [[4, 2]]
    assert torch.topk(x[0], 1).indices.tolist() == [4]


# -- corpora -------------------------------------------------------------------


@pytest.fixture(scope="module")
def dup():
    """1,600 docs: 600 copies of one doc (one exact tie class for every
    query over its terms, phrases included), 400 copies of its reversed
    pair, and 600 docs of varying length (near ties) with mid terms r*
    (semidense) and q* (compact) beside the head terms h0..h2, which are
    dense at the default floor."""
    rng = np.random.default_rng(41)
    docs = [make_docinfo("h0 h1 h2 x".split()) for _ in range(600)]
    docs += [make_docinfo(["h1", "h0", "h2", f"y{i % 7}"]) for i in range(400)]
    for i in range(600):
        toks = [f"r{i % 40}", "h1", "h0", "h1", "h2", f"q{i % 30}",
                f"r{(i + 1) % 40}"]
        toks += [f"z{rng.integers(100)}" for _ in range(i % 6)]
        docs.append(make_docinfo(toks))
    jp, oracle = build_index(docs, with_blooms=True)
    return jp, to_port(jp), oracle


def _pair(jp, port, **over):
    te, je = TorchEngine(port, device="cpu"), TpuEngine(jp)
    for e in (te, je):
        for k, v in over.items():
            setattr(e, k, v)
    return te, je


MEGA = dict(PRUNED_DENSE_MIN_NB=8, PRUNED_DENSE_C=4, PRUNED_PHRASE_C=4,
            PHRASE_MAX_L=64, PRUNED_PHRASE_KV=16)


# -- kernel level ----------------------------------------------------------------


def test_two_level_top_m_keeps_the_set_or_flags():
    """Quantized scores: tie classes everywhere, the boundary included.
    Where the boundary class fits the M lanes the kept set is lax.top_k's;
    where it does not, boundary_truncated flags the row (the engine then
    re-ranks exactly or takes the host)."""
    rng = np.random.default_rng(3)
    for NBLK, M in ((96, 64), (70, 64), (16, 64), (40, 10)):
        score = rng.integers(0, 40, size=(6, NBLK * 128)).astype(np.float32)
        score[1] = 7.0
        score[2, :5000] = JK.NEG_INF
        score[3] = np.where(rng.random(NBLK * 128) < 0.01, 39.0, 0.0)
        got_s, got_l = TK.two_level_top_m(torch.from_numpy(score), M)
        want_s, want_l = jax.lax.top_k(J(score), M)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        trunc = TK.boundary_truncated(torch.from_numpy(score), got_s, M).numpy()
        assert trunc[1]
        for b in np.nonzero(~trunc)[0]:  # the kept valid lanes
            live = got_s[b].numpy() > JK.NEG_INF
            assert sorted(got_l[b][live].tolist()) == \
                sorted(np.asarray(want_l)[b][live].tolist())
        np.testing.assert_array_equal(
            score[np.arange(6)[:, None], got_l.numpy()], got_s.numpy())


def _dense_planes(jp, je, levels):
    """The engine's own dense rows quantized to `levels` values per term
    (massive exact ties, blocks with equal maxima) and their block
    planes."""
    sc = je._h_dense_sc.copy()
    live = sc > 0
    top = sc.max(axis=1, keepdims=True)
    sc = np.where(live, np.ceil(sc / top * levels) / levels * top, 0)
    sc = sc.astype(np.float32)
    H, n_pad = sc.shape
    sc3 = sc.reshape(H, n_pad // 128, 128)
    top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
    return (sc, top2[:, :, 1].copy(), top2[:, :, 0].copy(),
            np.argmax(sc3, axis=2).astype(np.uint8))


def _dense_inputs(jp, je, term_lists, k):
    T = len(term_lists[0])
    B = 8
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    anchor = np.zeros(B, dtype=np.int32)
    ks = np.zeros(B, dtype=np.int32)
    for i, terms in enumerate(term_lists):
        r = [jp.lookup(t) for t in terms]
        starts[i] = je._starts32[r]
        ends[i] = je._starts32[r] + je._df32[r]
        slots[i] = je._dense_slot[r]
        use[i] = 1
        anchor[i] = int(np.argmin(jp.max_tf[r]))
        ks[i] = k
    return T, starts, ends, slots, use, anchor, ks


HEADS = ([["h0", "h1"], ["h1", "h0"], ["h2", "h0"]],
         [["h0", "h1", "h2"], ["h1", "h0", "h2"]])


@pytest.mark.parametrize("levels", [2, 5])
@pytest.mark.parametrize("C", [4, 9])
def test_pruned_dense_on_tied_blocks(dup, levels, C):
    """Equal block bounds at the C-th place: the pick keeps lax.top_k's
    blocks, so the packed output and next_ub are the reference's."""
    jp, _, _ = dup
    je = TpuEngine(jp)
    sc, bm, bm2, ap = _dense_planes(jp, je, levels)
    NB = je._n_pad_docs // 128
    for terms in HEADS:
        T, _, _, slots, use, _, ks = _dense_inputs(jp, je, terms, 10)
        args = (bm, slots, use)
        want_blk, want_ub = JK._select_ub_blocks(
            *(J(a) for a in args), T=T, NB=NB, C=C, blockmax2=J(bm2),
            argpos=J(ap))
        got_blk, got_ub = TK._select_ub_blocks(
            *(T_(a) for a in args), T=T, NB=NB, C=C, blockmax2=T_(bm2),
            argpos=T_(ap))
        np.testing.assert_array_equal(got_blk.numpy(), np.asarray(want_blk))
        np.testing.assert_array_equal(got_ub.numpy(), np.asarray(want_ub))
        M = 16
        kargs = (sc, je._h_dense_tf, bm, bm2, ap, slots, use, ks)
        want = np.asarray(JK.make_pruned_dense_kernel(T, NB, C, M, 3e-6)(
            *(J(a) for a in kargs)))
        got = TK.make_pruned_dense_kernel(T, NB, C, M, 3e-6)(
            *(T_(a) for a in kargs)).numpy()
        np.testing.assert_array_equal(got[:, T + 1, 0], want[:, T + 1, 0])
        ok = (got[:, T + 1, 0] & TK.FLAG_TRUNC) == 0
        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("levels", [2, 5])
@pytest.mark.parametrize("KV,k", [(16, 5), (200, 10)])
def test_mega_phrase_kernels_on_tied_planes(dup, levels, KV, k):
    """The full-scan and the block-pruned mega phrase over tied dense rows:
    the KV compaction cuts through tie classes, and both kernels give the
    JAX output exactly (stable selections keep lax.top_k's lanes)."""
    jp, _, _ = dup
    je = TpuEngine(jp)
    sc, bm, bm2, ap = _dense_planes(jp, je, levels)
    NB, n_pad = je._n_pad_docs // 128, je._n_pad_docs
    n_it = JK.n_iters_for(je._max_df)
    for terms in HEADS:
        T, starts, ends, slots, use, anchor, ks = _dense_inputs(jp, je, terms, k)
        M = min(KV, k + 6)
        tail = (je._h_doc, je._h_positions, jp.pos_starts.astype(np.int32),
                starts, ends, slots, use, anchor, ks)
        want = np.asarray(JK.make_full_phrase_kernel(
            T, n_pad, KV, 8, 32, M, n_it, 3e-6)(
            *(J(a) for a in (sc, je._h_dense_tf) + tail)))
        got = TK.make_full_phrase_kernel(T, n_pad, KV, 8, 32, M, n_it, 3e-6)(
            *(T_(a) for a in (sc, je._h_dense_tf) + tail)).numpy()
        np.testing.assert_array_equal(got, want)
        C = 6
        kv = min(KV, C * 128 - 1)
        pargs = (sc, je._h_dense_tf, bm, bm2, ap) + tail
        want = np.asarray(JK.make_pruned_phrase_kernel(
            T, NB, C, kv, 8, 32, min(kv, M), n_it, 3e-6)(
            *(J(a) for a in pargs)))
        got = TK.make_pruned_phrase_kernel(T, NB, C, kv, 8, 32, min(kv, M),
                                           n_it, 3e-6)(
            *(T_(a) for a in pargs)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] >= 0).any()


def _rows_by_doc(packed_out, T):
    lanes = packed_out[:, : T + 1]
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2)


@pytest.mark.parametrize("KV", [16, 64])
def test_verify_and_select_kernels_on_ties(dup, KV):
    """The compact and semidense phrase kernels (_verify_and_select's final
    top-M) on the duplicate corpus's tied scores: flags equal, and each
    unflagged row's (doc, tfs) lanes equal compared in doc order."""
    jp, _, _ = dup
    je = TpuEngine(jp)
    n_it = JK.n_iters_for(je._max_df)
    from wiser_tpu.engine.device import _PlannedQuery
    from wiser_tpu_torch.engine.host import PP_BUCKETS, _bucket

    def group(term_lists):
        g = []
        for i, terms in enumerate(term_lists):
            rows = [jp.lookup(t) for t in terms]
            pq = _PlannedQuery(i, rows, JQuery(terms, n_results=5,
                                               is_phrase=True))
            pq.plan_slots(jp.df)
            g.append(pq)
        return g

    compact = [["r3", "h1"], ["h2", "q7"], ["r5", "h1", "h0"], ["q2", "r4"]]
    semi = [["r3", "h1"], ["r9", "h1"], ["r11", "h1"], ["r0", "h1"]]
    for terms, sd in ((compact, False), (semi, True)):
        g = group(terms)
        T = max(len(t) for t in terms)
        g = [pq for pq in g if len(pq.rows) == T] if sd else \
            [pq for pq in g if len(pq.rows) == 2]
        T = len(g[0].rows)
        starts, ends, use, _, _, slot_of, ks = je._assemble(
            g, T, buckets=je.PHRASE_B_BUCKETS)
        slot_of = slot_of.astype(np.int32)
        L = max(_bucket(int(jp.df[pq.slot_rows[0]]), je._lb) for pq in g)
        PP = max(_bucket(int(jp.max_tf[pq.rows[0]]), PP_BUCKETS) for pq in g)
        M = min(KV, 12)
        if sd:
            slots = np.zeros(starts.shape, dtype=np.int32)
            for i, pq in enumerate(g):
                slots[i, 1:] = je._dense_slot[pq.slot_rows[1:]]
            args = (je._h_doc, je._h_score, je._h_tf, je._h_dense_sc,
                    je._h_positions, jp.pos_starts.astype(np.int32), starts,
                    ends, use, slots, slot_of, ks)
            mk = ("make_semidense_phrase_kernel",
                  (T, L, KV, PP, 32, M, je._n_pad_docs, n_it, 3e-6))
        else:
            probes = je._assemble_bloom_probes(g, T, starts.shape[0])
            args = ((je._h_doc, je._h_score, je._h_tf, je._h_positions,
                     jp.pos_starts.astype(np.int32), starts, ends, use,
                     slot_of, ks, je._h_bloom_rows, je._h_bloom_bitmap,
                     je._h_bloom_rank) + probes)
            mk = ("make_compact_phrase_kernel",
                  (T, L, KV, PP, 32, M, n_it, 3e-6))
        want = np.asarray(getattr(JK, mk[0])(*mk[1])(*(J(a) for a in args)))
        got = getattr(TK, mk[0])(*mk[1])(*(T_(a) for a in args)).numpy()
        flags = got[:, T + 1, 0]
        np.testing.assert_array_equal(flags, want[:, T + 1, 0])
        ok = (flags & TK.FLAG_TRUNC) == 0
        np.testing.assert_array_equal(_rows_by_doc(got, T)[ok],
                                      _rows_by_doc(want, T)[ok])
        assert (got[:, 0] >= 0).any()


# -- engine level ------------------------------------------------------------------


def test_bs_flat_and_two_level(dup):
    """bs and windowed over the 600-doc tie class: the flat selection (L
    512) and the two-level branch (L 2048 >= (M+1) * 128 lanes at margin
    0..3), with the truncated class reaching the k-th place."""
    jp, port, oracle = dup
    for margin in (0, 3):
        te = TorchEngine(port, device="cpu", margin=margin,
                         single_term_depth=0, dense_budget_bytes=0)
        je = TpuEngine(jp, margin=margin, single_term_depth=0,
                       dense_budget_bytes=0)
        qs = [SearchQuery(t, n_results=k)
              for t in (["h0"], ["h0", "h1"], ["h2", "h1", "h0"], ["x", "h0"],
                        ["h0", "y3"], ["r5", "h1"])
              for k in (1, 3, 10)]
        three_way(te, je, oracle, qs)
        st = te.stats_take()
        assert st["route_bs"] + st["route_windowed"] == len(qs)
        assert st["route_windowed"] > 0 and st["forced_host_tie_cut"] > 0


def test_dense_routes(dup):
    """The pruned dense pick over equal block bounds with its rescue, and
    semidense, on the duplicate corpus."""
    jp, port, oracle = dup
    te, je = _pair(jp, port, **MEGA)
    assert te._dense_H == 3
    qs = [SearchQuery(t, n_results=k)
          for t in (["h0", "h1"], ["h1", "h2", "h0"], ["r5", "h1"],
                    ["h2", "q7"], ["x", "h0"])
          for k in (1, 5, 10)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_pruned"] > 0 and st["route_semidense"] > 0


def test_phrase_routes(dup):
    """The full-scan mega phrase, then the block-pruned one (each with its
    rescue), the semidense and the compact phrase routes over tied
    candidates."""
    jp, port, oracle = dup
    te, je = _pair(jp, port, **MEGA)
    qs = [SearchQuery(t, n_results=k, is_phrase=True)
          for t in (["h0", "h1"], ["h1", "h0"], ["h0", "h1", "h2"],
                    ["h1", "h2"], ["r5", "h1"], ["h2", "q7"], ["q7", "r8"])
          for k in (1, 5, 10)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    for route in ("phrase_full", "phrase_semidense", "phrase_compact"):
        assert st.get(f"route_{route}", 0) > 0, route
    for e in (te, je):
        e.FULL_PHRASE_SCAN = False
    three_way(te, je, oracle, qs[:9])
    assert te.stats_take()["route_phrase_pruned"] > 0


@pytest.mark.parametrize("phrase", [False, True])
def test_staged_cold_finalizer(dup, monkeypatch, phrase):
    """Budget 0, the device cold path, margin 0: the M-lane buffer ends
    inside the 600-doc tie class; the cold finalizer's tie_class_cut sends
    the rows whose k-th place it reaches to the exact host search."""
    jp, port, oracle = dup
    for mod in (JS, TS):
        monkeypatch.setattr(mod.StagedEngine, "COLD_COMPUTE", "device")
        monkeypatch.setattr(mod, "COLD_L_BUCKETS", [2048] + mod.COLD_L_BUCKETS)
    te = TS.StagedEngine(port, 0, device="cpu", margin=0)
    je = JS.StagedEngine(jp, 0, margin=0)
    terms = ((["h0", "h1"], ["h1", "h0"], ["h0", "h1", "h2"]) if phrase
             else (["h0", "h1"], ["x", "h1"], ["h2", "h1", "h0"]))
    qs = [SearchQuery(t, n_results=k, is_phrase=phrase)
          for t in terms for k in (1, 3, 10)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st.get("route_cold_phrase" if phrase else "cold_chunks", 0) > 0
    assert st["cold_host_fallback_q"] > 0


# -- the mesh ------------------------------------------------------------------------


def test_mesh_merge_keeps_lax_top_k_order():
    """merge_shards over gathered lanes full of ties, against the JAX
    merge's lax.top_k (shard-major lanes, lowest index first among equal
    scores), M_out at and past the local M."""
    rng = np.random.default_rng(3)
    D, B, M, T = 4, 8, 6, 2
    for Mo in (M, 2 * M + 1):
        score = rng.choice(np.float32([4.0, 2.0, 2.0, 2.0]), size=(D, B, M))
        score = -np.sort(-score, axis=2)
        docs = (np.arange(D)[:, None, None] * 100
                + np.arange(M)[None, None, :] * 3
                + rng.integers(0, 3, size=(D, B, M))).astype(np.int32)
        tfs = rng.integers(1, 5, size=(D, B, T, M)).astype(np.int32)
        flags = np.zeros((D, B), dtype=np.int32)
        gs = jnp.asarray(score.transpose(1, 0, 2).reshape(B, D * M))
        s2, i2 = jax.lax.top_k(gs, Mo)
        i2 = np.asarray(i2)
        d2, sc2, t2, fl = SS.merge_shards(
            *(torch.from_numpy(a) for a in (docs, score, tfs, flags)),
            M_out=Mo)
        gd = docs.transpose(1, 0, 2).reshape(B, D * M)
        gt = tfs.transpose(1, 2, 0, 3).reshape(B, T, D * M)
        np.testing.assert_array_equal(d2.numpy(),
                                      np.take_along_axis(gd, i2, 1))
        np.testing.assert_array_equal(sc2.numpy(), np.asarray(s2))
        np.testing.assert_array_equal(
            t2.numpy(), np.take_along_axis(gt, i2[:, None, :].repeat(T, 1), 2))
        want_fl = np.asarray(JK.boundary_truncated(gs, s2, Mo)).astype(
            np.int32) * JK.FLAG_TRUNC
        np.testing.assert_array_equal(fl.numpy(), want_fl)


def _mesh_pair(jp, port, margin=54, **over):
    """The JAX ShardedEngine on 4 of the 8 virtual devices and the port's
    on 4 CPU shards, with the same class-level overrides."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("d",))
    JE = type("JE", (JShardedEngine,), over)
    TE = type("TE", (ShardedEngine,), over)
    return (TE(ShardedIndex.from_packed(port, 4), devices=["cpu"] * 4,
               margin=margin),
            JE(JShardedIndex.from_packed(jp, 4), mesh=mesh, margin=margin))


def test_mesh_engine_routes(dup):
    """The mesh over the duplicate corpus: bs at margin 0 (the truncated
    tie class reaches the k-th place: tie_class_cut), the dense scan, the
    pruned pick over equal block bounds (C = 2 of 4 blocks per shard),
    semidense and both phrase routes."""
    jp, port, oracle = dup
    conj = [SearchQuery(t, n_results=k)
            for t in (["h0", "h1"], ["h1", "h2", "h0"], ["r5", "h1"],
                      ["h2", "q7"], ["x", "h0"], ["h0", "y3"])
            for k in (1, 5, 10)]
    phr = [SearchQuery(t, n_results=k, is_phrase=True)
           for t in (["h0", "h1"], ["h1", "h0"], ["r5", "h1"], ["q7", "r8"])
           for k in (1, 10)]
    te, je = _mesh_pair(jp, port, margin=0, DENSE_MIN_DF_FLOOR=1 << 20)
    three_way(te, je, oracle, conj + phr)
    st = te.stats_take()
    assert st["route_bs"] > 0 and st["forced_host_tie_cut"] > 0
    for over in ({}, {"PRUNED_DENSE_MIN_NB": 1, "PRUNED_DENSE_C": 2,
                      "PHRASE_COMPACT_KV": 8}):
        te, je = _mesh_pair(jp, port, **over)
        three_way(te, je, oracle, conj + phr)
        st = te.stats_take()
        routes = (("route_pruned", "route_phrase_compact") if over
                  else ("route_dense", "route_phrase_list"))
        for route in routes + ("route_semidense",):
            assert st.get(route, 0) > 0, route
