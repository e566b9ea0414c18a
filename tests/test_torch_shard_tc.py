"""wiser_tpu_torch's mesh on tc columns (ShardedEngine(columns="tc"):
per-shard uint16 tc lanes, the uint8 dense tf plane and len-code row)
against wiser_tpu.engine.shard's tc mode.

Steps: each tc local step with its merge against its make_sharded_*_tc
program, compiled at xla_backend_optimization_level 0 (XLA's CPU jit at
its default level contracts FMAs and moves tc scores by up to 4 ulps, as
the other tc tests note): equal flag words (FLAG_TF_SAT and
FLAG_PRUNE_MISS included), and the merged (doc, tfs) lanes of every row
without FLAG_TRUNC equal up to the order of equal f32 scores. Engine:
identical (doc, f64 score) lists from the port, the JAX ShardedEngine
and OracleEngine over every route, mirroring tests/test_shard_tc.py's
cases on one 2,100-doc corpus; raw equal to tc; postings at most 0.51
of raw's bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu.engine.shard as JSH
from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.host import L_BUCKETS, PP_BUCKETS, _bucket, _PlannedQuery
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
from wiser_tpu_torch.types import SearchQuery

CPU8 = ["cpu"] * 8
NO_FMA = {"xla_backend_optimization_level": 0}
TC_FACTORIES = (JSH.make_sharded_kernel_tc, JSH.make_sharded_phrase_kernel_tc,
                JSH.make_sharded_dense_kernel_tc,
                JSH.make_sharded_pruned_dense_kernel_tc,
                JSH.make_sharded_semidense_kernel_tc,
                JSH.make_sharded_compact_phrase_kernel)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores, and these
    small-tensor steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


def jq(qs):
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase)
            for q in qs]


def three_way(te, je, oracle, qs):
    te.stats_take()  # the counters of this batch alone
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    return got


def no_fma_jit(fn):
    """serial_jit's stand-in for the step tests: one program per argument
    shape, compiled without FMA contraction."""
    compiled = {}

    def run(*args):
        key = tuple((getattr(a, "shape", None), str(getattr(a, "dtype", "")))
                    for a in args)
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(NO_FMA)
        return compiled[key](*args)

    return run


@pytest.fixture
def jax_no_fma(monkeypatch):
    monkeypatch.setattr(JSH, "serial_jit", no_fma_jit)
    for f in TC_FACTORIES:
        f.cache_clear()
    yield
    for f in TC_FACTORIES:
        f.cache_clear()


@pytest.fixture(scope="module")
def tiers():
    """test_shard_tiers.py's corpus at 2,100 docs (3 blocks of 128 per
    shard: the pruned scan), with bi-blooms."""
    docs = synth_docinfos(n_docs=2100, vocab_size=400, mean_len=60,
                          zipf_a=1.15, seed=11, with_blooms=True)
    jp, oracle = build_index(docs, with_blooms=True)
    port = to_port(jp)
    je = JSH.ShardedEngine(JSH.ShardedIndex.from_packed(jp, 8), columns="tc")
    te = ShardedEngine(ShardedIndex.from_packed(port, 8), devices=CPU8,
                       columns="tc")
    return jp, port, oracle, je, te


def mined_pairs(oracle, n, seed):
    """n adjacent distinct-term pairs of the corpus's bodies, drawn with a
    seed from their sorted set (synth_log.mine_phrases_from_index walks
    the oracle's sets, whose order changes with the process's hash
    seed)."""
    pairs = sorted({(a, b) for body in oracle.doc_bodies
                    for a, b in zip(body.split(" "), body.split(" ")[1:])
                    if a != b})
    idx = np.random.default_rng(seed).choice(len(pairs), size=n,
                                             replace=False)
    return [pairs[i] for i in idx]


def head_tail(te, port):
    head = np.nonzero(te._dense_slot >= 0)[0]
    tail = np.nonzero((te._dense_slot < 0) & (port.df >= 2))[0]
    return head, tail


# -- columns -------------------------------------------------------------------


def test_tc_columns_equal_the_jax_engine(tiers):
    jp, port, _, je, te = tiers
    assert te.rel_eps == je.rel_eps == 1e-5
    assert te._dense_H == je._dense_H > 0
    for s, cols in enumerate(te.shards):
        assert cols.score is None and cols.tf is None
        assert cols.tc.numpy().view(np.uint16).tobytes() == \
            np.asarray(je.d_postings_tc)[s].tobytes()
        for mine, ref in ((cols.dense_tf8, je.d_dense_tf8),
                          (cols.len_code, je.d_len_code),
                          (cols.blockmax, je.d_dense_blockmax)):
            ref = np.asarray(ref)[s]
            assert mine.numpy().dtype == ref.dtype
            assert mine.numpy().tobytes() == ref.tobytes()
    raw = ShardedEngine(te.sharded, devices=CPU8, dense_budget_bytes=0)
    assert te.device_bytes()["postings"] <= 0.51 * \
        raw.device_bytes()["postings"]


# -- each tc step with its merge ---------------------------------------------------


def planned(port, terms_list, k=10):
    out = []
    for qi, terms in enumerate(terms_list):
        pq = _PlannedQuery(qi, [port.term_to_row[t] for t in terms],
                           SearchQuery(list(terms), n_results=k))
        pq.plan_slots(port.df)
        out.append(pq)
    return out


def cooccurring(oracle, port, rows, n, T, seed):
    rng = np.random.default_rng(seed)
    allowed = {port.terms[r] for r in rows}
    out = []
    while len(out) < n:
        body = oracle.doc_bodies[int(rng.integers(len(oracle.doc_bodies)))]
        words = sorted({w for w in body.split(" ") if w in allowed})
        if len(words) >= T:
            out.append([str(w) for w in rng.choice(words, T, replace=False)])
    return out


def group_L(te, group):
    return max(_bucket(int(te._df_shard_max[pq.slot_rows[0]]), L_BUCKETS)
               for pq in group)


def rows_by_doc(packed, T):
    lanes = packed[:, : T + 1]
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2)


def assert_merged_equal(got, want, T):
    got = got.numpy()
    np.testing.assert_array_equal(got[:, T + 1], want[:, T + 1])
    clean = (want[:, T + 1, 0] & JK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(rows_by_doc(got[clean], T),
                                  rows_by_doc(want[clean], T))
    assert (want[clean, 0, :] >= 0).sum() > 0


def J(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("T", [1, 3])
def test_bs_step_tc(tiers, jax_no_fma, T):
    _, port, oracle, je, te = tiers
    _, tail = head_tail(te, port)
    group = planned(port, cooccurring(oracle, port, tail, 8, T, seed=T))
    rows, w, _, _, _ = te._assemble(group, T, 8)
    L = group_L(te, group)
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_bs(rows, w, T=T, L=L, M=M, M_out=Mo)
    d2, _, t2, flags = JSH.make_sharded_kernel_tc(
        T, L, M, JK.n_iters_for(te._max_df), je.mesh, je._avg32, M_out=Mo)(
        je.d_postings_doc, je.d_postings_tc, je.d_term_starts, je.d_df_shard,
        J(rows.astype(np.int32)), J(w))
    want = np.asarray(JK.pack_with_flags(d2, t2, flags))
    assert_merged_equal(got, want, T)


def test_phrase_step_tc(tiers, jax_no_fma):
    _, port, oracle, je, te = tiers
    pairs = mined_pairs(oracle, 40, 2)
    group = [pq for pq in planned(port, [list(p) for p in pairs])
             if len(pq.rows) == 2][:8]
    T = 2
    rows, w, _, slot_of, _ = te._assemble(group, T, 8)
    L = group_L(te, group)
    PP = max(_bucket(int(port.max_tf[pq.rows[0]]), PP_BUCKETS)
             for pq in group)
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_phrase(rows, w, slot_of, T=T, L=L, PP=PP, M=M, M_out=Mo)
    want = np.asarray(JSH.make_sharded_phrase_kernel_tc(
        T, L, PP, M, JK.n_iters_for(te._max_df), JK.n_iters_for(te._max_tf),
        je.mesh, je._avg32, M_out=Mo)(
        je.d_postings_doc, je.d_postings_tc, je.d_term_starts,
        je.d_df_shard, je.d_positions, je.d_pos_starts,
        J(rows.astype(np.int32)), J(w), J(slot_of.astype(np.int32))))
    assert_merged_equal(got, want, T)


def test_compact_phrase_step_tc(tiers, jax_no_fma, monkeypatch):
    _, port, oracle, je, te = tiers
    pairs = mined_pairs(oracle, 60, 5)
    group = [pq for pq in planned(port, [list(p) for p in pairs])
             if len(pq.rows) == 2][:8]
    T, KV = 2, 8
    monkeypatch.setattr(te, "PHRASE_COMPACT_KV", KV)
    rows, w, _, slot_of, ks = te._assemble(group, T, 8)
    L = group_L(te, group)
    PP = max(_bucket(int(port.max_tf[pq.rows[0]]), PP_BUCKETS)
             for pq in group)
    PW = max(_bucket(max(int(port.max_tf[r]) for r in pq.rows), PP_BUCKETS)
             for pq in group)
    probes = te._assemble_bloom_probes(group, T, 8)
    M, Mo = KV, 64
    got = te.mesh_compact_phrase(rows, w, slot_of, ks, probes, T=T, L=L,
                                 PP=PP, PW=PW, M=M, M_out=Mo)
    want = np.asarray(JSH.make_sharded_compact_phrase_kernel(
        T, L, KV, PP, PW, M, JK.n_iters_for(te._max_df), 3.0 * te.rel_eps,
        je.mesh, mode="tc", avg32=je._avg32, M_out=Mo)(
        je.d_postings_doc, je.d_postings_tc, je.d_term_starts,
        je.d_df_shard,
        # a PW tail, as the port's shards carry (test_torch_shard.py's
        # padded_positions: the JAX index has none)
        J(np.pad(np.asarray(je.d_positions), ((0, 0), (0, PW)))),
        je.d_pos_starts, je.d_bloom_rows,
        je.d_bloom_bitmap, je.d_bloom_rank, J(rows.astype(np.int32)), J(w),
        J(slot_of.astype(np.int32)), J(ks), *[J(p) for p in probes]))
    assert_merged_equal(got, want, T)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_dense_and_pruned_steps_tc(tiers, jax_no_fma, pruned, monkeypatch):
    _, port, _, je, te = tiers
    head, _ = head_tail(te, port)
    rng = np.random.default_rng(7)
    T, M, n = 3, 64, 32
    trows = np.stack([rng.choice(head, T, replace=False) for _ in range(n)])
    slots = te._dense_slot[trows].astype(np.int32)
    w = te._weights(trows, np.ones((n, T), dtype=np.float32))
    ks = np.full(n, 10, dtype=np.int32)
    if pruned:
        C, NB = 2, te._npd // 128
        monkeypatch.setattr(te, "PRUNED_DENSE_C", C)
        want = JSH.make_sharded_pruned_dense_kernel_tc(
            T, NB, C, M, 3.0 * te.rel_eps, je.mesh, je._avg32)(
            je.d_dense_tf8, je.d_len_code, je.d_dense_blockmax, J(slots),
            J(w), J(ks))
    else:
        want = JSH.make_sharded_dense_kernel_tc(T, te._npd, M, je.mesh,
                                                je._avg32)(
            je.d_dense_tf8, je.d_len_code, J(slots), J(w))
    got = te.mesh_dense(slots, w, ks, T=T, M=M, pruned=pruned)
    assert_merged_equal(got, np.asarray(want), T)


def test_semidense_step_tc(tiers, jax_no_fma):
    _, port, _, je, te = tiers
    head, tail = head_tail(te, port)
    tail = tail[np.argsort(port.df[tail])]
    rng = np.random.default_rng(13)
    T, n_bs = 3, 1
    rows = np.stack([[tail[rng.integers(0, len(tail) // 3)],
                      tail[rng.integers(len(tail) // 2, len(tail))],
                      rng.choice(head)] for _ in range(8)]).astype(np.int64)
    slots = np.zeros((8, T), dtype=np.int32)
    slots[:, 2] = te._dense_slot[rows[:, 2]]
    w = te._weights(rows, np.ones((8, T), dtype=np.float32))
    L = _bucket(int(te._df_shard_max[rows[:, 0]].max()), L_BUCKETS)
    n_it = JK.n_iters_for(_bucket(int(te._df_shard_max[rows[:, 1]].max()),
                                  L_BUCKETS))
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_semidense(rows, w, slots, T=T, L=L, M=M, n_bs=n_bs,
                            n_bs_iters=n_it, M_out=Mo)
    want = JSH.make_sharded_semidense_kernel_tc(
        T, L, M, te._npd, n_bs, n_it, je.mesh, je._avg32, M_out=Mo)(
        je.d_postings_doc, je.d_postings_tc, je.d_term_starts,
        je.d_df_shard, je.d_dense_tf8, J(rows.astype(np.int32)), J(w),
        J(slots))
    assert_merged_equal(got, np.asarray(want), T)


# -- the engine: test_shard_tc.py's cases ----------------------------------------


def test_single_and_multi_term_parity(tiers):
    jp, port, oracle, je, te = tiers
    rng = np.random.default_rng(4)
    live = [t for t in port.terms if port.df[port.term_to_row[t]] > 0]
    qs = [SearchQuery(list(dict.fromkeys(rng.choice(
        live, size=int(rng.integers(1, 4))).tolist())), n_results=10)
        for _ in range(40)]
    # deep-k single terms: the device path past the impact table
    qs += [SearchQuery([live[0]], n_results=200),
           SearchQuery([live[-1]], n_results=50)]
    three_way(te, je, oracle, qs)


def test_dense_and_semidense_routes_parity(tiers):
    jp, port, oracle, je, te = tiers
    assert te._dense_H > 0
    order = np.argsort(port.df)[::-1]
    head = [port.terms[r] for r in order[: te._dense_H]]
    tail = [port.terms[r] for r in order[te._dense_H:] if port.df[r] > 0]
    rng = np.random.default_rng(9)
    qs = [SearchQuery(list(dict.fromkeys(rng.choice(head, size=int(
        rng.integers(2, 4))).tolist())), n_results=10) for _ in range(40)]
    qs += [SearchQuery(list(dict.fromkeys([str(rng.choice(tail)),
                                           str(rng.choice(head))])),
                       n_results=10) for _ in range(40)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_dense"] > 0 and st["route_semidense"] > 0


def test_phrase_parity(tiers):
    jp, port, oracle, je, te = tiers
    rng = np.random.default_rng(11)
    live = [t for t in port.terms if port.df[port.term_to_row[t]] > 0]
    qs = [SearchQuery(ts, n_results=10, is_phrase=True) for ts in (
        list(dict.fromkeys(rng.choice(live, size=2).tolist()))
        for _ in range(40)) if len(ts) == 2]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 0


def test_compact_phrase_pipeline_parity(tiers):
    """The compact pipeline (bloom gate, KV = 8 compaction, OR-merged
    flags) on tc columns."""
    jp, port, oracle, _, _ = tiers

    class CompactJ(JSH.ShardedEngine):
        PHRASE_COMPACT_KV = 8

    class Compact(ShardedEngine):
        PHRASE_COMPACT_KV = 8

    je = CompactJ(JSH.ShardedIndex.from_packed(jp, 8), columns="tc")
    te = Compact(ShardedIndex.from_packed(port, 8), devices=CPU8,
                 columns="tc")
    rng = np.random.default_rng(31)
    live = [t for t in port.terms if port.df[port.term_to_row[t]] > 0]
    qs = [SearchQuery(ts, n_results=10, is_phrase=True) for ts in (
        list(dict.fromkeys(rng.choice(live, size=2).tolist()))
        for _ in range(30)) if len(ts) == 2]
    got = three_way(te, je, oracle, qs)
    assert sum(map(len, got)) > 0
    assert te.stats_take()["route_phrase_compact"] > 0


def test_raw_and_tc_identical(tiers):
    jp, port, oracle, _, te = tiers
    raw = ShardedEngine(te.sharded, devices=CPU8)
    rng = np.random.default_rng(23)
    live = [t for t in port.terms if port.df[port.term_to_row[t]] > 0]
    qs = [SearchQuery(list(dict.fromkeys(rng.choice(live, size=int(
        rng.integers(1, 4))).tolist())), n_results=10) for _ in range(40)]
    assert lists(raw.search_batch(qs)) == lists(te.search_batch(qs))


def test_mixed_batch_all_routes_tc(tiers):
    """Every tc route in one batch, the pruned scan at C = 2."""
    jp, port, oracle, _, _ = tiers

    class PrunedJ(JSH.ShardedEngine):
        PRUNED_DENSE_MIN_NB = 1
        PRUNED_DENSE_C = 2

    class Pruned(ShardedEngine):
        PRUNED_DENSE_MIN_NB = 1
        PRUNED_DENSE_C = 2

    je = PrunedJ(JSH.ShardedIndex.from_packed(jp, 8), columns="tc")
    te = Pruned(ShardedIndex.from_packed(port, 8), devices=CPU8,
                columns="tc")
    head, tail = head_tail(te, port)
    rng = np.random.default_rng(10)
    qs = []
    for i in range(40):
        kind = i % 5
        if kind == 0:
            qs.append(SearchQuery([port.terms[rng.choice(tail)]],
                                  n_results=10))
        elif kind == 1:
            qs.append(SearchQuery([port.terms[r] for r in rng.choice(
                head, size=2, replace=False)], n_results=10))
        elif kind == 2:
            qs.append(SearchQuery([port.terms[rng.choice(tail)],
                                   port.terms[rng.choice(head)]],
                                  n_results=10))
        elif kind == 3:
            qs.append(SearchQuery([port.terms[r] for r in rng.choice(
                tail, size=2, replace=False)], n_results=10))
        else:
            qs.append(SearchQuery([port.terms[r] for r in rng.choice(
                head, size=2, replace=False)], n_results=10, is_phrase=True))
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    for route in ("route_pruned", "route_semidense", "route_bs",
                  "route_phrase_list"):
        assert st.get(route, 0) > 0, route
