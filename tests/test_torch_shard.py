"""wiser_tpu_torch's mesh (engine/shard.py, engine/shard_steps.py) against
wiser_tpu.engine.shard, raw columns.

JAX runs on the conftest's 8 virtual CPU devices (a real Mesh); the port
runs with devices=["cpu"] * 8. Both get the same index (carried across
with convert.packed_from_arrays) and the same numpy-seeded queries.
Tolerance: exact — equal ShardedIndex arrays and device columns; each
local step with its merge against its make_sharded_* program: equal flag
words, and the merged (doc, tfs) lanes of every row without FLAG_TRUNC
equal up to the order of equal f32 scores (a local top-M on the CPU
keeps lax.top_k's set but may order its ties otherwise; the f64 re-rank
orders them canonically); identical (doc, f64 score) lists from the
port's ShardedEngine, the JAX ShardedEngine and OracleEngine on every
route (bs, dense, pruned, semidense with and without bs others,
phrase_body, compact phrase, host), mirroring tests/test_shard.py and
tests/test_shard_tiers.py. The merge is held to lax.top_k's order on
gathered lanes full of ties (ROADMAP C.3); test_torch_ties.py repeats it
with a tie-adversarial torch.topk. The tc mesh is in
test_torch_shard_tc.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu.engine.shard as JSH
import wiser_tpu_torch.engine.shard as TSH
from wiser_tpu.data.synth import make_docinfo, synth_docinfos, synth_query_terms
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine import shard_steps as S
from wiser_tpu_torch.engine.host import L_BUCKETS, PP_BUCKETS, _bucket, _PlannedQuery
from wiser_tpu_torch.engine.shard import (ShardedEngine, ShardedIndex,
                                          host_exact_search_sharded)
from wiser_tpu_torch.types import SearchQuery

CPU8 = ["cpu"] * 8


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
    return [JQuery(q.terms, n_results=q.n_results, is_phrase=q.is_phrase,
                   return_snippets=q.return_snippets) for q in qs]


def three_way(te, je, oracle, qs):
    te.stats_take()  # the counters of this batch alone
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(jq(qs)))
    assert got == lists(oracle.search(q) for q in jq(qs))
    return got


@pytest.fixture(scope="module")
def tiers():
    """test_shard_tiers.py's corpus at 2,100 docs (head terms past the dense
    threshold, 3 blocks of 128 per shard), with bi-blooms; JAX and port
    sharded indexes at D = 8."""
    docs = synth_docinfos(n_docs=2100, vocab_size=400, mean_len=60,
                          zipf_a=1.15, seed=11, with_blooms=True)
    jp, oracle = build_index(docs, with_blooms=True)
    port = to_port(jp)
    return (jp, port, oracle, JSH.ShardedIndex.from_packed(jp, 8),
            ShardedIndex.from_packed(port, 8))


@pytest.fixture(scope="module")
def engines(tiers):
    jp, port, oracle, jsh, tsh = tiers
    return JSH.ShardedEngine(jsh), ShardedEngine(tsh, devices=CPU8)


@pytest.fixture(scope="module")
def small(tiers, engines):
    """test_shard.py's cases run on the same corpus and engines."""
    jp, port, oracle, _, _ = tiers
    return (jp, port, oracle) + tuple(engines)


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


# -- the sharded index and the device columns -----------------------------------


def test_from_packed_equal_field_by_field(tiers):
    _, _, _, jsh, tsh = tiers
    for f in dataclasses.fields(jsh):
        if f.name == "source":
            continue
        a, b = getattr(jsh, f.name), getattr(tsh, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tsh.bloom_ends is not None and tsh.n_shards == 8


def test_device_columns_equal_the_jax_engine(engines):
    je, te = engines
    assert te._npd == je._npd and te._dense_H == je._dense_H > 0
    np.testing.assert_array_equal(te._dense_slot, je._dense_slot)
    for s, cols in enumerate(te.shards):
        assert cols.doc_base == s * te._npd
        for mine, ref in ((cols.doc, je.d_postings_doc),
                          (cols.score, je.d_postings_score),
                          (cols.tf, je.d_postings_tf),
                          (cols.term_starts, je.d_term_starts),
                          (cols.df, je.d_df_shard),
                          (cols.pos_starts, je.d_pos_starts),
                          (cols.dense_sc, je.d_dense_sc),
                          (cols.dense_tf, je.d_dense_tf),
                          (cols.blockmax, je.d_dense_blockmax),
                          (cols.bloom_bitmap, je.d_bloom_bitmap),
                          (cols.bloom_rank, je.d_bloom_rank)):
            ref = np.asarray(ref)[s]
            got = mine.numpy()
            assert got.tobytes() == ref.astype(got.dtype).tobytes()
        rows = cols.bloom_rows.numpy().view(np.uint32)
        np.testing.assert_array_equal(
            rows, np.asarray(je.d_bloom_rows)[s, : len(rows)])
    assert te.device_bytes()["total"] == sum(te.shard_bytes())


# -- the merge (ROADMAP C.3) ------------------------------------------------------


def jax_merge(docs, score, tfs, flags, Mo):
    """The JAX merge tail (_merge_gathered_flags) on gathered (D, B, ...)
    arrays: shard-major lanes, lax.top_k, OR of the flag words and the
    merge's boundary class."""
    D, B, M = docs.shape
    T = tfs.shape[2]
    gd = jnp.transpose(docs, (1, 0, 2)).reshape(B, D * M)
    gs = jnp.transpose(score, (1, 0, 2)).reshape(B, D * M)
    gt = jnp.transpose(tfs, (1, 2, 0, 3)).reshape(B, T, D * M)
    s2, i2 = jax.lax.top_k(gs, Mo)
    d2 = jnp.take_along_axis(gd, i2, axis=1)
    t2 = jnp.take_along_axis(gt, i2[:, None, :].repeat(T, 1), axis=2)
    fl = flags[0]
    for s in range(1, D):
        fl = fl | flags[s]
    fl = fl | JK.boundary_truncated(gs, s2, Mo).astype(jnp.int32) * JK.FLAG_TRUNC
    return [np.asarray(x) for x in (d2, s2, t2, fl)]


def tied_gather(seed, D=4, B=6, M=8, T=2):
    """Gathered shard outputs full of equal scores across and within
    shards (each shard's lanes sorted desc, as a local top-M is), doc ids
    ascending with the shard."""
    rng = np.random.default_rng(seed)
    score = rng.choice(np.float32([3.0, 2.5, 2.5, 1.0, 1.0, 1.0]),
                       size=(D, B, M))
    score = -np.sort(-score, axis=2)
    score[:, 0, -3:] = -np.inf  # a row with empty lanes
    docs = (np.arange(D)[:, None, None] * 1000
            + np.sort(rng.choice(1000, size=(D, B, M)), axis=2)
            ).astype(np.int32)
    docs = np.where(score > -np.inf, docs, -1).astype(np.int32)
    tfs = rng.integers(1, 9, size=(D, B, T, M)).astype(np.int32)
    flags = (rng.random((D, B)) < 0.2).astype(np.int32) * JK.FLAG_TRUNC
    flags[1, 2] |= JK.FLAG_PRUNE_MISS
    return docs, score.astype(np.float32), tfs, flags


@pytest.mark.parametrize("Mo", [8, 19], ids=["M_out=M", "M_out>M"])
def test_merge_keeps_lax_top_k_order_on_ties(Mo):
    for seed in range(3):
        arrays = tied_gather(seed)
        want = jax_merge(*[jnp.asarray(a) for a in arrays], Mo)
        got = S.merge_shards(*[torch.from_numpy(a) for a in arrays],
                             M_out=Mo)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


# -- each step with its merge against its make_sharded_* program ------------------


def planned(port, terms_list, k=10):
    out = []
    for qi, terms in enumerate(terms_list):
        pq = _PlannedQuery(qi, [port.term_to_row[t] for t in terms],
                           SearchQuery(list(terms), n_results=k))
        pq.plan_slots(port.df)
        out.append(pq)
    return out


def group_L(te, group):
    return max(_bucket(int(te._df_shard_max[pq.slot_rows[0]]), L_BUCKETS)
               for pq in group)


def rows_by_doc(packed, T):
    """Each row's (doc, tfs...) lanes sorted by doc."""
    lanes = packed[:, : T + 1]
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2)


def assert_merged_equal(got, want, T):
    """got (torch) and want (numpy) packed (B, T+2, M_out) merges: equal
    flag words, and rows without FLAG_TRUNC equal lane for lane up to the
    order of equal f32 scores (a local top-M on the CPU keeps lax.top_k's
    set but may order its ties otherwise; the merge and the f64 re-rank
    order them canonically)."""
    got = got.numpy()
    np.testing.assert_array_equal(got[:, T + 1], want[:, T + 1])
    clean = (want[:, T + 1, 0] & JK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(rows_by_doc(got[clean], T),
                                  rows_by_doc(want[clean], T))
    return clean


def assert_packed_equal(got, d2, t2, flags, T):
    flags = np.asarray(flags).astype(np.int32)
    want = np.concatenate([np.asarray(d2)[:, None, :], np.asarray(t2),
                           np.broadcast_to(flags[:, None, None],
                                           (len(flags), 1, d2.shape[1]))],
                          axis=1)
    return assert_merged_equal(got, want, T)


def cooccurring(oracle, port, rows, n, T, seed):
    """n queries of T distinct terms of `rows` that share a document."""
    rng = np.random.default_rng(seed)
    allowed = {port.terms[r] for r in rows}
    out = []
    while len(out) < n:
        body = oracle.doc_bodies[int(rng.integers(len(oracle.doc_bodies)))]
        words = sorted({w for w in body.split(" ") if w in allowed})
        if len(words) >= T:
            out.append([str(w) for w in rng.choice(words, T, replace=False)])
    return out


@pytest.mark.parametrize("T", [1, 2, 3])
def test_bs_step(tiers, engines, T):
    _, port, oracle, _, _ = tiers
    je, te = engines
    _, tail = head_tail(te, port)
    group = planned(port, cooccurring(oracle, port, tail, 8, T, seed=T))
    rows, w, _, _, ks = te._assemble(group, T, 8)
    L = group_L(te, group)
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_bs(rows, w, T=T, L=L, M=M, M_out=Mo)
    d2, _, t2, trunc = JSH.make_sharded_kernel(
        T, L, M, JK.n_iters_for(te._max_df), je.mesh, M_out=Mo)(
        je.d_postings_doc, je.d_postings_score, je.d_postings_tf,
        je.d_term_starts, je.d_df_shard, jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(w))
    assert_packed_equal(got, d2, t2, trunc, T)
    assert (got.numpy()[:, 0, :] >= 0).sum() > 8


def phrase_group(port, oracle, n, seed):
    pairs = mined_pairs(oracle, n, seed)
    return planned(port, [list(p) for p in pairs])


def test_phrase_step(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
    group = [pq for pq in phrase_group(port, oracle, 40, seed=2)
             if len(pq.rows) == 2][:8]
    T = 2
    rows, w, _, slot_of, ks = te._assemble(group, T, 8)
    L = group_L(te, group)
    PP = max(_bucket(int(port.max_tf[pq.rows[0]]), PP_BUCKETS)
             for pq in group)
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_phrase(rows, w, slot_of, T=T, L=L, PP=PP, M=M, M_out=Mo)
    want = np.asarray(JSH.make_sharded_phrase_kernel(
        T, L, PP, M, JK.n_iters_for(te._max_df), JK.n_iters_for(te._max_tf),
        je.mesh, M_out=Mo)(
        je.d_postings_doc, je.d_postings_score, je.d_postings_tf,
        je.d_term_starts, je.d_df_shard, je.d_positions, je.d_pos_starts,
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(w),
        jnp.asarray(slot_of.astype(np.int32))))
    assert_merged_equal(got, want, T)
    assert (want[:, 0, :] >= 0).sum() > 0


def padded_positions(je, PW):
    """The JAX engine's position bags with a PW tail, as the port's shards
    carry them: without it the longest shard's last bags are verified
    from clamped windows (test_compact_window_at_the_longest_shards_end),
    and the step comparison would test that fault, not the step."""
    return jnp.asarray(np.pad(np.asarray(je.d_positions), ((0, 0), (0, PW))))


def test_compact_phrase_step_with_blooms(tiers, engines, monkeypatch):
    _, port, oracle, _, _ = tiers
    je, te = engines
    group = [pq for pq in phrase_group(port, oracle, 60, seed=5)
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
    assert probes[3].any(), "some probe must be active"
    M, eps3 = KV, 3.0 * te.rel_eps
    Mo = min(64, M * 8)
    got = te.mesh_compact_phrase(rows, w, slot_of, ks, probes, T=T, L=L,
                                 PP=PP, PW=PW, M=M, M_out=Mo)
    want = np.asarray(JSH.make_sharded_compact_phrase_kernel(
        T, L, KV, PP, PW, M, JK.n_iters_for(te._max_df), eps3, je.mesh,
        mode="raw", M_out=Mo)(
        je.d_postings_doc, je.d_postings_score, je.d_postings_tf,
        je.d_term_starts, je.d_df_shard, padded_positions(je, PW),
        je.d_pos_starts, je.d_bloom_rows, je.d_bloom_bitmap, je.d_bloom_rank,
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(w),
        jnp.asarray(slot_of.astype(np.int32)), jnp.asarray(ks),
        *[jnp.asarray(p) for p in probes]))
    assert_merged_equal(got, want, T)
    assert (want[:, 0, :] >= 0).sum() > 0


def dense_inputs(te, port, T, seed, n=8):
    head, _ = head_tail(te, port)
    rng = np.random.default_rng(seed)
    trows = np.stack([rng.choice(head, T, replace=False) for _ in range(n)])
    slots = te._dense_slot[trows].astype(np.int32)
    w = np.ones((n, T), dtype=np.float32)
    ks = np.full(n, 10, dtype=np.int32)
    return slots, w, ks


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_dense_and_pruned_steps(tiers, engines, pruned, monkeypatch):
    _, port, _, _, _ = tiers
    je, te = engines
    T, M = 2, 64
    slots, w, ks = dense_inputs(te, port, T, seed=7)
    if pruned:
        C = 2
        NB = te._npd // 128
        assert NB >= C + 1
        monkeypatch.setattr(te, "PRUNED_DENSE_C", C)
        eps3 = 3.0 * te.rel_eps
        want = JSH.make_sharded_pruned_dense_kernel(T, NB, C, M, eps3,
                                                    je.mesh)(
            je.d_dense_sc, je.d_dense_tf, je.d_dense_blockmax,
            jnp.asarray(slots), jnp.asarray(w), jnp.asarray(ks))
    else:
        want = JSH.make_sharded_dense_kernel(T, te._npd, M, je.mesh)(
            je.d_dense_sc, je.d_dense_tf, jnp.asarray(slots), jnp.asarray(w))
    got = te.mesh_dense(slots, w, ks, T=T, M=M, pruned=pruned)
    assert_merged_equal(got, np.asarray(want), T)
    if pruned:
        assert (np.asarray(want)[:, T + 1, 0] & JK.FLAG_PRUNE_MISS).any()


@pytest.mark.parametrize("n_bs", [0, 1])
def test_semidense_step(tiers, engines, n_bs):
    _, port, _, _, _ = tiers
    je, te = engines
    head, tail = head_tail(te, port)
    tail = tail[np.argsort(port.df[tail])]
    rng = np.random.default_rng(11 + n_bs)
    T = 2 + n_bs
    rows = np.zeros((8, T), dtype=np.int64)
    for i in range(8):
        picks = [tail[rng.integers(0, len(tail) // 3)]]
        picks += [tail[rng.integers(len(tail) // 2, len(tail))]] * n_bs
        rows[i] = picks + [rng.choice(head)]
    slots = np.zeros((8, T), dtype=np.int32)
    slots[:, 1 + n_bs:] = te._dense_slot[rows[:, 1 + n_bs:]]
    w = np.ones((8, T), dtype=np.float32)
    L = _bucket(int(te._df_shard_max[rows[:, 0]].max()), L_BUCKETS)
    n_it = (JK.n_iters_for(_bucket(int(te._df_shard_max[rows[:, 1]].max()),
                                   L_BUCKETS)) if n_bs else 0)
    M = min(L, 64)
    Mo = min(64, M * 8)
    got = te.mesh_semidense(rows, w, slots, T=T, L=L, M=M, n_bs=n_bs,
                            n_bs_iters=n_it, M_out=Mo)
    want = JSH.make_sharded_semidense_kernel(
        T, L, M, te._npd, n_bs, n_it, je.mesh, M_out=Mo)(
        je.d_postings_doc, je.d_postings_score, je.d_postings_tf,
        je.d_term_starts, je.d_df_shard, je.d_dense_sc, je.d_dense_tf,
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(w),
        jnp.asarray(slots))
    assert_merged_equal(got, np.asarray(want), T)
    assert (np.asarray(want)[:, 0, :] >= 0).sum() > 0


# -- the engine: test_shard.py's cases ---------------------------------------------


def test_single_term(small):
    jp, port, oracle, je, te = small
    qs = [SearchQuery([t], n_results=10) for t in ["t0", "t1", "t5", "t42"]
          if t in port.term_to_row]
    qs.append(SearchQuery(["t0"], n_results=200))  # past the impact table
    three_way(te, je, oracle, qs)


def test_and_queries(small):
    jp, port, oracle, je, te = small
    qs = [SearchQuery(t, n_results=10)
          for t in synth_query_terms(10, 100, n_terms=2, seed=2)]
    qs += [SearchQuery(t, n_results=10)
           for t in synth_query_terms(6, 100, n_terms=3, seed=9)]
    three_way(te, je, oracle, qs)


def test_phrase_queries(small):
    jp, port, oracle, je, te = small
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(12, 30, n_terms=2, seed=17)]
    pairs = mined_pairs(oracle, 5, 2)
    qs += [SearchQuery(list(p), n_results=10, is_phrase=True) for p in pairs]
    got = three_way(te, je, oracle, qs)
    assert all(got[-len(pairs):]), "the mined phrases must match"


def test_matches_single_device_engine(small):
    jp, port, oracle, je, te = small
    single = TorchEngine(port, device="cpu")
    qs = [SearchQuery(t, n_results=10)
          for t in synth_query_terms(10, 100, n_terms=3, seed=9)]
    assert lists(te.search_batch(qs)) == lists(single.search_batch(qs))


def test_host_exact_sharded_matches(small):
    jp, port, oracle, je, te = small
    rows = [port.term_to_row["t0"], port.term_to_row["t1"]]
    for phrase in (False, True):
        d, s = host_exact_search_sharded(te.sharded, te.cache64, rows, 10,
                                         is_phrase=phrase)
        jd, js = JSH.host_exact_search_sharded(je.sharded, je.cache64, rows,
                                               10, is_phrase=phrase)
        o = oracle.search(JQuery(["t0", "t1"], n_results=10,
                                 is_phrase=phrase))
        assert list(d) == list(jd) == [e.doc_id for e in o.entries]
        np.testing.assert_array_equal(s, js)


def test_tie_fuzz_guard(monkeypatch):
    """A giant exact tie class: exact through the device path, and with
    every row forced suspect through the host path (test_shard.py)."""
    import wiser_tpu_torch.engine.device as TD

    docs = [make_docinfo("w w q".split()) for _ in range(200)]
    docs += [make_docinfo(["q", f"u{i}"]) for i in range(24)]
    jp, oracle = build_index(docs)
    port = to_port(jp)
    je = JSH.ShardedEngine(JSH.ShardedIndex.from_packed(jp, 8))
    te = ShardedEngine(ShardedIndex.from_packed(port, 8), devices=CPU8)
    q = [SearchQuery(["w", "q"], n_results=10)]
    three_way(te, je, oracle, q)
    calls = []
    orig = te._host_exact

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(te, "_host_exact", spy)
    monkeypatch.setattr(TD, "truncation_suspects",
                        lambda s, n, k, **kw: np.ones(len(s), dtype=bool))
    assert lists(te.search_batch(q)) == lists(oracle.search(x)
                                              for x in jq(q))
    assert calls, "a forced suspect must take the host path"


def test_saturation_routes_to_host(monkeypatch):
    docs = synth_docinfos(n_docs=600, vocab_size=60, mean_len=30, seed=5)
    jp, oracle = build_index(docs)
    port = to_port(jp)
    monkeypatch.setattr(JSH, "L_BUCKETS", [16])
    monkeypatch.setattr(TSH, "L_BUCKETS", [16])
    je = JSH.ShardedEngine(JSH.ShardedIndex.from_packed(jp, 8))
    te = ShardedEngine(ShardedIndex.from_packed(port, 8), devices=CPU8)
    head = port.terms[int(np.argmax(port.df))]
    qs = [SearchQuery([head, "t1"], n_results=10),
          SearchQuery([head, "t1"], n_results=10, is_phrase=True)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_host_merge"] == 1 and st["route_phrase_host"] == 1


def test_snippets(small):
    jp, port, oracle, je, _ = small
    te = ShardedEngine(ShardedIndex.from_packed(port, 8), devices=CPU8,
                       doc_bodies=oracle.doc_bodies)
    qs = [SearchQuery(["t0", "t1"], n_results=3, return_snippets=True),
          SearchQuery(["t0"], n_results=3, return_snippets=True),
          SearchQuery(["t0", "t1"], n_results=3)]
    got = te.search_batch(qs)
    for q, r in zip(qs, got):
        o = oracle.search(jq([q])[0])
        assert [(e.doc_id, e.doc_score, e.snippet) for e in r.entries] == \
            [(e.doc_id, e.doc_score, e.snippet) for e in o.entries]
    assert any(e.snippet for e in got[0].entries)
    assert not any(e.snippet for e in got[2].entries)


def test_submit_batch_pipelining(small):
    jp, port, oracle, je, te = small
    qs = [SearchQuery(t, n_results=10)
          for t in synth_query_terms(20, 100, n_terms=2, seed=17)]
    qs += [SearchQuery(["t0", "t1"], n_results=5, is_phrase=True)]
    results, pending = te.submit_batch(qs)
    te.run_pending(results, pending)
    assert lists(results) == lists(oracle.search(q) for q in jq(qs))


# -- the engine: test_shard_tiers.py's cases --------------------------------------


def test_dense_tier_built(engines):
    _, te = engines
    assert te._dense_H > 0 and te._st_depth


def test_dense_route(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
    head, _ = head_tail(te, port)
    rng = np.random.default_rng(5)
    qs = [SearchQuery([port.terms[r] for r in rng.choice(
        head, size=rng.integers(2, 4), replace=False)], n_results=10)
        for _ in range(40)]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["route_dense"] == len({tuple(q.terms) for q in qs})


def test_semidense_route(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
    head, tail = head_tail(te, port)
    rng = np.random.default_rng(6)
    qs = [SearchQuery([port.terms[rng.choice(tail)]]
                      + [port.terms[r] for r in rng.choice(
                          head, size=rng.integers(1, 3), replace=False)],
                      n_results=10) for _ in range(40)]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["route_semidense"] > 30


def test_semidense_with_bs_others(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
    head, tail = head_tail(te, port)
    order = tail[np.argsort(port.df[tail])]
    rng = np.random.default_rng(7)
    qs = [SearchQuery([port.terms[order[rng.integers(0, len(order) // 3)]],
                       port.terms[order[rng.integers(len(order) // 2,
                                                     len(order))]],
                       port.terms[rng.choice(head)]], n_results=10)
          for _ in range(30)]
    three_way(te, je, oracle, qs)


def test_single_term_table(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
    rng = np.random.default_rng(8)
    qs = [SearchQuery([port.terms[r]], n_results=10)
          for r in rng.integers(0, port.n_terms, size=30)]
    three_way(te, je, oracle, qs)
    assert te.stats_take()["route_single_table"] > 0


def test_coalescing_fanout(tiers, engines):
    _, port, _, _, _ = tiers
    _, te = engines
    head, _ = head_tail(te, port)
    q = SearchQuery([port.terms[r] for r in head[:2]], n_results=10)
    got = te.search_batch([q, SearchQuery(list(q.terms), n_results=10), q])
    assert lists(got)[0] == lists(got)[1] == lists(got)[2]
    assert lists(got)[0]
    assert te.stats_take()["q_coalesced"] == 2


def test_pruned_dense_guard(tiers):
    """The pruned mesh scan at C = 2 of each shard's 3 blocks: the guard
    after the merge sends every unprovable query to the host."""
    jp, port, oracle, jsh, tsh = tiers

    class SmallPrunedJ(JSH.ShardedEngine):
        PRUNED_DENSE_MIN_NB = 1
        PRUNED_DENSE_C = 2

    class SmallPruned(ShardedEngine):
        PRUNED_DENSE_MIN_NB = 1
        PRUNED_DENSE_C = 2

    je, te = SmallPrunedJ(jsh), SmallPruned(tsh, devices=CPU8)
    head, _ = head_tail(te, port)
    rng = np.random.default_rng(9)
    qs = [SearchQuery([port.terms[r] for r in rng.choice(head, size=2,
                                                        replace=False)],
                      n_results=10) for _ in range(30)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_pruned"] >= 25 and st["flag_prune_miss"] > 0


class _CompactJ(JSH.ShardedEngine):
    PHRASE_COMPACT_KV = 8


class _Compact(ShardedEngine):
    PHRASE_COMPACT_KV = 8


def test_compact_phrase_route(tiers):
    """test_shard_tc.py's compact pipeline case on raw columns: the bloom
    gate, KV = 8 compaction and the OR-merged flags. The port equals the
    oracle on every query and the JAX engine on every query but the one
    its window fault misses (next test)."""
    jp, port, oracle, jsh, tsh = tiers
    je, te = _CompactJ(jsh), _Compact(tsh, devices=CPU8)
    rng = np.random.default_rng(31)
    live = [t for t in port.terms if port.df[port.term_to_row[t]] > 0]
    qs = [SearchQuery(list(dict.fromkeys(rng.choice(live, 2).tolist())),
                      n_results=10, is_phrase=True) for _ in range(12)]
    qs = [q for q in qs if len(q.terms) == 2]
    qs += [SearchQuery(list(p), n_results=10, is_phrase=True)
           for p in mined_pairs(oracle, 10, 4)]
    got = lists(te.search_batch(qs))
    assert got == lists(oracle.search(q) for q in jq(qs))
    assert sum(map(len, got)) > 0
    assert te.stats_take()["route_phrase_compact"] > 0
    jax = lists(je.search_batch(jq(qs)))
    differ = [q.terms for q, a, b in zip(qs, got, jax) if a != b]
    assert differ in ([], [["t98", "t399"]])


def test_compact_window_at_the_longest_shards_end(tiers):
    """A fault of the reference (which stays as it is): the JAX
    ShardedIndex pads every shard's positions only to the longest shard's
    length, with no tail for the verify window, so a bag that starts
    within PW positions of that shard's end is verified from a window
    clamped back to n - PW. Here doc 1851's "t98" bag starts 28 positions
    before the end of shard 4 (the longest): the JAX compact route misses
    the phrase. The port pads every shard past the widest window and
    equals the oracle."""
    jp, port, oracle, jsh, tsh = tiers
    je, te = _CompactJ(jsh), _Compact(tsh, devices=CPU8)
    s = 1851 // te._npd
    assert tsh.pos_starts[s, -1] == tsh.positions.shape[1]  # the longest
    q = SearchQuery(["t98", "t399"], n_results=10, is_phrase=True)
    want = lists([oracle.search(jq([q])[0])])[0]
    assert 1851 in [d for d, _ in want]
    assert lists(te.search_batch([q]))[0] == want
    jax = lists(je.search_batch(jq([q])))[0]
    assert 1851 not in [d for d, _ in jax] and jax != want


def test_mixed_batch_all_routes(tiers, engines):
    jp, port, oracle, _, _ = tiers
    je, te = engines
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
    for route in ("route_dense", "route_semidense", "route_bs",
                  "route_phrase_list"):
        assert st.get(route, 0) > 0, route


def test_more_than_eight_terms(tiers, engines):
    """Queries of 9-10 terms keep their exact slot count (the JAX engine's
    T bucket of 8 drops terms; the oracle is the reference here)."""
    _, port, oracle, _, _ = tiers
    _, te = engines
    head, tail = head_tail(te, port)
    rng = np.random.default_rng(12)
    qs = [SearchQuery([port.terms[r] for r in rng.choice(head, 9,
                                                        replace=False)],
                      n_results=10),
          SearchQuery([port.terms[r] for r in rng.choice(tail, 1)]
                      + [port.terms[r] for r in rng.choice(head, 9,
                                                         replace=False)],
                      n_results=10)]
    assert lists(te.search_batch(qs)) == lists(oracle.search(q)
                                               for q in jq(qs))


def test_engine_defaults_to_the_card(small):
    _, port, _, _, _ = small
    sh = ShardedIndex.from_packed(port, 2)
    with pytest.raises(RuntimeError):
        ShardedEngine(sh)
    with pytest.raises(ValueError):
        ShardedEngine(sh, devices=["cpu"])
    sh.source = None
    with pytest.raises(ValueError):
        ShardedEngine(sh, devices=["cpu"] * 2)
