"""The list chain redesigned for Hopper (csrc/phrase_route.cu list_kernel:
a query's lanes in segments of one cluster, rounds of 256 lanes a CTA, a
thread a lane through the match and the gate, a thread a (lane, base)
through the verification, the verified lanes pushed into the cluster's
first CTA), checked on the CPU through its plan, its plain version and a
numpy model of what the kernel does:

- the model (each slot's posting index by the plain version's
  fixed-count search, the score s0 + (b1 + ...) from the tc table, the
  bloom gate, the bags in query-term order, the PP bases, each round's
  verified lanes pushed in an order no thread fixes, the first CTA's top
  M by (score desc, lane asc)) equals the plain version (engine/kernels.
  list_phrase_torch) bit for bit at every segment count from 1 to 8, raw
  and tc, gate on and off, on every tools/phrase_bench.LIST_CASES case:
  T 2-4, L 128-1,024, quantized scores tied across segment edges, fewer
  verified lanes than M, PP above every bag, hundreds of verified lanes
  (the radix cut past 256 keys). test_torch_phrase_route_kernels holds
  the plain version against the JAX chain (make_match_kernel{,_tc} with
  _bloom_gate, make_phrase_verify_kernel, make_select_topk_kernel{,_tc})
  on every case with the gate on; here the model meets the JAX chain
  directly on a case of each mode, gate on and off;
- ops/phrase_route.list_plan at the engine's shapes.

The kernel runs only on a card: the `cuda`-marked test holds it against
the plain version and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.ops import dense as D
from wiser_tpu_torch.ops import phrase_route as R
from wiser_tpu_torch.tools import phrase_bench as PB

CPU = torch.device("cpu")
NO_FMA = {"xla_backend_optimization_level": 0}
ROUND = 32  # a segment's lanes come in whole warps (R.LIST_ROUND)
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the searches ----------------------------------------------------------------


def _wrap32(x):
    """int64 -> the int32 value of its low 32 bits."""
    x = np.asarray(x, dtype=np.int64) & 0xFFFFFFFF
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def _fixed(col, target, lo, hi, iters):
    """bound.cuh search_fixed (engine/kernels._binary_search) over arrays:
    iters halvings of [lo, hi), int32 midpoints, reads clamped into col."""
    lo = np.asarray(lo, dtype=np.int64).copy()
    hi = np.asarray(hi, dtype=np.int64).copy()
    n = len(col)
    for _ in range(iters):
        mid = _wrap32(lo + hi) >> 1
        less = col[np.clip(mid, 0, n - 1)] < target
        lo = np.where(less, mid + 1, lo)
        hi = np.where(less, hi, mid)
    return lo


# -- the model of the kernel -------------------------------------------------


def _model_lanes(cols, batch, kw, mode, gate):
    """Each (query, lane)'s verdict as the kernel's threads reach it:
    (valid, verified, score f32, posting indices (B, T, L) slot order,
    saturation, candidate docs)."""
    T, L, PP = kw["T"], kw["L"], kw["PP"]
    doc = cols["doc"].astype(np.int64)
    n_doc = len(doc)
    tc = mode == "tc"
    st = batch["starts"].astype(np.int64)
    en = batch["ends"].astype(np.int64)
    w = (batch["idf"] if tc else batch["use"]).astype(F32)
    B = st.shape[0]
    lane = np.arange(L)[None, :]
    cs = st[:, :1]
    n_valid = np.clip(en[:, :1] - cs, 0, L)
    valid = lane < n_valid
    s_doc = np.clip(cs, 0, max(0, n_doc - L))
    n_col = len(cols["tc"] if tc else cols["score"])
    s_col = np.clip(cs, 0, max(0, n_col - L))
    d = doc[np.clip(s_doc + lane, 0, n_doc - 1)]
    if tc:
        table = D.tc_table_torch(torch.tensor(cols["avg32"])).numpy()
        lanes = cols["tc"].astype(np.int64)

        def pay(i, t):
            x = lanes[np.clip(i, 0, n_col - 1)]
            return F32(w[:, t:t + 1]) * table[x & 0xFF, (x >> 8) & 0xFF], \
                (x & 0xFF) >= 255
    else:
        sc = cols["score"].astype(F32)

        def pay(i, t):
            return sc[np.clip(i, 0, n_col - 1)] * w[:, t:t + 1], False

    s0, sat = pay(s_col + lane, 0)
    sat = np.broadcast_to(sat, (B, L)).copy()
    pidx = np.zeros((B, T, L), dtype=np.int64)
    pidx[:, 0] = _wrap32(cs + lane)
    alive = valid.copy()
    acc = np.zeros((B, L), dtype=F32)
    for t in range(1, T):
        lo = np.broadcast_to(st[:, t:t + 1], d.shape)
        hi = np.broadcast_to(en[:, t:t + 1], d.shape)
        r = _fixed(doc, d, lo, hi, kw["n_bs_iters"])
        found = (r < hi) & (doc[np.clip(r, 0, n_doc - 1)] == d)
        pidx[:, t] = r
        alive &= found
        p, s = pay(r, t)
        acc = np.where(alive, p if t == 1 else acc + p, acc)
        sat |= alive & s
    if gate:
        bitmap = cols["bloom_bitmap"].astype(np.uint32)
        rank = cols["bloom_rank"].astype(np.int64)
        rows = cols["bloom_rows"].astype(np.uint32)
        Pw = len(bitmap) // 2
        for c in range(batch["probe_slot"].shape[1]):
            on = batch["probe_active"][:, c:c + 1]
            slot = np.clip(batch["probe_slot"][:, c], 0, T - 1)
            pq = np.take_along_axis(pidx, slot[:, None, None], 1)[:, 0]
            sp = _wrap32(pq) + np.where(batch["probe_begins"][:, c:c + 1],
                                        Pw * 32, 0)
            wi = np.clip(sp >> 5, 0, len(bitmap) - 1)
            word = bitmap[wi]
            bit = (sp & 31).astype(np.uint32)
            present = (word >> bit) & 1
            below = word & ((np.uint32(1) << bit) - np.uint32(1))
            pop = np.unpackbits(below.view(np.uint8).reshape(*below.shape, 4),
                                axis=-1).sum(axis=-1).astype(np.int64)
            row = rows[np.clip(rank[wi] + pop, 0, len(rows) - 1)]
            mask = batch["probe_mask"][:, c:c + 1].astype(np.uint32)
            ok = (present == 1) & ((row & mask) == mask)
            alive &= ~on | ok
    # the bags in query-term order, then each base's test
    ps_col = cols["pos_starts"].astype(np.int64)
    n_ps = len(ps_col)
    pos = cols["positions"].astype(np.int64)
    n_pos = len(pos)
    ps = np.zeros((B, T, L), dtype=np.int64)
    pe = np.zeros((B, T, L), dtype=np.int64)
    for t in range(T):
        slot = np.clip(batch["slot_of"][:, t], 0, T - 1)
        pq = np.take_along_axis(pidx, slot[:, None, None], 1)[:, 0]
        pq = _wrap32(pq)
        ps[:, t] = ps_col[np.clip(pq, 0, n_ps - 1)]
        pe[:, t] = ps_col[np.clip(pq + 1, 0, n_ps - 1)]
    count = np.zeros((B, L), dtype=np.int64)
    for p in range(PP):
        bi = _wrap32(ps[:, 0] + p)
        ok = bi < pe[:, 0]
        base = pos[np.clip(bi, 0, n_pos - 1)]
        for t in range(1, T):
            tgt = base + t
            lo = _fixed(pos, tgt, ps[:, t], pe[:, t], kw["n_pos_iters"])
            ok &= (lo < pe[:, t]) & (pos[np.clip(lo, 0, n_pos - 1)] == tgt)
        count += ok
    score = (s0 + acc).astype(F32)
    return valid, alive & (count > 0), score, pidx, sat, d


def _segments(L, nseg):
    """The kernel's segments forced to nseg (phrase_bench.
    forced_list_segments, ops/phrase_route.segment_plan): lanes a segment,
    whole warps of 32."""
    rounds = -(-L // ROUND)
    seg_lanes = -(-rounds // min(nseg, rounds)) * ROUND
    return -(-L // seg_lanes), seg_lanes


def _model_out(lanes, cols, kw, mode, nseg, rng):
    """The packed (B, T+2, M) output of the kernel's model at nseg
    segments: each segment's rounds of 256 lanes push their verified lanes
    (key, posting indices, saturation) in an order no thread fixes; the
    first CTA sorts the c keys and writes the top M. Also returns the
    verified counts."""
    valid, ver, score, pidx, sat, d = lanes
    T, L, M = kw["T"], kw["L"], kw["M"]
    B = valid.shape[0]
    tc = mode == "tc"
    col = (cols["tc"].astype(np.int64) & 0xFF) if tc else \
        cols["tf"].astype(np.int64)
    out = np.zeros((B, T + 2, M), dtype=np.int32)
    n_seg, seg_lanes = _segments(L, nseg)
    counts = []
    for b in range(B):
        pushed = []
        for seg in range(n_seg):
            # a CTA's groups take lanes seg * seg_lanes + g, + 32, ...
            hi = min(int(valid[b].sum()), (seg + 1) * seg_lanes)
            for r0 in range(seg * seg_lanes, hi, 256):
                pushed += list(rng.permutation(
                    [l for l in range(r0, min(hi, r0 + 256)) if ver[b, l]]))
        assert sorted(pushed) == list(np.nonzero(ver[b])[0])  # once each
        pushed = list(rng.permutation(pushed))
        keys = sorted(pushed, key=lambda l: (-float(score[b, l]), l))
        c = len(keys)
        counts.append(c)
        top = keys[:M]
        out[b, 0] = -1
        out[b, 0, :len(top)] = d[b, top]
        for t in range(T):
            out[b, t + 1, :len(top)] = col[np.clip(_wrap32(pidx[b, t, top]),
                                                   0, len(col) - 1)]
        f = 0
        if c > M and score[b, keys[M]] == score[b, keys[M - 1]]:
            f |= TK.FLAG_TRUNC
        if tc and sat[b, top].any():
            f |= TK.FLAG_TF_SAT
        out[b, T + 1] = f
    return out, counts


_CACHE = {}


def _case(case, mode, gate):
    """(cols, batch, kw, plain output, model lanes) of a LIST_CASES case,
    cached for the module; gate False: the plain version with every probe
    inactive."""
    key = (case[0], mode, gate)
    if key not in _CACHE:
        (_, seed, n_docs, dfs, B, T, L, PP, M, tie, off, sb) = case
        cols = PB.synth_columns(seed, n_docs, dfs, tie=tie, sorted_bags=sb)
        batch = PB.phrase_batch(cols, B, T, M, seed + 100, probes_off=off)
        args, kw = PB.list_case(case, mode, CPU)
        if not gate:
            args = list(args)
            args[14] = args[14] & False
        plain = TK.list_phrase(*args, **kw).numpy()
        _CACHE[key] = (cols, batch, kw, plain,
                       _model_lanes(cols, batch, kw, mode, gate))
    return _CACHE[key]


RUNS = [(c, m, g) for c in PB.LIST_CASES for m in ("raw", "tc")
        for g in (True, False)]


@pytest.mark.parametrize("case,mode,gate", RUNS, ids=[
    f"{c[0]}-{m}-{'gate' if g else 'nogate'}" for c, m, g in RUNS])
def test_segmented_model_equals_the_plain_version(case, mode, gate):
    cols, batch, kw, plain, lanes = _case(case, mode, gate)
    rng = np.random.default_rng(len(case[0]))
    for nseg in range(1, 9):
        got, counts = _model_out(lanes, cols, kw, mode, nseg, rng)
        np.testing.assert_array_equal(got, plain, err_msg=f"nseg={nseg}")
    assert (plain[:, 0] >= 0).any()


def test_the_cases_reach_the_kernel_s_edges():
    """Some case cuts its verified keys by the radix select (c > 256 and
    > M + 1), some query verifies fewer lanes than M, a FLAG_TRUNC tie
    straddles the M-th place, the gate prunes verified lanes."""
    seen = {"radix": False, "few": False, "trunc": False, "pruned": False}
    for case in PB.LIST_CASES:
        cols, batch, kw, plain, lanes = _case(case, "raw", True)
        _, counts = _model_out(lanes, cols, kw, "raw", 8,
                               np.random.default_rng(0))
        seen["radix"] |= any(c > 256 and c > kw["M"] + 1 for c in counts)
        seen["few"] |= any(0 < c < kw["M"] for c in counts)
        seen["trunc"] |= bool((plain[:, kw["T"] + 1, 0]
                               & TK.FLAG_TRUNC).any())
        off = _case(case, "raw", False)[4][1]
        seen["pruned"] |= bool((off & ~lanes[1]).any())
    assert all(seen.values()), seen


def _jax_chain(cols, batch, kw, mode, gate):
    """The JAX list chain as wiser_tpu's dispatch runs it (every probe
    inactive without the gate), as numpy."""
    def jref(fn, *a):
        a = [jnp.asarray(x) for x in a]
        return jax.jit(fn).lower(*a).compile(NO_FMA)(*a)

    T, L, PP, M = kw["T"], kw["L"], kw["PP"], kw["M"]
    active_probes = batch["probe_active"] & gate
    blooms = (cols["bloom_rows"], cols["bloom_bitmap"], cols["bloom_rank"],
              batch["probe_slot"], batch["probe_begins"], batch["probe_mask"],
              active_probes)
    if mode == "raw":
        out = jref(JK.make_match_kernel(T, L, kw["n_bs_iters"]), cols["doc"],
                   cols["score"], batch["starts"], batch["ends"],
                   batch["use"], *blooms)
        match, bpass, cdocs, pidx, score = (np.asarray(o) for o in out)
    else:
        out = jref(JK.make_match_kernel_tc(T, L, kw["n_bs_iters"]),
                   cols["doc"], cols["tc"], cols["avg32"][0],
                   batch["starts"], batch["ends"], batch["idf"], *blooms)
        match, bpass, cdocs, pidx, score, sat = (np.asarray(o) for o in out)
    active = match & bpass
    pidx_q = np.take_along_axis(pidx, batch["slot_of"][:, :, None].repeat(
        L, 2), 1)
    n = np.asarray(jref(JK.make_phrase_verify_kernel(T, L, PP,
                                                     kw["n_pos_iters"]),
                        cols["positions"], cols["pos_starts"], pidx_q,
                        active))
    final = active & (n > 0)
    if mode == "raw":
        return np.asarray(jref(JK.make_select_topk_kernel(T, L, M),
                               cols["tf"], cdocs, pidx, score, final))
    return np.asarray(jref(JK.make_select_topk_kernel_tc(T, L, M),
                           cols["tc"], cdocs, pidx, score, final, sat))


@pytest.mark.parametrize("name,mode,gate", [
    ("t3", "raw", False), ("ties_t2", "tc", False), ("short_l", "tc", True)])
def test_model_equals_the_jax_chain(name, mode, gate):
    case = next(c for c in PB.LIST_CASES if c[0] == name)
    cols, batch, kw, plain, lanes = _case(case, mode, gate)
    got, _ = _model_out(lanes, cols, kw, mode, 8, np.random.default_rng(1))
    np.testing.assert_array_equal(got, _jax_chain(cols, batch, kw, mode,
                                                  gate))


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("B", [8, 32, 128])
def test_list_plan_at_engine_shapes(B):
    """Every engine group (B 8/32/128, T 2-4, L 128-1,024) on the H100's
    132 SMs: at most a cluster's 8 segments of whole warps of lanes that
    cover L with none empty, one 256-lane round each where the card holds
    them (B 8 and 32), shared memory within the card's 227 KB (the
    layout's: counters, rows, a round's active lanes, keys, posting
    indices, saturation, a flush's scratch)."""
    for T in (2, 3, 4):
        for L in (128, 256, 512, 1000, 1024):
            p = R.list_plan(B, T, L, 132)
            assert 1 <= p.nseg <= 8
            assert p.seg_lanes % R.LIST_ROUND == 0
            assert p.seg_lanes * p.nseg >= L > p.seg_lanes * (p.nseg - 1)
            P2 = 1 << (L - 1).bit_length()
            assert p.smem == (16 + R.LIST_QUERY_BYTES
                              + 4 * 256 * (4 + 3 * T) + 8 * P2
                              + (4 * T * L + 15) // 16 * 16
                              + (L + 15) // 16 * 16 + D.FLUSH_BYTES)
            assert p.smem <= 227 * 1024 == R.MAX_SMEM
            if B <= 32:
                assert p.seg_lanes == min(256, -(-L // 32) * 32)
    # a group that fills the card alone keeps a query in one CTA; B 128
    # takes two CTAs a query
    assert R.list_plan(1024, 2, 1024, 132).nseg == 1
    assert R.list_plan(128, 2, 1024, 132).nseg == 2


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_list_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    out = PB.list_phrase_cases(dev)  # gate on and off, every case
    assert out["cases"] == 4 * len(PB.LIST_CASES)
    for n in (1, 2, 8):
        with PB.forced_list_segments(n):
            assert PB.list_phrase_cases(dev, modes=("tc",))["cases"] > 0
