"""The segmented semidense kernels (csrc/segsel.cuh: the semidense step,
csrc/semidense.cu, and the semidense phrase route's selection,
csrc/phrase_route.cu) and the phrase recovery's warp search, checked on
the CPU through their plans and numpy models of what the kernels do:

- ops/semidense.segments at every engine shape spreads a query over as
  many CTAs as keep the group within two CTAs an SM (at most a cluster's
  8, none shorter than 512 lanes), fits the card's shared memory and
  covers L;
- the recovery (bound.cuh `recover`: its 32-ary warp
  lower bound, else lane t's replay of the fixed-count search) equals
  the fixed-count search of engine/kernels._binary_search everywhere,
  and takes the warp search wherever that search has converged in the
  run;
- segments' top K keys merged as merge_ranks merges them (keys.cuh)
  equal the stable top K of the whole candidate list, ties straddling
  segment edges included;
- tools/kernel_tally counts and restores the wrappers.

The kernels themselves run only on a card: the `cuda`-marked test holds
them against their plain versions at the new edges (semidense_bench.
segment_cases, phrase_bench.SDP_EDGE_CASES) and skips here.
"""

import numpy as np
import pytest
import torch

from wiser_tpu_torch.ops import semidense as SD

SMS = 132  # an H100 SXM
KV = 1024
M = 64  # k 10 + the engine's margin


@pytest.mark.parametrize("kind", ["step", "phrase"])
@pytest.mark.parametrize("B", [1, 8, 128, 1024])
@pytest.mark.parametrize("L", [128, 129, 1024, 1025, 8192, 32768])
@pytest.mark.parametrize("T", [2, 3, 4, 8])
def test_plans_spread_over_the_card(T, L, B, kind):
    """Every engine shape: the buffer within the card's shared memory,
    whole 256-lane segments covering L in at most a cluster's 8, a split
    only where the merge's lists fit the buffer; a query spread over as
    many segments as keep the group within two CTAs an SM, each at least
    two units long."""
    K = min(M + 1, L) if kind == "step" else KV + 1
    g = (SD.plan(B, T, min(T - 2, 2), L, M, SMS).seg if kind == "step"
         else SD.segments(B, L, K, SMS))
    assert g.K == K and g.KP >= K and g.KP < 2 * K
    assert g.smem <= SD.MAX_SMEM and not g.global_x
    assert 1 <= g.nseg <= SD.MAX_CLUSTER
    assert g.seg_lanes % SD.UNIT == 0
    assert g.nseg * g.seg_lanes >= L > (g.nseg - 1) * g.seg_lanes
    assert g.nseg == 1 or 3 * g.KP <= g.XC  # the merge's lists fit
    units = -(-L // SD.UNIT)
    assert g.nmax == min(SD.MAX_CLUSTER,
                         max(1, units // SD.MIN_SEG_UNITS))
    assert g.nseg == 1 or g.seg_lanes >= SD.MIN_SEG_UNITS * SD.UNIT
    n = max(1, min(g.nmax, SD.CTAS_PER_SM * SMS // B))
    assert g.nseg == -(-L // (-(-units // n) * SD.UNIT))
    assert B * g.nseg <= max(B, SD.CTAS_PER_SM * SMS)


def test_engine_groups_spread():
    """The smoke's engine groups: B 8 spreads a query over up to 8 CTAs
    (one a 1,024-lane segment at L 8,192), B 128 over 2 (the group's 256
    CTAs two an SM), B 1,024 keeps a CTA a query, and a query of 128 lanes
    stays whole."""
    assert SD.plan(8, 2, 0, 8192, M, SMS).seg.nseg == 8
    assert SD.segments(8, 2048, KV + 1, SMS).nseg == 4
    assert SD.plan(128, 2, 0, 8192, M, SMS).seg.nseg == 2
    assert SD.segments(128, 32768, KV + 1, SMS).nseg == 2
    assert SD.plan(1024, 2, 0, 128, M, SMS).seg.nseg == 1
    assert SD.plan(8, 4, 2, 128, M, SMS).seg.nseg == 1
    assert SD.plan(1, 2, 0, 32768, M, SMS).seg.nseg == 8


def test_deep_k_layouts():
    """A K past two lists in shared memory keeps a query in one CTA; past
    the card's shared memory its keys lie in device memory."""
    g = SD.segments(8, 32768, 2049, SMS)
    assert g.KP == 4096 and g.nseg == 1 and not g.global_x
    g = SD.segments(8, 32768, 20001, SMS)
    assert g.global_x and g.nseg == 1 and g.smem == SD.HEAD_BYTES
    assert SD.plan(8, 3, 1, 32768, 20000, SMS).scratch_bytes == \
        8 * 8 * g.XC


# -- the recovery's search ----------------------------------------------------


def fixed_search(doc, target, lo, hi, iters):
    """engine/kernels._binary_search (phrase_route.cu search_fixed): int32
    midpoints with wraparound, reads clamped into the column."""
    n = len(doc)
    for _ in range(iters):
        s = ((lo + hi + 2**31) % 2**32) - 2**31
        mid = s >> 1
        less = doc[min(max(mid, 0), n - 1)] < target
        lo, hi = (mid + 1, hi) if less else (lo, mid)
    return lo


def probe_at(lo, hi, lane):
    n = hi - lo
    if n <= 0:
        return -1
    if n <= 32:
        return lo + lane if lane < n else -1
    return lo + ((n * (lane + 1)) >> 5) if lane < 31 else -1


def narrow(lo, hi, c):
    n = hi - lo
    if n <= 0:
        return lo, hi
    if n <= 32:
        return lo + c, lo + c
    l0 = lo
    if c > 0:
        lo = l0 + ((n * c) >> 5) + 1
    if c < 31:
        hi = l0 + ((n * (c + 1)) >> 5)
    return lo, hi


def warp_lower_bound(doc, lo, hi, target):
    """bound.cuh warp_lower_bound: 32 probes a round, one ballot."""
    rounds = 0
    while hi > lo:
        c = 0
        for lane in range(32):
            p = probe_at(lo, hi, lane)
            c += p >= 0 and doc[p] < target
        lo, hi = narrow(lo, hi, c)
        rounds += 1
    return lo, rounds


def recover(doc, target, lo, hi, iters):
    """phrase_route.cu's recovery (bound.cuh recover, else the replay):
    (posting index, route)."""
    run = hi - lo
    max_run = 2**31 if iters >= 31 else 2**iters - 1
    if lo >= 0 and run >= 0 and hi <= len(doc) and hi < 2**30 \
            and run <= max_run:
        r, _ = warp_lower_bound(doc, lo, hi, target)
        if r < hi:
            return r, "warp"
    return fixed_search(doc, target, lo, hi, iters), "replay"


def _column(rng, lengths):
    """Sorted runs of unique docs laid end to end; (column, runs)."""
    runs, pos = [], 0
    parts = []
    for n in lengths:
        d = np.sort(rng.choice(4 * max(n, 1) + 64, size=n, replace=False))
        parts.append(d.astype(np.int64))
        runs.append((pos, pos + n))
        pos += n
    return np.concatenate(parts + [np.full(8, 2**31 - 1)]), runs


@pytest.mark.parametrize("seed", range(12))
def test_recovery_equals_the_fixed_count_search(seed):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 2, 31, 32, 33, 1000, int(rng.integers(2, 5000))]
    doc, runs = _column(rng, lengths)
    for lo, hi in runs:
        run = hi - lo
        need = int(np.ceil(np.log2(run + 1)))
        vals = doc[lo:hi]
        targets = list(vals[rng.integers(0, max(run, 1), 6)] if run else [])
        targets += [-1, 0, int(vals.max()) + 1 if run else 5,
                    int(vals[0]) + 1 if run else 7, 2**31 - 1]
        for iters in {0, max(need - 1, 0), need, need + 3, 30}:
            for t in targets:
                got, route = recover(doc, int(t), lo, hi, iters)
                assert got == fixed_search(doc, int(t), lo, hi, iters), \
                    (lo, hi, iters, t)
                found = run and int(vals.max()) >= t
                if iters >= need and found:
                    assert route == "warp"
                    assert got == lo + np.searchsorted(vals, t, "left")
                if iters < need and run:
                    assert route == "replay"


def test_warp_search_rounds():
    """About log32 of the run: 4 rounds over a million-id run where the
    fixed-count search takes 20 halvings."""
    doc = np.arange(0, 2_000_000, 2, dtype=np.int64)
    _, rounds = warp_lower_bound(doc, 0, len(doc), 777_777)
    assert rounds <= 5
    assert int(np.ceil(np.log2(len(doc) + 1))) == 20


# -- the segmented selection and its merge ------------------------------------


def tile_key(s, lane):
    """keys.cuh tile_key: (score desc, lane asc) as one unsigned order."""
    bits = int(np.float32(s).view(np.uint32))
    nz = bits == 0x80000000
    u = 0 if nz else bits
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | ((0x7FFFFFFF - lane) << 1) | int(nz)


def key_lane(key):
    return 0x7FFFFFFF - ((key & 0xFFFFFFFF) >> 1)


def merge_ranks(R, Q, KP):
    """keys.cuh merge_ranks: a key's place is its index plus the keys of
    the other list above it; R is KP long, 0-padded; Q's n_in nonzero."""
    Q = [q for q in Q if q]
    out = [0] * KP
    for i, r in enumerate(R):
        p = i + sum(q > r for q in Q)
        if p < KP:
            out[p] = r
    for j, q in enumerate(Q):
        p = j + sum(r > q for r in R)
        if p < KP:
            out[p] = q
    return out


@pytest.mark.parametrize("values", [4, 1])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L,B,K", [(2048, 8, 65), (8192, 1, 1025),
                                   (32768, 128, 1025), (1025, 1, 17),
                                   (4096, 8, 1501)])
def test_segment_merge_equals_stable_top_k(L, B, K, seed, values):
    """Segments' top K keys, merged in segsel.cuh's tree by merge_ranks,
    equal the stable top K of the query's lanes (a third unmatched; the
    scores from 4 values, or 1, where the K-th score's class spans every
    segment edge)."""
    rng = np.random.default_rng(seed + L)
    g = SD.segments(B, L, K, SMS)
    n_valid = int(rng.integers(L // 2, L + 1))
    score = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0][:values]),
                       size=n_valid)
    match = rng.random(n_valid) < 0.67
    lists = []
    for s in range(g.nseg):
        lanes = range(s * g.seg_lanes, min(n_valid, (s + 1) * g.seg_lanes))
        keys = sorted((tile_key(score[i], i) for i in lanes if match[i]),
                      reverse=True)[:K]
        lists.append(keys + [0] * (g.KP - len(keys)))
    half = 1
    while half < g.nseg:  # the cluster's rounds
        for s in range(0, g.nseg - half, 2 * half):
            lists[s] = merge_ranks(lists[s], lists[s + half], g.KP)
        half *= 2
    got = [key_lane(k) for k in lists[0][:K] if k]
    m = np.nonzero(match)[0]
    want = m[np.lexsort((m, -score[m]))][:K]  # stable: lane asc in ties
    assert got == list(want)
    if values == 1 and g.nseg > 1 and match[:g.seg_lanes].sum() < K:
        # every lane ties, and the K-th lies past the first segment's edge
        assert want[-1] >= g.seg_lanes


# -- the device-time tally ----------------------------------------------------


def test_kernel_tally_counts_and_restores(monkeypatch):
    from wiser_tpu_torch.ops import semidense as ops_semi
    from wiser_tpu_torch.tools.kernel_tally import KernelTally

    seen = []
    monkeypatch.setattr(ops_semi, "semidense",
                        lambda *a, **k: seen.append(k) or "out")
    fake = ops_semi.semidense
    starts = torch.zeros((8, 3), dtype=torch.int32)
    args = (None, None, None, starts)
    with KernelTally() as tally:
        assert ops_semi.semidense is not fake
        for _ in range(3):
            assert ops_semi.semidense(*args, T=3, L=128, M=10, n_bs=1,
                                      n_bs_iters=5) == "out"
        ops_semi.semidense(*args, T=3, L=128, M=10, n_bs=1, n_bs_iters=5,
                           avg32=torch.zeros(1))
    assert ops_semi.semidense is fake and len(seen) == 4
    calls = {k[0]: v for k, v in tally.calls.items()}
    assert calls["semidense"][0] == 3 and calls["semidense_tc"][0] == 1
    assert calls["semidense"][4] == {"B": 8, "T": 3, "L": 128, "M": 10,
                                     "n_bs": 1, "n_bs_iters": 5}


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_segment_edges_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools import phrase_bench as PB
    from wiser_tpu_torch.tools import semidense_bench as SDB

    dev = torch.device("cuda", 0)
    out = SDB.segment_cases(dev)
    assert out["cases"] > 0 and out["max_abs_err"] == 0.0
    for case in PB.SDP_EDGE_CASES:
        for mode in ("raw", "tc"):
            args, kw = PB.semidense_case(case, mode, dev)
            assert torch.equal(K.semidense_phrase_body(*args, **kw),
                               K.semidense_phrase_torch(*args, **kw))
