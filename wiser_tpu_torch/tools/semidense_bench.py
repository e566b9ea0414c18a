"""The semidense step's kernel (ops/semidense.semidense, csrc/semidense.cu)
and the phrase position verification's (ops/phrase.phrase_verify_docs,
csrc/phrase.cu) held against their plain torch versions
(engine/kernels._semidense_step_torch, _verify_docs_torch) and timed
beside them.

    python -m wiser_tpu_torch.tools.semidense_bench [--out report.json]
    python -m wiser_tpu_torch.tools.semidense_bench --probe [--out r.json]
    python -m wiser_tpu_torch.tools.semidense_bench --trees OLD,.,.,OLD \
        --index IDX [--routes ROUTES] [--headline] --out report.json

(on a card: the kernels build at first use). `semidense_cases` runs raw
and tc columns at T in {2, 3, 4, 8} with 0, 1 and 2 searched others,
L in {128, 2048, 32768} (a warp's tile, a CTA's, many tiles) and M in
{1, 16, 64}, over tools/search_bench's synthetic columns (empty, short
and long runs; half the terms' payloads from a few values, so boundary
ties are cut) and dense rows half full (half of them from a few values,
saturated tf bytes among the tc ones); then the edges: a mesh shard's
doc_base, a deep k, a narrow group, a wide group and B 1;
`segment_cases` the segmented kernel's edges (L at the 256-lane units'
edges with B 1 and 8, runs past the iteration count, doc_base over
split queries, a K that splits and one whose keys lie in device
memory). `check_semidense` is the comparison
(tools/search_bench.check without posting indices): flags bit-equal on
every row; the kept (doc, f32 score bits, tfs) in (score desc, doc asc)
order, equal to the plain version's on unflagged rows and above the
boundary score on flagged ones; the top-M score multisets equal.
`docs_cases` runs the verification from kept docs over postings with
planted phrases and noise (DOCS_GRID:
anchors on term 0 and later terms, a group of 8 and a warp an item, an
int32 column, runs past the iteration count, docs in no run, -1 lanes);
the counts must be equal on every row. `verify_inputs` makes position
bags for the plain window verification (_verify_pos_windows_torch) that
the tests hold against the JAX package.

`time_semidense` and `time_docs` work at the engine's shapes on
synthetic 1M inputs (semidense: B by the engine's lane budget, and the
engines' own group shapes, ENGINE_SHAPES; the verification: the mega
phrase's chunk, B 128 NL 1,024 at PP / PW 8-32, and the serve phase's
small groups, DOCS_SHAPES), and
`time_calls` at the calls an engine made (`Recorder`): each compared,
then timed in turns with the plain version (kernel, plain, plain,
kernel; CUDA events), the kernel once more after an L2 flush, its
launches by torch.profiler (else CUDA events around calls queued behind
a sleep, search_bench.queued_ms), the wrapper's host cost per call, the peak
device memory above the inputs and the bytes bound
(`semidense_bound_bytes`, `docs_bound_bytes`).

`--trees` measures each listed tree once, in turns, each in its own
process importing wiser_tpu_torch from that tree (tools/unpack_bench.
run_trees): the entry points (_semidense_step, _verify_docs) at the
synthetic shapes, then with `--index` (a saved 1M index) route_bench's
`--routes` sets, raw and tc, each traced, with the peak device memory
of a semidense group and of a mega phrase group above their inputs;
with `--headline`, bench.headline.run in each tree (its stats:
semidense_s, bs_s, the route counts). `--probe` reads each phase's
cycles at ENGINE_SHAPES from a measuring build (clock64() marks,
csrc/clocks.cuh; tools/dense_bench.clocks_build and phase_split).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# H100 SXM HBM3 rate (NVIDIA's data sheet) for the bytes bound
HBM_BYTES_PER_S = 3.35e12
INT32_MAX = 2**31 - 1
SECTOR = 32  # bytes a DRAM sector: the unit a gather moves
N_1M = 1_000_448  # the 1M index's padded doc lanes
CHECK_T = ((2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 0), (4, 2), (8, 0),
           (8, 2))  # (T, n_bs)
CHECK_L = (128, 2048, 32768)
CHECK_M = (1, 16, 64)
# (T, n_bs, L) of the timed semidense groups, B by the engine's lane
# budget; the verification's (B, T, NL, PP, PW): the mega phrase chunk
SEMI_SHAPES = ((2, 0, 2048), (3, 0, 2048), (3, 1, 8192), (2, 0, 32768))
# (B, T, n_bs, L) of the engines' semidense groups the smoke times (its
# dense and tc runs' largest and busiest: raw B 8 T 4 n_bs 2 L 128 and B
# 128 T 2 L 8,192; tc B 128 T 2 L 2,048 and B 1,024 T 2 L 128), on
# synthetic 1M inputs: the probe's and the trees' engine shapes
ENGINE_SHAPES = ((8, 4, 2, 128), (128, 2, 0, 8192), (128, 2, 0, 2048),
                 (1024, 2, 0, 128))
# the phase marks of semidense.cu's measuring build (WISER_CLOCKS, csrc/
# clocks.cuh; csrc/segsel.cuh's layout): the step's candidates, searched
# slots, dense gathers, key pushes with flushes and sort, and outputs in
# counters 0-4 over the CTAs in 6 (flushes counted in 11), a split query's
# merge in 5 over the merging CTAs in 7
SEMI_GROUPS = (("step", ("candidates", "windows", "gathers", "flush",
                         "outputs"), 0, 6, {"flushes": 11}),
               ("merge", ("merge",), 5, 7, {}))
TIME_M = 64
# route_bench's sets that take the semidense step (dense_t3 on tc
# columns, the zipf ladder's mixes, the tail x head sets) and the
# verification (the phrase sets)
ROUTES = ("dense_t3,zipf_t2,zipf_t3,zipf_t4,semidense_t3,"
          "semidense_tail_x_head,aol_df,phrase_mega,phrase_mixed")
SEMI_TAGS = ("wiser_semidense::", "tc_norm_kernel")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- the semidense step ------------------------------------------------------


def dense_rows(H: int, n_pad: int, seed: int, density: float = 0.5) -> dict:
    """H dense rows of n_pad lanes: raw f32 scores (0 = absent; every
    other row from a few values) with int32 tfs, and tc uint8 tf bytes
    (0 = absent, 3% of the present ones 255)."""
    rng = np.random.default_rng(seed)
    present = rng.random((H, n_pad)) < density
    few = rng.integers(1, 5, size=(H, n_pad)).astype(np.float32) * 0.5
    wide = rng.uniform(0.1, 5.0, size=(H, n_pad)).astype(np.float32)
    sc = np.where((np.arange(H) % 2 == 1)[:, None], few, wide)
    tf8 = np.where(rng.random((H, n_pad)) < 0.03, 255,
                   rng.integers(1, 255, size=(H, n_pad)))
    return {"dense_sc": np.where(present, sc, 0).astype(np.float32),
            "dense_tf": np.where(present, rng.integers(1, 40, size=(H, n_pad)),
                                 0).astype(np.int32),
            "dense_tf8": np.where(present, tf8, 0).astype(np.uint8)}


def semi_batch(cols: dict, B: int, T: int, n_bs: int, H: int, seed: int,
               cand=None, n_pad_rows: int = 2) -> dict:
    """(B, T) arrays as the engine assembles a semidense group: slot 0
    the candidate, slots 1..n_bs searched others, then 1 to T - 1 - n_bs
    dense rows, the padded dense slots repeating the first with use 0 and
    idf 0 (starts / ends 0 past the searched slots); the last n_pad_rows
    rows are batch padding (empty runs)."""
    rng = np.random.default_rng(seed)
    n_terms = len(cols["t_start"])
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    slots = np.zeros((B, T), dtype=np.int32)
    nd = T - 1 - n_bs
    for b in range(max(0, B - n_pad_rows)):
        terms = [int(rng.choice(cand)) if cand is not None
                 else int(rng.integers(n_terms))]
        terms += [int(x) for x in rng.integers(n_terms, size=n_bs)]
        for t, term in enumerate(terms):
            starts[b, t] = cols["t_start"][term]
            ends[b, t] = cols["t_start"][term] + cols["t_len"][term]
        n_real = (int(rng.integers(1, nd + 1)) if b % 4 else nd) if nd else 0
        rows = rng.integers(H, size=max(nd, 1))
        for i in range(nd):
            slots[b, 1 + n_bs + i] = rows[i] if i < n_real else rows[0]
        for t in range(T):
            if t < 1 + n_bs + n_real:
                use[b, t] = 1.0
                idf[b, t] = np.float32(rng.uniform(0.1, 8.0))
    return {"starts": starts, "ends": ends, "use": use, "idf32": idf,
            "slots": slots, "avg32": np.float32(57.25)}


def semi_tensors(cols: dict, planes: dict, batch: dict, dev) -> dict:
    """The columns, the dense rows and a batch as tensors on dev."""
    import torch

    from wiser_tpu_torch.tools import search_bench as SB

    t = SB.to_device(cols, batch, dev)
    for k in ("dense_sc", "dense_tf", "dense_tf8"):
        if k in planes:
            v = planes[k]
            t[k] = (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v))).to(dev)
    t["slots"] = torch.from_numpy(batch["slots"]).to(dev)
    return t


def semi_call(fn, t: dict, mode: str, T: int, L: int, M: int, n_bs: int,
              n_iters: int, doc_base: int = 0):
    """fn (kernels._semidense_step or its plain version) on the tensors t."""
    kw = dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_iters,
              doc_base=doc_base)
    if mode == "tc":
        return fn(t["doc"], t["tc"], t["dense_tf8"], t["starts"], t["ends"],
                  t["idf32"], t["slots"], avg32=t["avg32"], **kw)
    return fn(t["doc"], t["score"], t["dense_sc"], t["starts"], t["ends"],
              t["use"], t["slots"], postings_tf=t["tf"],
              dense_tf=t["dense_tf"], **kw)


def _with_pidx(out):
    """A semidense output with zero posting indices, the shape
    tools/search_bench.check compares."""
    import torch

    docs, score, tfs, flags = out
    return docs, score, tfs, torch.zeros_like(tfs), flags


def check_semidense(kern, plain, M: int, what: str) -> dict:
    """search_bench.check of the kernel's outputs against the plain
    version's on the same inputs, without posting indices (raises
    AssertionError on the first difference)."""
    from wiser_tpu_torch.tools import search_bench as SB

    return SB.check(_with_pidx(kern), _with_pidx(plain), None, M, what)


def _shift_docs(cols: dict, doc_base: int) -> dict:
    out = dict(cols)
    d = cols["doc"]
    out["doc"] = np.where(d == INT32_MAX, d, d + doc_base).astype(np.int32)
    return out


def semidense_cases(dev, seed: int = 0, Ls=CHECK_L, Ts=CHECK_T,
                    Ms=CHECK_M, B: int = 32) -> dict:
    """The kernel against the plain version (both on dev) over the grid
    and the edges the module docstring names. Returns the case count,
    the rows, and the largest absolute score difference (0: exact)."""
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools import search_bench as SB

    rows = []

    def one(cols, planes, batch, mode, T, L, M, n_bs, what, doc_base=0):
        rows.append(_check_one(dev, cols, planes, batch, mode, T, L, M, n_bs,
                               what, doc_base))

    H = 6
    for L in Ls:
        cols = SB.synth_columns(L, seed + L)
        n_pad = -(-(2 * L + 64) // 128) * 128
        planes = dense_rows(H, n_pad, seed + L + 1)
        for T, n_bs in Ts:
            batch = semi_batch(cols, B, T, n_bs, H, seed + T + n_bs)
            for M in Ms:
                for mode in ("raw", "tc"):
                    one(cols, planes, batch, mode, T, L, M, n_bs,
                        f"semidense {mode} T={T} n_bs={n_bs} L={L} M={M}")
    # a mesh shard: its docs from doc_base, its rows' lane 0 at doc_base
    L = 2048
    base = 777_000
    cols = _shift_docs(SB.synth_columns(L, seed + 5), base)
    planes = dense_rows(H, -(-(2 * L + 64) // 128) * 128, seed + 6)
    for T, n_bs in ((2, 0), (3, 1)):
        batch = semi_batch(cols, B, T, n_bs, H, seed + 7)
        for mode in ("raw", "tc"):
            one(cols, planes, batch, mode, T, L, 16, n_bs,
                f"semidense {mode} doc_base={base} T={T} n_bs={n_bs}",
                doc_base=base)
    # a deep k (the plane path), a narrow split group, a wide group, B 1
    L = 4096
    cols = SB.synth_columns(L, seed + 9)
    planes = dense_rows(H, -(-(2 * L + 64) // 128) * 128, seed + 10)
    for mode in ("raw", "tc"):
        for Bx, T, n_bs, M, what in ((16, 3, 1, 1500, "deep k, plane path"),
                                     (4, 3, 1, 64, "split tiles"),
                                     (2048, 2, 0, 16, "wide group"),
                                     (1, 4, 2, 8, "B 1")):
            batch = semi_batch(cols, Bx, T, n_bs, H, seed + Bx,
                               n_pad_rows=0 if Bx == 1 else 2)
            one(cols, planes, batch, mode, T, L, M, n_bs,
                f"semidense {mode} {what} B={Bx} T={T} n_bs={n_bs} M={M}")
    return {"cases": len(rows), "rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def _check_one(dev, cols, planes, batch, mode, T, L, M, n_bs, what,
               doc_base=0, n_iters=None) -> dict:
    """One case: the kernel against the plain version on dev (n_iters:
    the searched slots' halvings, by default enough for every run)."""
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools import search_bench as SB

    t = semi_tensors(cols, planes, batch, dev)
    it = n_iters if n_iters is not None else (SB._n_iters(cols) if n_bs
                                              else 0)
    r = check_semidense(
        semi_call(K._semidense_step, t, mode, T, L, M, n_bs, it, doc_base),
        semi_call(K._semidense_step_torch, t, mode, T, L, M, n_bs, it,
                  doc_base), M, what)
    r.update(mode=mode, T=T, L=L, M=M, n_bs=n_bs, what=what)
    return r


# (L, B): candidate loads at the 256-lane units' edges, B 1 and 8 (a
# query spread over a cluster of up to 8 CTAs)
SEGMENT_EDGES = ((255, 8), (256, 1), (257, 8), (1023, 1), (1024, 8),
                 (1025, 1), (2049, 8), (8191, 1))


def segment_cases(dev, seed: int = 0, edges=SEGMENT_EDGES) -> dict:
    """The segmented kernel's edges (ops/semidense.plan) against the plain
    version, raw and tc: L at the units' edges with B 1 and 8 (T 2, and T
    3 with a searched slot); a searched slot's runs past the iteration
    count (n_bs_iters 3, against runs of up to 2L); a mesh shard's
    doc_base over split queries; a K whose two lists still fit the buffer
    (K 1,501: split) and one past shared memory (K 20,001: one CTA a
    query, its keys in device memory)."""
    from wiser_tpu_torch.tools import search_bench as SB

    rows = []
    H = 6
    for L, B in edges:
        cols = SB.synth_columns(L, seed + L)
        planes = dense_rows(H, -(-(2 * L + 64) // 128) * 128, seed + L + 1)
        for T, n_bs in ((2, 0), (3, 1)):
            batch = semi_batch(cols, B, T, n_bs, H, seed + T + L,
                               n_pad_rows=0 if B == 1 else 2)
            for mode in ("raw", "tc"):
                rows.append(_check_one(
                    dev, cols, planes, batch, mode, T, L, 16, n_bs,
                    f"segments {mode} L={L} B={B} T={T} n_bs={n_bs}"))
    L = 2048
    cols = SB.synth_columns(L, seed + 21)
    planes = dense_rows(H, -(-(2 * L + 64) // 128) * 128, seed + 22)
    batch = semi_batch(cols, 8, 4, 2, H, seed + 23)
    shifted = _shift_docs(cols, 777_000)
    for mode in ("raw", "tc"):
        rows.append(_check_one(dev, cols, planes, batch, mode, 4, L, 16, 2,
                               f"segments {mode} past the count n_bs_iters 3",
                               n_iters=3))
        rows.append(_check_one(dev, shifted, planes, batch, mode, 4, L, 16, 2,
                               f"segments {mode} doc_base 777000 B=8",
                               doc_base=777_000))
    for L, B, M in ((4096, 8, 1500), (32768, 2, 20000)):
        cols = SB.synth_columns(L, seed + L + 5)
        planes = dense_rows(H, -(-(2 * L + 64) // 128) * 128, seed + L + 6)
        batch = semi_batch(cols, B, 3, 1, H, seed + 29, n_pad_rows=0)
        for mode in ("raw", "tc"):
            rows.append(_check_one(dev, cols, planes, batch, mode, 3, L, M, 1,
                                   f"segments {mode} K={M + 1} L={L} B={B}"))
    return {"cases": len(rows), "rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def semidense_bound_bytes(t: dict, mode: str, T: int, L: int, M: int,
                          n_bs: int, doc_base: int = 0) -> int:
    """The bytes the step must move, each once, for this call's data: the
    candidate slices' valid lanes (doc + score, 8 B a lane raw; doc + tc
    lane, 6 B tc); each searched slot's run once (4 B a doc id) and its
    payload at the hits (4 B raw, 2 B tc); per dense slot, the distinct
    32-byte sectors of its row that the lanes still alive there touch
    (distinct over the group: queries that share a row share its
    sectors); the winners' tf loads (4 B raw, 1 B tc a slot); the
    outputs (docs, scores, tfs, the flag word) and the (B, T) bounds,
    weights and slots."""
    import torch

    starts = t["starts"].cpu().numpy().astype(np.int64)
    ends = t["ends"].cpu().numpy().astype(np.int64)
    slots = t["slots"].cpu().numpy().astype(np.int64)
    docs = t["doc"].cpu().numpy()
    plane = t["dense_tf8" if mode == "tc" else "dense_sc"]
    B = starts.shape[0]
    n_doc, n_pad = docs.shape[0], plane.shape[1]
    lane_b = 1 if mode == "tc" else 4
    run = np.maximum(ends - starts, 0)
    valid = np.minimum(run[:, 0], L)
    total = int(valid.sum()) * (8 if mode == "raw" else 6)
    # each query's candidate docs, cut by its searched slots
    cand = []
    for b in range(B):
        s = int(min(max(starts[b, 0], 0), max(n_doc - L, 0)))
        cd = docs[s : s + int(valid[b])].astype(np.int64)
        for t_ in range(1, 1 + n_bs):
            r = docs[starts[b, t_] : ends[b, t_]]
            total += len(r) * 4
            cd = cd[np.isin(cd, r)]
            total += len(cd) * (4 if mode == "raw" else 2)
        cand.append(cd)
    sectors = []
    flat = plane.reshape(-1)
    for t_ in range(1 + n_bs, T):
        sizes = [len(c) for c in cand]
        if not sum(sizes):
            break
        at = np.concatenate([slots[b, t_] * n_pad
                             + np.clip(c - doc_base, 0, n_pad - 1)
                             for b, c in enumerate(cand)])
        sectors.append(np.unique(at * lane_b // SECTOR))
        held = (flat[torch.from_numpy(at).to(plane.device)] > 0).cpu().numpy()
        parts = np.split(held, np.cumsum(sizes)[:-1])
        cand = [c[h] for c, h in zip(cand, parts)]
    if sectors:
        total += len(np.unique(np.concatenate(sectors))) * SECTOR
    total += B * T * M * lane_b
    total += B * (2 * M + T * M + 1) * 4 + B * T * 16
    return int(total)


def semi_shape(T: int, n_bs: int, L: int, seed: int = 1, H: int = 16,
               B=None):
    """The timed group at (T, n_bs, L) on a synthetic 1M doc space: B
    given or by the engine's semidense lane budget, candidate runs of L/2..L docs,
    searched runs of L..4L, H dense rows of N_1M lanes 30% full."""
    from wiser_tpu_torch.engine.device import (B_BUCKETS,
                                               SEMIDENSE_LANE_BUDGET,
                                               _chunk_within)
    from wiser_tpu_torch.tools import search_bench as SB

    if B is None:
        B = _chunk_within(SEMIDENSE_LANE_BUDGET, (T - 1) * L, B_BUCKETS)
    rng = np.random.default_rng(seed + L)
    n_cand = 32
    lengths = (list(rng.integers(L // 2 + 1, L + 1, size=n_cand))
               + list(rng.integers(L, 4 * L + 1, size=16)))
    runs = (np.sort(rng.choice(N_1M - 448, size=int(n), replace=False))
            for n in lengths)
    cols = SB.build_columns(runs, rng, slack=L + 4096)
    planes = dense_rows(H, N_1M, seed + 3, density=0.3)
    batch = semi_batch(cols, B, T, n_bs, H, seed + T, cand=np.arange(n_cand),
                       n_pad_rows=0)
    if n_bs:  # the searched others from the longer runs
        r = rng.integers(n_cand, len(lengths), size=(B, n_bs))
        batch["starts"][:, 1 : 1 + n_bs] = cols["t_start"][r]
        batch["ends"][:, 1 : 1 + n_bs] = cols["t_start"][r] + cols["t_len"][r]
    return B, cols, planes, batch


# -- the position verification -------------------------------------------------


def verify_inputs(B: int, T: int, NL: int, PP: int, PW: int, seed: int,
                  wide: bool = False, sort: bool = True, max_tf: int = None,
                  anchor=None, tail: bool = False) -> dict:
    """Position bags for a (B, T, NL) verification, as numpy arrays: a
    positions column (int16 bits of uint16, or int32 with `wide`) of
    every (query, term, lane) bag in turn, ps / pe their bounds and the
    (B,) anchors (`anchor`: one value for every row, else random in
    [0, T)). A third of the lanes hold a planted phrase (bases y with y +
    t in term t's bag), the rest noise; bags hold 0 to max_tf (default
    PW + 2, so some pass the window) positions, sorted or not (`sort`);
    with `tail` the column ends at the last bag, with no pad, so its
    window is clamped at n - PW. An int16 column also holds 65535 and
    positions past 32,767."""
    rng = np.random.default_rng(seed)
    hi = 65535 if not wide else 200_000
    max_tf = PW + 2 if max_tf is None else max_tf
    anc = (rng.integers(0, T, size=B) if anchor is None
           else np.full(B, anchor)).astype(np.int32)
    bags = [[None] * NL for _ in range(B * T)]
    for b in range(B):
        for lane in range(NL):
            planted = rng.random() < 1 / 3
            ys = (rng.integers(0, hi - 2 * T, size=int(rng.integers(1, 4)))
                  if planted else np.zeros(0, np.int64))
            for t in range(T):
                n = int(rng.integers(0, max_tf + 1))
                if rng.random() < 0.1:
                    n = 0  # an empty bag
                noise = rng.integers(0, hi + 1, size=n)
                bag = np.concatenate([ys + t, noise])[: max(n, len(ys))]
                if not sort:
                    rng.shuffle(bag)
                else:
                    bag = np.sort(bag)
                bags[b * T + t][lane] = bag
    order = [(i, lane) for i in range(B * T) for lane in range(NL)]
    perm = rng.permutation(len(order))  # bags lie in no query order
    ps = np.zeros((B * T, NL), dtype=np.int64)
    pe = np.zeros((B * T, NL), dtype=np.int64)
    chunks, pos = [], 0
    for k in perm:
        i, lane = order[k]
        bag = bags[i][lane]
        ps[i, lane] = pos
        pe[i, lane] = pos + len(bag)
        chunks.append(bag)
        pos += len(bag)
    col = np.concatenate(chunks + [np.zeros(0, np.int64)])
    if not tail:
        col = np.concatenate([col, np.full(PW + 8, 65535 if not wide else -1)])
    if len(col) == 0:
        col = np.zeros(1, np.int64)
    positions = (col.astype(np.int32) if wide
                 else col.astype(np.uint16).view(np.int16))
    return {"positions": positions,
            "ps": ps.reshape(B, T, NL).astype(np.int32),
            "pe": pe.reshape(B, T, NL).astype(np.int32), "anchor": anc}


def verify_tensors(v: dict, dev) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for k, x in v.items()}


def check_verify(kern, plain, what: str) -> dict:
    """The counts equal on every row (raises AssertionError)."""
    k, p = kern.cpu().numpy(), plain.cpu().numpy()
    if k.shape != p.shape or not np.array_equal(k, p):
        bad = np.nonzero((k != p).any(axis=1))[0] if k.shape == p.shape \
            else []
        raise AssertionError(f"{what}: counts differ on {len(bad)} rows "
                             f"(shapes {k.shape} {p.shape})")
    return {"rows": int(k.shape[0]), "lanes_matched": int((k > 0).sum()),
            "max_count": int(k.max(initial=0))}


def docs_inputs(B: int, T: int, NL: int, PP: int, PW: int, seed: int, *,
                run: int = 300, long_run: int = 0, wide: bool = False,
                anchor=None, max_tf: int = 6) -> dict:
    """Inputs of the routes' verification forms, as numpy arrays: each
    query's T terms' sorted runs in a postings_doc column ((B, T) starts
    and ends, query-term order), a pos_starts column (one bag a posting,
    and its end) and the positions column of every posting's bag (int16
    bits of uint16, 65535 pads; or int32 with `wide`); docs (B, NL) of
    kept lanes: most in every run (a third with a planted phrase: y + t
    in term t's bag), some in no run (between ids, below and above every
    id), some -1 (past the matched lanes); the (B,) anchors (`anchor`:
    one value, else random in [0, T)); runs of about `run` ids, and with
    `long_run` one term a query of that many, past a small n_iters's
    count; pidx (B, T, NL) the posting indices the fixed-count search
    finds, laid out in slot order by a random slot_of (B, T), with
    in-range garbage on the -1 lanes; n_iters the converged count."""
    rng = np.random.default_rng(seed)
    hi = 65535 if not wide else 200_000
    n_docs = 4 * max(run, long_run, NL) + 64
    anc = (rng.integers(0, T, size=B) if anchor is None
           else np.full(B, anchor)).astype(np.int32)
    runs = []  # (ids, kept docs with a phrase, their bases + t) a (b, t)
    docs = np.full((B, NL), -1, np.int64)
    for b in range(B):
        shared = rng.choice(n_docs, size=NL, replace=False)
        kind = rng.random(NL)
        # 0.7 in every run, 0.2 in none, 0.1 past the matched lanes
        kept = shared[kind < 0.7]
        outside = np.sort(shared[(kind >= 0.7) & (kind < 0.9)])
        ph = kept[rng.random(len(kept)) < 1 / 3]
        ys = rng.integers(0, hi - 2 * T, size=len(ph))
        free = np.ones(n_docs, bool)
        free[kept] = False
        free[outside] = False
        pool = np.nonzero(free)[0]
        for t in range(T):
            size = long_run if long_run and t == b % T else run
            extra = rng.choice(pool, size=min(len(pool), size), replace=False)
            runs.append((np.sort(np.concatenate([kept, extra])), ph, ys + t))
        lanes = np.concatenate([kept, outside])[:NL]
        docs[b, rng.permutation(NL)[: len(lanes)]] = lanes
    if NL >= 2:  # a doc past every id of the column, and doc 0
        docs[0, :2] = [n_docs + 5, 0]
    lens = np.array([len(r[0]) for r in runs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ends = starts + lens
    postings_doc = np.concatenate([r[0] for r in runs]).astype(np.int32)
    n_post = len(postings_doc)
    # every bag: noise, and the planted bases' y + t where a phrase is
    n_noise = rng.integers(0, max_tf + 1, size=n_post)
    owner = [np.repeat(np.arange(n_post), n_noise)]
    vals = [rng.integers(0, hi + 1, size=int(n_noise.sum()))]
    for i, (ids, ph, yt) in enumerate(runs):
        owner.append(starts[i] + np.searchsorted(ids, ph))
        vals.append(yt)
    owner = np.concatenate(owner)
    vals = np.concatenate(vals)
    order = np.lexsort((vals, owner))
    pos_starts = np.concatenate(
        [[0], np.cumsum(np.bincount(owner, minlength=n_post))])
    col = np.concatenate([vals[order],
                          np.full(PW + 8, 65535 if not wide else -1)])
    positions = (col.astype(np.int32) if wide
                 else col.astype(np.uint16).view(np.int16))
    # the fixed-count search's indices, then in slot order
    n_iters = int(np.ceil(np.log2(int(lens.max()) + 1)))
    pidx_q = np.zeros((B, T, NL), np.int64)
    for b in range(B):
        for t in range(T):
            i = b * T + t
            pidx_q[b, t] = starts[i] + np.searchsorted(runs[i][0], docs[b])
    pidx_q = np.where((docs < 0)[:, None, :], rng.integers(
        0, n_post, size=pidx_q.shape), pidx_q)
    slot_of = np.stack([rng.permutation(T) for _ in range(B)]).astype(
        np.int32)
    pidx = np.zeros_like(pidx_q)
    for b in range(B):
        pidx[b, slot_of[b]] = pidx_q[b]
    return {"postings_doc": postings_doc, "positions": positions,
            "pos_starts": pos_starts.astype(np.int32),
            "docs": docs.astype(np.int32),
            "starts": starts.reshape(B, T).astype(np.int32),
            "ends": ends.reshape(B, T).astype(np.int32),
            "anchor": anc, "pidx": pidx.astype(np.int32),
            "slot_of": slot_of, "n_iters": n_iters}


def docs_call(fn, t: dict, T: int, NL: int, PP: int, PW: int,
              n_iters: int):
    """fn (kernels._verify_docs or its plain version) on t."""
    return fn(t["postings_doc"], t["positions"], t["pos_starts"], t["docs"],
              t["starts"], t["ends"], t["anchor"], T=T, NL=NL, PP=PP, PW=PW,
              n_iters=n_iters)


def pidx_call(fn, t: dict, T: int, NL: int, PP: int, PW: int):
    """fn (kernels._verify_pidx_torch) on t."""
    return fn(t["positions"], t["pos_starts"], t["pidx"], t["slot_of"], T=T,
              NL=NL, PP=PP, PW=PW)


# (B, T, NL, PP, PW, docs_inputs options, n_iters: None the converged
# count, else that many halvings)
DOCS_GRID = (
    (4, 2, 64, 8, 8, {}, None), (4, 2, 64, 32, 32, {}, None),
    (3, 3, 50, 8, 32, {"anchor": 2}, None),
    (3, 3, 40, 16, 16, {"anchor": 0}, None),
    (2, 4, 40, 64, 64, {"max_tf": 40}, None),  # a warp an item
    (2, 8, 16, 32, 32, {}, None), (2, 9, 12, 8, 8, {}, None),
    (2, 2, 30, 32, 32, {"wide": True}, None),
    (2, 2, 48, 16, 16, {"long_run": 5000}, 9),  # runs past the count
    (3, 2, 40, 8, 8, {"run": 2}, None),  # runs of a few ids
    (1, 1, 7, 8, 8, {}, None), (32, 2, 128, 16, 16, {}, None),
)


def docs_cases(dev, seed: int = 0) -> dict:
    """The mega routes' verification from kept docs against its plain
    version, both on dev, over DOCS_GRID:
    anchors on term 0 and later terms, an item a group of 8 and a warp,
    T past a group's 8, an int32 column, runs past the iteration count
    (the recovery replays the fixed-count search there), runs of a few
    ids, docs in no run and above every id, -1 lanes. Returns the case
    count and the rows."""
    from wiser_tpu_torch.engine import kernels as K

    rows = []
    for i, (B, T, NL, PP, PW, opt, it) in enumerate(DOCS_GRID):
        v = docs_inputs(B, T, NL, PP, PW, seed + i, **opt)
        n_iters = v.pop("n_iters") if it is None else it
        v.pop("n_iters", None)
        t = verify_tensors(v, dev)
        what = f"verify_docs B={B} T={T} NL={NL} PP={PP} PW={PW} {opt}"
        r = check_verify(docs_call(K._verify_docs, t, T, NL, PP, PW, n_iters),
                         docs_call(K._verify_docs_torch, t, T, NL, PP, PW,
                                   n_iters), what)
        r.update(form="docs", B=B, T=T, NL=NL, PP=PP, PW=PW, what=what)
        rows.append(r)
    return {"cases": len(rows), "rows": rows, "max_abs_err": 0.0}


def _window_sectors(positions, ps, pe, PW: int) -> int:
    """The distinct 32-byte sectors of the (lane, term) windows' valid
    entries: ps, pe numpy bag bounds, positions the column."""
    n = positions.shape[0]
    es = positions.element_size()
    start = np.clip(ps, 0, max(0, n - PW))
    cnt = np.clip(pe - ps, 0, PW)
    live = cnt > 0
    first = start[live] * es // SECTOR
    last = np.minimum(start[live] + cnt[live] - 1, n - 1) * es // SECTOR
    span = last - first + 1
    sec = np.repeat(first, span) + (np.arange(span.sum())
                                    - np.repeat(np.cumsum(span) - span, span))
    return int(len(np.unique(sec)))


def _pos_pairs(pos_starts, pidx):
    """(ps, pe, the distinct sectors of the pos_starts pairs) of posting
    indices pidx (numpy), each index clamped into the column."""
    n = len(pos_starts)
    i0 = np.clip(pidx, 0, n - 1)
    i1 = np.clip(pidx + 1, 0, n - 1)
    sec = np.unique(np.concatenate([i0, i1]) * 4 // SECTOR)
    return pos_starts[i0], pos_starts[i1], len(sec)


def docs_bound_bytes(t: dict, T: int, NL: int, PW: int, n_iters: int) -> int:
    """The bytes the verification from kept docs must move, each once:
    the (B, NL) kept docs, the (B, T) runs, the distinct 32-byte sectors
    of postings_doc that the fixed-count search's probes touch over every
    (lane, term) (the ids a search must compare), the sectors of each
    (lane, term)'s pos_starts pair and of its window's valid entries, the
    (B,) anchors and the (B, NL) counts."""
    doc = t["postings_doc"].cpu().numpy()
    docs = t["docs"].cpu().numpy().astype(np.int64)
    st = t["starts"].cpu().numpy().astype(np.int64)
    en = t["ends"].cpu().numpy().astype(np.int64)
    B = docs.shape[0]
    target = np.broadcast_to(docs[:, None, :], (B, T, NL)).ravel()
    lo = np.broadcast_to(st[:, :, None], (B, T, NL)).ravel().copy()
    hi = np.broadcast_to(en[:, :, None], (B, T, NL)).ravel().copy()
    n = len(doc)
    probes = []
    for _ in range(n_iters):
        mid = ((lo + hi).astype(np.int32) >> 1).astype(np.int64)
        i = np.clip(mid, 0, n - 1)
        probes.append(i)
        less = doc[i] < target
        lo = np.where(less, mid + 1, lo)
        hi = np.where(less, hi, mid)
    search = len(np.unique(np.concatenate(probes) * 4 // SECTOR)) \
        if probes else 0
    ps, pe, pairs = _pos_pairs(t["pos_starts"].cpu().numpy()
                               .astype(np.int64), lo)
    wins = _window_sectors(t["positions"], ps, pe, PW)
    return int((search + pairs + wins) * SECTOR + B * NL * 4 + B * T * 8
               + B * 4 + B * NL * 4)


# -- timing ------------------------------------------------------------------


def launch_ms(fn, tags, calls: int = 5) -> dict:
    """Device ms per call of each device kernel fn() launches whose name
    holds one of `tags`: torch.profiler (utils.trace) over `calls` calls
    after a warm one, the mean of each name's newest `calls` events
    (None with fewer, after three captures). `total` sums them (None
    where one is None or none ran); `events` counts each name's events;
    `all_ms` is every device event of the window a call."""
    import torch
    from torch.autograd import DeviceType

    from wiser_tpu_torch.utils import trace

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a capture that lost events is taken again
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                for _ in range(calls):
                    fn()
            events = sorted((e.time_range.start, e.time_range.end, e.name)
                            for e in prof.events()
                            if e.device_type == DeviceType.CUDA)
        out = {"kernels": {}, "events": {}, "calls": calls,
               "all_ms": sum(b - a for a, b, _ in events) / 1e3 / calls}
        for name in sorted({n for *_, n in events
                            if any(g in n for g in tags)}):
            mine = [b - a for a, b, n in events if n == name]
            key = name.split("(")[0].split("::")[-1]
            out["events"][key] = len(mine)
            out["kernels"][key] = (sum(mine[-calls:]) / 1e3 / calls
                                   if len(mine) >= calls else None)
        vals = list(out["kernels"].values())
        out["total"] = sum(vals) if vals and None not in vals else None
        if None not in vals:
            break
    return out


def time_pair(kern, plain, nbytes: int, tags, iters: int = 10,
              plain_iters: int = 3, with_plain: bool = True) -> dict:
    """The kernel and its plain version in turns (kernel, plain, plain,
    kernel; CUDA events), the kernel after an L2 flush, its launches'
    device time by torch.profiler (else CUDA events around calls queued
    behind a sleep, search_bench.queued_ms: no host gap), its host cost
    a call, both versions' peak memory above their inputs and the bytes
    bound."""
    import torch

    from wiser_tpu_torch.tools import search_bench as SB
    from wiser_tpu_torch.tools.dense_bench import peak_extra

    k1 = SB.event_ms(kern, iters)
    p = ([SB.event_ms(plain, plain_iters), SB.event_ms(plain, plain_iters)]
         if with_plain else [])
    k2 = SB.event_ms(kern, iters)
    split = launch_ms(kern, tags)
    queued = SB.queued_ms(kern, iters)
    row = {"event_ms": [k1, k2], "plain_ms": p, "queued_ms": queued,
           "device_ms": split["total"] or queued,
           "timing": ("torch.profiler" if split["total"] is not None
                      else "CUDA events, queued"),
           "flushed_ms": SB.flushed_ms(kern, iters),
           "host_us": SB.host_us(kern, iters), "launch_ms": split,
           "launches_per_call": sum(split["events"].values()) / split["calls"],
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "peak_extra": {"kernel": peak_extra(kern)}}
    row["share"] = row["bound_ms"] / row["device_ms"]
    if with_plain:
        row["peak_extra"]["plain"] = peak_extra(plain)
        row["speedup"] = min(p) / row["device_ms"]
    torch.cuda.empty_cache()
    return row


def time_semidense(dev, modes=("raw", "tc"), shapes=SEMI_SHAPES,
                   M: int = TIME_M, plain: bool = True,
                   compare: bool = True) -> list:
    """_semidense_step (the kernel where this tree has one) and, with
    `plain`, its plain version at `shapes` ((T, n_bs, L), B by the lane
    budget, or (B, T, n_bs, L)) on synthetic 1M inputs: compared
    (`compare`), then timed (`time_pair`)."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools import search_bench as SB

    plain_fn_of = getattr(K, "_semidense_step_torch", K._semidense_step)
    rows = []
    for shape in shapes:
        Bx, T, n_bs, L = shape if len(shape) == 4 else (None, *shape)
        B, cols, planes, batch = semi_shape(T, n_bs, L, B=Bx)
        it = SB._n_iters(cols) if n_bs else 0
        for mode in modes:
            t = semi_tensors(cols, {k: planes[k] for k in (
                ("dense_tf8",) if mode == "tc" else ("dense_sc", "dense_tf"))},
                batch, dev)

            def kern(t=t, mode=mode):
                return semi_call(K._semidense_step, t, mode, T, L, M, n_bs,
                                 it)

            def plain_fn(t=t, mode=mode):
                return semi_call(plain_fn_of, t, mode, T, L, M, n_bs, it)

            row = {"kind": "semidense", "mode": mode, "B": B, "T": T,
                   "n_bs": n_bs, "L": L, "M": M, "N_pad": N_1M}
            if compare:
                row["check"] = check_semidense(kern(), plain_fn(), M,
                                               f"semidense timed {row}")
            row.update(time_pair(kern, plain_fn, semidense_bound_bytes(
                t, mode, T, L, M, n_bs), SEMI_TAGS, with_plain=plain))
            log(f"semidense timing {json.dumps(row)}")
            rows.append(row)
            del t
            torch.cuda.empty_cache()
    return rows


# the routes' forms' timed groups (B, T, NL, PP, PW, run ids): the mega
# chunk at the engine's PP / PW 8-32 over head-term runs, and the serve
# phase's small groups
DOCS_SHAPES = ((128, 2, 1024, 16, 16, 30_000), (128, 2, 1024, 32, 32, 30_000),
               (128, 3, 1024, 32, 32, 30_000), (8, 2, 1024, 16, 16, 30_000),
               (32, 2, 1024, 16, 16, 30_000))
DOCS_TAGS = ("wiser_phrase::",)


def time_docs(dev, shapes=DOCS_SHAPES, plain: bool = True,
              compare: bool = True) -> list:
    """The verification from kept docs (kernels._verify_docs: its kernel
    on a card) and, with `plain`, its plain version at `shapes` on
    docs_inputs, compared and timed (time_pair; device_ms the calls
    queued behind a sleep, every launch included), each beside its bytes
    bound (docs_bound_bytes)."""
    import torch

    from wiser_tpu_torch.engine import kernels as K

    rows = []
    for B, T, NL, PP, PW, run in shapes:
        v = docs_inputs(B, T, NL, PP, PW, 17 + B + T, run=run)
        it = v.pop("n_iters")
        t = verify_tensors(v, dev)

        def kern(t=t):
            return docs_call(K._verify_docs, t, T, NL, PP, PW, it)

        def plain_fn(t=t):
            return docs_call(K._verify_docs_torch, t, T, NL, PP, PW, it)

        row = {"kind": "verify_docs", "B": B, "T": T, "NL": NL, "PP": PP,
               "PW": PW, "run": run, "n_iters": it}
        if compare:
            row["check"] = check_verify(kern(), plain_fn(),
                                        f"verify_docs timed {row}")
        row.update(time_pair(kern, plain_fn,
                             docs_bound_bytes(t, T, NL, PW, it), DOCS_TAGS,
                             with_plain=plain))
        row["device_ms"] = row["queued_ms"]
        row["timing"] = "CUDA events, queued (every launch)"
        row["share"] = row["bound_ms"] / row["device_ms"]
        log(f"verify_docs timing {json.dumps(row)}")
        rows.append(row)
        del t
        torch.cuda.empty_cache()
    return rows


# -- the engine's own calls -------------------------------------------------------


class Recorder:
    """Records the calls an engine makes of kernels._semidense_step and
    the verification from kept docs (_verify_docs; each distinct shape's
    largest group, at most `per_kind` shapes a kind) while installed
    (`with Recorder() as rec:`), so that `time_calls` can hold and time
    them afterwards."""

    KINDS = ("semidense", "verify_docs")

    def __init__(self, per_kind: int = 16):
        self.per_kind = per_kind
        self.calls = {k: {} for k in self.KINDS}
        self.counts = {k: {} for k in self.KINDS}

    def __enter__(self):
        from wiser_tpu_torch.engine import kernels as K

        self._orig = (K._semidense_step, K._verify_docs)
        semi, docs = self._orig

        def semi_rec(*args, **kw):
            mode = "tc" if kw.get("avg32") is not None else "raw"
            self._keep("semidense", (mode, kw["T"], kw["n_bs"], kw["L"],
                                     kw["M"]), args[3].shape[0], args, kw)
            return semi(*args, **kw)

        def docs_rec(*args, **kw):
            key = (kw["T"], kw["NL"], kw["PP"], kw["PW"], kw["n_iters"])
            self._keep("verify_docs", key, args[3].shape[0], args, kw)
            return docs(*args, **kw)

        K._semidense_step = semi_rec
        K._verify_docs = docs_rec
        return self

    def _keep(self, kind, key, B, args, kw):
        c = self.counts[kind]
        c[key] = c.get(key, 0) + 1
        calls = self.calls[kind]
        if key in calls:
            if B > calls[key][0]:
                calls[key] = (B, args, kw)
        elif len(calls) < self.per_kind:
            calls[key] = (B, args, kw)

    def __exit__(self, *exc):
        from wiser_tpu_torch.engine import kernels as K

        K._semidense_step, K._verify_docs = self._orig
        return False

    def chosen(self, kind: str):
        """A kind's recorded shape with the most lanes (B * L, or B * NL
        for the verification; its largest group), then its most called
        one where that is another: [(key, calls, (B, args, kw))]."""
        c, calls = self.counts[kind], self.calls[kind]
        if not calls:
            return []
        biggest = max(calls, key=lambda k: calls[k][0] * k[-2 if kind ==
                                                        "semidense" else 1])
        busiest = max(calls, key=lambda k: c[k])
        keys = [biggest] + ([busiest] if busiest != biggest else [])
        return [(k, c[k], calls[k]) for k in keys]


def time_calls(rec: Recorder, plain: bool = True) -> dict:
    """Each kind's chosen recorded shapes (`Recorder.chosen`: the largest
    group, the most called shape): the kernel against the plain version
    on the recorded inputs, then timed (`time_pair`). Returns
    {kind: rows} (Recorder.KINDS), the largest first."""
    from wiser_tpu_torch.engine import kernels as K

    out = {k: [] for k in Recorder.KINDS}
    for key, calls, (B, args, kw) in rec.chosen("semidense"):
        mode, T, n_bs, L, M = key

        def kern(args=args, kw=kw):
            return K._semidense_step(*args, **kw)

        def plain_fn(args=args, kw=kw):
            return K._semidense_step_torch(*args, **kw)

        row = {"kind": "semidense", "mode": mode, "B": B, "T": T,
               "n_bs": n_bs, "L": L, "M": M, "calls": calls,
               "N_pad": int(args[2].shape[1])}
        row["check"] = check_semidense(kern(), plain_fn(), M,
                                       f"semidense engine call {row}")
        t = {"doc": args[0], "starts": args[3], "ends": args[4],
             "slots": args[6],
             ("dense_tf8" if mode == "tc" else "dense_sc"): args[2]}
        row.update(time_pair(kern, plain_fn, semidense_bound_bytes(
            t, mode, T, L, M, n_bs, kw.get("doc_base", 0)), SEMI_TAGS,
            with_plain=plain))
        log(f"semidense engine timing {json.dumps(row)}")
        out["semidense"].append(row)
    for key, calls, (B, args, kw) in rec.chosen("verify_docs"):
        T, NL, PP, PW = key[:4]

        def kern(args=args, kw=kw):
            return K._verify_docs(*args, **kw)

        def plain_fn(args=args, kw=kw):
            return K._verify_docs_torch(*args, **kw)

        row = {"kind": "verify_docs", "B": B, "T": T, "NL": NL, "PP": PP,
               "PW": PW, "calls": calls}
        row["check"] = check_verify(kern(), plain_fn(),
                                    f"verify_docs engine call {row}")
        t = dict(zip(("postings_doc", "positions", "pos_starts", "docs",
                      "starts", "ends"), args))
        row.update(time_pair(kern, plain_fn,
                             docs_bound_bytes(t, T, NL, PW, kw["n_iters"]),
                             DOCS_TAGS, with_plain=plain))
        log(f"verify_docs engine timing {json.dumps(row)}")
        out["verify_docs"].append(row)
    return out


def probe(dev, shapes=ENGINE_SHAPES, modes=("raw", "tc"), M: int = TIME_M,
          iters: int = 10) -> list:
    """Each phase's cycles of the semidense step by clock64() marks (its
    measuring build, tools/dense_bench.clocks_build) at the engines'
    group shapes on synthetic 1M inputs, each beside its event-timed ms
    in that build. The entry point uses the library it loaded again
    afterwards."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import semidense as SD
    from wiser_tpu_torch.tools import search_bench as SB
    from wiser_tpu_torch.tools.dense_bench import clocks_build, phase_split

    loaded = SD._kernel_fns()
    fns = clocks_build("semidense", SD._Fns)
    rows = []
    try:
        SD._fns = fns
        for B, T, n_bs, L in shapes:
            _, cols, planes, batch = semi_shape(T, n_bs, L, B=B)
            it = SB._n_iters(cols) if n_bs else 0
            for mode in modes:
                t = semi_tensors(cols, {k: planes[k] for k in (
                    ("dense_tf8",) if mode == "tc"
                    else ("dense_sc", "dense_tf"))}, batch, dev)

                def fn(t=t, mode=mode):
                    return semi_call(K._semidense_step, t, mode, T, L, M,
                                     n_bs, it)

                row = dict(kind="semidense", mode=mode, B=B, T=T, n_bs=n_bs,
                           L=L, M=M, ms=SB.event_ms(fn, iters),
                           **phase_split(fn, fns, groups=SEMI_GROUPS))
                log(f"semidense probe {json.dumps(row)}")
                rows.append(row)
                del t
                torch.cuda.empty_cache()
    finally:
        SD._fns = loaded
    return rows


# -- old against new -----------------------------------------------------------


def _group_peaks(eng, queries) -> dict:
    """The peak device memory above their inputs of the engine's largest
    semidense group and mega phrase group over one pass of queries (the
    step's or dispatch's allocations, its outputs included)."""
    import torch

    from wiser_tpu_torch.engine import kernels as K

    peaks = {"semidense": 0, "phrase_mega": 0}
    semi = K._semidense_step
    mega = getattr(eng, "_mega_phrase_dispatch", None)

    def measured(kind, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            peaks[kind] = max(peaks[kind], int(
                torch.cuda.max_memory_allocated() - before))
            return out
        return run

    K._semidense_step = measured("semidense", semi)
    if mega is not None:
        eng._mega_phrase_dispatch = measured("phrase_mega", mega)
    try:
        eng.clear_result_memos()
        eng.search_batch(queries)
    finally:
        K._semidense_step = semi
        if mega is not None:
            del eng._mega_phrase_dispatch
        eng.clear_result_memos()
        eng.stats_take()
    return peaks


def route_sets(index: str, columns: str, routes, n: int = 2048) -> dict:
    """route_bench's sets on a TorchEngine of the index (the phrase sets
    from the index's mined pairs, `<index>/phrase_pairs.json`), each run
    by route_bench.run_set with a traced pass, and each with the peak
    device memory of its largest semidense and mega phrase group."""
    import torch

    from wiser_tpu_torch import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import route_bench as RB

    packed = PackedIndex.load(index, skip_offsets=True)
    eng = TorchEngine(packed, device="cuda", columns=columns)
    sets = RB.build_route_sets(packed, eng, n, 10)
    if "aol_df" in routes:  # the chip smoke's df-ranked AOL mix
        sets["aol_df"] = RB.aol_mixed_queries(packed, n, by_df=True)
    if any(r.startswith("phrase_") for r in routes):
        with open(os.path.join(index, "phrase_pairs.json")) as f:
            pairs = [tuple(x) for x in json.load(f)]
        sets.update(RB.build_phrase_route_sets(packed, eng, None, n, 10,
                                               pairs=pairs))
    out = {}
    for name in routes:
        queries = sets.get(name)
        if not queries:
            continue
        peaks = _group_peaks(eng, queries)
        with tempfile.TemporaryDirectory() as tmp:
            row = RB.run_set(eng, queries, 2048, trace_dir=tmp)
        row["group_peak_bytes"] = peaks
        row["queries"] = len(queries)
        log(f"{columns} {name}: {json.dumps(row)}")
        out[name] = row
        torch.cuda.empty_cache()
    del eng
    torch.cuda.empty_cache()
    return out


def measure(root: str, index=None, routes: str = ROUTES,
            headline: bool = False) -> dict:
    """One tree's readings, in this process: the entry points at the
    synthetic shapes (no plain times, no comparison), then, given a saved
    index, route_bench's `routes` raw and tc, each traced, with the group
    peaks; with `headline`, bench.headline.run (bench.py's workload on
    the card, its index built in the tree's own cache) and its stats
    (semidense_s, bs_s and the route counts among them)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools.unpack_bench import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("semidense_bench measures a card: none is "
                           "available")
    dev = torch.device("cuda", 0)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(K.__file__),
           "timing": time_semidense(dev, shapes=SEMI_SHAPES + ENGINE_SHAPES,
                                    plain=False, compare=False)
           + time_docs(dev, plain=False, compare=False)}
    if index:
        sets = [r for r in routes.split(",") if r]
        out["routes"] = {c: route_sets(index, c, sets) for c in ("raw", "tc")}
    if headline:
        from wiser_tpu_torch.bench import headline as HL

        h = HL.run(device="cuda")
        out["headline"] = {"line": h["line"], "passes": h["passes"],
                           "stats": h["stats"]}
        del h
        torch.cuda.empty_cache()
    return out


def summary(runs: list) -> dict:
    """Per run: each timed shape's [device ms, flushed ms, host us, bound
    share], each route set's [untraced wall s, traced device busy ms,
    busy share, semidense group peak bytes, mega group peak bytes] and
    the headline's [pass QPS, semidense_s, bs_s, route_semidense,
    route_bs]."""
    res = []
    for r in runs:
        s = {"tree": r["tree"], "card": r["card"]}
        for x in r["timing"]:
            key = (f"semidense_{x['mode']}_B{x['B']}_T{x['T']}_nbs"
                   f"{x['n_bs']}_L{x['L']}" if x["kind"] == "semidense"
                   else f"{x['kind']}_B{x['B']}_T{x['T']}_NL{x['NL']}"
                   f"_PW{x['PW']}")
            s[key] = [x["device_ms"], x["flushed_ms"], x["host_us"],
                      x["share"]]
        for columns, sets in r.get("routes", {}).items():
            for name, row in sets.items():
                traced = row.get("traced") or {}
                s[f"{columns}_{name}"] = [
                    row.get("wall_s"), traced.get("device_busy_ms"),
                    traced.get("busy_share"),
                    row["group_peak_bytes"]["semidense"],
                    row["group_peak_bytes"]["phrase_mega"]]
        if "headline" in r:
            st = r["headline"]["stats"]
            s["headline"] = [r["headline"]["line"]["pass_qps"],
                             st.get("semidense_s"), st.get("bs_s"),
                             st.get("route_semidense"), st.get("route_bs")]
        res.append(s)
    return {"semidense_bench": res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-check", action="store_true")
    ap.add_argument("--check-only", action="store_true",
                    help="build and compare, no timing")
    ap.add_argument("--trees", default=None,
                    help="comma-separated trees, measured in turns")
    ap.add_argument("--root", help="measure this tree in this process")
    ap.add_argument("--index", help="a saved 1M index for route_bench's sets")
    ap.add_argument("--routes", default=ROUTES)
    ap.add_argument("--headline", action="store_true",
                    help="--trees: each tree's bench.headline run too")
    ap.add_argument("--probe", action="store_true",
                    help="each phase's cycles at the engines' shapes "
                    "(a measuring build), then stop")
    args = ap.parse_args(argv)
    if args.root:
        res = measure(args.root, args.index, args.routes, args.headline)
        print(json.dumps(res), flush=True)
        return res
    if args.trees:
        from wiser_tpu_torch.tools.unpack_bench import run_trees

        extra = ["--routes", args.routes]
        if args.headline:
            extra.append("--headline")
        if args.index:
            extra += ["--index", os.path.abspath(args.index)]
        res = {"runs": run_trees(__file__, args.trees.split(","), extra)}
        print(json.dumps(summary(res["runs"])), flush=True)
    else:
        import torch

        from wiser_tpu_torch.build import build_log, load_libraries
        from wiser_tpu_torch.runtime import resolve_device
        from wiser_tpu_torch.tools.unpack_bench import card_line

        dev = resolve_device("cuda")
        res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
        load_libraries(("semidense", "phrase", "dense"))
        res["build_s"] = {n: build_log[n][0]
                          for n in ("semidense", "phrase", "dense")}
        for n in ("semidense", "phrase"):
            log(build_log[n][1])
        if args.probe:
            args.skip_check = args.check_only = True
            res["probe"] = probe(dev)
        if not args.skip_check:
            for name, fn in (("semidense_check", semidense_cases),
                             ("segment_check", segment_cases),
                             ("verify_check", docs_cases)):
                t0 = time.perf_counter()
                res[name] = fn(dev)
                res[name].pop("rows")
                res[name]["wall_s"] = time.perf_counter() - t0
                log(f"{name}: {res[name]}")
        if not args.check_only:
            res["timing"] = (time_semidense(dev, shapes=SEMI_SHAPES
                                            + ENGINE_SHAPES)
                             + time_docs(dev))
        print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
