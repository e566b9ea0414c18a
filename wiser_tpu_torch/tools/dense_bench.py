"""The dense head-term tier's kernels (ops/dense.py, csrc/dense.cu) held
against their plain torch versions on synthetic dense planes, and timed
beside them at the engine's shapes.

    python -m wiser_tpu_torch.tools.dense_bench [--out report.json]
    python -m wiser_tpu_torch.tools.dense_bench --probe [--index IDX]
    python -m wiser_tpu_torch.tools.dense_bench --trees OLD,.,.,OLD \
        [--index IDX] --out report.json

(on a card: the kernels build at first use). `check_cases` runs the
block-list scan over every block (engine/kernels.dense_scan_body{,_tc}
against dense_scan_body{,_tc}_torch), raw and tc, at T in {1, 2, 3, 4,
8}, N_pad in {1, 157, 7,816} x 128 blocks, M in {1, 16, 64, 254} (and
1,500 and 5,000 on 157 blocks, whose running lists leave shared memory)
and B in {1, 8, 128, 1,024}; the pick (_select_ub_blocks against
_select_ub_blocks_torch) in both bound forms at C in {256, 512, 1,024}
(and small C on 157 blocks, and 65,536 blocks, whose bounds leave shared
memory); and the pruned scan (pruned_scan_body against
pruned_scan_body_torch) at those C; then the grid's edges: queries with
no match, with fewer than M matches, fewer than M + 1 blocks, padded
slots, saturated tf bytes and len codes >= 128 (every tc plane has
them); and the redesign's edges (`edge_cases`): groups whose queries
share every row, none, or repeat a row, B 1 and B 8, every (len code,
tf byte) lane of the tc tables and the tc table kernel itself, equal
and signed-zero bounds, C + 1 = NB, a small group's split pick. Half of the synthetic rows draw their scores from a
few values, so boundary ties are cut at the M-th place and block bounds tie at the
C-th. `check` is the comparison: flags bit-equal on every row; the
kernel's lanes in (score desc, doc asc) order; its kept (doc, f32 score
bits, tfs) equal to the plain version's sorted so, on unflagged rows,
and above the boundary score on flagged ones; the top-M score multiset
equal on every row; blk and next_ub bit-equal. `time_shapes` works at
the engine's shapes on the 1M planes (synthetic, or an engine's own):
the full scan at DENSE_CHUNK (B 128, T 2-4, N_pad 1,000,448, M 64), the
pruned scan at its groups (T 2 at B 1,024, T 3-4 at B 512; C 512, M 64)
and its pick alone; each compared (`check`), then timed in turns with
the plain version (kernel, plain, plain, kernel; CUDA events), once more
after an L2 flush, each launch by torch.profiler, the wrapper's host
cost per call, the peak device memory above the inputs (kernel and
plain), and the bytes bound (`bound_bytes`, the group's distinct rows and
per query).

`--probe [--index IDX]` reads each kernel phase's cycles from a
measuring build's `clock64()` marks (`probe`), on synthetic 1M planes
and, with `--index`, on the engines' own planes.

`--trees` measures each listed tree once, in turns, each in its own
process importing wiser_tpu_torch from that tree (a checkout of another
commit, e.g. unpacked from `git archive`), through
tools/unpack_bench.run_trees: the engine's entry points (dense_scan_body,
pruned_scan_body, _select_ub_blocks: a kernel in this tree, the plain
version in a tree without one) at `time_shapes`'s shapes on synthetic 1M
planes and, with `--index` (a saved 1M index), on that index's own
planes (a TorchEngine's, raw and tc), then route_bench's ROUTES sets,
raw and tc, each traced.
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
NB_1M = 7816  # the 1M index's 128-doc blocks (N_pad 1,000,448)
CHECK_T = (1, 2, 3, 4, 8)
CHECK_NB = (1, 157, NB_1M)
CHECK_M = (1, 16, 64, 254)
CHECK_C = (256, 512, 1024)
# (B, T) of the timed groups: the full scan at DENSE_CHUNK, the pruned
# scan at its lane budget's B buckets (engine/device.py)
FULL_SHAPES = ((128, 2), (128, 3), (128, 4))
PRUNED_SHAPES = ((1024, 2), (512, 3), (512, 4))
TIME_M, TIME_C = 64, 512
# route_bench's sets whose queries take the dense tier on the 1M index
ROUTES = "dense_t3,zipf_t2,zipf_t3,zipf_t4,dense_all_head_pair"
KERNEL_TAG = "wiser_dense::"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_planes(H: int, NB: int, seed: int) -> dict:
    """Dense planes of H rows over NB 128-doc blocks, as numpy arrays:
    raw "sc" f32 scores (0 = absent) and "tf" int32, tc "tf8" uint8
    (3% of present lanes saturated at 255) and the shared "code" uint8
    len-code row (0..255), and the block planes "bm", "bm2" (second max
    with multiplicity), "ap" (argmax lane, uint8) of sc. Row 0 holds only
    even docs and row 1 only odd ones (a query on both matches nothing);
    row 2 is sparse (fewer than M matches); of the rest, every other row
    draws its scores from four values, so sums tie."""
    rng = np.random.default_rng(seed)
    N = NB * 128
    sc = np.zeros((H, N), dtype=np.float32)
    tf = np.zeros((H, N), dtype=np.int32)
    dens = (0.05, 0.3, 0.6, 0.15)
    for h in range(H):
        if h < 2:
            present = (np.arange(N) % 2 == h) & (rng.random(N) < 0.6)
        else:
            present = rng.random(N) < (0.001 if h == 2 else dens[h % 4])
        n = int(present.sum())
        if h % 2:
            vals = rng.integers(1, 5, size=n).astype(np.float32) * 0.5
        else:
            vals = rng.uniform(0.01, 5.0, size=n).astype(np.float32)
        sc[h, present] = vals
        tf[h, present] = rng.integers(1, 40, size=n)
    tf8 = np.minimum(tf, 254).astype(np.uint8)
    tf8[(tf > 0) & (rng.random((H, N)) < 0.03)] = 255
    sc3 = sc.reshape(H, NB, 128)
    if NB:
        top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
        bm, bm2 = top2[:, :, 1].copy(), top2[:, :, 0].copy()
    return {"sc": sc, "tf": tf, "tf8": tf8,
            "code": rng.integers(0, 256, size=N).astype(np.uint8),
            "bm": bm, "bm2": bm2,
            "ap": np.argmax(sc3, axis=2).astype(np.uint8),
            "avg32": np.float32(57.25)}


def synth_slots(B: int, T: int, H: int, seed: int, n_pad_rows: int = 2,
                rows=None) -> dict:
    """(B, T) int32 slots and f32 use_score / idf32 in slot order, as the
    engine assembles them: 1..T distinct real rows (every fourth query
    T), padded slots repeating slot 0 with use 0 and idf 0; the last
    n_pad_rows queries are batch padding (slot 0, weights 0). `rows`:
    explicit rows per query instead."""
    rng = np.random.default_rng(seed)
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    for b in range(B if rows is not None else max(0, B - n_pad_rows)):
        if rows is not None:
            r = list(rows[b % len(rows)])[:T]
        else:
            n = T if b % 4 == 0 else int(rng.integers(1, T + 1))
            r = list(rng.choice(np.arange(3, H), size=min(n, H - 3),
                                replace=False))
        slots[b] = r + [r[0]] * (T - len(r))
        use[b, : len(r)] = 1.0
        idf[b, : len(r)] = rng.uniform(0.1, 8.0, size=len(r))
    return {"slots": slots, "use": use, "idf32": idf}


def to_device(arrays: dict, dev) -> dict:
    import torch

    return {k: (torch.tensor(v, device=dev) if np.ndim(v) == 0 else
                torch.from_numpy(np.ascontiguousarray(v)).to(dev))
            for k, v in arrays.items()}


def weights(t: dict, mode: str):
    return t["idf32"] if mode == "tc" else t["use"]


def full_call(fns, p: dict, q: dict, mode: str, M: int):
    """The full scan through fns = (raw, tc) (the dispatchers or the
    plain versions) on device planes p and slots q."""
    N_pad = p["sc"].shape[1] if mode == "raw" else p["tf8"].shape[1]
    T = q["slots"].shape[1]
    if mode == "tc":
        return fns[1](p["tf8"], p["code"], p["avg32"], q["slots"],
                      q["idf32"], T=T, N_pad=N_pad, M=M)
    return fns[0](p["sc"], p["tf"], q["slots"], q["use"], T=T, N_pad=N_pad,
                  M=M)


def pruned_call(fn, p: dict, q: dict, mode: str, C: int, M: int,
                second: bool = True):
    """pruned_scan_body (or its plain version) on device planes p."""
    T = q["slots"].shape[1]
    NB = p["bm"].shape[1]
    tc = mode == "tc"
    return fn(p["tf8"] if tc else p["sc"], None if tc else p["tf"],
              p["code"] if tc else None, p["avg32"] if tc else None, p["bm"],
              p["bm2"] if second else None, p["ap"] if second else None,
              q["slots"], weights(q, mode), T=T, NB=NB, C=C, M=M)


def pick_call(fn, p: dict, q: dict, mode: str, C: int, second: bool = True):
    """_select_ub_blocks (or its plain version) with the bound's weights
    (use_score raw, idf32 > 0 tc)."""
    T = q["slots"].shape[1]
    w = (q["idf32"] > 0).float() if mode == "tc" else q["use"]
    return fn(p["bm"], q["slots"], w, T=T, NB=p["bm"].shape[1], C=C,
              blockmax2=p["bm2"] if second else None,
              argpos=p["ap"] if second else None)


def _np(out):
    return [o.cpu().numpy() for o in out]


def canon(docs, score, tfs, M: int):
    """Each row's lanes sorted by (score desc, doc asc), cut at M; lanes
    past the kept ones read doc -1, score -inf, tfs 0."""
    T = tfs.shape[1]
    order = np.lexsort((docs, -score), axis=1)[:, :M]
    d = np.take_along_axis(docs, order, axis=1)
    s = np.take_along_axis(score, order, axis=1)
    tf = np.take_along_axis(tfs, order[:, None, :].repeat(T, 1), axis=2)
    kept = s > -np.inf
    return (np.where(kept, d, -1), np.where(kept, s, -np.inf),
            np.where(kept[:, None, :], tf, 0))


def check(kern, plain, M: int, what: str) -> dict:
    """Hold a scan's kernel outputs (top_docs, top_score, tfs, flags[,
    next_ub]) against the plain version's, as the module docstring says;
    raise AssertionError on the first difference. Returns the row counts
    and the largest absolute score difference (0 when exact)."""
    kd, ks, kt, kf = _np(kern[:4])
    pd, ps, pt, pf = _np(plain[:4])
    B = kd.shape[0]
    bad = np.nonzero(kf != pf)[0]
    if len(bad):
        b = bad[0]
        raise AssertionError(f"{what}: flags differ on {len(bad)} rows, "
                             f"first row {b}: kernel {kf[b]} plain {pf[b]}")
    if len(kern) > 4:
        kn, pn = _np(kern[4:5])[0], _np(plain[4:5])[0]
        if not np.array_equal(kn.view(np.int32), pn.view(np.int32)):
            raise AssertionError(f"{what}: next_ub differs")
    cd, cs, ct = canon(kd, ks, kt, M)
    if not (np.array_equal(cd, kd)
            and np.array_equal(cs.view(np.int32), ks.view(np.int32))):
        raise AssertionError(f"{what}: the kernel's lanes are not in "
                             f"(score desc, doc asc) order")
    wd, ws, wt = canon(pd, ps, pt, M)
    flagged = (kf & 1) != 0
    cmp = ~flagged[:, None] | (ws > ws[:, M - 1:M])
    for name, got, want in (("docs", kd, wd),
                            ("score bits", ks.view(np.int32),
                             ws.astype(np.float32).view(np.int32)),
                            ("tfs", kt, wt)):
        mask = cmp if got.ndim == 2 else cmp[:, None, :]
        rows = np.nonzero(((got != want) & mask).reshape(B, -1).any(axis=1))[0]
        if len(rows):
            b = rows[0]
            raise AssertionError(
                f"{what}: {name} differ on {len(rows)} rows, first row {b} "
                f"(flags {kf[b]}): kernel {got[b].ravel()[:8]} plain "
                f"{want[b].ravel()[:8]}")
    if not np.array_equal(np.sort(ks, axis=1), np.sort(ps, axis=1)):
        raise AssertionError(f"{what}: top-M score multisets differ")
    a, b = np.sort(ks, axis=1), np.sort(ps, axis=1)
    fin = np.isfinite(a) & np.isfinite(b)
    return {"rows": B, "flagged": int(flagged.sum()),
            "tf_sat": int(((kf & 4) != 0).sum()),
            "kept": int((ks > -np.inf).sum()),
            "max_abs_err": float(np.abs(a[fin] - b[fin]).max())
            if fin.any() else 0.0}


def check_pick(kern, plain, what: str) -> dict:
    """blk and next_ub bit-equal."""
    kb, kn = _np(kern)
    pb, pn = _np(plain)
    if not np.array_equal(kb, pb):
        rows = np.nonzero((kb != pb).any(axis=1))[0]
        raise AssertionError(f"{what}: blk differs on {len(rows)} rows, "
                             f"first {rows[0]}: kernel {kb[rows[0]][:8]} "
                             f"plain {pb[rows[0]][:8]}")
    if not np.array_equal(kn.view(np.int32), pn.view(np.int32)):
        raise AssertionError(f"{what}: next_ub differs")
    return {"rows": kb.shape[0], "max_abs_err": 0.0}


def _B_for(NB: int, T: int, i: int) -> int:
    """The check grid's batch at NB blocks: 1,024 on 157 blocks at T 2, the
    DENSE_CHUNK 128 on the 1M plane up to T 3, else 1 or 8."""
    if NB == 157 and T == 2:
        return 1024
    if NB == NB_1M and T <= 3:
        return 128
    return 1 if i % 3 == 0 else 8


def check_cases(dev, seed: int = 0, NBs=CHECK_NB, Ts=CHECK_T, Ms=CHECK_M,
                Cs=CHECK_C, H: int = 12) -> dict:
    """Every case of the module docstring's grid through the kernels and
    the plain versions on the CUDA device `dev`. Raises on the first
    difference; returns the totals and each case's counts."""
    from wiser_tpu_torch.engine import kernels as K

    kern_full = (K.dense_scan_body, K.dense_scan_body_tc)
    plain_full = (K.dense_scan_body_torch, K.dense_scan_body_tc_torch)
    cases = []

    def add(row, **kw):
        row.update(kw)
        cases.append(row)

    for NB in NBs:
        p = to_device(synth_planes(H, NB, seed + NB), dev)
        lanes = NB * 128
        for i, T in enumerate(Ts):
            B = _B_for(NB, T, i)
            q = to_device(synth_slots(B, T, H, seed + 7 * T + NB,
                                      n_pad_rows=2 if B >= 8 else 0), dev)
            for mode in ("raw", "tc"):
                M = min(Ms[(i + (mode == "tc")) % len(Ms)], lanes - 1)
                what = f"full {mode} NB={NB} B={B} T={T} M={M}"
                add(check(full_call(kern_full, p, q, mode, M),
                          full_call(plain_full, p, q, mode, M), M, what),
                    kind="full", mode=mode, NB=NB, B=B, T=T, M=M, what=what)
        # the edges: no match (rows 0 and 1), fewer than M matches (the
        # sparse row 2), a padded slot, the largest M
        edge = to_device(synth_slots(4, 3, H, seed, rows=[[0, 1], [2, 3],
                                                          [2], [4, 2, 5]]),
                         dev)
        for mode in ("raw", "tc"):
            M = min(254, lanes - 1)
            what = f"edges {mode} NB={NB} M={M}"
            add(check(full_call(kern_full, p, edge, mode, M),
                      full_call(plain_full, p, edge, mode, M), M, what),
                kind="edges", mode=mode, NB=NB, B=4, T=3, M=M, what=what)
        if NB == 157:
            # running lists past shared memory (KP 2,048 stays in it,
            # 8,192 goes to the scratch), full and over 64 picked blocks
            q = to_device(synth_slots(8, 3, H, seed + 3), dev)
            for mode in ("raw", "tc"):
                for M in (1500, 5000):
                    what = f"large M {mode} NB={NB} M={M}"
                    add(check(full_call(kern_full, p, q, mode, M),
                              full_call(plain_full, p, q, mode, M), M, what),
                        kind="full", mode=mode, NB=NB, B=8, T=3, M=M,
                        what=what)
                what = f"large M pruned {mode} NB={NB} C=64 M=5000"
                add(check(pruned_call(K.pruned_scan_body, p, q, mode, 64,
                                      5000),
                          pruned_call(K.pruned_scan_body_torch, p, q, mode,
                                      64, 5000), 5000, what),
                    kind="pruned", mode=mode, NB=NB, B=8, T=3, C=64, M=5000,
                    what=what)
        picks = [C for C in Cs if C < NB] or [c for c in (16, 64, NB - 1)
                                               if 1 <= c < NB]
        for j, C in enumerate(picks):
            T = Ts[(j + 1) % len(Ts)]
            B = 1024 if (C == 512 and NB == NB_1M) else 8
            q = to_device(synth_slots(B, T, H, seed + C + T), dev)
            for mode in ("raw", "tc"):
                for second in (True, False):
                    what = (f"pick {mode} NB={NB} B={B} T={T} C={C} "
                            f"{'anchor' if second else 'sum'}")
                    add(check_pick(pick_call(K._select_ub_blocks, p, q, mode,
                                             C, second),
                                   pick_call(K._select_ub_blocks_torch, p, q,
                                             mode, C, second), what),
                        kind="pick", mode=mode, NB=NB, B=B, T=T, C=C,
                        what=what)
                M = min(Ms[(j + 2) % len(Ms)], C * 128)
                what = f"pruned {mode} NB={NB} B={B} T={T} C={C} M={M}"
                add(check(pruned_call(K.pruned_scan_body, p, q, mode, C, M),
                          pruned_call(K.pruned_scan_body_torch, p, q, mode, C,
                                      M), M, what),
                    kind="pruned", mode=mode, NB=NB, B=B, T=T, C=C, M=M,
                    what=what)
        del p
    # bounds past the pick's shared memory: 65,536 blocks (a scratch)
    NB = 65536
    rng = np.random.default_rng(seed + NB)
    bm = (rng.integers(0, 6, size=(H, NB)) * 0.5).astype(np.float32)
    bm2 = np.minimum(bm, (rng.integers(0, 6, size=(H, NB)) * 0.5)
                     .astype(np.float32))
    p = to_device({"bm": bm, "bm2": bm2,
                   "ap": rng.integers(0, 128, size=(H, NB)).astype(np.uint8)},
                  dev)
    q = to_device(synth_slots(8, 3, H, seed + 1), dev)
    for second in (True, False):
        what = f"pick scratch NB={NB} C=1024 {'anchor' if second else 'sum'}"
        add(check_pick(pick_call(K._select_ub_blocks, p, q, "raw", 1024,
                                 second),
                       pick_call(K._select_ub_blocks_torch, p, q, "raw", 1024,
                                 second), what),
            kind="pick", mode="raw", NB=NB, B=8, T=3, C=1024, what=what)
    cases += edge_cases(dev, seed, H)
    flagged = sum(c.get("flagged", 0) for c in cases)
    if not flagged:
        raise AssertionError("no case cut a boundary tie (FLAG_TRUNC)")
    return {"cases": len(cases), "flagged_rows": flagged,
            "tf_sat_rows": sum(c.get("tf_sat", 0) for c in cases),
            "kept_lanes": sum(c.get("kept", 0) for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rows": cases}


# the scan's group edges: (name, B, T, rows per query or None for random
# draws)
SCAN_EDGES = (("shared", 8, 2, [[3, 4]]),
              ("disjoint", 4, 2, [[3, 4], [5, 6], [7, 8], [9, 10]]),
              ("repeat", 7, 3, [[5, 5, 6], [6, 5, 5], [3, 3, 3], [4, 7, 4],
                                [8, 9, 10], [5, 6], [11]]),
              ("one", 1, 2, [[3, 4]]),
              ("rescue8", 8, 3, None))


def tc_lane_planes(tft: int, NB: int = 12) -> dict:
    """tc planes whose lanes hold every len code 0..255 against the tf
    bytes 0, 1, tft - 1, tft, 254 and 255 (doc d: code d % 256, row 0's
    tf byte the (d // 256)-th of those), row 1 tf 1 everywhere."""
    N = NB * 128
    tfs = np.array([0, 1, tft - 1, tft, 254, 255], dtype=np.uint8)
    d = np.arange(N)
    tf8 = np.ones((2, N), dtype=np.uint8)
    tf8[0] = tfs[(d // 256) % len(tfs)]
    return {"tf8": tf8, "code": (d % 256).astype(np.uint8),
            "avg32": np.float32(57.25)}


def pick_edge_planes(NB: int = 1000, seed: int = 5) -> dict:
    """Block planes of 3 rows over NB blocks (no multiple of the pick's
    512-thread CTA): row 0 every bound equal (1.0, second maxima 1.0,
    argmax 0), row 1 +1, -1 and 0 mixed (times a weight of 0: bounds +0
    and -0), row 2 drawn from a few values."""
    rng = np.random.default_rng(seed)
    bm = np.ones((3, NB), dtype=np.float32)
    bm[1] = rng.choice(np.array([1.0, -1.0, 0.0], dtype=np.float32), NB)
    bm[2] = rng.integers(0, 4, NB).astype(np.float32) * 0.5
    bm2 = np.minimum(bm, np.float32(0.5))
    ap = np.zeros((3, NB), dtype=np.uint8)
    ap[2] = rng.integers(0, 128, NB)
    return {"bm": bm, "bm2": bm2, "ap": ap}


def edge_cases(dev, seed: int = 0, H: int = 12) -> list:
    """The redesign's edges, each kernel against its plain version: the
    full scan over groups whose queries share every row, none, or repeat
    a row within a query (each row copied once a step), B 1 and the
    rescue's B 8, raw and tc;
    every (len code, tf byte) lane of the tc tables at tf 0, 1, TC_TFT -
    1, TC_TFT, 254 and 255; the pick with every bound equal, +0 and -0
    bounds, C + 1 = NB, NB no multiple of its CTA and B 1, both bound
    forms, and B 1 over the 1M blocks (its bounds split over CTAs)."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import dense as D

    kern_full = (K.dense_scan_body, K.dense_scan_body_tc)
    plain_full = (K.dense_scan_body_torch, K.dense_scan_body_tc_torch)
    cases = []
    p = to_device(synth_planes(H, 157, seed + 157), dev)
    for name, B, T, rows in SCAN_EDGES:
        q = to_device(synth_slots(B, T, H, seed + B + T, rows=rows,
                                  n_pad_rows=0), dev)
        for mode in ("raw", "tc"):
            M = 64 if name != "one" else 254
            what = f"rows {name} {mode} B={B} T={T} M={M}"
            row = check(full_call(kern_full, p, q, mode, M),
                        full_call(plain_full, p, q, mode, M), M, what)
            row.update(kind="rows", mode=mode, NB=157, B=B, T=T, M=M,
                       what=what)
            cases.append(row)
    lp = to_device(tc_lane_planes(D.TC_TFT), dev)
    for rows, M in (([[0]], 1500), ([[0, 1], [1, 0]], 1500), ([[0]], 64)):
        T = len(rows[0])
        q = to_device(synth_slots(len(rows), T, 2, seed, rows=rows,
                                  n_pad_rows=0), dev)
        N_pad = lp["tf8"].shape[1]
        what = f"tc lanes T={T} M={M}"
        args = (lp["tf8"], lp["code"], lp["avg32"], q["slots"], q["idf32"])
        row = check(K.dense_scan_body_tc(*args, T=T, N_pad=N_pad, M=M),
                    K.dense_scan_body_tc_torch(*args, T=T, N_pad=N_pad, M=M),
                    M, what)
        if M == 1500 and row["kept"] != len(rows) * 5 * 256:
            raise AssertionError(f"{what}: {row['kept']} lanes kept, not "
                                 f"every lane with a tf byte")
        row.update(kind="tc_lanes", mode="tc", B=len(rows), T=T, M=M,
                   what=what)
        cases.append(row)
    pp = to_device(pick_edge_planes(), dev)
    NB = pp["bm"].shape[1]
    picks = (("equal", [[0]], [[1.0]]), ("signed_zero", [[1]], [[0.0]]),
             ("mixed", [[1, 2], [2, 0], [0, 2]], [[0.0, 1.0], [1.0, 1.0],
                                                  [1.0, 0.0]]))
    for name, rows, w in picks:
        for C in (1, 300, NB - 1):
            for second in (True, False):
                slots = torch.tensor(rows, dtype=torch.int32, device=dev)
                ws = torch.tensor(w, dtype=torch.float32, device=dev)
                kw = dict(T=slots.shape[1], NB=NB, C=C,
                          blockmax2=pp["bm2"] if second else None,
                          argpos=pp["ap"] if second else None)
                what = (f"pick {name} B={len(rows)} C={C} "
                        f"{'anchor' if second else 'sum'}")
                row = check_pick(K._select_ub_blocks(pp["bm"], slots, ws,
                                                     **kw),
                                 K._select_ub_blocks_torch(pp["bm"], slots,
                                                           ws, **kw), what)
                row.update(kind="pick_edge", mode="raw", NB=NB,
                           B=len(rows), C=C, what=what)
                cases.append(row)
    for avg in (1.0, 57.25, 312.7):
        a32 = torch.tensor([avg], dtype=torch.float32, device=dev)
        got, want = D.tc_table(a32).cpu().numpy(), D.tc_table_torch(
            a32).cpu().numpy()
        what = f"tc table avg={avg}"
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"{what}: differs from the plain table")
        cases.append({"kind": "tc_table", "mode": "tc", "what": what,
                      "rows": 256, "max_abs_err": 0.0})
    p1 = to_device(synth_planes(H, NB_1M, seed + 1), dev)
    q = to_device(synth_slots(1, 3, H, seed + 2, n_pad_rows=0), dev)
    for mode in ("raw", "tc"):
        what = f"pick split {mode} B=1 NB={NB_1M} C=512"
        row = check_pick(pick_call(K._select_ub_blocks, p1, q, mode, 512),
                         pick_call(K._select_ub_blocks_torch, p1, q, mode,
                                   512), what)
        row.update(kind="pick_edge", mode=mode, NB=NB_1M, B=1, C=512,
                   what=what)
        cases.append(row)
    return cases


def time_tc_table(dev, avg: float = 57.25, iters: int = 20) -> dict:
    """The tc table kernel alone against its plain version (bit-equal
    first): the kernel's own device time by torch.profiler (CUDA events
    around the calls where the capture lost it), the plain version's by
    CUDA events; its bound: the table written and avg32 read."""
    import torch

    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.search_bench import event_ms, host_us

    a32 = torch.tensor([avg], dtype=torch.float32, device=dev)
    got, want = D.tc_table(a32), D.tc_table_torch(a32)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("tc table differs from the plain table")
    nbytes = 4 * 256 * 256 + 4
    own = launch_ms(lambda: D.tc_table(a32))["kernels"].get("tc_norm_kernel")
    return {"ms": own if own is not None
            else event_ms(lambda: D.tc_table(a32), iters),
            "timing": "torch.profiler" if own is not None else "CUDA events",
            "plain_ms": event_ms(lambda: D.tc_table_torch(a32), iters),
            "host_us": host_us(lambda: D.tc_table(a32), iters),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0.0,
            "shape": "(256, 256) f32"}


def bound_bytes(slots, mode: str, N_pad: int, M: int, kept: int = None,
                blocks=None, per_query: bool = False) -> int:
    """The bytes the scan must move, each once: the (row, block) payload
    its queries read (4 B a lane raw, 1 B tc; the len-code row's blocks
    once, tc), distinct over the group (per_query: counted per query),
    the block list (8 B a block), the (B, T) slots and weights, the
    winners' tf loads (4 B raw, 1 B tc a slot; `kept` lanes, else B * M),
    and the outputs written (docs, scores, tfs, the flag word)."""
    slots = np.asarray(slots, dtype=np.int64)
    B, T = slots.shape
    NB = N_pad // 128
    lane_b = 4 if mode == "raw" else 1
    if blocks is None:
        blk = np.broadcast_to(np.arange(NB), (B, NB))
    else:
        blk = np.asarray(blocks, dtype=np.int64)
        total_list = blk.size * 8
    pairs = (slots[:, :, None] * NB + blk[:, None, :]).reshape(B, -1)
    if per_query:
        n_pairs = sum(len(np.unique(r)) for r in pairs)
        n_code = B * blk.shape[1]
    else:
        n_pairs = len(np.unique(pairs))
        n_code = len(np.unique(blk))
    total = n_pairs * 128 * lane_b
    if mode == "tc":
        total += n_code * 128
    if blocks is not None:
        total += total_list
    total += B * T * 8
    total += (B * M if kept is None else kept) * T * lane_b
    total += B * (2 * M + T * M + 1) * 4
    return int(total)


def pick_bound_bytes(slots, NB: int, C: int, second: bool = True,
                     per_query: bool = False) -> int:
    """The bytes the pick must move, each once: each slot's blockmax row
    (and blockmax2 and argpos, 9 B a block), distinct over the group
    (per_query: per query), the (B, T) slots and weights, and the (B, C)
    int64 ids and (B,) next_ub written."""
    slots = np.asarray(slots, dtype=np.int64)
    B, T = slots.shape
    rows = (sum(len(np.unique(r)) for r in slots) if per_query
            else len(np.unique(slots)))
    return int(rows * NB * (9 if second else 4) + B * T * 8 + B * C * 8
               + B * 4)


def launch_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each device kernel fn() launches:
    torch.profiler (utils.trace) over `calls` calls after a warm one.
    `kernels` holds this library's kernels (wiser_dense::) by name, each
    the mean of its newest `calls` events (None with fewer, after three
    captures); `total` sums them (None where one is None or none ran);
    `all_ms` is every device event of the window a call (the plain
    version's kernels too); `events` counts each name's events."""
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
        for name in sorted({n for *_, n in events if KERNEL_TAG in n}):
            mine = [b - a for a, b, n in events if n == name]
            key = name.split(KERNEL_TAG)[1].split("(")[0]
            out["events"][key] = len(mine)
            out["kernels"][key] = (sum(mine[-calls:]) / 1e3 / calls
                                   if len(mine) >= calls else None)
        vals = list(out["kernels"].values())
        out["total"] = sum(vals) if vals and None not in vals else None
        if None not in vals:
            break
    return out


def peak_extra(fn) -> int:
    """Device bytes fn() allocates at its peak above what was allocated
    before it (its outputs included)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return int(extra)


def planes_1m(dev, seed: int = 1, H: int = 64) -> dict:
    """Synthetic planes at the 1M index's width (NB_1M blocks), on dev."""
    return to_device(synth_planes(H, NB_1M, seed), dev)


def engine_planes(eng) -> dict:
    """A TorchEngine's own dense planes in time_shapes's keys."""
    p = {"bm": eng.d_dense_blockmax, "bm2": eng.d_dense_blockmax2,
         "ap": eng.d_dense_argpos}
    if eng.tc:
        p.update(tf8=eng.d_dense_tf8, code=eng.d_len_code,
                 avg32=eng.d_avg32)
    else:
        p.update(sc=eng.d_dense_sc, tf=eng.d_dense_tf)
    return p


def _time(kern, plain, iters: int, plain_iters: int, with_plain: bool):
    """Kernel and plain version in turns (kernel, plain, plain, kernel),
    the kernel after an L2 flush, its host cost and launches (the timers
    of tools/search_bench)."""
    from wiser_tpu_torch.tools.search_bench import (event_ms, flushed_ms,
                                                     host_us)

    k1 = event_ms(kern, iters)
    p = [event_ms(plain, plain_iters), event_ms(plain, plain_iters)] \
        if with_plain else []
    k2 = event_ms(kern, iters)
    split = launch_ms(kern)
    return {"event_ms": [k1, k2], "plain_ms": p,
            "device_ms": split["total"] or min(k1, k2),
            "flushed_ms": flushed_ms(kern, iters),
            "host_us": host_us(kern, iters), "launch_ms": split,
            "launches_per_call": sum(split["events"].values())
            / split["calls"]}


def time_shapes(dev, mode: str = "raw", planes=None, M: int = TIME_M,
                C: int = TIME_C, full=FULL_SHAPES, pruned=PRUNED_SHAPES,
                iters: int = 10, plain_iters: int = 3, seed: int = 1,
                plain: bool = True, compare: bool = True) -> list:
    """The kernels and their plain versions at the engine's shapes on
    `planes` (device tensors in synth_planes's keys for `mode`; default
    synthetic 1M planes): the full scan at each (B, T) of `full`, the
    pruned scan and its pick alone at each of `pruned`. Each compared
    (`check`, `check_pick`; compare=False skips it), timed (`_time`), its
    peak memory above the inputs and its bytes bound. plain=False: the
    entry points alone (the kernel, or in a tree without one its plain
    version), timed without a plain column."""
    import torch

    from wiser_tpu_torch.engine import kernels as K

    p = planes if planes is not None else planes_1m(dev, seed)
    H = p["bm"].shape[0]
    NB = p["bm"].shape[1]
    N_pad = NB * 128
    kern_full = (K.dense_scan_body, K.dense_scan_body_tc)
    plain_full = (getattr(K, "dense_scan_body_torch", None),
                  getattr(K, "dense_scan_body_tc_torch", None))
    pick_plain = getattr(K, "_select_ub_blocks_torch", None)
    pruned_plain = getattr(K, "pruned_scan_body_torch", None)
    rows = []

    def record(row, kern, plain_fn, nbytes, nbytes_q):
        t = _time(kern, plain_fn, iters, plain_iters, plain)
        row.update(t)
        row.update(bytes=nbytes, bytes_per_query=nbytes_q,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_ms_per_query=nbytes_q / HBM_BYTES_PER_S * 1e3)
        row["share"] = row["bound_ms"] / row["device_ms"]
        row["share_per_query"] = row["bound_ms_per_query"] / row["device_ms"]
        row["flushed_share"] = row["bound_ms"] / row["flushed_ms"]
        row["peak_extra"] = {"kernel": peak_extra(kern)}
        if plain:
            row["peak_extra"]["plain"] = peak_extra(plain_fn)
            row["speedup"] = min(row["plain_ms"]) / row["device_ms"]
        log(f"dense timing {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()

    for B, T in full:
        q = to_device(synth_slots(B, T, H, seed + B + T, n_pad_rows=0), dev)

        def kern(q=q):
            return full_call(kern_full, p, q, mode, M)

        def plain_fn(q=q):
            return full_call(plain_full, p, q, mode, M)

        row = {"kind": "full", "mode": mode, "B": B, "T": T, "N_pad": N_pad,
               "M": M}
        out = kern()
        if compare:
            row["check"] = check(out, plain_fn(), M,
                                 f"{mode} full B={B} T={T}")
        kept = int((out[0] >= 0).sum())
        s = q["slots"].cpu().numpy()
        record(row, kern, plain_fn,
               bound_bytes(s, mode, N_pad, M, kept),
               bound_bytes(s, mode, N_pad, M, kept, per_query=True))
    for B, T in pruned:
        q = to_device(synth_slots(B, T, H, seed + B + T, n_pad_rows=0), dev)

        def kern(q=q):
            return pruned_call(K.pruned_scan_body, p, q, mode, C, M)

        def plain_fn(q=q):
            return pruned_call(pruned_plain, p, q, mode, C, M)

        def pick(q=q):
            return pick_call(K._select_ub_blocks, p, q, mode, C)

        def pick_plain_fn(q=q):
            return pick_call(pick_plain, p, q, mode, C)

        s = q["slots"].cpu().numpy()
        row = {"kind": "pick", "mode": mode, "B": B, "T": T, "NB": NB, "C": C}
        blk = pick()[0]
        if compare:
            row["check"] = check_pick(pick(), pick_plain_fn(),
                                      f"{mode} pick B={B} T={T}")
        record(row, pick, pick_plain_fn, pick_bound_bytes(s, NB, C),
               pick_bound_bytes(s, NB, C, per_query=True))
        row = {"kind": "pruned", "mode": mode, "B": B, "T": T, "NB": NB,
               "C": C, "M": M}
        out = kern()
        if compare:
            row["check"] = check(out, plain_fn(), M,
                                 f"{mode} pruned B={B} T={T}")
        kept = int((out[0] >= 0).sum())
        b = blk.cpu().numpy()
        record(row, kern, plain_fn,
               bound_bytes(s, mode, N_pad, M, kept, blocks=b)
               + pick_bound_bytes(s, NB, C),
               bound_bytes(s, mode, N_pad, M, kept, blocks=b, per_query=True)
               + pick_bound_bytes(s, NB, C, per_query=True))
    return rows


# the phase marks of dense.cu's measuring build (WISER_DENSE_CLOCKS):
# counter index -> phase; scan counters 0-5 over the CTAs in 6, pick
# counters 8-11 over the selecting CTAs in 12
SCAN_PHASES = ("prologue", "load", "score", "barrier", "flush", "epilogue")
PICK_PHASES = ("bounds", "gather", "select", "compact")


def clocks_build() -> object:
    """dense.cu built with -DWISER_DENSE_CLOCKS (a measuring build beside
    the library the entry points load), bound as ops/dense._Fns, with its
    `clocks` reader."""
    import ctypes

    from wiser_tpu_torch import build
    from wiser_tpu_torch.ops import dense as D

    flags = (build.NVCC_FLAGS + build.EXTRA_NVCC_FLAGS["dense"]
             + ("-DWISER_DENSE_CLOCKS",))
    lib = build._load("dense_clocks", os.path.join(build.CSRC, "dense.cu"),
                      flags, lambda src, out: [build._nvcc(), *flags, "-o",
                                               out, src])
    fns = D._Fns(lib)
    fns.clocks = lib.wiser_dense_clocks
    fns.clocks.argtypes = [ctypes.c_void_p]
    fns.clocks.restype = ctypes.c_int
    return fns


def _bind(fns) -> None:
    """Point ops/dense's entry points at the kernel library fns (and its
    occupancy)."""
    from wiser_tpu_torch.ops import dense as D

    D._fns = fns
    D._resident.cache_clear()


def read_clocks(fns) -> list:
    import ctypes

    import torch

    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    rc = fns.clocks(ctypes.addressof(buf))
    if rc:
        raise RuntimeError(f"wiser_dense_clocks: {rc}")
    return list(buf)


def phase_split(fn, fns, calls: int = 3) -> dict:
    """Each phase's cycles a CTA (thread 0's view) over `calls` calls of
    fn() in the measuring build fns: the scan's and the pick's phases, and
    each phase's share of its kernel's total."""
    fn()
    read_clocks(fns)
    for _ in range(calls):
        fn()
    c = read_clocks(fns)
    out = {}
    for names, first, n_at in ((SCAN_PHASES, 0, 6), (PICK_PHASES, 8, 12)):
        if not c[n_at]:
            continue
        cyc = {k: c[first + i] / c[n_at] for i, k in enumerate(names)}
        tot = sum(cyc.values())
        out["scan" if first == 0 else "pick"] = {
            "ctas_a_call": c[n_at] / calls, "cycles_a_cta": cyc,
            "share": {k: v / tot for k, v in cyc.items()},
            # scan: key flushes a CTA; pick: select passes and early
            # rankings a selecting CTA
            "counts": ({"flushes": c[7] / c[n_at]} if first == 0 else
                       {"passes": c[13] / c[n_at],
                        "ranked": c[14] / c[n_at]})}
    return out


def probe(dev, planes=None, modes=("raw", "tc"), full=FULL_SHAPES,
          pruned=PRUNED_SHAPES, M: int = TIME_M, C: int = TIME_C,
          iters: int = 10, seed: int = 1) -> list:
    """Each kernel phase's cycles by clock64() marks (the measuring
    build) at the full scan's shapes and at the pruned scan's with its
    pick, on `planes` (default synthetic 1M planes) in `modes`, each
    beside its event-timed ms in that build. The entry points use the
    library they loaded again afterwards."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.search_bench import event_ms

    p = planes if planes is not None else planes_1m(dev, seed)
    H = p["bm"].shape[0]
    qs = {(B, T): to_device(synth_slots(B, T, H, seed + B + T, n_pad_rows=0),
                            dev) for B, T in full + pruned}
    kern_full = (K.dense_scan_body, K.dense_scan_body_tc)
    rows = []
    loaded = D._kernel_fns()
    fns = clocks_build()
    try:
        _bind(fns)
        for mode in modes:
            for kind, shapes in (("full", full), ("pruned", pruned)):
                for B, T in shapes:
                    q = qs[(B, T)]
                    if kind == "full":
                        def fn(q=q, mode=mode):
                            return full_call(kern_full, p, q, mode, M)
                    else:
                        def fn(q=q, mode=mode):
                            return pruned_call(K.pruned_scan_body, p, q,
                                               mode, C, M)
                    rows.append(dict(kind=kind, mode=mode, B=B, T=T,
                                     ms=event_ms(fn, iters),
                                     **phase_split(fn, fns)))
    finally:
        _bind(loaded)
        torch.cuda.empty_cache()
    for row in rows:
        log(f"dense probe {json.dumps(row)}")
    return rows


def measure(root: str, index=None, routes: str = ROUTES) -> dict:
    """One tree's readings, in this process: its entry points at
    time_shapes's shapes, raw and tc (no plain times, no comparison), on
    synthetic 1M planes and, given a saved index, on a TorchEngine's own
    planes of it in each column mode; then route_bench's `routes` raw and
    tc, each set traced."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools.unpack_bench import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("dense_bench measures a card: none is available")
    dev = torch.device("cuda", 0)
    p = planes_1m(dev)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(K.__file__),
           "timing": {m: time_shapes(dev, m, planes=p, plain=False,
                                     compare=False)
                      for m in ("raw", "tc")}}
    del p
    torch.cuda.empty_cache()
    if index:
        from wiser_tpu_torch import TorchEngine
        from wiser_tpu_torch.index.format import PackedIndex
        from wiser_tpu_torch.tools import route_bench as RB

        packed = PackedIndex.load(index, skip_offsets=True)
        out["engine_timing"] = {}
        for columns in ("raw", "tc"):
            eng = TorchEngine(packed, device="cuda", columns=columns)
            out["engine_timing"][columns] = time_shapes(
                dev, columns, planes=engine_planes(eng), plain=False,
                compare=False)
            del eng
            torch.cuda.empty_cache()
        del packed
        out["routes"] = {}
        for columns in ("raw", "tc"):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "routes.json")
                RB.main(["--index", index, "--columns", columns,
                         "--n-queries", "2048", "--routes", routes,
                         "--trace", tmp, "--out", path])
                with open(path) as f:
                    out["routes"][columns] = json.load(f)["routes"]
    return out


def summary(runs: list) -> dict:
    """Per run: each shape's [device ms, flushed ms, host us, bound
    share] (on the index's planes: keys prefixed engine_), and each route
    set's [untraced wall s, traced device busy ms, device ms of the dense
    kernels in the traced pass, busy share]."""
    res = []
    for r in runs:
        s = {"tree": r["tree"], "card": r["card"]}
        for prefix, timing in (("", r["timing"]),
                               ("engine_", r.get("engine_timing", {}))):
            for mode, rows in timing.items():
                for x in rows:
                    s[f"{prefix}{x['kind']}_{mode}_B{x['B']}_T{x['T']}"] = [
                        x["device_ms"], x["flushed_ms"], x["host_us"],
                        x["share"]]
        for columns, sets in r.get("routes", {}).items():
            for name, row in sets.items():
                traced = row.get("traced") or {}
                kern_ms = sum(op["self_ms"] for op in traced.get("top_ops", [])
                              if KERNEL_TAG in op["kernel"])
                s[f"{columns}_{name}"] = [row.get("wall_s"),
                                          traced.get("device_busy_ms"),
                                          kern_ms, traced.get("busy_share")]
        res.append(s)
    return {"dense_bench": res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-check", action="store_true")
    ap.add_argument("--trees", default=None,
                    help="comma-separated trees, measured in turns")
    ap.add_argument("--root", help="measure this tree in this process")
    ap.add_argument("--index", help="a saved 1M index for route_bench's sets")
    ap.add_argument("--routes", default=ROUTES)
    ap.add_argument("--probe", action="store_true",
                    help="each kernel phase's cycles (clock64() marks)")
    args = ap.parse_args(argv)
    if args.root:
        res = measure(args.root, args.index, args.routes)
        print(json.dumps(res), flush=True)
        return res
    if args.trees:
        from wiser_tpu_torch.tools.unpack_bench import run_trees

        extra = ["--routes", args.routes]
        if args.index:
            extra += ["--index", os.path.abspath(args.index)]
        res = {"runs": run_trees(__file__, args.trees.split(","), extra)}
        print(json.dumps(summary(res["runs"])), flush=True)
    else:
        import torch

        from wiser_tpu_torch.build import build_log
        from wiser_tpu_torch.ops import dense as D
        from wiser_tpu_torch.runtime import resolve_device
        from wiser_tpu_torch.tools.unpack_bench import card_line

        dev = resolve_device("cuda")
        res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
        D._kernel_fns()
        res["build_s"], compiler = build_log["dense"]
        log(compiler)
        if not args.skip_check:
            t0 = time.perf_counter()
            res["check"] = check_cases(dev)
            res["check"].pop("rows")
            res["check"]["wall_s"] = time.perf_counter() - t0
            log(f"dense check: {res['check']}")
        if args.probe and args.index:
            # each column mode on a TorchEngine's own planes of the
            # index, then the synthetic planes
            from wiser_tpu_torch import TorchEngine
            from wiser_tpu_torch.index.format import PackedIndex

            packed = PackedIndex.load(args.index, skip_offsets=True)
            res["probe"] = {}
            for columns in ("raw", "tc"):
                eng = TorchEngine(packed, device="cuda", columns=columns)
                res["probe"][columns] = probe(
                    dev, planes=engine_planes(eng), modes=(columns,))
                del eng
                torch.cuda.empty_cache()
            res["probe"]["synthetic"] = probe(dev)
        elif args.probe:
            res["probe"] = probe(dev)
        else:
            res["timing"] = {m: time_shapes(dev, m) for m in ("raw", "tc")}
        print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
