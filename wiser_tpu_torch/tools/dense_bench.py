"""The dense head-term tier's kernels (ops/dense.py, csrc/dense.cu) held
against their plain torch versions on synthetic dense planes, and timed
beside them at the engine's shapes.

    python -m wiser_tpu_torch.tools.dense_bench [--out report.json]
    python -m wiser_tpu_torch.tools.dense_bench --probe [--index IDX]
    python -m wiser_tpu_torch.tools.dense_bench --phrase --tune [--index IDX] \
        [--out r.json]
    python -m wiser_tpu_torch.tools.dense_bench --phrase [--probe] \
        [--index IDX]
    python -m wiser_tpu_torch.tools.dense_bench --trees OLD,.,.,OLD \
        [--index IDX] [--routes phrase_mega --parts phrase] --out report.json

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
and, with `--index`, on the engines' own planes. Its machinery
(`clocks_build`, `read_clocks`, `phase_split` with a library's counter
groups) builds and reads the semidense and phrase route libraries'
measuring builds too (semidense_bench and phrase_bench `--probe`).

`--phrase` does the same for the full-scan mega phrase's passes
(full_phrase_select and full_phrase_band against their plain versions):
`check_phrase_cases` (the selection's lanes and score bits, every band
word), `time_phrase_shapes` at PHRASE_SHAPES and KV 1,024 and 4,096
(the band where no row needs it and where every needing row streams),
with `--index` on the engines' planes and `phrase_mega_set`
(route_bench's phrase_mega set from the index's mined pairs: traced
device time, the set's and a mega group's peak memory); `--probe` the
selection's phase cycles (`probe_phrase`).

`--trees` measures each listed tree once, in turns, each in its own
process importing wiser_tpu_torch from that tree (a checkout of another
commit, e.g. unpacked from `git archive`), through
tools/unpack_bench.run_trees: the engine's entry points (dense_scan_body,
pruned_scan_body, _select_ub_blocks: a kernel in this tree, the plain
version in a tree without one) at `time_shapes`'s shapes on synthetic 1M
planes and, with `--index` (a saved 1M index), on that index's own
planes (a TorchEngine's, raw and tc), then route_bench's ROUTES sets,
raw and tc, each traced; with `--parts phrase` the phrase's passes
instead (a tree without them times none) and `--routes phrase_mega`
the phrase_mega set (`phrase_mega_set`).
"""

from __future__ import annotations

import argparse
import contextlib
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


def _record(rows: list, row: dict, kern, plain_fn, nbytes: int,
            nbytes_q: int, iters: int, plain_iters: int, plain: bool,
            what: str) -> None:
    """Time kern (and plain_fn) at a timed shape (`_time`), its peak
    memory above the inputs and its bytes bound (the group's, and per
    query), into row; log it and append it to rows."""
    import torch

    row.update(_time(kern, plain_fn, iters, plain_iters, plain))
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
    log(f"{what} timing {json.dumps(row)}")
    rows.append(row)
    torch.cuda.empty_cache()


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
        _record(rows, row, kern, plain_fn, nbytes, nbytes_q, iters,
                plain_iters, plain, "dense")

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


# -- the full-scan mega phrase's passes ---------------------------------------

# the phrase's timed groups (B, T) at KV 1,024 and the rescue's 4,096:
# the mega phrase's chunk on the 1M index is B 128 (engine/device.py's
# lane budget), smaller groups where fewer mega phrases meet
PHRASE_SHAPES = ((8, 2), (32, 2), (128, 2), (128, 3))
PHRASE_KVS = (1024, 4096)
PHRASE_EPS3 = 3e-6


def phrase_slots(B: int, T: int, H: int, seed: int, n_pad_rows: int = 1,
                 rows=None) -> dict:
    """(B, T) int32 slots and f32 weights of a phrase group, as the engine
    assembles them: T real rows a query (every slot a term, query-term
    order; drawn from rows 3.. without repeats, or `rows`), use 1 and idf
    0.1-8; the last n_pad_rows queries are batch padding (slot 0, weights
    0: they match nothing)."""
    rng = np.random.default_rng(seed)
    slots = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    for b in range(max(0, B - n_pad_rows) if rows is None else B):
        r = (list(rows[b % len(rows)]) if rows is not None else
             list(rng.choice(np.arange(3, H), size=T, replace=T > H - 3)))
        slots[b] = r
        use[b] = 1.0
        idf[b] = rng.uniform(0.1, 8.0, size=T)
    return {"slots": slots, "use": use, "idf32": idf}


def _phrase_args(p: dict, q: dict, mode: str, KV: int):
    """(plane, slots, weights) and the keywords of the phrase's passes."""
    tc = mode == "tc"
    plane = p["tf8"] if tc else p["sc"]
    kw = dict(T=q["slots"].shape[1], N_pad=plane.shape[1], KV=KV)
    if tc:
        kw.update(len_code=p["code"], avg32=p["avg32"])
    return (plane, q["slots"], weights(q, mode)), kw


@contextlib.contextmanager
def forced_path(path):
    """ops/dense.select_path answers `path` ("one" or "two"; None: its
    own rule) while the block runs, restored after."""
    from wiser_tpu_torch.ops import dense as D

    rule = D.select_path
    if path is not None:
        D.select_path = lambda B, NB, KV: path
    try:
        yield
    finally:
        D.select_path = rule


def select_call(plain: bool, p: dict, q: dict, mode: str, KV: int,
                path=None):
    """full_phrase_select (the kernels on a card; `path` forces
    ops/dense.select_path's answer there, forced_path) or its plain
    version, as (top_cs, top_cl, bkeys): the selection's block keys for
    the listed band, None where the path took one pass, for the plain
    version, or in a tree whose selection returns two outputs."""
    from wiser_tpu_torch.engine import kernels as K

    args, kw = _phrase_args(p, q, mode, KV)
    if not plain:
        with forced_path(path):
            sel = tuple(K.full_phrase_select(*args, **kw))
        return sel if len(sel) == 3 else sel + (None,)
    rows_f32, _ = K._phrase_rows(*args, len_code=kw.get("len_code"),
                                 avg32=kw.get("avg32"))
    return K.full_phrase_select_torch(rows_f32, T=kw["T"],
                                      N_pad=kw["N_pad"], KV=KV) + (None,)


def band_call(plain: bool, p: dict, q: dict, mode: str, KV: int, sel, thr,
              kth_doc=None, bkeys=None):
    """full_phrase_band (the kernel on a card: with the selection's block
    keys bkeys the listed band, else the stream over every block) or its
    plain version, on the selection sel = (top_cs, top_cl[, bkeys]): the
    keys passed are bkeys, not sel's."""
    from wiser_tpu_torch.engine import kernels as K

    args, kw = _phrase_args(p, q, mode, KV)
    kth = kth_doc if mode == "tc" else None
    if not plain:
        if bkeys is not None:
            kw["bkeys"] = bkeys
        return K.full_phrase_band(*args, *sel[:2], thr, kth_doc=kth, **kw)
    rows_f32, payload = K._phrase_rows(*args, len_code=kw.get("len_code"),
                                       avg32=kw.get("avg32"))
    return K.full_phrase_band_torch(rows_f32, sel[1], thr, T=kw["T"],
                                    N_pad=kw["N_pad"], KV=KV,
                                    rows_payload=payload, kth_doc=kth)


def check_select(kern, plain, KV: int, what: str) -> dict:
    """The selections bit-equal at every place: score bits and lanes (the
    canonical top KV + 1 on both sides, ops/dense.py), in (score desc,
    lane asc) order, -inf and -1 past the matched lanes. Either may carry
    its block keys third (select_call), which are not compared."""
    ks_, kl = _np(kern[:2])
    ps, pl = _np(plain[:2])
    for name, got, want in (("score bits", ks_.view(np.int32),
                             ps.view(np.int32)), ("lanes", kl, pl)):
        rows = np.nonzero((got != want).any(axis=1))[0]
        if len(rows):
            b = rows[0]
            raise AssertionError(
                f"{what}: {name} differ on {len(rows)} rows, first row {b}: "
                f"kernel {got[b][:8]} plain {want[b][:8]}")
    order = np.lexsort((np.where(kl >= 0, kl, 1 << 31), -ks_), axis=1)
    if not np.array_equal(order, np.broadcast_to(np.arange(kl.shape[1]),
                                                 kl.shape)):
        raise AssertionError(f"{what}: not in (score desc, lane asc) order")
    fin = np.isfinite(ks_[:, KV])
    return {"rows": kl.shape[0], "kept": int((kl >= 0).sum()),
            "full_rows": int(fin.sum()), "max_abs_err": 0.0}


def key_scores(bkeys):
    """(scores, valid) of the sweep's (B, NB) block keys as numpy: each
    key's f32 score (keys.cuh tile_key_score) and whether it is a match
    (key 0: a block with no matched lane)."""
    k = bkeys.cpu().numpy().view(np.uint64)
    u = (k >> np.uint64(32)).astype(np.uint32)
    bits = np.where(u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF),
                    ~u).astype(np.uint32)
    bits = np.where((k & np.uint64(1)) != 0, np.uint32(0x80000000), bits)
    return bits.view(np.float32), k != 0


def listed_blocks(bkeys, thr) -> np.ndarray:
    """(B,) the blocks the listed band streams for each query: those whose
    sweep key is a match scoring at least thr."""
    sc, valid = key_scores(bkeys)
    t = thr.cpu().numpy().astype(np.float32)
    return (valid & (sc >= t[:, None])).sum(axis=1)


def band_bound_bytes(slots, mode: str, N_pad: int, K: int, need, hit,
                     listed=None, per_query: bool = False) -> int:
    """The band pass's least bytes: phrase_bound_bytes with the lanes it
    must read, none for a row that does not need the band, one for a row
    that flags, and for a needing row that finds nothing every lane, or,
    listed ((B,) listed_blocks), its listed blocks' lanes and its NB block
    keys."""
    need = np.asarray(need, dtype=bool)
    hit = np.asarray(hit, dtype=bool)
    rest = np.full(len(need), N_pad) if listed is None \
        else np.asarray(listed) * 128
    lanes = np.where(need, np.where(hit, 1, rest), 0)
    keys = 0 if listed is None else int((need & ~hit).sum()) * (N_pad // 128) * 8
    return phrase_bound_bytes(slots, mode, N_pad, K, per_query,
                              lanes=lanes) + keys


def band_cases(sel, mode: str, N_pad: int):
    """(name, thr, kth_doc) cases of the band on a selection (device
    tensors): thr past every (KV+1)-th score (no row needs the band), at
    it (every full row does), just under it and far under it; tc also
    with the k-th doc at the (KV+1)-th lane itself (its payload tie: the
    stream runs), at doc 0 and past the last doc."""
    import torch

    cs, cl = sel[:2]
    unseen = cs[:, -1]
    fin = torch.isfinite(unseen)
    top = unseen[fin].max() if bool(fin.any()) else torch.tensor(1.0)
    base = {"skip": torch.full_like(unseen, float(top) * 2 + 1),
            "at": torch.where(fin, unseen, 1.0),
            "under": torch.where(fin, unseen * 0.999, 1.0),
            "far": torch.full_like(unseen, 1e-3)}
    kths = {"lane0": torch.zeros_like(cl[:, 0])}
    if mode == "tc":
        kths = {"kv1": cl[:, -1].clamp(min=0).contiguous(),
                "lane0": kths["lane0"],
                "past": torch.full_like(cl[:, 0], N_pad + 5)}
    return [(f"{t}/{k}", thr.contiguous(), kd)
            for t, thr in base.items() for k, kd in kths.items()]


def check_phrase_cases(dev, seed: int = 0, H: int = 12,
                       NBs=(1, 157, NB_1M)) -> dict:
    """The phrase's kernels against their plain versions on the CUDA
    device `dev`: the selection (check_select) raw and tc at T 2 and 3,
    KV 1,024 and 4,096 (reduced to the lane set), over 1, 157 and 7,816
    blocks (B 128 and 32 on the 1M planes, 8 below), then T 8 and the
    edge rows (a repeated row, disjoint rows, a sparse row, batch
    padding); each selection also by the path its plan did not take
    (ops/dense.select_path: the one pass, and threshold first wherever
    the doc space has K blocks); the band word bit-equal on each
    selection at every band_cases case, run as the engine runs it (tc
    listed by the selection's block keys where it gave them, else over
    every block); the band's stream on tc planes of
    one payload (it reads every lane and finds nothing) with a lane of
    another payload at the last doc (it finds it at its last step); and
    planes of one score in every lane of 2,048 blocks, raw and tc, B 1
    and 8, KV 1,024 by both paths and the rescue's 4,096 in one pass
    (every block key ties at kappa's score, so the lowest docs decide). Raises on the
    first difference; returns the totals and each case's counts."""
    import torch

    from wiser_tpu_torch.ops import dense as D

    cases = []
    rows_need = [0, 0]

    def one(p, q, mode, KV, what, **kw):
        *sel, bk = select_call(False, p, q, mode, KV)
        want = select_call(True, p, q, mode, KV)
        row = check_select(sel, want, KV, what)
        # the path the plan did not take, where the doc space allows it
        NB = (p["tf8"] if mode == "tc" else p["sc"]).shape[1] // 128
        taken = D.select_path(q["slots"].shape[0], NB, KV)
        for path in ("one", "two"):
            if path != taken and (path == "one" or NB >= KV + 1):
                check_select(select_call(False, p, q, mode, KV, path), want,
                             KV, f"{what} path {path}")
                row[f"path_{path}"] = True
        N_pad = (p["tf8"] if mode == "tc" else p["sc"]).shape[1]
        for name, thr, kd in band_cases(sel, mode, N_pad):
            # as the engine runs it: listed where the selection gave
            # block keys (tc; a raw row takes none), else every block
            want = band_call(True, p, q, mode, KV, sel, thr, kd)
            got = band_call(False, p, q, mode, KV, sel, thr, kd, bk)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{what} band {name}: words differ: kernel "
                    f"{got.tolist()[:16]} plain {want.tolist()[:16]}")
            if bk is not None:
                row["listed_band_cases"] = row.get("listed_band_cases",
                                                   0) + 1
            need = sel[0][:, -1] >= thr
            rows_need[0] += int(need.sum())
            rows_need[1] += int(got.sum())
        row.update(kind="phrase", mode=mode, KV=KV, what=what, **kw)
        cases.append(row)

    for NB in NBs:
        p = to_device(synth_planes(H, NB, seed + NB), dev)
        for T in (2, 3):
            for KV in PHRASE_KVS:
                KVr = min(KV, NB * 128 - 1)
                B = (128 if KV == 1024 else 32) if NB == NB_1M else 8
                q = to_device(phrase_slots(B, T, H, seed + 7 * T + KV), dev)
                for mode in ("raw", "tc"):
                    one(p, q, mode, KVr, f"phrase {mode} NB={NB} B={B} "
                        f"T={T} KV={KVr}", NB=NB, B=B, T=T)
        if NB == 157:
            edge = to_device(phrase_slots(
                5, 3, H, seed, rows=[[5, 5, 6], [0, 1, 4], [2, 4, 6],
                                     [3, 5, 7], [6, 3, 6]]), dev)
            edge["use"][4] = 0.0
            edge["idf32"][4] = 0.0
            q8 = to_device(phrase_slots(8, 8, H, seed + 8), dev)
            for mode in ("raw", "tc"):
                one(p, edge, mode, 1024, f"phrase edges {mode}", NB=NB, B=5,
                    T=3)
                one(p, q8, mode, 1024, f"phrase T=8 {mode}", NB=NB, B=8,
                    T=8)
        del p
    # the band's stream: one payload everywhere (row 1: a lower tf byte at
    # the last doc), the k-th doc at the (KV+1)-th lane, thr at the
    # lowest score of the row: every lane is in the band, and only that
    # last one is no payload tie
    from wiser_tpu_torch.engine import kernels as K

    NB = 157
    tf8 = np.full((2, NB * 128), 3, dtype=np.uint8)
    tf8[1, -1] = 2
    p = to_device({"tf8": tf8, "code": np.full(NB * 128, 40, np.uint8),
                   "avg32": np.float32(57.25)}, dev)
    for rows in ([[0, 0]], [[0, 1]]):
        q = to_device(phrase_slots(1, 2, 2, seed, rows=rows), dev)
        sel = select_call(False, p, q, "tc", 1024)
        check_select(sel, select_call(True, p, q, "tc", 1024), 1024,
                     f"stream {rows}")
        args, kw = _phrase_args(p, q, "tc", 1024)
        rows_f32, _ = K._phrase_rows(*args, len_code=kw["len_code"],
                                     avg32=kw["avg32"])
        thr = K._phrase_score(rows_f32, 2).amin(dim=1).contiguous()
        kd = sel[1][:, -1].contiguous()
        got = band_call(False, p, q, "tc", 1024, sel, thr, kd)
        want = band_call(True, p, q, "tc", 1024, sel, thr, kd)
        if not torch.equal(got, want) or int(got[0]) != (rows[0][1] == 1):
            raise AssertionError(f"band stream {rows}: kernel "
                                 f"{got.tolist()} plain {want.tolist()}")
        cases.append({"kind": "band_stream", "mode": "tc", "rows": 1,
                      "hit": int(got[0]), "what": f"stream {rows}",
                      "max_abs_err": 0.0})
    # the listed band (tc, 2,048 blocks, threshold first): tf 5 in blocks
    # 0-15 (2,048 lanes: the selection keeps the first 1,025), tf 2
    # elsewhere but one lane of tf 4 in block 2,000; the k-th doc at the
    # (KV+1)-th lane, a payload tie of every tf-5 lane. At thr = that
    # lane's score only it flags, from a block the selection never
    # listed, and the band lists blocks 0-15 and 2,000; just above it
    # nothing flags
    NB = 2048
    tf8 = np.full((1, NB * 128), 2, dtype=np.uint8)
    tf8[0, :16 * 128] = 5
    x = 2000 * 128 + 77
    tf8[0, x] = 4
    p = to_device({"tf8": tf8, "code": np.full(NB * 128, 40, np.uint8),
                   "avg32": np.float32(57.25)}, dev)
    q = to_device(phrase_slots(1, 1, 1, seed, rows=[[0]]), dev)
    *sel, bk = select_call(False, p, q, "tc", 1024)
    check_select(sel, select_call(True, p, q, "tc", 1024), 1024,
                 "listed band edge")
    args, kw = _phrase_args(p, q, "tc", 1024)
    rows_f32, _ = K._phrase_rows(*args, len_code=kw["len_code"],
                                 avg32=kw["avg32"])
    sx = K._phrase_score(rows_f32, 1)[:, x].contiguous()
    kd = sel[1][:, -1].contiguous()
    for thr, hit, listed in ((sx, 1, 17), (torch.nextafter(
            sx, torch.full_like(sx, float("inf"))), 0, 16)):
        got = band_call(False, p, q, "tc", 1024, sel, thr, kd, bk)
        want = band_call(True, p, q, "tc", 1024, sel, thr, kd)
        n = int(listed_blocks(bk, thr)[0]) if bk is not None else None
        if not torch.equal(got, want) or int(got[0]) != hit or n != listed:
            raise AssertionError(f"listed band edge: kernel {got.tolist()} "
                                 f"plain {want.tolist()}, {n} blocks listed")
        cases.append({"kind": "band_listed", "mode": "tc", "rows": 1,
                      "hit": hit, "listed": n, "what": "listed band edge",
                      "max_abs_err": 0.0})
    # one score everywhere: every block key ties at kappa's score
    NB = 2048
    tie = {"sc": np.ones((2, NB * 128), np.float32),
           "tf8": np.full((2, NB * 128), 3, np.uint8),
           "code": np.full(NB * 128, 40, np.uint8),
           "avg32": np.float32(57.25)}
    tie["sc"][1, ::5] = 0.0  # row 1 misses every fifth doc
    tie["tf8"][1, ::5] = 0
    p = to_device(tie, dev)
    for B in (1, 8):
        q = to_device(phrase_slots(B, 2, 2, seed, rows=[[0, 1]]), dev)
        for mode in ("raw", "tc"):
            for KV in PHRASE_KVS:
                want = select_call(True, p, q, mode, KV)
                for path in ("one", "two")[:1 + (NB >= KV + 1)]:
                    what = f"ties {mode} B={B} KV={KV} path {path}"
                    cases.append(dict(check_select(
                        select_call(False, p, q, mode, KV, path), want, KV,
                        what), kind="phrase_ties", mode=mode, KV=KV, B=B,
                        path=path, what=what))
    del p
    if not (rows_need[0] and rows_need[1]):
        raise AssertionError(f"the band cases need {rows_need[0]} rows and "
                             f"flag {rows_need[1]}")
    return {"cases": len(cases), "need_rows": rows_need[0],
            "band_rows": rows_need[1],
            "kept_lanes": sum(c.get("kept", 0) for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rows": cases}


def phrase_bound_bytes(slots, mode: str, N_pad: int, K: int,
                       per_query: bool = False, lanes=None) -> int:
    """The bytes the selection must move, each once: every lane of the
    distinct rows its queries read (4 B raw, 1 B tc, and tc the len-code
    row once; per_query: counted per query), the (B, T) slots and
    weights, and the (B, K) lanes and scores written. `lanes` ((B,)): the
    band pass's, lanes[b] lanes of query b's distinct rows (and tc of the
    len codes) read, its selection's two words, its (KV+1)-th score and
    thr read and its word written."""
    slots = np.asarray(slots, dtype=np.int64)
    B, T = slots.shape
    lane_b = 4 if mode == "raw" else 1
    if lanes is not None:
        per = [len(np.unique(r)) * lane_b + (mode == "tc") for r in slots]
        return int(sum(n * int(x) for n, x in zip(per, lanes))
                   + B * T * 8 + B * (8 + 4 + 4 + 4))
    n_rows = (sum(len(np.unique(r)) for r in slots) if per_query
              else len(np.unique(slots)))
    total = n_rows * N_pad * lane_b + (N_pad * (B if per_query else 1)
                                       if mode == "tc" else 0)
    return int(total + B * T * 8 + B * K * 8)


def phrase_part_bytes(slots, mode: str, N_pad: int, KV: int) -> dict:
    """The least bytes of each launch of the selection's path
    (ops/dense.select_path), each read once: "sweep" the distinct rows'
    lanes (and tc the len-code row once), the slots and weights, the (B,
    NB) block keys written; "select" threshold first: each query's K
    listed blocks of its distinct rows (and tc their len codes), its
    block keys read, the slots and weights, the (B, K) outputs; in one
    pass: phrase_bound_bytes."""
    from wiser_tpu_torch.ops import dense as D

    slots = np.asarray(slots, dtype=np.int64)
    B, T = slots.shape
    NB, K = N_pad // 128, KV + 1
    # a tree without the threshold-first selection makes one pass
    if getattr(D, "select_path", lambda *a: "one")(B, NB, KV) == "one":
        return {"select": phrase_bound_bytes(slots, mode, N_pad, K)}
    lane_b = 4 if mode == "raw" else 1
    rows = sum(len(np.unique(r)) for r in slots)
    sweep = phrase_bound_bytes(slots, mode, N_pad, 0) + B * NB * 8
    listed = (rows * K * 128 * lane_b + (B * K * 128 if mode == "tc" else 0)
              + B * NB * 8 + B * T * 8 + B * K * 8)
    return {"sweep": sweep, "select": listed}


def select_parts_ms(p: dict, q: dict, mode: str, KV: int,
                    iters: int = 10):
    """The threshold-first selection's two launches timed apart
    (search_bench.queued_ms): the sweep alone (tc: its table launch too),
    then the listed selection alone on the sweep's block keys, through
    ops/dense's launch helpers (no launch counted). None where the plan
    takes one pass, or in a tree without the sweep."""
    import torch

    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.search_bench import queued_ms

    if not hasattr(D, "select_plan"):
        return None
    (plane, slots, weights), kw = _phrase_args(p, q, mode, KV)
    dev, B, T, N_pad = plane.device, slots.shape[0], kw["T"], kw["N_pad"]
    NB, K = N_pad // 128, KV + 1
    sp = D.select_plan(B, T, NB, KV, mode,
                       lambda kind, listed: D.resident_for(
                           mode, T, KV, dev, listed, kind,
                           NB if listed else 0))
    if sp.sweep is None:
        return None
    bkeys = torch.empty(2 * B * NB, dtype=torch.int32, device=dev)
    table = torch.empty(D.TC_TABLE_WORDS, dtype=torch.float32, device=dev)
    out = torch.empty(2 * B * K, dtype=torch.int32, device=dev)
    pk = dict(T=T, N_pad=N_pad, KV=KV, len_code=kw.get("len_code"),
              avg32=kw.get("avg32"),
              table=table.data_ptr() if mode == "tc" else 0,
              bkeys=bkeys.data_ptr())

    def sweep():
        D._launch(lambda f: f.scan, D._phrase_params(
            "sweep", sp.sweep, plane, slots, weights, nblk=NB, **pk), dev,
            "phrase_sweep")

    def listed():
        D._launch(lambda f: f.scan, D._phrase_params(
            "select", sp.select, plane, slots, weights, nblk=K,
            outs=(out.data_ptr(), out.data_ptr() + 4 * B * K), **pk), dev,
            "phrase_select")

    sweep()
    torch.cuda.synchronize()
    return {"sweep": queued_ms(sweep, iters), "select": queued_ms(listed, iters)}


def time_phrase_shapes(dev, mode: str = "raw", planes=None,
                       shapes=PHRASE_SHAPES, KVs=PHRASE_KVS, iters: int = 10,
                       plain_iters: int = 3, seed: int = 1,
                       plain: bool = True, compare: bool = True) -> list:
    """The phrase's kernels and plain versions at the engine's groups on
    `planes` (synthetic 1M planes by default): at each (B, T) of `shapes`
    and each KV of KVs, the selection (compared with check_select) and the
    band pass as the engine runs it (listed, on the selection's block
    keys, where it took the threshold-first path) at two thresholds:
    `skip`, past every (KV+1)-th score (no row needs the band: the usual
    group), and `stream`, at each row's (KV+1)-th score (raw: that lane
    flags itself; tc: with the k-th doc at that lane, a payload tie, every
    listed block is read until a band lane); where it was listed, also
    `stream_all`, the same band over every block. Each timed (`_time`:
    turns with the plain version, an L2 flush, each launch by
    torch.profiler, host cost; the band also queued behind a sleep), its
    peak memory above the inputs and its bytes bound (the band's:
    band_bound_bytes)."""
    import torch

    from wiser_tpu_torch.tools.search_bench import queued_ms

    p = planes if planes is not None else planes_1m(dev, seed)
    H, N_pad = (p["tf8"] if mode == "tc" else p["sc"]).shape
    rows = []

    def record(row, kern, plain_fn, nbytes, nbytes_q):
        _record(rows, row, kern, plain_fn, nbytes, nbytes_q, iters,
                plain_iters, plain, "phrase")

    for B, T in shapes:
        q = to_device(phrase_slots(B, T, H, seed + B + T, n_pad_rows=0), dev)
        s = q["slots"].cpu().numpy()
        for KV in KVs:
            KV = min(KV, N_pad - 1)
            head = {"mode": mode, "B": B, "T": T, "N_pad": N_pad, "KV": KV}

            def sel_k(q=q, KV=KV):
                return select_call(False, p, q, mode, KV)

            def sel_p(q=q, KV=KV):
                return select_call(True, p, q, mode, KV)

            *sel, bk = sel_k()
            row = dict(head, kind="phrase_select")
            if compare:
                row["check"] = check_select(sel, sel_p(), KV,
                                            f"{mode} select B={B} T={T}")
            row["part_bytes"] = phrase_part_bytes(s, mode, N_pad, KV)
            row["part_ms"] = select_parts_ms(p, q, mode, KV, iters)
            record(row, sel_k, sel_p,
                   phrase_bound_bytes(s, mode, N_pad, KV + 1),
                   phrase_bound_bytes(s, mode, N_pad, KV + 1, True))
            unseen = sel[0][:, -1]
            fin = torch.isfinite(unseen)
            top = float(unseen[fin].max()) if bool(fin.any()) else 1.0
            kd = sel[1][:, -1].clamp(min=0).contiguous()
            # the band as the engine runs it (listed where the selection
            # gave block keys) at `skip`, and at `stream` both listed and,
            # where it was, over every block (`stream_all`)
            for name, thr, keys in (
                    ("skip", torch.full_like(unseen, top * 2 + 1), bk),
                    ("stream", torch.where(fin, unseen, 1.0).contiguous(),
                     bk),
                    ("stream_all", torch.where(fin, unseen,
                                               1.0).contiguous(), None)):
                if name == "stream_all" and bk is None:
                    continue

                def band_k(q=q, KV=KV, thr=thr, keys=keys):
                    return band_call(False, p, q, mode, KV, sel, thr, kd,
                                     keys)

                def band_p(q=q, KV=KV, thr=thr):
                    return band_call(True, p, q, mode, KV, sel, thr, kd)

                row = dict(head, kind=f"phrase_band_{name}")
                got = band_k()
                if compare and not torch.equal(got, band_p()):
                    raise AssertionError(f"{mode} band {name} B={B} T={T}: "
                                         f"words differ")
                row["flagged"] = int(got.sum())
                # the lanes the band must read: none for a row that does
                # not need it, every lane (listed: its listed blocks' lanes
                # and its block keys) of one that needs it and finds
                # nothing, at least one of one that flags
                need = (sel[0][:, -1] >= thr).cpu().numpy()
                hit = got.cpu().numpy() != 0
                listed = None if keys is None else listed_blocks(keys, thr)
                row["need_rows"] = int(need.sum())
                if listed is not None:
                    row["listed_blocks"] = int(listed[need & ~hit].sum())
                record(row, band_k, band_p,
                       band_bound_bytes(s, mode, N_pad, KV + 1, need, hit,
                                        listed),
                       band_bound_bytes(s, mode, N_pad, KV + 1, need, hit,
                                        listed, True))
                # queued behind a sleep: no host gap in the reading
                row["queued_ms"] = queued_ms(band_k, iters)
                row["queued_share"] = row["bound_ms"] / row["queued_ms"]
    return rows


# the selection's tuning grid: groups (B, T), KVs, the listed
# selection's forced segments a query (None: the plan's) and rings
TUNE_SHAPES = ((128, 2), (32, 2), (8, 2))
TUNE_NSEG = (None, 1, 2, 4, 8)


def tune_select(dev, planes=None, modes=("raw", "tc"), shapes=TUNE_SHAPES,
                KVs=PHRASE_KVS, nsegs=TUNE_NSEG, iters: int = 10,
                seed: int = 1) -> list:
    """The selection's launches timed by path ("one"; "two" at each
    forced segment count of the listed selection at the first KV, the
    plan's own at the others), each compared with the plain version
    first: per launch its device ms by torch.profiler (launch_ms) and the
    call's ms queued behind a sleep (search_bench.queued_ms). The path is
    forced by forced_path and the segments by wrapping ops/dense.plan for
    the call, both restored after; LISTED_CTAS was chosen from these rows
    on synthetic planes and ops/dense.select_path from them on the
    engine planes (PERF.md §6)."""
    import torch

    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.search_bench import queued_ms

    p = planes if planes is not None else planes_1m(dev, seed)
    plan0 = D.plan
    rows = []

    def forced(nseg):
        def plan(B, T, NB, M, mode, resident, listed=False, kind="scan",
                 pick_nb=0):
            pl = plan0(B, T, NB, M, mode, resident, listed, kind, pick_nb)
            if not (nseg and listed and kind == "select"):
                return pl
            steps = -(-NB // pl.step_blocks)
            sps = -(-steps // nseg)
            if sps * pl.step_blocks > D.IDS_CAP:
                return pl
            return pl._replace(nseg=-(-steps // sps),
                               bps=sps * pl.step_blocks)
        return plan

    try:
        for mode in modes:
            H, N_pad = (p["tf8"] if mode == "tc" else p["sc"]).shape
            for B, T in shapes:
                q = to_device(phrase_slots(B, T, H, seed + B + T,
                                           n_pad_rows=0), dev)
                for KV in KVs:
                    want = select_call(True, p, q, mode, KV)
                    grid = [("one", None)] + [
                        ("two", n) for n in (nsegs if KV == KVs[0]
                                             else (None,))]
                    for path, nseg in grid:
                        D.plan = forced(nseg)
                        plan0.cache_clear()
                        D._resident.cache_clear()

                        def fn(q=q, KV=KV, path=path):
                            return select_call(False, p, q, mode, KV, path)

                        check_select(fn(), want, KV, f"tune {mode} B={B} "
                                     f"KV={KV} {path} {nseg}")
                        with forced_path(path):
                            sp = D.select_plan(
                                B, T, N_pad // 128, KV, mode,
                                lambda kind, listed: D.resident_for(
                                    mode, T, KV, dev, listed, kind,
                                    N_pad // 128 if listed else 0))
                        split = launch_ms(fn)
                        rows.append({
                            "mode": mode, "B": B, "T": T, "KV": KV,
                            "path": path, "nseg": sp.select.nseg,
                            "NS": sp.select.NS,
                            "sweep_nseg": sp.sweep.nseg if sp.sweep else None,
                            "kernels": split["kernels"],
                            "total_ms": split["total"],
                            "queued_ms": queued_ms(fn, iters)})
                        log(f"tune {json.dumps(rows[-1])}")
    finally:
        D.plan = plan0
        plan0.cache_clear()
        D._resident.cache_clear()
        torch.cuda.empty_cache()
    return rows


# the phase marks of dense.cu's measuring build (WISER_CLOCKS, clocks.cuh):
# counter index -> phase; scan counters 0-5 over the CTAs in 6, pick
# counters 8-11 over the selecting CTAs in 12
SCAN_PHASES = ("prologue", "load", "score", "barrier", "flush", "epilogue")
PICK_PHASES = ("bounds", "gather", "select", "compact")
# phase_split's groups: (name, phases, first counter, the CTA count's
# counter, {a count's name: its counter}), each count over the CTAs
DENSE_GROUPS = (("scan", SCAN_PHASES, 0, 6, {"flushes": 7}),
                ("pick", PICK_PHASES, 8, 12, {"passes": 13, "ranked": 14}))
# the phrase's selection: the selection's scan counters (0-5 over its
# CTAs in 6, keep_tops in 7), the listed selection's pick of its blocks
# (24: from the CTA's start; its copy, K-th key and ranks in 26-28) and a
# split query's cluster merge (25) over the same CTAs, and the sweep's own
# scan counters (16-21 over its CTAs in 22)
PHRASE_GROUPS = (("select", SCAN_PHASES, 0, 6, {"keep_tops": 7}),
                 ("listed_pick", ("pick",), 24, 6, {}),
                 ("pick_split", ("copy", "kth", "ranks"), 26, 6, {}),
                 ("cluster_merge", ("merge",), 25, 6, {}),
                 ("sweep", SCAN_PHASES, 16, 22, {}))


def clocks_build(name: str = "dense", fns_cls=None) -> object:
    """csrc/<name>.cu built with -DWISER_CLOCKS (a measuring build beside
    the library the entry points load: csrc/clocks.cuh's marks), bound as
    fns_cls (default ops/dense._Fns), with its `clocks` reader
    wiser_<name>_clocks."""
    import ctypes

    from wiser_tpu_torch import build
    from wiser_tpu_torch.ops import dense as D

    flags = (build.NVCC_FLAGS + build.EXTRA_NVCC_FLAGS.get(name, ())
             + ("-DWISER_CLOCKS",))
    lib = build._load(f"{name}_clocks", os.path.join(build.CSRC,
                                                     f"{name}.cu"),
                      flags, lambda src, out: [build._nvcc(), *flags, "-o",
                                               out, src])
    fns = (fns_cls or D._Fns)(lib)
    fns.clocks = getattr(lib, f"wiser_{name}_clocks")
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
        raise RuntimeError(f"clocks reader: {rc}")
    return list(buf)


def phase_split(fn, fns, calls: int = 3, groups=DENSE_GROUPS) -> dict:
    """Each phase's cycles a CTA (thread 0's view) over `calls` calls of
    fn() in the measuring build fns, for each group of counters (default
    dense.cu's scan and pick): its CTAs a call, each phase's cycles a CTA
    and share of the group's total, and its counts a CTA (scan: key
    flushes; pick: select passes and early rankings a selecting CTA)."""
    fn()
    read_clocks(fns)
    for _ in range(calls):
        fn()
    c = read_clocks(fns)
    out = {}
    for label, names, first, n_at, counts in groups:
        if not c[n_at]:
            continue
        cyc = {k: c[first + i] / c[n_at] for i, k in enumerate(names)}
        tot = sum(cyc.values())
        out[label] = {
            "ctas_a_call": c[n_at] / calls, "cycles_a_cta": cyc,
            "share": {k: (v / tot if tot else 0.0) for k, v in cyc.items()},
            "counts": {k: c[i] / c[n_at] for k, i in counts.items()}}
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


def phrase_mega_set(index: str, columns: str, n: int = 2048,
                    trace: bool = True) -> dict:
    """route_bench's phrase_mega set (up to n phrase queries from the
    index's mined pairs, `<index>/phrase_pairs.json`, whose terms are
    both dense) on a TorchEngine of the index: route_bench.run_set (warm
    pass, timed pass, a traced pass), with the peak device memory of the
    passes above the engine's own, and that of a mega-phrase group above
    its inputs (the largest over the engine's _mega_phrase_dispatch
    calls: the group's arrays, its outputs included)."""
    import torch

    from wiser_tpu_torch import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import route_bench as RB

    with open(os.path.join(index, "phrase_pairs.json")) as f:
        pairs = [tuple(x) for x in json.load(f)]
    packed = PackedIndex.load(index, skip_offsets=True)
    eng = TorchEngine(packed, device="cuda", columns=columns)
    queries = RB.build_phrase_route_sets(packed, eng, None, n, 10,
                                         pairs=pairs)["phrase_mega"]
    dispatch = eng._mega_phrase_dispatch
    group_peak = [0]

    def measured(*args):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = dispatch(*args)
        torch.cuda.synchronize()
        group_peak[0] = max(group_peak[0],
                            torch.cuda.max_memory_allocated() - before)
        return out

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        eng.search_batch(queries)  # the set's peak, without the wrapper
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        eng.clear_result_memos()
        eng._mega_phrase_dispatch = measured
        eng.search_batch(queries)
        del eng._mega_phrase_dispatch
        eng.clear_result_memos()
        eng.stats_take()
        torch.cuda.reset_peak_memory_stats()
        row = RB.run_set(eng, queries, 2048, trace_dir=tmp if trace else None)
    row["peak_above_engine_bytes"] = int(max(
        peak, torch.cuda.max_memory_allocated() - base))
    row["group_peak_bytes"] = int(group_peak[0])
    row["queries"] = len(queries)
    log(f"phrase_mega {columns}: {json.dumps(row)}")
    return row


def probe_phrase(dev, planes=None, modes=("raw", "tc"),
                 shapes=PHRASE_SHAPES, KVs=PHRASE_KVS, iters: int = 5,
                 seed: int = 1) -> list:
    """Each phase's cycles of the phrase's selection (the measuring
    build's counters, PHRASE_GROUPS: the sweep's phases, the listed
    selection's pick of its blocks, its scan phases and keep_tops, a
    split query's cluster merge) at each (B, T) and KV, beside its
    event-timed ms in that build."""
    import torch

    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.search_bench import event_ms

    p = planes if planes is not None else planes_1m(dev, seed)
    rows = []
    loaded = D._kernel_fns()
    fns = clocks_build()
    try:
        _bind(fns)
        for mode in modes:
            H, N_pad = (p["tf8"] if mode == "tc" else p["sc"]).shape
            for B, T in shapes:
                q = to_device(phrase_slots(B, T, H, seed + B + T,
                                           n_pad_rows=0), dev)
                for KV in KVs:
                    KV = min(KV, N_pad - 1)

                    def fn(q=q, mode=mode, KV=KV):
                        return select_call(False, p, q, mode, KV)

                    rows.append(dict(kind="phrase_select", mode=mode, B=B,
                                     T=T, KV=KV, ms=event_ms(fn, iters),
                                     path=D.select_path(B, N_pad // 128, KV),
                                     **phase_split(fn, fns,
                                                   groups=PHRASE_GROUPS)))
                    log(f"phrase probe {json.dumps(rows[-1])}")
    finally:
        _bind(loaded)
        torch.cuda.empty_cache()
    return rows


def phrase_readings(dev, index=None, probe: bool = False) -> dict:
    """`--phrase`: time_phrase_shapes raw and tc on synthetic 1M planes
    and, with a saved index, on a TorchEngine's own planes of it in each
    column mode with its phrase_mega set; with `probe`, probe_phrase on
    the same planes instead."""
    import torch

    out = {}
    fn = probe_phrase if probe else (
        lambda dev, planes, modes: {m: time_phrase_shapes(dev, m, planes)
                                    for m in modes})
    if index:
        from wiser_tpu_torch import TorchEngine
        from wiser_tpu_torch.index.format import PackedIndex

        packed = PackedIndex.load(index, skip_offsets=True)
        out["engine"] = {}
        for columns in ("raw", "tc"):
            eng = TorchEngine(packed, device="cuda", columns=columns)
            out["engine"][columns] = fn(dev, engine_planes(eng), (columns,))
            del eng
            torch.cuda.empty_cache()
        del packed
        if not probe:
            out["phrase_mega"] = {c: phrase_mega_set(index, c)
                                  for c in ("raw", "tc")}
    out["synthetic"] = fn(dev, planes_1m(dev), ("raw", "tc"))
    torch.cuda.empty_cache()
    return {"probe" if probe else "timing": out}


def measure(root: str, index=None, routes: str = ROUTES,
            parts: str = "dense") -> dict:
    """One tree's readings, in this process: with "dense" in `parts` its
    entry points at time_shapes's shapes, with "phrase" the phrase's
    passes at time_phrase_shapes's (where the tree has them), raw and tc
    (no plain times, no comparison), on synthetic 1M planes and, given a
    saved index, on a TorchEngine's own planes of it in each column mode;
    then route_bench's `routes` raw and tc, each set traced (phrase_mega:
    phrase_mega_set, from the index's mined pairs)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools.unpack_bench import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("dense_bench measures a card: none is available")
    dev = torch.device("cuda", 0)
    parts = set(parts.split(","))
    if "phrase" in parts and not hasattr(K, "full_phrase_select"):
        parts.discard("phrase")  # a tree before the phrase's kernels

    def timings(planes_of):
        out = {}
        for m in ("raw", "tc"):
            p = planes_of(m)
            if "dense" in parts:
                out[m] = time_shapes(dev, m, planes=p, plain=False,
                                     compare=False)
            if "phrase" in parts:
                out[f"phrase_{m}"] = time_phrase_shapes(
                    dev, m, planes=p, plain=False, compare=False)
            del p
            torch.cuda.empty_cache()
        return out

    p1 = planes_1m(dev)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(K.__file__),
           "timing": timings(lambda m: p1)}
    del p1
    torch.cuda.empty_cache()
    sets = [r for r in routes.split(",") if r]
    if index:
        from wiser_tpu_torch import TorchEngine
        from wiser_tpu_torch.index.format import PackedIndex
        from wiser_tpu_torch.tools import route_bench as RB

        if parts & {"dense", "phrase"}:
            packed = PackedIndex.load(index, skip_offsets=True)

            def engine_planes_of(columns):
                eng = TorchEngine(packed, device="cuda", columns=columns)
                return engine_planes(eng)

            out["engine_timing"] = timings(engine_planes_of)
            del packed
        out["routes"] = {}
        for columns in ("raw", "tc"):
            rest = [r for r in sets if r != "phrase_mega"]
            out["routes"][columns] = {}
            if rest:
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "routes.json")
                    RB.main(["--index", index, "--columns", columns,
                             "--n-queries", "2048", "--routes",
                             ",".join(rest), "--trace", tmp, "--out", path])
                    with open(path) as f:
                        out["routes"][columns] = json.load(f)["routes"]
            if "phrase_mega" in sets:
                out["routes"][columns]["phrase_mega"] = phrase_mega_set(
                    index, columns)
            torch.cuda.empty_cache()
    return out


def summary(runs: list) -> dict:
    """Per run: each shape's [device ms, flushed ms, host us, bound
    share] and, where read (the band), its queued ms (on the index's
    planes: keys prefixed engine_), and each route
    set's [untraced wall s, traced device busy ms, device ms of the dense
    kernels in the traced pass, busy share]."""
    res = []
    for r in runs:
        s = {"tree": r["tree"], "card": r["card"]}
        for prefix, timing in (("", r["timing"]),
                               ("engine_", r.get("engine_timing", {}))):
            for mode, rows in timing.items():
                for x in rows:
                    kv = f"_KV{x['KV']}" if "KV" in x else ""
                    key = (f"{prefix}{x['kind']}_{x.get('mode', mode)}"
                           f"_B{x['B']}_T{x['T']}{kv}")
                    s[key] = [x["device_ms"], x["flushed_ms"], x["host_us"],
                              x["share"]] + ([x["queued_ms"]]
                                             if "queued_ms" in x else [])
        for columns, sets in r.get("routes", {}).items():
            for name, row in sets.items():
                traced = row.get("traced") or {}
                kern_ms = sum(op["self_ms"] for op in traced.get("top_ops", [])
                              if KERNEL_TAG in op["kernel"])
                s[f"{columns}_{name}"] = [row.get("wall_s"),
                                          traced.get("device_busy_ms"),
                                          kern_ms, traced.get("busy_share")]
                if "peak_above_engine_bytes" in row:
                    s[f"{columns}_{name}_peak_bytes"] = [
                        row["peak_above_engine_bytes"],
                        row["group_peak_bytes"]]
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
    ap.add_argument("--phrase", action="store_true",
                    help="the full-scan phrase's passes instead of the "
                         "dense scan and pick")
    ap.add_argument("--tune", action="store_true",
                    help="--phrase: the selection's paths, segments and "
                    "rings timed (tune_select; with --index each path on "
                    "the engines' planes), then stop")
    ap.add_argument("--parts", default="dense",
                    help="--trees: what each tree times (dense, phrase)")
    args = ap.parse_args(argv)
    if args.root:
        res = measure(args.root, args.index, args.routes, args.parts)
        print(json.dumps(res), flush=True)
        return res
    if args.trees:
        from wiser_tpu_torch.tools.unpack_bench import run_trees

        extra = ["--routes", args.routes]
        if args.parts != "dense":
            extra += ["--parts", args.parts]
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
            res["check"] = (check_phrase_cases if args.phrase
                            else check_cases)(dev)
            res["check"].pop("rows")
            res["check"]["wall_s"] = time.perf_counter() - t0
            log(f"dense check: {res['check']}")
        if args.phrase and args.tune and args.index:
            # each path forced on each column mode's engine planes of the
            # index (the plan's own segments), then stop
            from wiser_tpu_torch import TorchEngine
            from wiser_tpu_torch.index.format import PackedIndex

            packed = PackedIndex.load(args.index, skip_offsets=True)
            res["tune"] = {}
            for columns in ("raw", "tc"):
                eng = TorchEngine(packed, device="cuda", columns=columns)
                res["tune"][columns] = tune_select(
                    dev, planes=engine_planes(eng), modes=(columns,),
                    nsegs=(None,))
                del eng
                torch.cuda.empty_cache()
        elif args.phrase and args.tune:
            res["tune"] = tune_select(dev)
        elif args.phrase:
            res.update(phrase_readings(dev, args.index, args.probe))
        elif args.probe and args.index:
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
