"""The bs search kernel (ops/search.bs_search, csrc/search.cu) held against
its plain torch version (engine/kernels.search_body_torch) on synthetic
posting columns, and timed beside it at the engine's bs shapes.

    python -m wiser_tpu_torch.tools.search_bench [--out report.json]
    python -m wiser_tpu_torch.tools.search_bench --trees OLD,.,.,OLD \
        [--index IDX] --out report.json

(on a card: the kernel builds at first use). `check_cases` runs raw and
tc columns at T in {1, 2, 3, 4, 8, 9}, L in {128, 512, 2048, 8192,
32768, 65536} (each tile width of the kernel and one bucket above) and
M in {16, 64, L}, over candidate runs that are empty, shorter than L and
longer than L, with scores drawn from a few values on half the terms, so
boundary ties are cut and FLAG_TRUNC fires; then `edge_cases`: M + 1 at
the tile path's key cap and one above, candidate slices clamped at the
column's end across another run (unsorted lanes), a short candidate run
against a run of 2^20 + 3 (a window wider than shared memory), that run
again at a short n_bs_iters (the bounded search stops short), and a
group wide enough that each worker takes several tiles. `check` is the
comparison: flags bit-equal on every row; each row's kept (doc, f32
score bits, tfs, posting indices) equal, in the kernel's order (score
desc, doc asc), to the plain version's whole plane (M = L) sorted so
and cut at M, which on a flagged row keeps the lowest docs of the
boundary class; and the plain version's top-M score multiset, and its
kept set on unflagged rows, equal to the kernel's. `time_shapes` works
at the engine's batch, B = engine/device.bs_chunk(T, L) (4,096 where
the lane budget allows), and M = 64: it holds the kernel against the
plain version there (`check` without the whole plane, which is too large
to sort), then times both in turns (kernel, plain, plain, kernel) on
CUDA events after a warm-up, the kernel once more with the 50 MB L2
flushed before each call (`flushed_ms`), its launches' own device time
by torch.profiler (`launch_ms`: every kernel of the library, by name),
the wrapper's host cost per call, and the bytes bound (`bound_bytes`).

`--trees` measures each listed tree once, in turns, each in its own
process importing wiser_tpu_torch from that tree (a checkout of another
commit, e.g. unpacked from `git archive`), through
tools/unpack_bench.run_trees, so that two versions compare within one
call on one card: `time_shapes` raw and tc (the plain version's times
left out), and with `--index` (a saved 1M index) route_bench's
`--routes` sets, raw and tc, each traced.
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
CHECK_T = (1, 2, 3, 4, 8, 9)
CHECK_L = (128, 512, 2048, 8192, 32768, 65536)
# (T, L) of the timed groups: the headline's bs shapes at M = 64
TIME_SHAPES = ((2, 128), (3, 2048), (4, 8192), (2, 32768), (4, 32768))
TIME_M = 64
FLUSH_BYTES = 256 << 20  # written before a call to flush the 50 MB L2
# route_bench's sets whose queries take the bs step on the 1M index
ROUTES = "bsearch_tail_pair,midcand_x_2head_t3,windowed_mid_pair"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_columns(L: int, seed: int, lengths=None, n_terms: int = 24):
    """Raw and tc posting columns of n_terms runs over a doc range of
    2L + 64 (build_columns), the column ending in L + 4096 pad lanes as
    the engine's columns do. Run lengths: `lengths`, or empty, 1, short,
    about L and up to 2L (the long ones dense in the range, so 9-way
    intersections match)."""
    rng = np.random.default_rng(seed)
    U = 2 * L + 64
    if lengths is None:
        fixed = [0, 1, max(1, L // 8), L // 2, max(1, L - 1), L, L + 1,
                 3 * L // 2, 2 * L, 2 * L]
        lengths = fixed + list(rng.integers(1, 2 * L + 1,
                                            size=max(0, n_terms - len(fixed))))
    # drawn lazily, each run just before its payloads
    runs = (np.sort(rng.choice(U, size=int(min(n, U)), replace=False))
            for n in lengths)
    return build_columns(runs, rng, slack=L + 4096)


def build_columns(runs, rng, slack: int):
    """Raw and tc posting columns of the sorted doc-id runs `runs` (an
    iterable), as
    numpy arrays: {"doc" int32, "score" f32, "tf" int32, "tc" int16 bits
    of uint16 lanes, "t_start", "t_len"}. Each run is padded to a
    multiple of 128 with INT32_MAX docs and 0 payload, and the column
    ends in `slack` pad lanes. Every other run draws its scores, tfs and
    tc lanes from a few values, so equal sums tie at the boundary."""
    docs, scores, tfs, tcs, t_start, t_len = [], [], [], [], [], []
    pos = 0
    for i, d in enumerate(runs):
        d = np.asarray(d, dtype=np.int32)
        n = len(d)
        if i % 2:  # tie-prone payloads
            sc = rng.integers(1, 5, size=n).astype(np.float32) * 0.5
            tf = rng.integers(1, 3, size=n).astype(np.int32)
            tc = (np.uint16(17) << np.uint16(8)) | tf.astype(np.uint16)
        else:
            sc = rng.uniform(0.1, 5.0, size=n).astype(np.float32)
            tf = rng.integers(1, 40, size=n).astype(np.int32)
            code = rng.integers(0, 232, size=n).astype(np.uint16)
            tf8 = np.where(rng.random(n) < 0.03, 255,
                           rng.integers(1, 255, size=n)).astype(np.uint16)
            tc = (code << np.uint16(8)) | tf8
        pad = (-n) % 128
        docs.append(np.concatenate([d, np.full(pad, INT32_MAX, np.int32)]))
        scores.append(np.concatenate([sc, np.zeros(pad, np.float32)]))
        tfs.append(np.concatenate([tf, np.zeros(pad, np.int32)]))
        tcs.append(np.concatenate([tc, np.zeros(pad, np.uint16)]))
        t_start.append(pos)
        t_len.append(n)
        pos += n + pad
    return {"doc": np.concatenate(docs + [np.full(slack, INT32_MAX, np.int32)]),
            "score": np.concatenate(scores + [np.zeros(slack, np.float32)]),
            "tf": np.concatenate(tfs + [np.zeros(slack, np.int32)]),
            "tc": np.concatenate(tcs + [np.zeros(slack, np.uint16)]
                                 ).view(np.int16),
            "t_start": np.asarray(t_start, dtype=np.int64),
            "t_len": np.asarray(t_len, dtype=np.int64)}


def synth_batch(cols: dict, B: int, T: int, seed: int, cand=None,
                n_pad_rows: int = 2):
    """(B, T) int32 starts / ends, f32 use_score and idf32 in slot order,
    as the engine assembles them: 1..T real slots, the padded ones
    repeating slot 0 with use 0 and idf 0; the last n_pad_rows rows are
    batch padding (empty runs). Slot 0's term from `cand` (term ids) if
    given, else any term."""
    rng = np.random.default_rng(seed)
    n_terms = len(cols["t_start"])
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    for b in range(max(0, B - n_pad_rows)):
        n_real = int(rng.integers(1, T + 1)) if b % 4 else T
        terms = [int(rng.choice(cand)) if cand is not None
                 else int(rng.integers(n_terms))]
        terms += [int(t) for t in rng.integers(n_terms, size=n_real - 1)]
        for t in range(T):
            term = terms[t] if t < n_real else terms[0]
            starts[b, t] = cols["t_start"][term]
            ends[b, t] = cols["t_start"][term] + cols["t_len"][term]
            if t < n_real:
                use[b, t] = 1.0
                idf[b, t] = np.float32(rng.uniform(0.1, 8.0))
    return {"starts": starts, "ends": ends, "use": use, "idf32": idf,
            "avg32": np.float32(57.25)}


def to_device(cols: dict, batch: dict, dev):
    import torch

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in cols.items() if k in ("doc", "score", "tf", "tc")}
    t.update({k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
              for k in ("starts", "ends", "use", "idf32")})
    t["avg32"] = torch.tensor(batch["avg32"], device=dev)
    return t


def call(fn, t: dict, mode: str, T: int, L: int, M: int, n_iters: int):
    """fn (bs_search or search_body_torch) on the device tensors t."""
    kw = dict(T=T, L=L, M=M, n_bs_iters=n_iters)
    if mode == "tc":
        return fn(t["doc"], None, None, t["starts"], t["ends"], None,
                  tc=t["tc"], idf32=t["idf32"], avg32=t["avg32"], **kw)
    return fn(t["doc"], t["score"], t["tf"], t["starts"], t["ends"],
              t["use"], **kw)


def _np(out):
    return [o.cpu().numpy() for o in out]


def canon(docs, score, tfs, pidx, M: int):
    """Each row's lanes sorted by (score desc, doc asc), cut at M; lanes
    past the kept ones read doc -1, score -inf, tfs 0, pidx -1."""
    B, T = tfs.shape[:2]
    order = np.lexsort((docs, -score), axis=1)[:, :M]
    d = np.take_along_axis(docs, order, axis=1)
    s = np.take_along_axis(score, order, axis=1)
    tf = np.take_along_axis(tfs, order[:, None, :].repeat(T, 1), axis=2)
    pi = np.take_along_axis(pidx, order[:, None, :].repeat(T, 1), axis=2)
    kept = s > -np.inf
    return (np.where(kept, d, -1), np.where(kept, s, -np.inf),
            np.where(kept[:, None, :], tf, 0),
            np.where(kept[:, None, :], pi, -1), kept)


def check(kern, plain, full, M: int, what: str) -> dict:
    """Hold the kernel's outputs against the plain version's at M (plain)
    and, where given, at M = L (full), as the module docstring says;
    raise AssertionError on the first difference. Without `full` (a
    plane too large to sort), the kept (doc, score bits, tfs, posting
    indices) are held against the plain version's top M sorted by (score
    desc, doc asc) on unflagged rows, and above the boundary score on
    flagged ones. Returns the row counts and the largest absolute score
    difference (0 when exact)."""
    kd, ks, kt, kp, kf = _np(kern)
    pd, ps, pt, pp, pf = _np(plain)
    B = kd.shape[0]
    bad = np.nonzero(kf != pf)[0]
    if len(bad):
        b = bad[0]
        raise AssertionError(f"{what}: flags differ on {len(bad)} rows, "
                             f"first row {b}: kernel {kf[b]} plain {pf[b]}")
    kept = ks > -np.inf
    kp = np.where(kept[:, None, :], kp, -1)
    if full is not None:
        wd, ws, wt, wp, _ = canon(*_np(full)[:4], M)
        cmp = np.ones((B, M), dtype=bool)
    else:
        wd, ws, wt, wp, _ = canon(pd, ps, pt, pp, M)
        flagged = (kf & 1) != 0
        cmp = ~flagged[:, None] | (ws > ws[:, M - 1:M])
    cd, cs, ct, cp, _ = canon(kd, ks, kt, kp, M)
    if not np.array_equal(cd, kd):
        raise AssertionError(f"{what}: the kernel's lanes are not in "
                             f"(score desc, doc asc) order")
    for name, got, want in (("docs", kd, wd),
                            ("score bits", ks.view(np.int32),
                             ws.astype(np.float32).view(np.int32)),
                            ("tfs", kt, wt), ("pidx", kp, wp)):
        mask = cmp if got.ndim == 2 else cmp[:, None, :]
        rows = np.nonzero(((got != want) & mask).reshape(B, -1).any(axis=1))[0]
        if len(rows):
            b = rows[0]
            raise AssertionError(
                f"{what}: {name} differ from the sorted plane on "
                f"{len(rows)} rows, first row {b} (flags {kf[b]}): kernel "
                f"{got[b].ravel()[:8]} want {want[b].ravel()[:8]}")
    if not np.array_equal(np.sort(ks, axis=1), np.sort(ps, axis=1)):
        raise AssertionError(f"{what}: top-M score multisets differ")
    clean = (kf & 1) == 0
    for b in np.nonzero(clean)[0]:
        if set(kd[b][kd[b] >= 0]) != set(pd[b][pd[b] >= 0]):
            raise AssertionError(f"{what}: kept sets differ on unflagged "
                                 f"row {b}")
    a, b = np.sort(ks, axis=1), np.sort(ps, axis=1)
    fin = np.isfinite(a) & np.isfinite(b)
    err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
    return {"rows": B, "flagged": int((kf & 1).sum()),
            "tf_sat": int(((kf & 4) != 0).sum()), "kept": int(kept.sum()),
            "max_abs_err": err}


def rows_batch(cols: dict, rows, T: int, seed: int) -> dict:
    """synth_batch's arrays for explicit rows of term ids in slot order
    (padded slots repeat slot 0 with use 0 and idf 0)."""
    rng = np.random.default_rng(seed)
    B = len(rows)
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    for b, terms in enumerate(rows):
        for t in range(T):
            term = int(terms[t] if t < len(terms) else terms[0])
            starts[b, t] = cols["t_start"][term]
            ends[b, t] = cols["t_start"][term] + cols["t_len"][term]
            if t < len(terms):
                use[b, t] = 1.0
                idf[b, t] = np.float32(rng.uniform(0.1, 8.0))
    return {"starts": starts, "ends": ends, "use": use, "idf32": idf,
            "avg32": np.float32(57.25)}


def _n_iters(cols: dict) -> int:
    from wiser_tpu_torch.engine.kernels import n_iters_for

    return n_iters_for(int(cols["t_len"].max()))


def edge_cases(seed: int = 0, wide_B: int = 1024) -> list:
    """The check grid's edges, as dicts of name, cols, batch, T, L, M,
    n_iters and full (whether the whole plane is compared):

    - M + 1 at ops/search.KEY_CAP (the tile path, at one tile and at
      several) and one above (the plane path);
    - candidate slices clamped at the column's end: the candidate is the
      column's last run, shorter than L, with nothing after it, so the
      L-lane load starts inside the runs before it (unsorted lanes);
    - short candidate runs against a run of 2^20 + 3 ids (a window wider
      than shared memory and than the lanes' searches), then the same at
      n_bs_iters 20, 10 and 0, where the bounded search stops short of
      the lower bound in that run and not in a 500-id run beside it;
    - a group of wide_B queries at L = 8192, so that each worker takes
      several tiles (compared without the whole plane)."""
    from wiser_tpu_torch.ops.search import KEY_CAP

    rng = np.random.default_rng(seed)
    out = []

    def case(name, cols, batch, T, L, M, n_iters, full=True):
        out.append(dict(name=name, cols=cols, batch=batch, T=T, L=L, M=M,
                        n_iters=n_iters, full=full))

    for L, T in ((2048, 2), (8192, 3)):
        cols = synth_columns(L, seed + L + 1)
        batch = synth_batch(cols, 16, T, seed + T)
        for M in (KEY_CAP - 1, KEY_CAP):
            case(f"cap L={L} M={M}", cols, batch, T, L, M, _n_iters(cols))
    for L in (128, 2048, 8192):
        U = 2 * L + 64
        lengths = (L // 2, 2 * L, L, 3 * L // 2, L // 3)
        cols = build_columns(
            (np.sort(rng.choice(U, size=n, replace=False)) for n in lengths),
            rng, slack=0)
        last = len(lengths) - 1
        n = int(cols["t_start"][last] + cols["t_len"][last])
        cols = {k: (v[:n] if k in ("doc", "score", "tf", "tc") else v)
                for k, v in cols.items()}
        for T in (2, 3):
            rows = [[last] + list(rng.integers(0, last, size=T - 1))
                    for _ in range(12)]
            case(f"clamped L={L} T={T}", cols, rows_batch(cols, rows, T, L + T),
                 T, L, 16, _n_iters(cols))
    # the wide run: the even docs below 2^21 + 6; the candidate runs and
    # a 500-id run draw from it, so the intersections match
    big = np.arange(0, 2 * (2**20 + 3), 2)
    odd = 2 * rng.choice(len(big), size=50, replace=False) + 1
    c0 = np.union1d(rng.choice(big, size=70, replace=False), odd[:30])
    c3 = np.union1d(rng.choice(big, size=40, replace=False), odd[30:])
    mid = np.union1d(rng.choice(c0[c0 % 2 == 0], size=40, replace=False),
                     rng.choice(big, size=460, replace=False))
    cols = build_columns([c0, big, mid, c3], rng, slack=4096)
    for L in (128, 2048):
        # 21 iterations finish every search of the wide run; 20 leave some
        # a range of one id; 10 and 0 stop far short
        for T, n_iters in ((2, 21), (3, 21), (2, 20), (3, 20), (3, 10),
                           (3, 0)):
            rows = [[0, 1], [3, 1]] if T == 2 else [[0, 2, 1], [3, 1, 2]]
            case(f"wide L={L} T={T} iters={n_iters}", cols,
                 rows_batch(cols, rows * 8, T, T * 100 + n_iters), T, L, 16,
                 n_iters)
    cols = synth_columns(8192, seed + 99)
    case(f"several tiles B={wide_B}", cols,
         synth_batch(cols, wide_B, 4, seed + 5), 4, 8192, 64, _n_iters(cols),
         full=False)
    return out


def check_cases(dev, seed: int = 0, Ls=CHECK_L, Ts=CHECK_T,
                edges: bool = True) -> dict:
    """Every (mode, T, L, M) case, then every edge_cases entry, through
    the kernel and the plain version on the CUDA device `dev`. Raises on
    the first difference; returns the totals and each case's counts."""
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import search as S

    def run(t, mode, T, L, M, n_iters, full, what):
        kern = call(S.bs_search, t, mode, T, L, M, n_iters)
        plain = call(K.search_body_torch, t, mode, T, L, M, n_iters)
        whole = (call(K.search_body_torch, t, mode, T, L, L, n_iters)
                 if full else None)
        row = check(kern, plain, whole, M, what)
        row.update(mode=mode, T=T, L=L, M=M, what=what)
        return row

    cases = []
    for L in Ls:
        cols = synth_columns(L, seed + L)
        n_iters = K.n_iters_for(int(cols["t_len"].max()))
        B = 32 if L <= 2048 else 8
        for T in Ts:
            batch = synth_batch(cols, B, T, seed + 7 * T + L)
            t = to_device(cols, batch, dev)
            for M in sorted({16, 64, L}):
                for mode in ("raw", "tc"):
                    cases.append(run(t, mode, T, L, M, n_iters, True,
                                     f"{mode} T={T} L={L} M={M}"))
    if edges:
        for e in edge_cases(seed):
            t = to_device(e["cols"], e["batch"], dev)
            for mode in ("raw", "tc"):
                cases.append(run(t, mode, e["T"], e["L"], e["M"],
                                 e["n_iters"], e["full"],
                                 f"{mode} {e['name']}"))
    flagged = sum(c["flagged"] for c in cases)
    if not flagged:
        raise AssertionError("no case cut a boundary tie (FLAG_TRUNC)")
    return {"cases": len(cases), "flagged_rows": flagged,
            "tf_sat_rows": sum(c["tf_sat"] for c in cases),
            "kept_lanes": sum(c["kept"] for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rows": cases}


def bound_bytes(starts, ends, mode: str, L: int, M: int) -> int:
    """The bytes the step must move, each once: the candidate slices'
    valid lanes (doc + score, 8 B a lane raw; doc + tc lane, 6 B tc); per
    query and other slot, min(run, valid lanes * ceil(log2(run + 1)))
    4-byte doc ids, the run read once or one id per probe of each valid
    lane's search, whichever is fewer; the winners' tfs (4 B raw, 2 B tc
    per slot); the outputs written (docs, scores, tfs and posting indices
    per slot, the flag word); and the (B, T) bounds and weights."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    B, T = starts.shape
    run = np.maximum(ends - starts, 0)
    valid = np.minimum(run[:, 0], L)
    lane_b = 8 if mode == "raw" else 6
    total = int(valid.sum()) * lane_b
    if T > 1:
        other = run[:, 1:]
        probes = np.ceil(np.log2(other + 1.0)).astype(np.int64)
        total += int(np.minimum(other, valid[:, None] * probes).sum()) * 4
    total += B * T * M * (4 if mode == "raw" else 2)
    total += B * ((2 * T + 2) * M + 1) * 4 + B * T * 12
    return total


def event_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls: CUDA events around
    the calls, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, cycles: int = 2_000_000) -> float:
    """Mean device time of fn() over `iters` calls queued behind a sleep
    kernel (torch.cuda._sleep): the host enqueues the calls while the card
    waits, so no host gap between them enters the CUDA events around
    them, as it does in event_ms where the wrapper's host cost exceeds
    its kernels' time. After a warm call; the sleep grows until it
    outlasts the enqueueing (fn must not synchronize)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        s0 = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.9 * s0.elapsed_time(start):
            break
        cycles *= 4
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int) -> float:
    """The wrapper's host cost per call: the host clock over `calls`
    calls of fn() until the last returns (after a warm one and a
    synchronize)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def flushed_ms(fn, iters: int) -> float:
    """Mean device time of fn() with the L2 flushed before each call: a
    FLUSH_BYTES write, then CUDA events around the call alone."""
    import torch

    junk = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        junk.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    del junk
    return total / iters


def launch_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel of the search library that fn()
    launches (the names in wiser_search::, whatever the tree's form of
    the kernel calls them): torch.profiler (utils.trace) over `calls`
    calls after a warm one, the newest `calls` device events of each
    name. `total` sums them (None where a name has fewer events than
    calls: not measured); `events` counts each name's events and `other`
    names the trace's other device kernels."""
    import torch
    from torch.autograd import DeviceType

    from wiser_tpu_torch.utils import trace

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for _ in range(calls):
                fn()
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
    names = sorted({n for *_, n in events if "wiser_search::" in n})
    out = {"kernels": {}, "events": {}, "calls": calls}
    for name in names:
        mine = [b - a for a, b, n in events if n == name]
        key = name.split("wiser_search::")[1].split("(")[0]
        out["events"][key] = len(mine)
        out["kernels"][key] = (sum(mine[-calls:]) / 1e3 / calls
                               if len(mine) >= calls else None)
    vals = list(out["kernels"].values())
    out["total"] = sum(vals) if vals and None not in vals else None
    out["other"] = sorted({n.split("(")[0] for *_, n in events
                           if "wiser_search::" not in n})
    return out


def shape_batch(T: int, L: int, seed: int = 1):
    """The timed group at (T, L): B = bs_chunk(T, L) queries whose
    candidate runs are L/2..L long (a candidate's L bucket), the other
    slots' L..4L, over a doc range of 8L + 64."""
    from wiser_tpu_torch.engine.device import bs_chunk

    B = bs_chunk(T, L)
    rng = np.random.default_rng(seed + L)
    n_cand = 32
    lengths = list(rng.integers(L // 2 + 1, L + 1, size=n_cand)) + list(
        rng.integers(L, 4 * L + 1, size=32))
    cols = synth_columns(4 * L, seed + L, lengths=lengths)
    batch = synth_batch(cols, B, T, seed + T, cand=np.arange(n_cand),
                        n_pad_rows=0)
    return B, cols, batch


def time_shapes(dev, mode: str = "raw", shapes=TIME_SHAPES, M: int = TIME_M,
                iters: int = 20, plain_iters: int = 3, seed: int = 1,
                plain: bool = True) -> list:
    """The kernel and its plain version at each (T, L) of `shapes`
    (shape_batch): compared (`check`), then timed in turns (kernel,
    plain, plain, kernel; with plain=False the kernel twice), the kernel
    once more with the L2 flushed before each call, its launches by
    name (launch_ms) and the wrapper's host cost per call."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import search as S

    rows = []
    for T, L in shapes:
        B, cols, batch = shape_batch(T, L, seed)
        t = to_device(cols, batch, dev)
        n_iters = K.n_iters_for(int(cols["t_len"].max()))

        def kern():
            return call(S.bs_search, t, mode, T, L, M, n_iters)

        def plain_fn():
            return call(K.search_body_torch, t, mode, T, L, M, n_iters)

        # the kernel against its plain version at this batch size
        chk = check(kern(), plain_fn(), None, M,
                    f"{mode} B={B} T={T} L={L} M={M}")
        k1 = event_ms(kern, iters)
        p = [event_ms(plain_fn, plain_iters),
             event_ms(plain_fn, plain_iters)] if plain else []
        k2 = event_ms(kern, iters)
        fl = flushed_ms(kern, iters)
        hu = host_us(kern, iters)
        split = launch_ms(kern)
        nbytes = bound_bytes(batch["starts"], batch["ends"], mode, L, M)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # the kernel's own time: its launches' device time where the
        # trace holds them all, else the CUDA events around the calls
        own = split["total"] or min(k1, k2)
        plan = getattr(S, "plan", None)
        row = {"mode": mode, "B": B, "T": T, "L": L, "M": M,
               "event_ms": [k1, k2], "device_ms": own, "flushed_ms": fl,
               "host_us": hu, "launch_ms": split,
               "launches_per_call": (sum(split["events"].values())
                                     / split["calls"]),
               "plan": plan(B, T, L, M)._asdict() if plan else None,
               "bytes": nbytes, "bound_ms": bound, "share": bound / own,
               "flushed_share": bound / fl, "check": chk}
        if plain:
            row.update(plain_ms=p, speedup=min(p) / own)
        rows.append(row)
        log(f"search timing {row}")
        del t
        torch.cuda.empty_cache()
    return rows


def measure(root: str, index=None, routes: str = ROUTES) -> dict:
    """One tree's readings, in this process: time_shapes raw and tc (no
    plain times) and, given a saved index, route_bench's `routes` raw and
    tc, each set traced."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.ops import search as S
    from wiser_tpu_torch.tools.unpack_bench import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("search_bench measures a card: none is available")
    dev = torch.device("cuda", 0)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(S.__file__),
           "timing": {m: time_shapes(dev, m, plain=False)
                      for m in ("raw", "tc")}}
    if index:
        from wiser_tpu_torch.tools import route_bench as RB

        out["routes"] = {}
        for columns in ("raw", "tc"):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "routes.json")
                RB.main(["--index", index, "--columns", columns,
                         "--routes", routes, "--trace", tmp, "--out", path])
                with open(path) as f:
                    out["routes"][columns] = json.load(f)["routes"]
    return out


def summary(runs: list) -> dict:
    """Per run: each shape's [device ms, flushed ms, host us, bound
    share], and each route set's [untraced wall s, device ms of the search
    kernels in its traced pass, device busy ms of that pass]."""
    res = []
    for r in runs:
        s = {"tree": r["tree"], "card": r["card"]}
        for mode, rows in r["timing"].items():
            for x in rows:
                s[f"{mode}_T{x['T']}_L{x['L']}"] = [
                    x["device_ms"], x["flushed_ms"], x["host_us"],
                    x["share"]]
        for columns, sets in r.get("routes", {}).items():
            for name, row in sets.items():
                traced = row.get("traced") or {}
                kern_ms = sum(op["self_ms"] for op in traced.get("top_ops", [])
                              if "wiser_search::" in op["kernel"])
                s[f"{columns}_{name}"] = [row.get("wall_s"), kern_ms,
                                          traced.get("device_busy_ms")]
        res.append(s)
    return {"search_bench": res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-check", action="store_true")
    ap.add_argument("--trees", default=None,
                    help="comma-separated trees, measured in turns")
    ap.add_argument("--root", help="measure this tree in this process")
    ap.add_argument("--index", help="a saved index for route_bench's sets")
    ap.add_argument("--routes", default=ROUTES)
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
        from wiser_tpu_torch.ops import search as S
        from wiser_tpu_torch.runtime import resolve_device
        from wiser_tpu_torch.tools.unpack_bench import card_line

        dev = resolve_device("cuda")
        res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
        S._kernel_fns()
        res["build_s"], compiler = build_log["search"]
        log(compiler)
        if not args.skip_check:
            res["check"] = check_cases(dev)
            res["check"].pop("rows")
            log(f"search check: {res['check']}")
        res["timing"] = {m: time_shapes(dev, m) for m in ("raw", "tc")}
        print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
