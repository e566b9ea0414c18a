#!/usr/bin/env python3
"""Chip smoke for wiser_tpu_torch: drive the port's main path once on one
CUDA card and check it.

    python3 chip_smoke.py            # the full smoke (one card, ~8 min)
    python3 chip_smoke.py --docs 200000 --phases kernel,resident

It always compiles csrc/unpack.cu for sm_90a first (nvcc, first use).
The resident and staged phases share a wiki-shaped 1M-doc index
(data/scale_corpus defaults: vocab 200k, mean length 120, Zipf 1.25,
seed 42; fast builder), cached under .smoke_cache/. Phases:
  kernel    the unpack kernel against its plain torch version and the
            repo's native codec, every width 1..32, G in {1, 256, 65536},
            bit for bit; kernel vs plain time at the staged shapes
  resident  TorchEngine(dense_budget_bytes=0) on two AOL-mix query sets
            (k=10, seed 7): bench.py's (Zipf ranks over the spelling-sorted
            term dictionary) and the same ranks over terms sorted by df;
            QPS, routes, host-fallback rate, parity of >= 200 multi-term
            queries of each set against the exact host search
  staged    StagedEngine(hbm_budget_bytes=0, cold_transfer="packed") with
            the device cold path, same query sets and parity checks; the
            unpack kernel's launches on those runs must be > 0

Any failure raises before the last line. The last line of stdout is the
contract's {"ok": true, "device": {...}}; the line before it lists the
kernels. The full report is the last line of stderr, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
K = 10
PARITY_SAMPLE = 256
PHASES = ("kernel", "resident", "staged")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events, after
    a warmup)."""
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


# -- kernel ----------------------------------------------------------------


def kernel_phase(report: dict) -> dict:
    import numpy as np
    import torch

    from wiser_tpu_torch.ops import unpack as U
    from wiser_tpu_torch.shared import native

    if not native.available():
        raise RuntimeError("native codec library did not build (g++ needed)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    max_err = 0
    checked = 0
    for w in range(1, 33):
        for G in (1, 256, 65536):
            vals = rng.integers(0, 2**w, size=G * 128, dtype=np.uint64
                                ).astype(np.uint32)
            words = native.pack_blocks(vals, np.full(G, w, dtype=np.uint8))
            words_np = words.reshape(G, 4 * w)
            ref = native.unpack_blocks(words_np.reshape(-1),
                                       np.full(G, w, dtype=np.uint8))
            if not np.array_equal(ref, vals):
                raise AssertionError(f"native codec round trip w={w} G={G}")
            d_words = torch.from_numpy(words_np.view(np.int32)).to(dev)
            got = U.unpack_delta_blocks(d_words, None, w).cpu().numpy()
            plain = U.unpack_blocks_torch(d_words, w).reshape(-1).cpu().numpy()
            first = rng.integers(0, 2**31 - 1, size=G).astype(np.int32)
            d_first = torch.from_numpy(first).to(dev)
            got_d = U.unpack_delta_blocks(d_words, d_first, w).cpu().numpy()
            plain_d = U.delta_decode_docs(
                U.unpack_blocks_torch(d_words, w), d_first
            ).reshape(-1).cpu().numpy()
            for a, b, what in ((got.view(np.uint32), ref, "native"),
                               (got, plain, "plain unpack"),
                               (got_d, plain_d, "plain delta decode")):
                diff = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                max_err = max(max_err, diff)
                if diff:
                    raise AssertionError(
                        f"unpack kernel != {what} at w={w} G={G} "
                        f"(max abs diff {diff})")
            checked += 1
    torch.cuda.synchronize()
    log(f"kernel: {checked} (width, G) cases bit-exact")

    # time at the staged shapes: w = PACK_WIDTH, G over _G16_BUCKETS
    from wiser_tpu_torch.engine.staged import _G16_BUCKETS, PACK_WIDTH

    w = PACK_WIDTH
    timing = []
    for G in _G16_BUCKETS:
        vals = rng.integers(0, 2**w, size=G * 128, dtype=np.uint64
                            ).astype(np.uint32)
        words = native.pack_blocks(vals, np.full(G, w, dtype=np.uint8))
        d_words = torch.from_numpy(words.reshape(G, 4 * w).view(np.int32)).to(dev)
        d_first = torch.from_numpy(
            rng.integers(0, 2**30, size=G).astype(np.int32)).to(dev)
        out = torch.empty(G * 128, dtype=torch.int32, device=dev)
        iters = 200
        # kernel, plain, plain, kernel: compare within one call, in turns
        k1 = cuda_ms(lambda: U.unpack_delta_blocks(d_words, d_first, w, out=out), iters)
        p1 = cuda_ms(lambda: U.delta_decode_docs(
            U.unpack_blocks_torch(d_words, w), d_first), iters)
        p2 = cuda_ms(lambda: U.delta_decode_docs(
            U.unpack_blocks_torch(d_words, w), d_first), iters)
        k2 = cuda_ms(lambda: U.unpack_delta_blocks(d_words, d_first, w, out=out), iters)
        bytes_moved = G * 4 * w * 4 + G * 4 + G * 128 * 4
        row = {"G": G, "width": w, "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
               "kernel_GBps": bytes_moved / (min(k1, k2) * 1e-3) / 1e9}
        timing.append(row)
        log(f"kernel timing {row}")
    report["kernel_timing"] = timing
    big = timing[-1]
    return {"max_abs_err": max_err, "ms": min(big["kernel_ms"]),
            "plain_ms": min(big["plain_ms"])}


# -- index + queries ---------------------------------------------------------


def get_index(n_docs: int, report: dict):
    from wiser_tpu_torch.shared import (PackedIndex, build_packed_fast,
                                        generate_linedoc)

    idx_dir = os.path.join(CACHE, f"idx_{n_docs}")
    t0 = time.perf_counter()
    if os.path.isdir(idx_dir):
        packed = PackedIndex.load(idx_dir)
        report["index"] = {"cached": True, "load_s": time.perf_counter() - t0}
    else:
        os.makedirs(CACHE, exist_ok=True)
        path = os.path.join(CACHE, f"wiki_{n_docs}.linedoc")
        generate_linedoc(path, n_docs, verbose=False)
        t1 = time.perf_counter()
        packed = build_packed_fast(path)
        t2 = time.perf_counter()
        os.remove(path)
        packed.save(idx_dir)
        report["index"] = {"cached": False, "generate_s": t1 - t0,
                           "build_s": t2 - t1}
    report["index"].update(n_docs=packed.n_docs, n_terms=packed.n_terms,
                           padded_postings=packed.n_postings,
                           max_df=int(packed.df.max()))
    log(f"index: {report['index']}")
    return packed


def aol_mixed_queries(packed, n_queries: int, seed: int = 7,
                      by_df: bool = False):
    """1-4 term conjunctive queries with the AOL length mix (bench.py's
    workload generator). Its Zipf ranks index the term dictionary, which
    is sorted by spelling, so over this corpus the picks are unrelated to
    term frequency; by_df=True indexes the terms by descending df
    instead, so the ranks follow frequency and head terms meet."""
    import numpy as np

    from wiser_tpu_torch.shared import SearchQuery

    rng = np.random.default_rng(seed)
    n_terms = rng.choice([1, 2, 3, 4], size=n_queries,
                         p=[0.43, 0.29, 0.20, 0.08])
    terms = packed.terms
    if by_df:
        order = np.argsort(-packed.df, kind="stable")
        terms = [packed.terms[r] for r in order]
    queries = []
    for nt in n_terms:
        ranks = np.minimum(rng.zipf(1.25, size=int(nt)) - 1, packed.n_terms - 1)
        queries.append(SearchQuery([terms[r] for r in ranks], n_results=K))
    return queries


def parity_sample(queries):
    """Indices of up to PARITY_SAMPLE distinct multi-term queries."""
    seen, out = set(), []
    for i, q in enumerate(queries):
        key = tuple(q.terms)
        if len(q.terms) >= 2 and key not in seen:
            seen.add(key)
            out.append(i)
    return out[:PARITY_SAMPLE]


def check_parity(packed, queries, results, sample, what: str) -> int:
    from wiser_tpu_torch.engine.host import host_exact_search
    from wiser_tpu_torch.shared import Bm25Similarity

    cache64 = Bm25Similarity(packed.avg_len).cache
    bad = []
    for i in sample:
        q = queries[i]
        rows = [packed.term_to_row[t] for t in q.terms]
        d, s = host_exact_search(packed, cache64, rows, q.n_results)
        want = [(int(a), float(b)) for a, b in zip(d, s)]
        got = [(e.doc_id, e.doc_score) for e in results[i].entries]
        if got != want:
            bad.append((q.terms, got[:3], want[:3]))
    if len(sample) < 200:
        raise AssertionError(f"{what}: only {len(sample)} multi-term queries")
    if bad:
        raise AssertionError(f"{what}: {len(bad)}/{len(sample)} parity "
                             f"mismatches, first: {bad[0]}")
    log(f"{what}: parity 0/{len(sample)} mismatches")
    return len(sample)


def serve(engine, queries, report_key: str, report: dict):
    """Warm pass, then a timed pass with result memos cleared; returns the
    timed pass's results. Kernel launch counts are zeroed just before the
    timed pass and read just after it."""
    import torch

    from wiser_tpu_torch.ops import unpack as U

    engine.search_batch(queries)
    engine.clear_result_memos()
    engine.stats_take()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    U.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.search_batch(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(U.launch_counts)
    stats = engine.stats_take()
    multi = sum(len(q.terms) >= 2 for q in queries)
    report[report_key] = {"queries": len(queries), "wall_s": wall,
                          "qps": len(queries) / wall, "stats": stats,
                          "multi_term_queries": multi, "launches": launches,
                          "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log(f"{report_key}: {len(queries)} queries in {wall:.3f}s = "
        f"{len(queries) / wall:.1f} QPS; launches {launches}; stats {stats}")
    return results


# -- main --------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, ROOT)
    from wiser_tpu_torch.build import build_log, load_library

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]}

    t0 = time.perf_counter()
    load_library("unpack")
    build_s, compiler_out = build_log["unpack"]
    report["build"] = {"unpack_s": build_s, "wall_s": time.perf_counter() - t0}
    print(f"build: csrc/unpack.cu in {build_s:.2f}s", flush=True)
    log(compiler_out)

    kern = {"name": "unpack_delta_blocks", "route": "cuda",
            "source": "wiser_tpu_torch/csrc/unpack.cu",
            "replaces": "wiser_tpu/ops/unpack.py:123", "launches": 0,
            "max_abs_err": None, "ms": None, "plain_ms": None}
    if "kernel" in phases:
        kern.update(kernel_phase(report))

    if "resident" in phases or "staged" in phases:
        from wiser_tpu_torch import StagedEngine, TorchEngine

        packed = get_index(args.docs, report)
        # the df-ranked set runs a quarter as many queries: its head-term
        # conjunctions cost ~0.1 s each on the exact host path at 1M docs
        mixes = {"aol": aol_mixed_queries(packed, args.queries),
                 "aol_df": aol_mixed_queries(packed, args.queries // 4,
                                             by_df=True)}
        engines = []
        if "resident" in phases:
            engines.append(("resident", lambda: TorchEngine(
                packed, device="cuda", dense_budget_bytes=0)))
        if "staged" in phases:
            def staged():
                eng = StagedEngine(packed, 0, device="cuda",
                                   cold_transfer="packed")
                eng.COLD_COMPUTE = "device"
                return eng

            engines.append(("staged", staged))
        for name, make in engines:
            t0 = time.perf_counter()
            eng = make()
            torch.cuda.synchronize()
            report[f"{name}_init_s"] = time.perf_counter() - t0
            report[f"{name}_device_bytes"] = eng.device_bytes()
            for mix, queries in mixes.items():
                key = f"{name}_{mix}"
                res = serve(eng, queries, key, report)
                report[key]["parity_checked"] = check_parity(
                    packed, queries, res, parity_sample(queries), key)
            del eng, res
            torch.cuda.empty_cache()
        if "staged" in phases:
            launches = sum(report[f"staged_{mix}"]["launches"]["unpack_delta_blocks"]
                           for mix in mixes)
            if launches <= 0:
                raise AssertionError(
                    "staged phase never launched the unpack kernel")
            kern["launches"] = launches

    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")
    report["total_s"] = time.perf_counter() - t_start
    log(json.dumps(report))
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
