#!/usr/bin/env python3
"""Chip smoke for wiser_tpu_torch: drive the port's main path once on one
CUDA card and check it.

    python3 chip_smoke.py            # the full smoke (one card, 15-19 min)
    python3 chip_smoke.py --docs 200000 --phases kernel,dense,phrase

It always compiles csrc/unpack.cu, csrc/search.cu and csrc/dense.cu for
sm_90a first (one nvcc each, all three at the same time, first use).
The engine phases share a wiki-shaped 1M-doc index with bi-blooms
(data/scale_corpus defaults: vocab 200k, mean length 120, Zipf 1.25,
seed 42, WITH_BI_BLOOM rows; fast builder with the reference indexer's
BloomConfig(5, 0.0009)), cached under .smoke_cache/ with the phrase
pairs mined from its first 2,000 bodies; where it is not cached, a child
process builds it (host work, started first) while the libraries build,
the kernel phase holds the card, the headline and serve phases run on
bench.py's own corpus and the tools phase runs its part that needs no
1M index (their reports and each kernels-line row say whether the build
ran beside them). Two AOL-mix query sets (k=10,
seed 7): `aol` is bench.py's (Zipf ranks over the spelling-sorted term
dictionary), `aol_df` the same ranks over terms sorted by df, so head
terms meet; and `phrase`, 4,096 draws (seed 7) from the mined adjacent
pairs, as the scale bench's config 4_phrase. Every run is a warm pass
(on a 128-query prefix for the host-bound mixes: the staged and pruned
phrase mixes and aol_df without a dense tier), then a
timed pass with the result memos cleared, then parity of >= 200
distinct multi-term queries against the exact host search (phrase
search for phrases). Phases:
  kernel    the unpack kernel's two entries against their plain torch
            versions and the repo's native codec, bit for bit: the
            uniform entry at every width 1..32, G in {1, 256, 65536},
            raw and delta; the mixed entry (one launch over a block
            table) at random widths 1..32 per block and a random order of
            destinations, G in {1, 7, 65539}. Then both timed: device time
            from torch.profiler (tools/unpack_bench), the wrapper's host
            cost per call, the plain version's time and the bytes bound,
            the uniform entry at w = 16 over the staged G buckets (and at
            65,536 after an L2 flush), in turns with the plain version.
            Then the bs search kernel (ops/search.bs_search, csrc/
            search.cu) against its plain torch version on the card
            (tools/search_bench.check_cases): raw and tc, T in {1, 2, 3,
            4, 8, 9}, L in {128, 512, 2048, 8192, 32768, 65536}, M in
            {16, 64, L}, empty, short and long candidate runs, planted
            boundary ties, and the grid's edges (search_bench.edge_cases:
            M + 1 at the tile path's key cap and one above, candidate
            slices clamped at the column's end, a window wider than
            shared memory, a short n_bs_iters, several tiles a worker);
            flags bit-equal on every row, the kept lanes equal to the
            plain version's whole plane in (score desc, doc asc) order;
            entry() (wiser_tpu_torch/entry.py) on the card against the
            same call on the CPU, as it is and with its rows cut to 1
            and 2 slots (its 4-slot rows match no doc); then, at the
            headline's bs shapes (B = engine/device.bs_chunk, T 2-4, L
            128-32,768, M 64), raw and tc, the kernel held against the
            plain version (flags bit-equal, the top-M score multiset,
            the kept lanes on unflagged rows and above the boundary on
            flagged ones) and timed in turns with it (kernel, plain,
            plain, kernel; CUDA events), once more after an L2 flush,
            each launch by torch.profiler, with the bytes bound. Then the
            dense tier's kernels (ops/dense.py, csrc/dense.cu) against
            their plain torch versions (tools/dense_bench.check_cases):
            the block-list scan over every block, raw and tc, T in {1, 2,
            3, 4, 8}, N_pad in {1, 157, 7,816} x 128, M in {1, 16, 64,
            254}, B in {1, 8, 128, 1,024}; the block pick in both bound
            forms and the pruned scan at C in {256, 512, 1,024}; no
            match, fewer than M matches, padded slots, saturated tf bytes,
            len codes >= 128, bounds past shared memory; flags, blk and
            next_ub bit-equal, the kept lanes equal on unflagged rows,
            the top-M score multiset on every row; then both timed on
            synthetic 1M planes (dense_bench.time_shapes at B 128, T 2,
            and the pruned group B 1,024, T 2, C 512)
  resident  TorchEngine(dense_budget_bytes=0): bs and windowed routes and
            host merges; raises unless aol_df takes the windowed route.
            Then `windowed`, up to 1,024 df-ranked draws (seed 8) that the
            windowed route takes, served twice on the same engine: as
            routed, and with the route switched off through its
            thresholds (`windowed_bs`; the host-merge threshold raised
            too, so every one of them takes bs), which times the windowed
            kernel against bs on the same queries
  dense     TorchEngine at the default dense budget: dense, pruned
            (block-max) and semidense routes with the batched rescue;
            raises unless aol_df takes the pruned and semidense routes;
            then the dense kernels on the engine's own planes
            (dense_bench.time_shapes: the full scan at B 128, T 2-4, M
            64; the pruned scan and its pick at T 2 B 1,024, T 3-4 B
            512, C 512), each held against and timed in turns with its
            plain version, with the peak memory above the inputs (the tc
            phase does the same on its planes)
  phrase    the phrase set through the same dense-budget TorchEngine:
            full-scan mega (with its rescue), semidense, compact and
            list-chain phrase routes and the exact host phrase search;
            raises unless the full, semidense and compact-or-list routes
            each answer some; then a 256 prefix of it with
            FULL_PHRASE_SCAN = False on the instance (`phrase_pruned`),
            which must take the block-pruned mega route
  staged    StagedEngine with the device cold path and packed transport,
            at budget 0 and at a quarter of the full-residency bytes
            (which must admit dense rows and stage cold chunks), over
            aol, aol_df and a 256 prefix of the phrase set: budget 0
            must answer phrases on the cold device path (phrase_body over
            staged position bags), the quarter budget some hot (the hot
            engine's phrase routes) and some cold; the unpack kernel's
            launches on those runs, phrase mixes included, must be > 0
  tc        TorchEngine(columns="tc") at the default dense budget over
            all three sets, and the pruned phrase prefix as above;
            raises unless aol_df takes the pruned and semidense routes,
            the phrase set the full-scan, semidense and compact-or-list
            routes, its postings take at most 0.51 of the raw engine's
            bytes and its dense tier holds more rows than the raw one
            (those two against the dense phase's engine, when it ran)
  staged_tc StagedEngine(columns="tc"), device cold path, packed
            transport, at a quarter of full_residency_bytes(packed,
            "tc"), phrases included; raises unless it admits dense rows,
            stages cold chunks, answers phrases hot and cold and launches
            the unpack kernel
  harness   the port's measurement harnesses, called in process on the
            same index (the dense and tc phases' engines when they ran):
            tools/scale_bench configs 1-4 at 2,048 queries each (batch
            2,048, 2 in flight; the phrase config from the cached pairs),
            50 sampled per config against the host; tools/parity_audit,
            32 queries per config through the engine with strict_parity
            on, every result verified, flag counts reported;
            tools/route_bench, every route set at 256 queries, whose
            named route must take a majority, with zipf_t3 run once more
            under torch.profiler (utils.trace: top device ops, device
            busy share); bench/run_exp's memory grid at 0.05 and 0.25 of
            full_device_bytes (aol_mix, 512 queries, device cold path),
            which must launch the unpack kernel; tools/stage_probe (B=512,
            T=3, C=512, M=16, SB=8) on tc columns. A mismatch or a failed
            check raises
  mesh      the doc-partitioned mesh on the same 1M index, MESH_SHARDS =
            4 shards on the one card (the layout a four-card machine gives,
            one shard per card): tools/dryrun_multichip (every mesh route,
            raw and tc, host-verified), ShardedIndex.from_packed timed, then
            `mesh` (ShardedEngine, raw) and `mesh_tc` (columns="tc") over
            aol, aol_df, aol_df_pruned (1,024 df-ranked queries with
            PRUNED_DENSE_MIN_NB = 1024 on the instance: at 4 shards the
            1,954 blocks per shard stay under the default 2,048) and a 256
            phrase prefix; `mesh_staged` (ShardedStagedEngine at a quarter
            of its full residency bytes) over aol, aol_df 1,024 and a 256
            phrase prefix; and tools/shard_ladder.run on the mesh engine
            (configs 1-4, 256 queries each, 50 sampled). Raises unless
            aol_df takes the dense and semidense routes, aol_df_pruned the
            pruned one, the phrase prefix the compact and list ones (and,
            raw and tc, their kernels launch there), mesh_tc's
            postings take <= 0.51 of mesh's bytes, and mesh_staged answers
            some queries hot and stages some cold groups
  tools     the last modules of the port, on one card: tools/
            wiki_pipeline at 25,000 docs (synthesized enwiki abstract XML
            -> the analyzer of data/corpus -> WITH_BI_BLOOM linedoc -> fast
            builder -> check_posting_list, which must find 0 errors ->
            TorchEngine on the card, 4,096 df-Zipf 1-3-term queries with
            200 of them re-searched on the host, 0 mismatches), then
            ops/unpack's pack_doc_blocks + unpack_doc_blocks over the
            pipeline index's whole doc column and, when an engine phase
            loaded it, the 1M index's (exactly one unpack_mixed_blocks
            launch a column, every width present), each bit for bit
            against the plain torch decode, the native codec and the
            column, then the single launch timed against the per-width
            loop of unpack_delta_blocks in turns (single, loop, loop,
            single); tools/micro_bench's codec, host, snippet and
            device rows; tools/gather_probe at its defaults (the four
            gather forms, three of them bit-exact against each other, CUDA
            events); tools/prune_probe (n 32, C 32,64,128) with the raw
            and the tc engine's dense sets on the 1M index (the pipeline's
            when no engine phase ran)
  headline  bench.py's headline on the card (wiser_tpu_torch.bench.
            headline.run): its 20k-doc synthetic corpus built by the
            port's builder (OracleEngine + pack_oracle) into
            .smoke_cache/, 262,144 AOL-mix queries in batches of 131,072
            with 2 in flight, a warm pass and two timed passes on raw
            columns; prints its JSON line, and checks >= 200 distinct
            multi-term queries of the last timed pass against the exact
            host search
  serve     the same corpus saved with a chunked LZ4 doc store under
            <dir>/docs, the engine made by create_search_engine(
            "torch:<dir>") (factory, LazyDocBodies, native LZ4), wrapped
            in a BatchingExecutor(max_batch=4096, max_wait_ms=2.0) and
            driven in process by 8 threads calling search_many on wire
            batches of 64: 4,096 AOL-mix queries (seed 7) and 512 phrase
            queries mined from the bodies, every other one asking for 3
            snippet passages; >= 200 distinct multi-term queries, phrases
            included, must equal the port's OracleEngine over the same
            docs, snippet strings included, and some snippets must hold
            "<b>"

Any failure raises before the last line. The last line of stdout is the
contract's {"ok": true, "device": {...}}; the line before it lists the
kernels (unpack_delta_blocks and unpack_mixed_blocks, the unpack
kernel's two entries, and bs_search, each with its launches on the
path, device ms, host us per call, plain ms and bound); before that come
the tools summary, the mesh summary, the harness summary and the route
summary of every run. bs_search's launches (its tile path; the plane
path, for M + 1 past the key cap, counts as bs_search_plane) are
counted on the timed passes of every engine run, the harness, the mesh
and the headline; the smoke fails if the resident, dense, staged, mesh
or headline phase ran and launched the tile path 0 times. So are the
dense kernels' (the scan's raw instantiation dense_scan and its tc one
dense_scan_tc, the tc table dense_tc_table launched before each tc
scan, the merge launch dense_scan_merge, and dense_pick): the smoke
fails if neither scan launched on the dense, tc or mesh phase, or on
another phase whose route counters show dense, pruned or rescued
queries, if dense_scan never launched on the dense phase or
dense_scan_tc on the tc phase, or if dense_pick never launched on the
dense or tc phase. The full-scan mega phrase's kernels (the selection's
block-key sweep phrase_sweep and the selection phrase_select, threshold
first or in one pass, and its band pass phrase_band, which streams only
the blocks whose sweep key reaches thr where the selection took the
threshold-first path; phrase_sweep_tc, phrase_select_tc and
phrase_band_tc on tc columns) are held against their plain versions in
the kernel phase (dense_bench.check_phrase_cases: raw and tc, T 2, 3
and 8, KV 1,024 and 4,096 over 1, 157 and 7,816 blocks, each selection
by both paths where the doc space allows, one score everywhere so every
block key ties at kappa's score, every band case as the engine runs it
(tc listed where the selection gave block keys, else over every block)
at thresholds each side of the (KV+1)-th score and, tc, its payload
ties, a full stream and a band lane outside the selection's
listed blocks) and timed there on synthetic 1M planes and in the dense
and tc phases on the engines' planes (the band where no row needs it
and where every row needs it and, tc, none flags); the smoke
fails if the phrase set's full-scan route answered queries on the dense
or tc phase and the selection, the band or the verification from kept
docs did not launch there, or the sweep where the mega chunk's plan
takes the threshold-first path. The semidense step (semidense on raw
columns, semidense_tc on tc ones; csrc/semidense.cu) and the phrase
position verification from kept docs (csrc/phrase.cu:
phrase_verify_docs, the mega routes) are held against their plain
versions in the kernel phase (semidense_bench.semidense_cases,
segment_cases and docs_cases: raw and tc, T 2 to 8 with 0
to 2 searched others, a mesh shard's doc_base, a deep k, the segmented
kernel's edges: L at the 256-lane units' edges with B 1 and 8, runs past
the iteration count, a K whose keys lie in device memory; bags with
planted phrases, clamped windows, anchors not 0, int16 and int32
columns, runs past the recovery's iteration count, docs in no run) and
timed there on synthetic 1M inputs, then on the dense and tc phases' own
calls (semidense_bench.Recorder: each kind's largest group and most
called shape, compared and timed after the passes, the kernels line
reading the largest); the smoke fails if semidense never launched on
the dense phase, semidense_tc on the tc phase, phrase_verify_docs on
the dense or tc phase with the phrase set. The semidense phrase
route (semidense_phrase, semidense_phrase_tc;
csrc/phrase_route.cu: the selection of the KV + 1 best AND keys, the
recovery and window verification of the kept lanes, the top M) and the
list chain (list_phrase, list_phrase_tc: a query's lanes in segments of
one cluster, a thread a lane through match and bloom gate, the round's
active lanes compacted, a thread a (lane, base) through the
verification by binary search, the verified keys pushed into the
cluster's first CTA and their top M taken there, one launch; without its
gate, with the kept scores, list_phrase_nogate{,_tc}: the mesh's list
route) and the compact route (compact_phrase, compact_phrase_tc: the
semidense phrase route's selection with every slot searched and the
bi-bloom gate tested on the way, its verification and output with the
tc lanes' tfs and the kept scores) are held against their plain versions
in the kernel phase (phrase_bench.semidense_phrase_cases,
list_phrase_cases and compact_phrase_cases: raw and tc, T 2 to 4, ties
straddling the (KV+1)-th
lane, fewer than KV + 1 matches, absent bloom rows, no active probe, PP
above every bag, a bag holding 65,535, B 1 over 8 segments with ties
across their edges, a recovery past its iteration count, a list group
over 8 segments with hundreds of verified lanes, every list case with
and without the gate, every lane gated out, a candidate run clamped at
the column's end, a mesh shard's L 131,072 and its B 8 groups at L
524,288; packed outputs and kept scores bit for bit) and timed there on
synthetic 1M inputs (the list chain at the engines' B 128 and B 8 groups
too), then on the dense, tc, mesh and mesh_tc runs' own calls
(phrase_bench.Recorder: each kind's largest group, compared bit for bit
and timed after the passes, the mesh's outside the main path's tally);
the smoke fails if a run's mix
(the mesh's aside) answered queries on the semidense phrase, list or
compact route and that route's kernel did not launch on its timed pass,
if the raw kernels never launched on the dense phase or the tc ones on
the tc phase with the phrase set, or if the mesh's phrase mixes answered
queries on the compact or list route and compact_phrase{,_tc} or
list_phrase_nogate{,_tc} did not launch there. Every kernel's device
ms summed over the main path (tools/kernel_tally: each wrapper's calls
on the timed runs and the harness, mesh, headline and serve phases,
each call shape timed with its calls queued behind a sleep kernel
before the phase's engines go) is the report's kernel_device_ms, by
phase and shape, and a line of its own. The full report is the last
line of stderr, one JSON object (also written to the --report path, if
given).
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
K = 10
PARITY_SAMPLE = 256
PHASES = ("kernel", "resident", "dense", "phrase", "staged", "tc",
          "staged_tc", "harness", "mesh", "tools", "headline", "serve")


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


def _ops():
    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.ops import phrase as PH
    from wiser_tpu_torch.ops import phrase_route as PR
    from wiser_tpu_torch.ops import search as S
    from wiser_tpu_torch.ops import semidense as SD
    from wiser_tpu_torch.ops import unpack as U

    return U, S, D, SD, PH, PR


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for m in _ops():
        m.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by wrapper name."""
    out = {}
    for m in _ops():
        out.update(m.launch_counts)
    return out


# -- kernel ----------------------------------------------------------------


def kernel_phase(report: dict) -> dict:
    """Both entries of the unpack kernel against their plain torch
    versions and the native codec, bit for bit, then timed: the uniform
    entry at w = 16 over the staged engine's G buckets, the mixed entry
    at G = 65,539 random widths; device time from torch.profiler, host
    cost per call, in turns with the plain version (kernel, plain,
    plain, kernel). Returns the kernels line's entries by name."""
    import numpy as np
    import torch

    from wiser_tpu_torch.engine.staged import _G16_BUCKETS, PACK_WIDTH
    from wiser_tpu_torch.native import lib as native
    from wiser_tpu_torch.ops import unpack as U
    from wiser_tpu_torch.tools import unpack_bench as UB
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def check(a, b, what):
        diff = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
                   ) if a.size else 0
        if diff or a.shape != b.shape:
            raise AssertionError(f"unpack kernel != {what} "
                                 f"(max abs diff {diff})")
        return diff

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
                max_err = max(max_err, check(a, b, f"{what} at w={w} G={G}"))
            checked += 1
    torch.cuda.synchronize()
    log(f"kernel: {checked} uniform (width, G) cases bit-exact")

    # the mixed entry: random widths 1..32 per block, the table in a
    # random order of destinations, against the plain version and the
    # native codec (which decodes a stream of mixed widths itself)
    mixed_err = 0
    mixed = {}
    for G in (1, 7, 65539):
        widths = rng.integers(1, 33, size=G).astype(np.uint8)
        vals = (rng.integers(0, 2**32, size=(G, 128), dtype=np.uint64)
                & ((np.uint64(1) << widths.astype(np.uint64)[:, None])
                   - np.uint64(1))).astype(np.uint32)
        stream = native.pack_blocks(vals.reshape(-1), widths)
        offsets = np.zeros(G, dtype=np.int64)
        np.cumsum(4 * widths[:-1].astype(np.int64), out=offsets[1:])
        dest = rng.permutation(G).astype(np.int32)
        first = rng.integers(-2**31, 2**31 - 1, size=G).astype(np.int32)
        table = U.upload_table((stream, widths, offsets, dest, first), dev)
        out = torch.empty(G * 128, dtype=torch.int32, device=dev)
        got = U.unpack_mixed_blocks(*table, out=out).cpu().numpy()
        plain = U.unpack_mixed_blocks_torch(
            *table, out=torch.empty_like(out)).cpu().numpy()
        d = native.unpack_blocks(stream, widths).reshape(G, 128).astype(np.int64)
        nat = np.zeros((G, 128), dtype=np.int64)
        nat[dest] = (first.astype(np.int64)[:, None] + np.cumsum(d + 1, axis=1)
                     - (d[:, :1] + 1))
        nat = ((nat + 2**31) % 2**32 - 2**31).reshape(-1)  # int32 wrap
        for b, what in ((plain, "plain mixed"), (nat, "native mixed")):
            mixed_err = max(mixed_err, check(got, b, f"{what} at G={G}"))
        mixed = {"table": table, "out": out, "G": G, "stream": stream}
    torch.cuda.synchronize()
    log("kernel: 3 mixed-width cases bit-exact")

    # the uniform entry at the staged shapes, in turns with the plain
    # version; the mixed entry at the last case's table
    w = PACK_WIDTH
    turns = [UB.bench_uniform(U, dev, _G16_BUCKETS, w)]
    plain = []
    for _ in range(2):
        plain.append({})
        for G in _G16_BUCKETS:
            d_words, d_first = UB.uniform_inputs(G, w, G, dev)
            plain[-1][G] = cuda_ms(lambda: U.delta_decode_docs(
                U.unpack_blocks_torch(d_words, w), d_first), 100)
    turns.append(UB.bench_uniform(U, dev, _G16_BUCKETS, w))
    timing = []
    for a, b in zip(*turns):
        row = {k: a[k] for k in ("G", "width", "l2", "bound_ms", "source")}
        row.update({k: [a.get(k), b.get(k)] for k in ("ms", "host_us",
                                                      "call_us", "share")})
        if row["l2"] == "warm":
            row["plain_ms"] = [p[row["G"]] for p in plain]
        timing.append(row)
        log(f"kernel timing {row}")
    report["kernel_timing"] = timing
    big = [r for r in timing if r["G"] == max(_G16_BUCKETS)
           and r["l2"] == "warm"][0]

    G, table, out = mixed["G"], mixed["table"], mixed["out"]
    mixed_bytes = 4 * mixed["stream"].size + (4 + 13 + 512) * G
    m1 = UB.timed(lambda: U.unpack_mixed_blocks(*table, out=out), 100, 500,
                  mixed_bytes)
    mp = cuda_ms(lambda: U.unpack_mixed_blocks_torch(*table, out=out), 5)
    m2 = UB.timed(lambda: U.unpack_mixed_blocks(*table, out=out), 100, 500,
                  mixed_bytes)
    report["kernel_timing_mixed"] = {"G": G, "turns": [m1, m2],
                                     "plain_ms": mp}
    log(f"kernel timing mixed G={G}: {m1['ms']} / {m2['ms']} ms, plain {mp}")
    # the decode is a few integer ops per value: bytes bound it. No single
    # PyTorch call computes it (library_ms null).
    return {
        "unpack_delta_blocks": {
            "max_abs_err": max_err, "ms": min(big["ms"]),
            "host_us": min(big["host_us"]), "plain_ms": min(big["plain_ms"]),
            "bound_ms": big["bound_ms"], "shape": f"w=16 G={big['G']}"},
        "unpack_mixed_blocks": {
            "max_abs_err": mixed_err, "ms": min(m1["ms"], m2["ms"]),
            "host_us": min(m1["host_us"], m2["host_us"]), "plain_ms": mp,
            "bound_ms": m1["bound_ms"], "shape": f"random widths G={G}"}}


def search_kernel_phase(report: dict) -> dict:
    """The bs search kernel against its plain torch version on the card
    (tools/search_bench.check_cases: raw and tc, T in {1, 2, 3, 4, 8, 9},
    L in {128, 512, 2048, 8192, 32768, 65536}, M in {16, 64, L}, empty,
    short and long candidate runs, planted boundary ties, and
    search_bench.edge_cases), entry() on the card against the same call
    on the CPU (its rows at 4, 2 and 1 slots), then the kernel held
    against and timed in turns with the plain version (kernel, plain,
    plain, kernel; CUDA events) at the headline's bs shapes, raw and tc
    (search_bench.time_shapes), where each call must take the tile path
    in the launches its plan names (one where L fits a tile) and
    allocate no (B, L) plane. Returns the kernels line's bs_search
    entry."""
    import torch

    from wiser_tpu_torch.engine.kernels import n_iters_for, search_body
    from wiser_tpu_torch.entry import entry
    from wiser_tpu_torch.ops.search import bs_search
    from wiser_tpu_torch.tools import search_bench as SB

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    chk = SB.check_cases(dev)
    torch.cuda.synchronize()
    chk.pop("rows")
    report["search_check"] = dict(chk, wall_s=time.perf_counter() - t0)
    log(f"kernel: bs_search equal to its plain version in {chk['cases']} "
        f"cases: {report['search_check']}")

    # entry() on the card against the same call on the CPU
    # (search_bench.check: flags bit-equal; kept lanes equal to the CPU's
    # whole plane in (score desc, doc asc) order, on a flagged row the
    # lowest docs of its boundary class). Its 4-slot rows match no doc at
    # 240 docs, so its index and rows cut to their first 1 and 2 slots go
    # through search_body too.
    fn, args = entry("cuda")
    fn_cpu, args_cpu = entry("cpu")
    L, M = 128, 16
    n_iters = n_iters_for(args[0].numel())

    def cut(a, T):
        return list(a[:3]) + [x[:, :T].contiguous() for x in a[3:]]

    report["entry"] = {}
    for T in (4, 2, 1):
        if T == 4:
            got, want = fn(*args), fn_cpu(*args_cpu)
        else:
            got = search_body(*cut(args, T), T=T, L=L, M=M,
                              n_bs_iters=n_iters)
            want = search_body(*cut(args_cpu, T), T=T, L=L, M=M,
                               n_bs_iters=n_iters)
        full = search_body(*cut(args_cpu, T), T=T, L=L, M=L,
                           n_bs_iters=n_iters)
        report["entry"][f"T{T}"] = SB.check(got, want, full, M,
                                            f"entry() at T={T}")
    if not (report["entry"]["T1"]["kept"] and report["entry"]["T2"]["kept"]):
        raise AssertionError("entry()'s rows at 1 or 2 slots kept no doc")
    log(f"kernel: entry() on the card equals the CPU: {report['entry']}")

    t0 = time.perf_counter()
    timing = {mode: SB.time_shapes(dev, mode) for mode in ("raw", "tc")}
    report["search_timing"] = dict(timing, wall_s=time.perf_counter() - t0)
    for rows in timing.values():
        for r in rows:
            plan = r["plan"]
            seen = r["launch_ms"]["events"]
            if plan["path"] != "tile" or (
                    r["launch_ms"]["total"] is not None
                    and r["launches_per_call"] != plan["launches"]):
                raise AssertionError(f"bs_search at {r['mode']} T={r['T']} "
                                     f"L={r['L']}: plan {plan}, launches "
                                     f"{seen}")
    # the tile path allocates no (B, L) plane: the widest group's peak
    row = max(timing["raw"], key=lambda r: r["B"] * r["L"] * r["T"])
    B, cols, batch = SB.shape_batch(row["T"], row["L"])
    t = SB.to_device(cols, batch, dev)
    n_iters = n_iters_for(int(cols["t_len"].max()))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    SB.call(bs_search, t, "raw", row["T"], row["L"], row["M"], n_iters)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    report["search_peak_bytes"] = {"extra": extra,
                                   "plane": B * row["L"] * 4}
    if extra >= B * row["L"]:
        raise AssertionError(f"bs_search allocated {extra} bytes on a "
                             f"(B={B}, L={row['L']}) group")
    del t
    # the line's row: the widest group of the timed shapes
    err = max([chk["max_abs_err"]] + [r["check"]["max_abs_err"]
                                      for rows in timing.values()
                                      for r in rows])
    return {"max_abs_err": err, "ms": row["device_ms"],
            "host_us": row["host_us"], "plain_ms": min(row["plain_ms"]),
            "bound_ms": row["bound_ms"],
            "shape": f"raw B={row['B']} T={row['T']} L={row['L']} "
                     f"M={row['M']}"}


# the dense tier's kernels: (name, the TPU-side step it replaces);
# dense_scan counts the raw scan's launches, dense_scan_tc the tc
# scan's
DENSE_KERNELS = (
    ("dense_scan", "wiser_tpu/engine/kernels.py:1863"),
    ("dense_scan_tc", "wiser_tpu/engine/kernels.py:1061"),
    ("dense_tc_table", "wiser_tpu/engine/kernels.py:77"),
    ("dense_scan_merge", "wiser_tpu/engine/kernels.py:284"),
    ("dense_pick", "wiser_tpu/engine/kernels.py:1222"),
    ("phrase_sweep", "wiser_tpu/engine/kernels.py:1648"),
    ("phrase_sweep_tc", "wiser_tpu/engine/kernels.py:1648"),
    ("phrase_select", "wiser_tpu/engine/kernels.py:1648"),
    ("phrase_select_tc", "wiser_tpu/engine/kernels.py:1648"),
    ("phrase_band", "wiser_tpu/engine/kernels.py:1648"),
    ("phrase_band_tc", "wiser_tpu/engine/kernels.py:1648"))
# the kernel phase's timed shapes on synthetic 1M planes (the dense and
# tc phases time every engine shape on the engines' own planes)
DENSE_KERNEL_FULL, DENSE_KERNEL_PRUNED = ((128, 2),), ((1024, 2),)
# the phrase's passes: the kernel phase times the mega chunk (B 128, T 2)
# at KV 1,024 and the rescue's 4,096 on synthetic 1M planes; the dense
# and tc phases every group of dense_bench.PHRASE_SHAPES at KV 1,024 and
# the chunk at 4,096 on the engines' planes, with one plain turn each
PHRASE_KERNEL = ((128, 2),)
PHRASE_PLAIN_ITERS = 1


def phrase_rows(timing: dict) -> dict:
    """The kernels line's entries of the phrase's passes from
    dense_bench.time_phrase_shapes rows ({mode: rows}): phrase_sweep
    {,_tc} and phrase_select{,_tc} from the selection at B 128, T 2, KV
    1,024 (the threshold-first path: each launch's own device time and
    bound, dense_bench.phrase_part_bytes), phrase_band{,_tc} from its
    band pass at the `stream` threshold (every row needs the band; tc:
    a payload tie at the (KV+1)-th lane, so a row reads its listed
    blocks and finds no band lane; raw: that lane flags at once), beside
    the `skip` reading (no row needs the band: the usual group) and, where
    the band was listed, the stream over every block; each its own
    launches' device time by torch.profiler (the call's CUDA events where
    the capture lost one; the band's queued behind a sleep too), host
    cost, plain version (the whole selection's for both of its launches),
    bound and shares; the other readings stay in the report."""
    from wiser_tpu_torch.tools.dense_bench import HBM_BYTES_PER_S

    out = {}
    for mode, rows in timing.items():
        sfx = "_tc" if mode == "tc" else ""
        tc = "true" if mode == "tc" else "false"
        def at(kind):
            return next((x for x in rows if x["kind"] == kind
                         and x["B"] == 128 and x["T"] == 2
                         and x["KV"] == 1024), None)

        for kind, name in (("phrase_select", "phrase_select"),
                           ("phrase_band_stream", "phrase_band")):
            r = at(kind)
            if r is None:
                continue
            shape = (f"{mode} B=128 T=2 N_pad={r['N_pad']} KV=1024"
                     + (f" (every row needs the band; {r['need_rows']} "
                        f"rows, {r['flagged']} flag, "
                        f"{r.get('listed_blocks', 'every')} listed blocks "
                        f"read by the rest)" if "band" in kind else ""))
            base = {"max_abs_err": 0.0, "host_us": r["host_us"],
                    "plain_ms": min(r["plain_ms"]),
                    "launches_per_call": r["launches_per_call"]}
            if kind == "phrase_band_stream":
                ms = r["launch_ms"]["total"]
                entry_ms = ms if ms is not None else r["queued_ms"]
                entry = dict(
                    base, ms=entry_ms,
                    timing="torch.profiler" if ms is not None
                    else "CUDA events, queued", queued_ms=r["queued_ms"],
                    bound_ms=r["bound_ms"], share=r["bound_ms"] / entry_ms,
                    share_per_query=r["bound_ms_per_query"] / entry_ms,
                    queued_share=r["bound_ms"] / r["queued_ms"],
                    shape=shape)
                for other, key in (("phrase_band_skip", "skip"),
                                   ("phrase_band_stream_all", "stream_all")):
                    o = at(other)
                    if o is not None:
                        entry[f"{key}_ms"] = o["queued_ms"]
                        entry[f"{key}_bound_ms"] = o["bound_ms"]
                out[name + sfx] = entry
                continue
            kernels = r["launch_ms"]["kernels"]
            parts = r.get("part_ms") or {}
            for part, kid in (("sweep", 3), ("select", 1)):
                nbytes = r["part_bytes"].get(part)
                if nbytes is None:
                    continue
                ms = kernels.get(f"scan_kernel<{tc}, {kid}>")
                timing = "torch.profiler"
                if ms is None and part in parts:
                    ms, timing = parts[part], "CUDA events, queued, alone"
                elif ms is None:
                    ms, timing = r["device_ms"], "CUDA events (the selection)"
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                out[f"phrase_{part}{sfx}"] = dict(
                    base, ms=ms, timing=timing,
                    bound_ms=bound, share=bound / ms,
                    selection_ms=r["device_ms"],
                    selection_bound_ms=r["bound_ms"],
                    selection_share=r["bound_ms"] / r["device_ms"],
                    shape=shape)
    return out


def dense_rows(timing: dict, err: float) -> dict:
    """The kernels line's entries of the dense kernels from
    dense_bench.time_shapes rows: dense_scan and dense_scan_merge from the
    raw full scan at B 128, T 2, dense_scan_tc from the tc one (when
    timed), dense_pick from the raw pick at the first pruned group; each
    its own launch's device time by torch.profiler, or, where the capture
    lost that launch, the call's CUDA events (less the merge's reading,
    for a scan); its host cost a call, its bound and its shares of the
    group's bound and of the per-query one. The merge's entry is left out
    when its launch was not captured (an earlier reading then stands);
    its bound is the segments' keys read and the outputs written, and
    plain_ms is the plain version of the whole scan for the scan and the
    merge."""
    import torch

    from wiser_tpu_torch.ops import dense as D
    from wiser_tpu_torch.tools.dense_bench import HBM_BYTES_PER_S

    def own(r, prefix):
        return next((v for k, v in r["launch_ms"]["kernels"].items()
                     if k.startswith(prefix) and v is not None), None)

    def scan_entry(full, mode):
        scan_ms = own(full, "scan_kernel")
        merge_ms = own(full, "merge_kernel")
        ms = (scan_ms if scan_ms is not None
              else full["device_ms"] - (merge_ms or 0.0))
        return merge_ms, {
            "max_abs_err": err, "ms": ms,
            "timing": ("torch.profiler" if scan_ms is not None
                       else "CUDA events"),
            "host_us": full["host_us"], "plain_ms": min(full["plain_ms"]),
            "bound_ms": full["bound_ms"],
            "share": full["bound_ms"] / ms,
            "share_per_query": full["bound_ms_per_query"] / ms,
            "shape": f"{mode} B={full['B']} T={full['T']} "
                     f"N_pad={full['N_pad']} M={full['M']}"}

    out = {}
    tc_full = next((r for r in timing.get("tc", []) if r["kind"] == "full"),
                   None)
    if tc_full is not None:
        out["dense_scan_tc"] = scan_entry(tc_full, "tc")[1]
    if "raw" not in timing:
        return out
    full = next(r for r in timing["raw"] if r["kind"] == "full")
    pick = next(r for r in timing["raw"] if r["kind"] == "pick")
    merge_ms, out["dense_scan"] = scan_entry(full, "raw")
    pick_ms = own(pick, "pick_kernel")
    pick_ms = pick_ms if pick_ms is not None else pick["device_ms"]
    out["dense_pick"] = {
        "max_abs_err": 0.0, "ms": pick_ms,
        "timing": ("torch.profiler" if own(pick, "pick_kernel") is not None
                   else "CUDA events"),
        "host_us": pick["host_us"], "plain_ms": min(pick["plain_ms"]),
        "bound_ms": pick["bound_ms"], "share": pick["bound_ms"] / pick_ms,
        "share_per_query": pick["bound_ms_per_query"] / pick_ms,
        "shape": f"raw B={pick['B']} T={pick['T']} NB={pick['NB']} "
                 f"C={pick['C']} anchor form"}
    if merge_ms is not None:
        B, T, M = full["B"], full["T"], full["M"]
        dev = torch.device("cuda", 0)
        p = D.plan(B, T, full["N_pad"] // 128, M, "raw",
                   D.resident_for("raw", T, M, dev))
        merge_bytes = B * p.nseg * p.K * 8 + B * (2 * M + T * M + 1) * 4
        out["dense_scan_merge"] = {
            "max_abs_err": err, "ms": merge_ms, "timing": "torch.profiler",
            "host_us": full["host_us"], "plain_ms": min(full["plain_ms"]),
            "bound_ms": merge_bytes / HBM_BYTES_PER_S * 1e3,
            "shape": f"{out['dense_scan']['shape']}, {p.nseg} segments"}
    return out


def dense_kernel_phase(report: dict) -> dict:
    """The dense tier's kernels against their plain torch versions on the
    card (tools/dense_bench.check_cases: the block-list scan over every
    block, raw and tc, the pick in both bound forms, the pruned scan, and
    the grid's edges), then timed on synthetic 1M planes in turns with
    the plain versions (dense_bench.time_shapes at DENSE_KERNEL_FULL and
    DENSE_KERNEL_PRUNED). Returns the kernels line's dense entries."""
    import torch

    from wiser_tpu_torch.tools import dense_bench as DB

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    chk = DB.check_cases(dev)
    torch.cuda.synchronize()
    chk.pop("rows")
    report["dense_check"] = dict(chk, wall_s=time.perf_counter() - t0)
    log(f"kernel: the dense kernels equal their plain versions in "
        f"{chk['cases']} cases: {report['dense_check']}")
    t0 = time.perf_counter()
    chk = DB.check_phrase_cases(dev)
    torch.cuda.synchronize()
    chk.pop("rows")
    report["phrase_check"] = dict(chk, wall_s=time.perf_counter() - t0)
    log(f"kernel: the phrase's passes equal their plain versions in "
        f"{chk['cases']} cases: {report['phrase_check']}")
    t0 = time.perf_counter()
    planes = DB.planes_1m(dev)
    timing = {mode: DB.time_shapes(dev, mode, planes=planes,
                                   full=DENSE_KERNEL_FULL,
                                   pruned=DENSE_KERNEL_PRUNED)
              for mode in ("raw", "tc")}
    err = max([chk["max_abs_err"]] + [r["check"]["max_abs_err"]
                                      for rows in timing.values()
                                      for r in rows])
    out = dense_rows(timing, err)
    for _ in range(2):  # a capture that lost the merge launch: again
        if "dense_scan_merge" in out:
            break
        again = {"raw": DB.time_shapes(dev, "raw", planes=planes,
                                       full=DENSE_KERNEL_FULL,
                                       pruned=DENSE_KERNEL_PRUNED)}
        out = dense_rows(again, err)
    ph = {mode: [r for KV in DB.PHRASE_KVS
                 for r in DB.time_phrase_shapes(
                     dev, mode, planes=planes, shapes=PHRASE_KERNEL,
                     KVs=(KV,), plain_iters=PHRASE_PLAIN_ITERS)]
          for mode in ("raw", "tc")}
    out.update(phrase_rows(ph))
    del planes
    torch.cuda.empty_cache()
    out["dense_tc_table"] = DB.time_tc_table(dev)
    report["dense_kernel_timing"] = dict(timing, phrase=ph,
                                         wall_s=time.perf_counter() - t0)
    return out


# the semidense step's and the verification's kernels on the path:
# (name, the TPU-side step it replaces, its source); the verification
# from kept docs (the mega routes) and from posting indices (the compact
# route)
SEMI_KERNELS = (
    ("semidense", "wiser_tpu/engine/kernels.py:1103",
     "wiser_tpu_torch/csrc/semidense.cu"),
    ("semidense_tc", "wiser_tpu/engine/kernels.py:989",
     "wiser_tpu_torch/csrc/semidense.cu"),
    ("phrase_verify_docs", "wiser_tpu/engine/kernels.py:1291",
     "wiser_tpu_torch/csrc/phrase.cu"))
# the kernel phase's timed shapes on synthetic 1M inputs: the semidense
# group (T, n_bs, L) at the engine's B, the verification's mega chunk
# (B, T, NL, PP, PW, run ids)
SEMI_KERNEL_SHAPES = ((3, 0, 2048),)
DOCS_KERNEL_SHAPES = ((128, 2, 1024, 16, 16, 30_000),)


def semi_rows(rows: list, err: float, source: str) -> dict:
    """The kernels line's entries from semidense_bench timing rows: the
    first semidense row of each column mode and the first verification
    row, each with its device time (torch.profiler, or the call's CUDA
    events where the capture lost a launch), host cost, plain version,
    bound and share."""
    out = {}
    for r in rows:
        name = ("phrase_" + r["kind"] if r["kind"].startswith("verify")
                else "semidense" + ("_tc" if r["mode"] == "tc" else ""))
        if name in out:
            continue
        shape = (f"{r['mode']} B={r['B']} T={r['T']} n_bs={r['n_bs']} "
                 f"L={r['L']} M={r['M']} N_pad={r['N_pad']}"
                 if r["kind"] == "semidense" else
                 f"B={r['B']} T={r['T']} NL={r['NL']} PP={r['PP']} "
                 f"PW={r['PW']}")
        out[name] = {
            "max_abs_err": err if r["kind"] == "semidense" else 0.0,
            "ms": r["device_ms"], "timing": r["timing"],
            "host_us": r["host_us"], "plain_ms": min(r["plain_ms"]),
            "bound_ms": r["bound_ms"], "share": r["share"],
            "launches_per_call": r["launches_per_call"],
            "peak_extra": r["peak_extra"],
            "shape": f"{shape} ({source})"}
    return out


def semi_kernel_phase(report: dict) -> dict:
    """The semidense step's and the verification's kernels against their
    plain versions on the card (semidense_bench.semidense_cases, the
    segmented kernel's edges segment_cases, and docs_cases), then timed
    on synthetic 1M inputs in turns with the plain versions. Returns the
    kernels line's entries."""
    import torch

    from wiser_tpu_torch.tools import semidense_bench as SDB

    dev = torch.device("cuda", 0)
    for key, fn in (("semidense_check", SDB.semidense_cases),
                    ("segment_check", SDB.segment_cases),
                    ("verify_docs_check", SDB.docs_cases)):
        t0 = time.perf_counter()
        chk = fn(dev)
        torch.cuda.synchronize()
        chk.pop("rows")
        report[key] = dict(chk, wall_s=time.perf_counter() - t0)
        log(f"kernel: {key}: the kernel equals its plain version in "
            f"{chk['cases']} cases: {report[key]}")
    t0 = time.perf_counter()
    rows = (SDB.time_semidense(dev, shapes=SEMI_KERNEL_SHAPES)
            + SDB.time_docs(dev, shapes=DOCS_KERNEL_SHAPES))
    torch.cuda.empty_cache()
    report["semi_kernel_timing"] = {"rows": rows,
                                    "wall_s": time.perf_counter() - t0}
    return semi_rows(rows, max(report["semidense_check"]["max_abs_err"],
                               report["segment_check"]["max_abs_err"]),
                     "synthetic 1M")


def semi_engine_timing(report: dict, name: str, rec) -> dict:
    """The largest recorded group and the most called shape of each kind
    (the semidense step, the verification) of a run's passes, each
    compared and timed after them (semidense_bench.time_calls); these
    launches come after the passes, so the main path's counts do not
    hold them. Returns the kernels line's entries (the largest
    group's)."""
    import torch

    from wiser_tpu_torch.tools import semidense_bench as SDB

    t0 = time.perf_counter()
    out = SDB.time_calls(rec)
    torch.cuda.empty_cache()
    report[f"{name}_semi_timing"] = dict(out, wall_s=time.perf_counter() - t0)
    rows = out["semidense"] + out["verify_docs"]
    err = max([r["check"]["max_abs_err"] for r in out["semidense"]] + [0.0])
    return semi_rows(rows, err, f"the {name} engine's own calls")


ROUTE_KERNELS = (
    ("semidense_phrase", "wiser_tpu/engine/kernels.py:840"),
    ("semidense_phrase_tc", "wiser_tpu/engine/kernels.py:840"),
    ("list_phrase", "wiser_tpu/engine/kernels.py:465"),
    ("list_phrase_tc", "wiser_tpu/engine/kernels.py:363"),
    ("compact_phrase", "wiser_tpu/engine/kernels.py:686"),
    ("compact_phrase_tc", "wiser_tpu/engine/kernels.py:686"),
    ("list_phrase_nogate", "wiser_tpu/engine/shard.py:227"),
    ("list_phrase_nogate_tc", "wiser_tpu/engine/shard.py:618"))
# the kernel phase's timed groups on synthetic 1M inputs: the semidense
# phrase at the mega chunk's B; the list chain at the engines' B 128 (the
# kernels line's row) and the serve phase's B 8 (phrase_bench.
# LIST_ENGINE), and a full list group; the compact route at the resident
# engine's L 32,768 group (B 128) and a mesh shard's L 131,072 (B 32); the
# mesh's list route at a shard's B 128
ROUTE_SDP_SHAPES = ((128, 2, 2048),)
ROUTE_LIST_SHAPES = ((128, 2, 512), (8, 2, 512), (1024, 2, 1024))
ROUTE_COMPACT_SHAPES = ((128, 2, 32768), (32, 2, 131072))
ROUTE_NOGATE_SHAPES = ((128, 2, 512),)


def route_kernel_phase(report: dict) -> dict:
    """The semidense phrase route's, the list chain's (with and without
    its gate) and the compact route's kernels against their plain
    versions on the card (phrase_bench.semidense_phrase_cases,
    list_phrase_cases and compact_phrase_cases), then timed on synthetic
    1M inputs in turns with the plain versions. Returns the kernels
    line's entries."""
    import torch

    from wiser_tpu_torch.tools import phrase_bench as PB

    dev = torch.device("cuda", 0)
    for key, fn in (("semidense_phrase_check", PB.semidense_phrase_cases),
                    ("list_phrase_check", PB.list_phrase_cases),
                    ("compact_phrase_check", PB.compact_phrase_cases)):
        t0 = time.perf_counter()
        chk = fn(dev)
        torch.cuda.synchronize()
        report[key] = dict(chk, wall_s=time.perf_counter() - t0)
        log(f"kernel: {key}: the kernel equals its plain version bit for "
            f"bit in {chk['cases']} cases: {report[key]}")
    t0 = time.perf_counter()
    rows = (PB.time_semidense_phrase(dev, shapes=ROUTE_SDP_SHAPES)
            + PB.time_list_phrase(dev, shapes=ROUTE_LIST_SHAPES)
            + PB.time_compact_phrase(dev, shapes=ROUTE_COMPACT_SHAPES)
            + PB.time_list_nogate(dev, shapes=ROUTE_NOGATE_SHAPES))
    torch.cuda.empty_cache()
    report["route_kernel_timing"] = {"rows": rows,
                                     "wall_s": time.perf_counter() - t0}
    return PB.kernel_rows(rows, "synthetic 1M")


def route_engine_timing(report: dict, name: str, rec) -> dict:
    """The largest recorded group of each kind (the semidense phrase
    route, the list chain, the compact route) of a run's passes, compared
    and timed after
    them (phrase_bench.time_calls); these launches come after the passes,
    so the main path's counts do not hold them. Returns the kernels
    line's entries."""
    import torch

    from wiser_tpu_torch.tools import phrase_bench as PB

    t0 = time.perf_counter()
    out = PB.time_calls(rec, busiest=False)
    torch.cuda.empty_cache()
    report[f"{name}_route_timing"] = dict(out,
                                          wall_s=time.perf_counter() - t0)
    return PB.kernel_rows([r for k in PB.Recorder.KINDS for r in out[k]],
                          f"the {name} engine's own calls")


def route_launches(report: dict):
    """Whether every run mix's timed pass (the mesh's aside: mesh_phase
    checks its own) that answered queries on the semidense phrase, the
    list or the compact route launched that route's kernel (either column
    mode) there. Returns ({entry and kernel: [queries, launches]}, [the
    entries where it did not])."""
    seen, idle = {}, []
    for key, r in report.items():
        if not (isinstance(r, dict) and isinstance(r.get("launches"), dict)
                and isinstance(r.get("stats"), dict)) or \
                key.startswith("mesh"):
            continue
        st, ln = r["stats"], r["launches"]
        for route, kernel in (("phrase_semidense", "semidense_phrase"),
                              ("phrase_list", "list_phrase"),
                              ("phrase_compact", "compact_phrase")):
            took = (st.get(f"route_{route}", 0)
                    + st.get(f"hot_route_{route}", 0))
            n = ln.get(kernel, 0) + ln.get(kernel + "_tc", 0)
            if took:
                seen[f"{key} {kernel}"] = [took, n]
                if not n:
                    idle.append(f"{key} ({route}: {took} queries)")
    return seen, idle


def dense_engine_timing(report: dict, name: str, eng) -> dict:
    """dense_bench.time_shapes on a TorchEngine's own 1M planes (every
    engine shape, its columns' mode); these launches come after the
    timed passes, so the main path's counts do not hold them. Returns
    the kernels line's dense entries (raw: the scan, its merge and the
    pick; tc: the tc scan)."""
    import torch

    from wiser_tpu_torch.tools import dense_bench as DB

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    timing = {eng.columns: DB.time_shapes(dev, eng.columns,
                                          planes=DB.engine_planes(eng))}
    torch.cuda.empty_cache()
    report[f"{name}_dense_timing"] = dict(timing,
                                          wall_s=time.perf_counter() - t0)
    err = max(r["check"]["max_abs_err"] for r in timing[eng.columns])
    t0 = time.perf_counter()
    planes = DB.engine_planes(eng)
    ph = {eng.columns: DB.time_phrase_shapes(
              dev, eng.columns, planes=planes, KVs=(1024,),
              plain_iters=PHRASE_PLAIN_ITERS)
          + DB.time_phrase_shapes(dev, eng.columns, planes=planes,
                                  shapes=PHRASE_KERNEL, KVs=(4096,),
                                  plain_iters=PHRASE_PLAIN_ITERS)}
    del planes
    torch.cuda.empty_cache()
    report[f"{name}_phrase_timing"] = dict(ph,
                                           wall_s=time.perf_counter() - t0)
    return {**dense_rows(timing, err), **phrase_rows(ph)}


# -- index + queries ---------------------------------------------------------


def get_index(n_docs: int, report: dict):
    """The bi-bloom index and the mined phrase pairs (cached together)."""
    import resource

    from wiser_tpu_torch.data.scale_corpus import (generate_linedoc,
                                                   mine_phrases_from_linedoc)
    from wiser_tpu_torch.index.bloom import BloomConfig
    from wiser_tpu_torch.index.fast_builder import build_packed_fast
    from wiser_tpu_torch.index.format import PackedIndex

    idx_dir = os.path.join(CACHE, f"idx_{n_docs}_bibloom")
    pairs_path = os.path.join(idx_dir, "phrase_pairs.json")
    t0 = time.perf_counter()
    if os.path.exists(pairs_path):
        packed = PackedIndex.load(idx_dir)
        with open(pairs_path) as f:
            pairs = [tuple(p) for p in json.load(f)]
        report["index"] = {"cached": True, "load_s": time.perf_counter() - t0}
    else:
        os.makedirs(CACHE, exist_ok=True)
        path = os.path.join(CACHE, f"wiki_{n_docs}_bibloom.linedoc")
        generate_linedoc(path, n_docs, with_blooms=True, verbose=False)
        t1 = time.perf_counter()
        stats: dict = {}
        packed = build_packed_fast(path, with_blooms=True,
                                   bloom_cfg=BloomConfig(5, 0.0009),
                                   stats=stats)
        t2 = time.perf_counter()
        pairs = mine_phrases_from_linedoc(path, packed.term_to_row,
                                          max_pairs=2000, max_rows=2000)
        os.remove(path)
        packed.save(idx_dir)
        with open(pairs_path, "w") as f:
            json.dump(pairs, f)
        report["index"] = {
            "cached": False, "generate_s": t1 - t0, "build_s": t2 - t1,
            "bloom_build_s": stats["bloom_s"],
            # ru_maxrss is in KiB on Linux
            "peak_host_rss_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    report["index"].update(n_docs=packed.n_docs, n_terms=packed.n_terms,
                           padded_postings=packed.n_postings,
                           max_df=int(packed.df.max()),
                           bloom_row_bytes=2 * packed.bloom_ends.nbytes,
                           phrase_pairs=len(pairs))
    log(f"index: {report['index']}")
    return packed, pairs


# the phases that load the 1M index
INDEX_PHASES = ("resident", "dense", "phrase", "staged", "tc", "staged_tc",
                "harness", "mesh")


def start_index_build(n_docs: int):
    """get_index in a child process, so that the index's host-bound build
    runs while the libraries build and the kernel, headline and serve
    phases run; None where the index is cached. The child builds into this process's CACHE and prints
    get_index's report line last on stdout. The kernel phase's host
    readings are then taken beside the build: each row says so
    (host_us_beside_build)."""
    idx_dir = os.path.join(CACHE, f"idx_{n_docs}_bibloom")
    if os.path.exists(os.path.join(idx_dir, "phrase_pairs.json")):
        return None
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.CACHE = sys.argv[3]; r = {}; "
            "chip_smoke.get_index(int(sys.argv[2]), r); "
            "print(json.dumps(r['index']), flush=True)")
    return subprocess.Popen([sys.executable, "-c", code, ROOT, str(n_docs),
                             CACHE], stdout=subprocess.PIPE, text=True,
                            cwd=ROOT)


def aol_mixed_queries(packed, n_queries: int, seed: int = 7,
                      by_df: bool = False):
    """bench.py's AOL-mix conjunctions over the index, k = K
    (tools/route_bench.aol_mixed_queries; by_df: the df-ranked set)."""
    from wiser_tpu_torch.tools.route_bench import aol_mixed_queries as aol

    return aol(packed, n_queries, seed, by_df, K)


def phrase_queries(pairs, n_queries: int, seed: int = 7):
    """n_queries phrase queries drawn uniformly from the mined pairs."""
    import numpy as np

    from wiser_tpu_torch.types import SearchQuery

    idx = np.random.default_rng(seed).integers(0, len(pairs), size=n_queries)
    return [SearchQuery(list(pairs[i]), n_results=K, is_phrase=True)
            for i in idx]


def windowed_eligible(packed, queries, limit: int):
    """Up to `limit` of the queries that TorchEngine's routing sends to the
    windowed kernel when it has no dense tier: 2+ terms, candidate (least
    df) bucket within [WINDOWED_MIN_L, WINDOWED_MAX_L] and the longest
    list's bucket at most WINDOWED_MAX_RATIO times it."""
    from wiser_tpu_torch import TorchEngine as E
    from wiser_tpu_torch.engine.host import L_BUCKETS, _bucket

    out = []
    for q in queries:
        dfs = [int(packed.df[packed.term_to_row[t]]) for t in q.terms]
        if len(dfs) < 2:
            continue
        L = _bucket(min(dfs), L_BUCKETS)
        if (E.WINDOWED_MIN_L <= L <= E.WINDOWED_MAX_L
                and _bucket(max(dfs), L_BUCKETS) // L <= E.WINDOWED_MAX_RATIO):
            out.append(q)
    return out[:limit]


def parity_sample(queries):
    """Indices of up to PARITY_SAMPLE distinct multi-term queries."""
    seen, out = set(), []
    for i, q in enumerate(queries):
        key = (tuple(q.terms), q.is_phrase)
        if len(q.terms) >= 2 and key not in seen:
            seen.add(key)
            out.append(i)
    return out[:PARITY_SAMPLE]


def check_parity(packed, queries, results, sample, what: str,
                 expected: dict) -> int:
    """Compare against the exact host search (phrase search for phrase
    queries); `expected` memoizes its answers across runs (the index is
    the same)."""
    from wiser_tpu_torch.engine.host import host_exact_search
    from wiser_tpu_torch.scoring import Bm25Similarity

    cache64 = Bm25Similarity(packed.avg_len).cache
    bad = []
    for i in sample:
        q = queries[i]
        key = (tuple(q.terms), q.n_results, q.is_phrase)
        if key not in expected:
            rows = [packed.term_to_row[t] for t in q.terms]
            d, s = host_exact_search(packed, cache64, rows, q.n_results,
                                     is_phrase=q.is_phrase)
            expected[key] = [(int(a), float(b)) for a, b in zip(d, s)]
        want = expected[key]
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


def serve(engine, queries, report_key: str, report: dict,
          warm: int | None = None):
    """Warm pass (over the first `warm` queries, or all), then a timed
    pass over all of them with result memos cleared; returns the timed
    pass's results. Kernel launch counts are zeroed just before the timed
    pass and read just after it."""
    import torch

    engine.search_batch(queries[:warm])
    engine.clear_result_memos()
    engine.stats_take()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = engine.search_batch(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stats = engine.stats_take()
    multi = sum(len(q.terms) >= 2 for q in queries)
    report[report_key] = {"queries": len(queries), "warm_queries":
                          len(queries[:warm]), "wall_s": wall,
                          "qps": len(queries) / wall, "stats": stats,
                          "multi_term_queries": multi, "launches": launches,
                          "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log(f"{report_key}: {len(queries)} queries in {wall:.3f}s = "
        f"{len(queries) / wall:.1f} QPS; launches {launches}; stats {stats}")
    return results


# -- route and capacity checks ------------------------------------------------


def check_dense_routes(report: dict, name: str) -> None:
    st = report[f"{name}_aol_df"]["stats"]
    if not (st.get("route_pruned", 0) > 0
            and st.get("route_semidense", 0) > 0):
        raise AssertionError(
            f"{name} run: aol_df took no pruned or semidense route {st}")


def check_phrase_routes(report: dict, name: str) -> None:
    """The full-scan, semidense and compact-or-list phrase routes each
    answer some of the phrase set, and where the full scan answered any,
    the phrase's selection, band and verification from kept docs
    launched (the tc ones on tc columns), and the selection's sweep
    where the mega chunk's plan takes the threshold-first path (its doc
    space holds KV + 1 blocks)."""
    from wiser_tpu_torch.ops import dense as D

    r = report[f"{name}_phrase"]
    st = r["stats"]
    routes = {k: st.get(f"route_phrase_{k}", 0)
              for k in ("full", "semidense", "compact", "list", "host")}
    r["phrase_routes"] = routes
    if not (routes["full"] > 0 and routes["semidense"] > 0
            and routes["compact"] + routes["list"] > 0):
        raise AssertionError(
            f"{name} run: a phrase route took no query {routes}")
    info = report[f"{name}_engine"]
    sfx = "_tc" if info["columns"] == "tc" else ""
    names = ["phrase_select", "phrase_band"]
    if D.select_path(1, info["n_pad_docs"] // 128,
                     info["phrase_kv"]) == "two":
        names.append("phrase_sweep")
    kernels = {k + sfx: r["launches"].get(k + sfx, 0) for k in names}
    kernels["phrase_verify_docs"] = r["launches"].get("phrase_verify_docs",
                                                      0)
    if routes["full"] > 0 and not all(kernels.values()):
        raise AssertionError(
            f"{name} run: {routes['full']} full-scan phrases, but the "
            f"phrase's kernels launched {kernels}")


def check_tc_capacity(report: dict) -> None:
    """tc postings at most 0.51 of the raw engine's bytes and a larger
    dense tier at the same budget, against the dense phase's engine."""
    raw = report["dense_engine"]
    tc = report["tc_engine"]
    ratio = tc["device_bytes"]["postings"] / raw["device_bytes"]["postings"]
    report["tc_engine"]["postings_vs_raw"] = ratio
    if ratio > 0.51 or tc["dense_rows"] <= raw["dense_rows"]:
        raise AssertionError(
            f"tc capacity: postings {ratio:.4f} of raw (limit 0.51), "
            f"{tc['dense_rows']} dense rows vs raw {raw['dense_rows']}")


def check_staging(report: dict, name: str) -> None:
    """A budget that stages: dense rows admitted, cold chunks staged and
    their doc columns decoded by the unpack kernel."""
    info = report[f"{name}_engine"]
    mixes = [report[f"{name}_{mix}"] for mix in ("aol", "aol_df")]
    chunks = sum(r["stats"].get("cold_chunks", 0) for r in mixes)
    launches = sum(r["launches"]["unpack_delta_blocks"] for r in mixes)
    if info["dense_rows"] <= 0 or chunks <= 0 or launches <= 0:
        raise AssertionError(
            f"{name} run: {info['dense_rows']} dense rows, {chunks} cold "
            f"chunks, {launches} unpack launches (all must be > 0)")


def check_staged_phrases(report: dict, name: str) -> None:
    """Phrases answered on the cold device path (phrase_body over staged
    bags) with the unpack kernel launched, and at a budget that admits
    terms some through the hot engine's phrase routes too."""
    r = report[f"{name}_phrase"]
    st = r["stats"]
    hot = sum(v for k, v in st.items() if k.startswith("hot_route_phrase_"))
    cold = st.get("route_cold_phrase", 0)
    launches = r["launches"]["unpack_delta_blocks"]
    r["phrase_split"] = {"hot": hot, "cold_device": cold,
                         "cold_lane_budget_host":
                             st.get("route_cold_phrase_host", 0),
                         "cold_sat_host": st.get("route_cold_sat_host", 0)}
    if cold <= 0 or launches <= 0 or (name != "staged" and hot <= 0):
        raise AssertionError(
            f"{name} phrase: {hot} hot, {cold} cold device phrases, "
            f"{launches} unpack launches")


def check_windowed(report: dict) -> None:
    """Resident aol_df takes the windowed route; the windowed set takes
    only it, and only bs with the route switched off."""
    n = report["resident_aol_df"]["stats"].get("route_windowed", 0)
    on = report["resident_windowed"]["stats"]
    off = report["resident_windowed_bs"]["stats"]
    if (n <= 0 or on.get("route_bs", 0) or on.get("route_host_merge", 0)
            or off.get("route_windowed", 0) or off.get("route_host_merge", 0)
            or on.get("route_windowed", 0) != off.get("route_bs", 0)):
        raise AssertionError(
            f"windowed: aol_df {n}; on {on}; off {off}")


def check_pruned_phrases(report: dict, name: str) -> None:
    st = report[f"{name}_phrase_pruned"]["stats"]
    if st.get("route_phrase_pruned", 0) <= 0 or st.get("route_phrase_full"):
        raise AssertionError(f"{name} phrase_pruned: no pruned mega route "
                             f"{st}")


# -- headline and serve --------------------------------------------------------

BENCH_VOCAB, BENCH_MEAN_LEN = 20_000, 120  # bench.py's corpus
SERVE_QUERIES, SERVE_PHRASES, WIRE_BATCH, SERVE_THREADS = 4096, 512, 64, 8


def bench_corpus(n_docs: int, report: dict):
    """bench.py's synthetic corpus through the port's builder, saved where
    bench.headline.get_index looks for it; returns (packed, oracle)."""
    from wiser_tpu_torch.data.synth import synth_docinfos
    from wiser_tpu_torch.index.builder import build_index

    t0 = time.perf_counter()
    docs = synth_docinfos(n_docs, BENCH_VOCAB, BENCH_MEAN_LEN, zipf_a=1.25,
                          seed=42, with_blooms=False)
    t1 = time.perf_counter()
    packed, oracle = build_index(docs)
    t2 = time.perf_counter()
    packed.save(os.path.join(
        CACHE, f"torch_idx_{n_docs}_{BENCH_VOCAB}_{BENCH_MEAN_LEN}"))
    report["bench_index"] = {
        "synth_s": t1 - t0, "build_s": t2 - t1, "n_docs": packed.n_docs,
        "n_terms": packed.n_terms, "padded_postings": packed.n_postings}
    log(f"bench index: {report['bench_index']}")
    return packed, oracle


def headline_phase(report: dict, n_docs: int, n_queries: int) -> None:
    """bench_corpus(n_docs) has saved the index: run() loads it from CACHE."""
    import torch

    from wiser_tpu_torch.bench import headline as H

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = H.run(n_docs=n_docs, vocab=BENCH_VOCAB, mean_len=BENCH_MEAN_LEN,
                n_queries=n_queries, columns="raw", profile=True,
                device="cuda", cache_dir=CACHE)
    torch.cuda.synchronize()
    line = out["line"]
    report["headline"] = dict(
        line, wall_s=time.perf_counter() - t0, passes=out["passes"],
        launches=read_counts(), stats=out["stats"],
        peak_device_bytes=torch.cuda.max_memory_allocated())
    queries, results = out["queries"], out["results"]
    report["headline"]["parity_checked"] = check_parity(
        out["packed"], queries, results, parity_sample(queries), "headline",
        {})
    log(f"headline: {report['headline']}")


def mined_phrases(bodies, n: int):
    """The first n distinct adjacent word pairs of the bodies."""
    seen, out = set(), []
    for body in bodies:
        words = body.split(" ")
        for a, b in zip(words, words[1:]):
            if a != b and (a, b) not in seen:
                seen.add((a, b))
                out.append([a, b])
                if len(out) == n:
                    return out
    return out


def serve_phase(report: dict, corpus) -> None:
    import threading

    import numpy as np
    import torch

    from wiser_tpu_torch.bench import headline as H
    from wiser_tpu_torch.engine.factory import create_search_engine
    from wiser_tpu_torch.index.doc_store import (ChunkedDocStoreWriter,
                                                 LazyDocBodies)
    from wiser_tpu_torch.serve.server import BatchingExecutor
    from wiser_tpu_torch.types import SearchQuery

    packed, oracle = corpus
    t0 = time.perf_counter()
    idx_dir = os.path.join(CACHE, f"serve_{packed.n_docs}")
    packed.save(idx_dir)
    w = ChunkedDocStoreWriter(os.path.join(idx_dir, "docs"))
    for body in oracle.doc_bodies:
        w.add(body)
    w.close()
    engine = create_search_engine(f"torch:{idx_dir}")
    if not (isinstance(engine.doc_bodies, LazyDocBodies)
            and engine.doc_bodies._r.codec == "lz4"):
        raise AssertionError("serve: the engine has no LZ4 doc store")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(7)
    queries = H.aol_mixed_queries(packed, SERVE_QUERIES) + [
        SearchQuery(p, n_results=K, is_phrase=True)
        for p in mined_phrases(oracle.doc_bodies, SERVE_PHRASES)]
    queries = [queries[i] for i in rng.permutation(len(queries))]
    for q in queries[::2]:
        q.return_snippets, q.n_snippet_passages = True, 3
    batches = [queries[i : i + WIRE_BATCH]
               for i in range(0, len(queries), WIRE_BATCH)]

    def drive(executor):
        """8 threads, each serving every 8th wire batch through
        search_many; returns (results in query order, per-request
        latencies: each request's wire batch round trip, wall)."""
        results = [None] * len(batches)
        lat = [None] * len(batches)

        def worker(tid):
            for bi in range(tid, len(batches), SERVE_THREADS):
                t = time.perf_counter()
                results[bi] = executor.search_many(batches[bi])
                lat[bi] = [time.perf_counter() - t] * len(batches[bi])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        if any(r is None for r in results):
            raise AssertionError("serve: a wire batch got no answer")
        return ([r for rs in results for r in rs],
                np.array([x for xs in lat for x in xs]), wall)

    executor = BatchingExecutor(engine, max_batch=4096, max_wait_ms=2.0)
    try:
        drive(executor)  # warm pass
        engine.clear_result_memos()
        engine.stats_take()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        results, lat, wall = drive(executor)
        torch.cuda.synchronize()
    finally:
        executor.stop()
    launches = read_counts()

    # parity: distinct multi-term queries (AND and phrase, with and without
    # snippets) against the oracle over the same docs, snippets included
    seen, sample = set(), []
    for i, q in enumerate(queries):
        key = (tuple(q.terms), q.is_phrase, q.return_snippets)
        if len(q.terms) >= 2 and key not in seen:
            seen.add(key)
            sample.append(i)
    sample = ([i for i in sample if not queries[i].is_phrase][:256]
              + [i for i in sample if queries[i].is_phrase][:128])
    bad = []
    for i in sample:
        want = [(e.doc_id, e.doc_score, e.snippet)
                for e in oracle.search(queries[i]).entries]
        got = [(e.doc_id, e.doc_score, e.snippet) for e in results[i].entries]
        if got != want:
            bad.append((queries[i], got[:1], want[:1]))
    n_phr = sum(queries[i].is_phrase for i in sample)
    if len(sample) < 200 or n_phr == 0:
        raise AssertionError(f"serve: {len(sample)} parity queries, "
                             f"{n_phr} phrases")
    if bad:
        raise AssertionError(f"serve: {len(bad)}/{len(sample)} mismatches "
                             f"against the oracle, first: {bad[0]}")
    snips = [e.snippet for q, r in zip(queries, results) if q.return_snippets
             for e in r.entries]
    if not any("<b>" in s for s in snips):
        raise AssertionError("serve: no snippet holds <b>")
    if any(e.snippet for q, r in zip(queries, results)
           if not q.return_snippets for e in r.entries):
        raise AssertionError("serve: a query that asked for no snippet "
                             "got one")
    log(f"serve: parity 0/{len(sample)} mismatches ({n_phr} phrases), "
        f"snippets included")
    report["serve"] = {
        "queries": len(queries), "phrase_queries": SERVE_PHRASES,
        "snippet_queries": len(queries[::2]), "threads": SERVE_THREADS,
        "wire_batch": WIRE_BATCH, "setup_s": setup_s, "wall_s": wall,
        "qps": len(queries) / wall,
        "latency_ms": {"p50": 1e3 * float(np.percentile(lat, 50)),
                       "p99": 1e3 * float(np.percentile(lat, 99))},
        "snippets_with_b": sum("<b>" in s for s in snips),
        "parity_checked": len(sample), "parity_phrases": n_phr,
        "launches": launches, "stats": engine.stats_take(),
        "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log(f"serve: {report['serve']}")


# -- harness ------------------------------------------------------------------

# the audit and the memory grid cut from 64 and 2,048 queries when the
# mesh phase came in and the grid again from 1,024 when the phrase routes'
# kernels came in, to keep the smoke inside its time (the scale configs'
# 2,048, cut to 1,024 for a while, restored once the index built beside
# the kernel phase)
HARNESS_Q, HARNESS_AUDIT, HARNESS_ROUTE_Q, HARNESS_GRID_Q = 2048, 32, 256, 512
HARNESS_FRACS = (0.05, 0.25)
GRID_KEYS = ("budget_bytes", "hot_fraction", "phrase_hot_fraction",
             "dense_fraction", "hot_bytes_used", "device_mem_bytes", "qps",
             "unpack_launches")


def harness_phase(report: dict, packed, pairs, engines: dict,
                  trace_dir: str) -> int:
    """The port's harness functions on the 1M index, in process: the
    scale ladder (configs 1-4), a strict parity audit, the route sets
    (zipf_t3 traced by torch.profiler), the memory grid and the stage
    probe. engines: the dense and tc phases' engines, if they ran.
    Returns the unpack kernel's launches over the phase."""
    import torch

    from wiser_tpu_torch import TorchEngine
    from wiser_tpu_torch.bench import run_exp
    from wiser_tpu_torch.ops import unpack as U
    from wiser_tpu_torch.tools import (parity_audit, route_bench,
                                       scale_bench, stage_probe)

    out = report["harness"] = {}
    t_phase = time.perf_counter()
    reset_counts()
    dense = engines.get("dense") or TorchEngine(packed, device="cuda")

    # the ladder: configs 1-4, HARNESS_Q queries each, 2 batches in flight
    t0 = time.perf_counter()
    configs = scale_bench.build_configs(packed, None, HARNESS_Q, K,
                                        pairs=pairs)
    ladder = scale_bench.ladder(dense, packed, configs, HARNESS_Q, 50)
    out["scale_bench"] = {"configs": ladder,
                          "wall_s": time.perf_counter() - t0}
    bad = {n: r["parity_mismatches"] for n, r in ladder.items()}
    if len(ladder) != 4 or any(bad.values()):
        raise AssertionError(f"scale_bench: configs {sorted(ladder)}, "
                             f"parity mismatches {bad}")
    log(f"harness scale_bench: {out['scale_bench']}")

    # strict parity, every result verified on the host (this engine with
    # strict_parity on for the audit)
    t0 = time.perf_counter()
    dense.strict_parity = True
    try:
        audit = {n: parity_audit.audit_config(dense, packed,
                                              qs[:HARNESS_AUDIT],
                                              HARNESS_AUDIT)
                 for n, qs in configs.items()}
    finally:
        dense.strict_parity = False
    out["parity_audit"] = {"configs": audit,
                           "wall_s": time.perf_counter() - t0}
    bad = {n: r["mismatches"] for n, r in audit.items()}
    if any(bad.values()):
        raise AssertionError(f"parity_audit: mismatches {bad}")
    log(f"harness parity_audit: {out['parity_audit']}")

    # the route sets; the named route must take a majority of its set
    t0 = time.perf_counter()
    sets = route_bench.build_route_sets(packed, dense, HARNESS_ROUTE_Q, K)
    sets.update(route_bench.build_phrase_route_sets(
        packed, dense, None, HARNESS_ROUTE_Q, K, pairs=pairs))
    routes, minority = {}, {}
    for name, qs in sets.items():
        row = route_bench.run_set(
            dense, qs, HARNESS_ROUTE_Q,
            trace_dir=trace_dir if name == "zipf_t3" else None)
        row["route_counts"] = {k: v for k, v in row["stats"].items()
                               if k.startswith("route_") and v}
        share = route_bench.route_share(name, row["stats"])
        if share is not None and not 2 * share[0] > share[1]:
            minority[name] = row["route_counts"]
        routes[name] = row
        log(f"harness route {name}: {len(qs)} queries, {row['qps']:.1f} "
            f"QPS, routes {row['route_counts']}")
    out["route_bench"] = {"sets": routes, "wall_s": time.perf_counter() - t0}
    if "zipf_t3" not in routes or minority:
        raise AssertionError(f"route_bench: sets {sorted(routes)}; the named "
                             f"route took no majority in {minority}")
    traced = routes["zipf_t3"]["traced"]
    log(f"harness trace zipf_t3: {traced}")
    if traced["device"] != "cuda" or traced["busy_share"] is None:
        raise AssertionError(f"the trace saw no device events: {traced}")

    # the memory grid on this index, device cold path
    t0 = time.perf_counter()
    grid = []
    for t in run_exp.memory_matrix(n_queries=HARNESS_GRID_Q,
                                   batch=HARNESS_GRID_Q,
                                   fracs=HARNESS_FRACS,
                                   cold_compute="device"):
        before = U.launch_counts["unpack_delta_blocks"]
        r = dataclasses.asdict(run_exp.run_treatment(t, device="cuda",
                                                     packed=packed))
        r["unpack_launches"] = U.launch_counts["unpack_delta_blocks"] - before
        grid.append(r)
        torch.cuda.empty_cache()
        log(f"harness memory grid {t.name}: "
            + json.dumps({k: r[k] for k in GRID_KEYS}))
    out["run_exp"] = {"rows": grid, "wall_s": time.perf_counter() - t0}
    if not any(r["unpack_launches"] for r in grid):
        raise AssertionError("run_exp: no memory-grid row launched the "
                             "unpack kernel")

    # the stage probe on tc columns
    t0 = time.perf_counter()
    tc = engines.get("tc") or TorchEngine(packed, device="cuda",
                                          columns="tc")
    # C = 512 blocks, or half the index's blocks below 131,072 docs
    C = min(512, packed.n_docs // 256)
    out["stage_probe"] = dict(stage_probe.probe(tc, packed, B=512, T=3,
                                                C=C, M=16, SB=8),
                              wall_s=time.perf_counter() - t0)
    log(f"harness stage_probe: {out['stage_probe']}")
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t_phase
    launches = U.launch_counts["unpack_delta_blocks"]
    out["unpack_launches"] = launches
    out["bs_search_launches"] = read_counts()["bs_search"]
    out["launches"] = read_counts()
    return launches


def harness_summary(h: dict) -> dict:
    """The harness readings for the stdout line."""
    traced = h["route_bench"]["sets"]["zipf_t3"]["traced"]
    return {
        "wall_s": h["wall_s"],
        "scale_bench": {n: {"qps": r["qps"], "mismatches":
                            r["parity_mismatches"]}
                        for n, r in h["scale_bench"]["configs"].items()},
        "parity_audit": {n: {"mismatches": r["mismatches"],
                             "flags": r["flags"]}
                         for n, r in h["parity_audit"]["configs"].items()},
        "routes": {n: {"qps": r["qps"], "routes": r["route_counts"]}
                   for n, r in h["route_bench"]["sets"].items()},
        "trace_zipf_t3": {
            "busy_share": traced["busy_share"],
            "traced_wall_s": traced["wall_s"],
            "untraced_wall_s": traced["untraced_wall_s"],
            "top_ops": [(o["name"], o["self_ms"], o["calls"])
                        for o in traced["top_ops"][:5]]},
        "memory_grid": [{k: r[k] for k in GRID_KEYS}
                        for r in h["run_exp"]["rows"]],
        "stage_probe_ms": {k: v for k, v in h["stage_probe"].items()
                           if k.endswith("_ms")}}


# -- mesh -------------------------------------------------------------------

# the phrase prefix and the shard ladder's queries a config cut from 512
# and 2,048 when the full-scan phrase's checks came in, and the ladder's
# to 512 when the semidense and verification checks came in and to 256
# when the phrase routes' kernels came in, to keep the smoke well inside
# its time on a slow host (128 for a while, restored once the index built
# beside the kernel phase)
MESH_SHARDS, MESH_PRUNED_Q, MESH_LADDER_Q = 4, 1024, 256
MESH_PHRASE_Q, MESH_STAGED_PHRASE_Q = 256, 256
# the aol_df_pruned mix's PRUNED_DENSE_MIN_NB: under the 1,954 blocks a
# shard holds at 1M docs and 4 shards
MESH_PRUNED_MIN_NB = 1024


def mesh_phase(report: dict, packed, pairs, pools: dict, expected: dict,
               Q: int, recs: dict) -> dict:
    """The mesh at MESH_SHARDS shards on the card: the dry run, the sharded
    index, the raw / tc / staged mesh engines over the query sets (the
    smoke's serve and check_parity), the shard ladder. The raw and tc
    engines' phrase route calls over their mixes (not the ladder's) are
    recorded into recs[name] (phrase_bench.Recorder), for the caller to
    hold and time after the phase. Returns the summary line's object."""
    import torch

    from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
    from wiser_tpu_torch.engine.staged_shard import (ShardedStagedEngine,
                                                     full_residency_bytes)
    from wiser_tpu_torch.tools import scale_bench, shard_ladder
    from wiser_tpu_torch.tools.dryrun_multichip import dryrun_multichip
    from wiser_tpu_torch.tools.phrase_bench import Recorder

    D = MESH_SHARDS
    out = report["mesh"] = {"shards": D}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(D, "cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    log(f"mesh dryrun: {out['dryrun']}")
    t0 = time.perf_counter()
    sharded = ShardedIndex.from_packed(packed, D)
    out["from_packed_s"] = time.perf_counter() - t0
    W = min(Q, 128)
    flat = {"aol": ("aol", Q, {}, None), "aol_df": ("aol_df", Q, {}, None),
            "aol_df_pruned": ("aol_df", MESH_PRUNED_Q,
                              {"PRUNED_DENSE_MIN_NB": MESH_PRUNED_MIN_NB}, W),
            "phrase": ("phrase", MESH_PHRASE_Q, {}, W)}
    runs = [("mesh", lambda: ShardedEngine(sharded), flat),
            ("mesh_tc", lambda: ShardedEngine(sharded, columns="tc"), flat),
            ("mesh_staged", lambda: ShardedStagedEngine(
                packed, D, full_residency_bytes(packed, D) // 4,
                full=sharded),
             {"aol": ("aol", Q, {}, None),
              "aol_df": ("aol_df", MESH_PRUNED_Q, {}, None),
              "phrase": ("phrase", MESH_STAGED_PHRASE_Q, {}, W)})]
    mixes_out = {}
    for name, make, mixes in runs:
        t0 = time.perf_counter()
        eng = make()
        torch.cuda.synchronize()
        hot = getattr(eng, "hot", eng)
        info = {"init_s": time.perf_counter() - t0, "columns": hot.columns,
                "placement": [str(d) for d in hot.placement],
                "device_bytes": eng.device_bytes(),
                "shard_bytes": hot.shard_bytes(),
                "dense_rows": int(hot._dense_H),
                "dense_build_s": hot.dense_build_s}
        if name == "mesh_staged":
            info.update(hot_fraction=eng.hot_fraction,
                        hot_bytes_used=eng.hot_bytes_used,
                        total_full=eng.total_full)
        report[f"{name}_engine"] = info
        log(f"{name} engine: {info}")
        if name in ("mesh", "mesh_tc"):
            recs[name] = Recorder().__enter__()
        for mix, (pool, nq, attrs, warm) in mixes.items():
            queries = pools[pool][:nq]
            key = f"{name}_{mix}"
            for a, v in attrs.items():
                setattr(eng, a, v)  # this instance, this mix only
            res = serve(eng, queries, key, report, warm)
            for a in attrs:
                delattr(eng, a)
            report[key]["engine_attrs"] = attrs
            report[key]["parity_checked"] = check_parity(
                packed, queries, res, parity_sample(queries), key, expected)
            st = report[key]["stats"]
            mixes_out[key] = {
                "qps": report[key]["qps"], "queries": len(queries),
                "peak_device_bytes": report[key]["peak_device_bytes"],
                "routes": {k: v for k, v in st.items()
                           if (k.startswith("route_") or k.startswith("flag_")
                               or k in ("cold_chunks", "host_fallback_q",
                                        "forced_host_tie_cut"))
                           and v}}
        if name in recs:
            recs[name].__exit__(None, None, None)
        if name == "mesh":
            # the shard ladder on the raw mesh engine
            t0 = time.perf_counter()
            configs = scale_bench.build_configs(packed, None, MESH_LADDER_Q,
                                                K, pairs=pairs)
            ladder = shard_ladder.run(packed, eng, configs, MESH_LADDER_Q,
                                      50)
            out["ladder"] = {"configs": ladder,
                             "wall_s": time.perf_counter() - t0}
            bad = {n: r["parity_mismatches"] for n, r in ladder.items()}
            if len(ladder) != 4 or any(bad.values()):
                raise AssertionError(f"shard_ladder: configs {sorted(ladder)},"
                                     f" parity mismatches {bad}")
            log(f"mesh shard_ladder: {out['ladder']}")
        del eng, hot, res
        torch.cuda.empty_cache()

    def st(key):
        return report[key]["stats"]

    def launched(key, route, kernel):
        """A mix that answered queries on a phrase route launched its
        kernel (either column mode) on its timed pass."""
        ln = report[key]["launches"]
        return not st(key).get(f"route_{route}", 0) or (
            ln.get(kernel, 0) + ln.get(kernel + "_tc", 0) > 0)

    checks = {
        "mesh_aol_df dense + semidense": st("mesh_aol_df").get("route_dense", 0)
        > 0 and st("mesh_aol_df").get("route_semidense", 0) > 0,
        "mesh_aol_df_pruned pruned":
            st("mesh_aol_df_pruned").get("route_pruned", 0) > 0,
        "mesh_phrase compact":
            st("mesh_phrase").get("route_phrase_compact", 0) > 0,
        "mesh_phrase list":
            st("mesh_phrase").get("route_phrase_list", 0) > 0,
        **{f"{key} {route} kernel": launched(key, route, kernel)
           for key in ("mesh_phrase", "mesh_tc_phrase")
           for route, kernel in (("phrase_compact", "compact_phrase"),
                                 ("phrase_list", "list_phrase_nogate"))},
        "mesh_tc postings <= 0.51 of mesh":
            report["mesh_tc_engine"]["device_bytes"]["postings"]
            <= 0.51 * report["mesh_engine"]["device_bytes"]["postings"],
        "mesh_staged hot and cold": sum(
            st(f"mesh_staged_{m}").get("route_hot", 0) for m in
            ("aol", "aol_df", "phrase")) > 0 and sum(
            st(f"mesh_staged_{m}").get("cold_chunks", 0) for m in
            ("aol", "aol_df", "phrase")) > 0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh: failed checks {failed}")
    out["wall_s"] = time.perf_counter() - t_phase
    return {"shards": D, "placement": report["mesh_engine"]["placement"],
            "wall_s": out["wall_s"], "from_packed_s": out["from_packed_s"],
            "dryrun_s": out["dryrun_s"],
            "shard_bytes": {n: report[f"{n}_engine"]["shard_bytes"]
                            for n, _, _ in runs},
            "postings_tc_vs_raw":
                report["mesh_tc_engine"]["device_bytes"]["postings"]
                / report["mesh_engine"]["device_bytes"]["postings"],
            "mixes": mixes_out,
            "ladder_qps": {n: r["qps"] for n, r in
                           out["ladder"]["configs"].items()}}


# -- tools ------------------------------------------------------------------

# the pipeline's corpus: 25,000 docs (50,000 before the semidense and
# verification checks came in; 15,000 for a while, restored once it ran
# beside the index build), so that the smoke's wall stays under its
# 1,200 s limit on a slow host (the 1M index is the main path's)
TOOLS_PIPE_DOCS, TOOLS_PIPE_Q, TOOLS_PIPE_PARITY = 25_000, 4096, 200
TOOLS_PRUNE_N, TOOLS_PRUNE_C = 32, (32, 64, 128)
# gather_probe's defaults: n_pad, B, L, reps
TOOLS_GATHER = (1_000_448, 128, 8192, 8)


def column_round_trip(postings_doc) -> dict:
    """A whole doc column through pack_doc_blocks and unpack_doc_blocks on
    the card (one unpack_mixed_blocks launch, every block written in
    place), held bit for bit against the plain torch version (on the
    card's tensors), the native codec with a numpy delta decode, and the
    column itself (real lanes; sentinel lanes carry the previous id).
    Returns the widths with their blocks, the kernel's launches (counted
    from 0 around the decode alone), and the device time (torch.profiler)
    and host cost per call of the single launch against the per-width
    loop of unpack_delta_blocks (the decode before it), in turns (single,
    loop, loop, single), with the plain version's and the bytes bound."""
    import numpy as np
    import torch

    from wiser_tpu_torch.index.format import SENTINEL_DOC
    from wiser_tpu_torch.native import lib as native
    from wiser_tpu_torch.ops import unpack as U
    from wiser_tpu_torch.runtime import resolve_device
    from wiser_tpu_torch.tools import unpack_bench as UB

    t0 = time.perf_counter()
    cols = U.pack_doc_blocks(postings_doc)
    pack_s = time.perf_counter() - t0
    U.reset_launch_counts()
    t0 = time.perf_counter()
    got = U.unpack_doc_blocks(cols, device="cuda")
    decode_s = time.perf_counter() - t0
    launches = dict(U.launch_counts)
    if launches != {"unpack_delta_blocks": 0, "unpack_mixed_blocks": 1}:
        raise AssertionError(f"unpack launches {launches} for one column "
                             f"(one unpack_mixed_blocks launch expected)")
    dev = resolve_device("cuda")
    G = len(cols["block_first"])
    table = U.upload_table(U.doc_block_table(cols), dev)
    plain = U.unpack_mixed_blocks_torch(*table, out=torch.empty(
        G * 128, dtype=torch.int32, device=dev)).cpu().numpy()
    nat = np.zeros((G, 128), dtype=np.int64)
    for w, (sel, words) in cols["groups"].items():
        d = native.unpack_blocks(words.reshape(-1), np.full(
            len(sel), w, dtype=np.uint8)).reshape(-1, 128).astype(np.int64)
        nat[sel] = (cols["block_first"][sel].astype(np.int64)[:, None]
                    + np.cumsum(d + 1, axis=1) - (d[:, :1] + 1))
    real = postings_doc != SENTINEL_DOC
    for what, ref in (("plain torch", plain),
                      ("native", nat.reshape(-1)),
                      ("the column", np.where(real, postings_doc, got))):
        if not np.array_equal(got, ref):
            n_bad = int((got != ref).sum())
            raise AssertionError(f"unpack_doc_blocks != {what} on {n_bad} "
                                 f"of {len(got)} lanes")

    # these launches are not the path's
    forms = UB.column_forms(U, cols, dev)
    out = torch.empty(G * 128, dtype=torch.int32, device=dev)
    rows = {"single": [], "loop": []}
    for name in ("single", "loop", "loop", "single"):
        fn, _ = forms[name]
        rows[name].append(UB.timed(
            fn, 10, 20, UB.column_bytes(cols, name == "single"),
            launches=1 if name == "single" else len(cols["groups"])))
    if not np.array_equal(forms["loop"][1]().cpu().numpy(), got):
        raise AssertionError("the per-width loop != unpack_doc_blocks")
    plain_ms = [cuda_ms(lambda: U.unpack_mixed_blocks_torch(*table, out=out),
                        3) for _ in range(2)]

    def turns(rs):
        return {k: [r[k] for r in rs] for k in ("ms", "host_us", "call_us",
                                                 "share", "launches_per_call",
                                                 "source", "events")
                } | {"bound_ms": rs[0]["bound_ms"]}

    words_bytes = sum(4 * words.size for _, words in cols["groups"].values())
    return {"blocks": G, "lanes": int(len(postings_doc)),
            "widths": {int(w): len(sel)
                       for w, (sel, _) in sorted(cols["groups"].items())},
            "packed_bytes": words_bytes,
            "unpack_launches": launches["unpack_mixed_blocks"],
            "pack_s": pack_s, "decode_s": decode_s,
            "single": turns(rows["single"]), "loop": turns(rows["loop"]),
            "plain_ms": plain_ms, "bit_exact": True}


def tools_phase_early(report: dict, beside: bool) -> None:
    """The tools phase's part that needs no 1M index (tools_phase runs it
    where it has not run): the raw-text pipeline at TOOLS_PIPE_DOCS docs
    with its engine on the card, the whole-column unpack round trip over
    its index, micro_bench's codec, host, snippet and device rows and
    gather_probe at its defaults. beside: the 1M index was building on
    the host as it started."""
    import torch

    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import gather_probe, micro_bench, wiki_pipeline
    from wiser_tpu_torch.utils import ResultTable

    out = report["tools"] = {"beside_the_index_build": beside}
    t_phase = time.perf_counter()
    work = os.path.join(CACHE, "wikipipe")
    t0 = time.perf_counter()
    rec = wiki_pipeline.run_pipeline(work, TOOLS_PIPE_DOCS,
                                     n_queries=TOOLS_PIPE_Q,
                                     parity_n=TOOLS_PIPE_PARITY,
                                     device="cuda")
    rec["wall_s"] = time.perf_counter() - t0
    out["pipeline"] = rec
    log(f"tools pipeline: {rec}")
    eng = rec["engine"]
    if (rec["check_posting_list_errors"] or eng["parity_mismatches"]
            or eng["parity_sample"] < TOOLS_PIPE_PARITY):
        raise AssertionError(f"pipeline: {rec}")
    pipe_packed = PackedIndex.load(os.path.join(work, "idx"),
                                   skip_offsets=True)
    out["unpack_pipeline"] = column_round_trip(pipe_packed.postings_doc)
    log(f"tools unpack (pipeline column): {out['unpack_pipeline']}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    table = ResultTable()
    micro_bench.bench_codecs(table)
    micro_bench.bench_intersection_host(table)
    micro_bench.bench_snippets(table)
    micro_bench.bench_device(table, "cuda")
    out["micro_bench"] = {"rows": table.rows,
                          "wall_s": time.perf_counter() - t0}
    log(f"tools micro_bench: {out['micro_bench']}")

    t0 = time.perf_counter()
    out["gather_probe"] = dict(gather_probe.probe(*TOOLS_GATHER, "cuda"),
                               wall_s=time.perf_counter() - t0)
    log(f"tools gather_probe: {out['gather_probe']}")
    torch.cuda.empty_cache()
    out["early_wall_s"] = time.perf_counter() - t_phase


def tools_phase(report: dict, packed) -> dict:
    """tools_phase_early where it has not run, then the whole-column
    unpack round trip over the 1M index (when an engine phase loaded it)
    and prune_probe (raw and tc dense sets) on the 1M index, or on the
    pipeline's when no engine phase ran. Returns the summary line's
    object; wall_s is the two parts' sum."""
    import torch

    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import prune_probe

    if "tools" not in report:
        tools_phase_early(report, False)
    out = report["tools"]
    t_phase = time.perf_counter()
    rec = out["pipeline"]
    eng = rec["engine"]
    launches = out["unpack_pipeline"]["unpack_launches"]
    if packed is not None:
        out["unpack_1m"] = column_round_trip(packed.postings_doc)
        log(f"tools unpack (1M column): {out['unpack_1m']}")
        launches += out["unpack_1m"]["unpack_launches"]
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    target = (packed if packed is not None else PackedIndex.load(
        os.path.join(CACHE, "wikipipe", "idx"), skip_offsets=True))
    prune = {"index_docs": target.n_docs}
    for columns in ("raw", "tc"):
        probe = prune_probe.Probe(target, columns=columns)
        classes = prune_probe.build_classes(target, probe, TOOLS_PRUNE_N, K)
        prune[columns] = {"dense_rows": int(probe.dense.sum()),
                          "classes": prune_probe.report_classes(
                              probe, classes, K, list(TOOLS_PRUNE_C))}
        del probe
    prune["wall_s"] = time.perf_counter() - t0
    out["prune_probe"] = prune
    log(f"tools prune_probe: {prune}")
    out["wall_s"] = out["early_wall_s"] + time.perf_counter() - t_phase
    out["unpack_launches"] = launches

    def unpack_line(r):
        return {k: r[k] for k in ("blocks", "widths", "unpack_launches",
                                  "single", "loop", "plain_ms")}

    return {
        "wall_s": out["wall_s"],
        "pipeline": {k: rec[k] for k in (
            "n_docs", "xml_synth_s", "xml_to_linedoc_s", "index_s",
            "check_s", "n_terms", "n_postings", "check_posting_list_errors",
            "wall_s")} | {"engine": {k: eng[k] for k in (
                "qps", "wall_s", "warmup_s", "parity_mismatches",
                "parity_sample")}},
        "unpack": {k: unpack_line(out[k]) for k in ("unpack_pipeline",
                                                    "unpack_1m") if k in out},
        "unpack_launches": launches,
        "micro_bench": {r["bench"]: {k: v for k, v in r.items()
                                     if k != "bench"}
                        for r in out["micro_bench"]["rows"]},
        "gather_probe": {n: {k: r[k] for k in ("ms", "G_lanes_per_s",
                                               "bound_ms")}
                         for n, r in out["gather_probe"]["variants"].items()},
        "prune_probe": prune}


# -- main --------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--bench-docs", type=int, default=20_000,
                    help="the headline and serve corpus (bench.py's)")
    ap.add_argument("--bench-queries", type=int, default=262_144,
                    help="the headline's queries (bench.py's)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--report", help="also write the full report here (JSON)")
    ap.add_argument("--trace-dir", default=os.path.join(CACHE, "trace"),
                    help="the harness phase's torch.profiler trace")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "tc" in phases and "dense" not in phases:
        ap.error("the tc phase's byte and row checks need the dense phase "
                 "as their raw reference")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, ROOT)
    from wiser_tpu_torch.build import build_log, load_libraries

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]}

    # the 1M index builds on the host (a child process) while the
    # libraries build and the kernel phase runs
    idx_proc = (start_index_build(args.docs)
                if any(p in phases for p in INDEX_PHASES) else None)
    if idx_proc is not None:
        atexit.register(lambda: idx_proc.poll() is None and idx_proc.kill())
    # one nvcc a library, all at the same time (a build error is raised
    # here)
    t0 = time.perf_counter()
    libs = ("unpack", "search", "dense", "semidense", "phrase",
            "phrase_route")
    load_libraries(libs)
    report["build"] = {f"{n}_s": build_log[n][0] for n in libs}
    report["build"]["wall_s"] = time.perf_counter() - t0
    for n in libs:
        print(f"build: csrc/{n}.cu in {build_log[n][0]:.2f}s", flush=True)
        log(build_log[n][1])

    def kernel_row(name, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": None,
                "ms": None, "host_us": None, "host_us_beside_build": None,
                "plain_ms": None,
                "bound_ms": None, "bound_by": "bytes", "library_ms": None}

    # the unpack kernel's two entries (the uniform width of the staged
    # cold chunks, the block table of a whole doc column) and the bs step
    kerns = {name: kernel_row(name, "wiser_tpu_torch/csrc/unpack.cu",
                              "wiser_tpu/ops/unpack.py:123")
             for name in ("unpack_delta_blocks", "unpack_mixed_blocks")}
    kerns["bs_search"] = kernel_row("bs_search",
                                    "wiser_tpu_torch/csrc/search.cu",
                                    "wiser_tpu/engine/kernels.py:205")
    for name, replaces in DENSE_KERNELS:
        kerns[name] = kernel_row(name, "wiser_tpu_torch/csrc/dense.cu",
                                 replaces)
    for name, replaces, source in SEMI_KERNELS:
        kerns[name] = kernel_row(name, source, replaces)
    for name, replaces in ROUTE_KERNELS:
        kerns[name] = kernel_row(name, "wiser_tpu_torch/csrc/phrase_route.cu",
                                 replaces)
    kern = kerns["unpack_delta_blocks"]
    if "kernel" in phases:
        for name, entry in kernel_phase(report).items():
            kerns[name].update(entry)
        kerns["bs_search"].update(search_kernel_phase(report))
        torch.cuda.empty_cache()
        for name, entry in dense_kernel_phase(report).items():
            kerns[name].update(entry)
        torch.cuda.empty_cache()
        for name, entry in semi_kernel_phase(report).items():
            kerns[name].update(entry)
        torch.cuda.empty_cache()
        for name, entry in route_kernel_phase(report).items():
            kerns[name].update(entry)
    # the kernel phase's host readings, taken while the index built on
    # the host where it was not cached (a later phase's reading of a row
    # replaces its own); runs of the two kinds are not comparable
    kernel_host_us = {n: r["host_us"] for n, r in kerns.items()}

    # (run name, make engine, {mix: (pool, number of queries, engine
    # attributes set for that mix only, warm-pass queries or None = all)})
    runs = []
    Q = args.queries
    # the phrase prefixes of the pruned and the staged mixes (512 before
    # the mesh phase came in, 1,024 before that)
    P = min(Q, 256)
    PS = min(Q, 256)
    # mixes that spend seconds a pass on exact host searches and staging
    # (the staged and pruned phrase mixes, and the df-ranked set without
    # a dense tier) warm on a prefix
    W = min(P, 128)
    # the windowed set again with the route off: its groups take bs
    windowed_off = {"WINDOWED_MIN_L": 1 << 30, "HOST_MERGE_MIN_L": 1 << 30}
    pruned = {"FULL_PHRASE_SCAN": False}
    if "resident" in phases:
        # df-ranked head conjunctions cost ~0.14 s each on the exact host
        # merge at 1M docs without the dense tier: an eighth of the queries
        runs.append(("resident", lambda: TorchEngine(
            packed, device="cuda", dense_budget_bytes=0),
            {"aol": ("aol", Q, {}, None), "aol_df": ("aol_df", Q // 8, {}, W),
             "windowed": ("windowed", Q // 4, {}, None),
             "windowed_bs": ("windowed", Q // 4, windowed_off, None)}))
    dense_mixes = {}
    if "dense" in phases:
        dense_mixes.update(aol=("aol", Q, {}, None),
                           aol_df=("aol_df", Q, {}, None))
    if "phrase" in phases:
        dense_mixes.update(phrase=("phrase", Q, {}, None),
                           phrase_pruned=("phrase", P, pruned, W))
    if dense_mixes:
        runs.append(("dense", lambda: TorchEngine(packed, device="cuda"),
                     dense_mixes))

    def staged(frac, columns="raw"):
        def make():
            budget = (int(full_residency_bytes(packed, columns) * frac)
                      if frac else 0)
            eng = StagedEngine(packed, budget, device="cuda",
                               columns=columns, cold_transfer="packed")
            eng.COLD_COMPUTE = "device"
            return eng

        return make

    if "staged" in phases:
        runs.append(("staged", staged(0), {
            "aol": ("aol", Q, {}, None), "aol_df": ("aol_df", Q // 8, {}, W),
            "phrase": ("phrase", PS, {}, W)}))
        runs.append(("staged_q", staged(0.25), {
            "aol": ("aol", Q, {}, None), "aol_df": ("aol_df", Q // 4, {}, None),
            "phrase": ("phrase", PS, {}, W)}))
    if "tc" in phases:
        runs.append(("tc", lambda: TorchEngine(packed, device="cuda",
                                               columns="tc"),
                     {"aol": ("aol", Q, {}, None),
                      "aol_df": ("aol_df", Q, {}, None),
                      "phrase": ("phrase", Q, {}, None),
                      "phrase_pruned": ("phrase", P, pruned, W)}))
    if "staged_tc" in phases:
        runs.append(("staged_tc", staged(0.25, "tc"), {
            "aol": ("aol", Q, {}, None), "aol_df": ("aol_df", Q // 4, {}, None),
            "phrase": ("phrase", PS, {}, W)}))
    keep: dict = {}  # the dense and tc engines, for the harness phase
    # bs_search launches on each phase's timed passes
    bs_by_phase: dict = {}
    # the dense kernels' launches on each phase's timed passes, and the
    # dense, pruned and rescued queries its route counters show
    dense_by_phase: dict = {}
    dense_work: dict = {}

    def add_dense(phase: str, r: dict) -> None:
        c = dense_by_phase.setdefault(
            phase, {name: 0 for name, _ in DENSE_KERNELS})
        for name in c:
            c[name] += r["launches"].get(name, 0)
        dense_work[phase] = dense_work.get(phase, 0) + sum(
            v for k, v in r.get("stats", {}).items()
            if k.endswith(("route_dense", "route_pruned", "prune_rescued")))

    def phase_of(run_name: str) -> str:
        return "staged" if run_name == "staged_q" else run_name
    expected: dict = {}  # the exact host answers, across runs
    packed = None  # the 1M index, when a phase that needs it runs
    # every kernel's device ms summed over the main path's launches (the
    # timed passes of every run and the harness, mesh, headline and serve
    # phases), timed per call shape before each phase's engines go
    from wiser_tpu_torch.tools.kernel_tally import KernelTally

    tally = KernelTally()

    def bench_phases(beside: bool) -> None:
        """The headline and serve phases, on bench.py's own corpus (no 1M
        index); beside: the 1M index was building on the host as they
        started (their host-clock readings say so)."""
        corpus = bench_corpus(args.bench_docs, report)
        if "headline" in phases:
            with tally:
                headline_phase(report, args.bench_docs, args.bench_queries)
            tally.flush("headline")
            bs_by_phase["headline"] = report["headline"]["launches"][
                "bs_search"]
            add_dense("headline", report["headline"])
            report["headline"]["beside_the_index_build"] = beside
        if "serve" in phases:
            with tally:
                serve_phase(report, corpus)
            tally.flush("serve")
            add_dense("serve", report["serve"])
            report["serve"]["beside_the_index_build"] = beside
        del corpus
        torch.cuda.empty_cache()

    bench_done = False
    if runs or "harness" in phases or "mesh" in phases:
        from wiser_tpu_torch import StagedEngine, TorchEngine
        from wiser_tpu_torch.engine.staged import full_residency_bytes

        built = None
        if idx_proc is not None:
            # the bench phases and the tools phase's first part need no
            # 1M index: they run while it builds
            if "headline" in phases or "serve" in phases:
                bench_phases(idx_proc.poll() is None)
                bench_done = True
            if "tools" in phases:
                tools_phase_early(report, idx_proc.poll() is None)
            out, _ = idx_proc.communicate()
            if idx_proc.returncode:
                raise RuntimeError(f"the index build failed "
                                   f"({idx_proc.returncode})")
            built = json.loads(out.strip().splitlines()[-1])
        packed, pairs = get_index(args.docs, report)
        if built is not None:
            report["index"] = dict(built, load_s=report["index"]["load_s"],
                                   beside_the_kernel_phase=True)
    if runs or "mesh" in phases:
        pools = {"aol": aol_mixed_queries(packed, Q),
                 "aol_df": aol_mixed_queries(packed, Q, by_df=True),
                 "phrase": phrase_queries(pairs, Q)}
    if runs:
        # df-ranked draws the windowed route takes (seed 8)
        pools["windowed"] = windowed_eligible(
            packed, aol_mixed_queries(packed, 8 * Q, seed=8, by_df=True),
            Q // 4)
        from wiser_tpu_torch.tools.phrase_bench import Recorder as PRec
        from wiser_tpu_torch.tools.semidense_bench import Recorder

        for name, make, mixes in runs:
            t0 = time.perf_counter()
            # the dense and tc runs record their semidense, verification
            # and phrase route calls, timed after their passes
            rec = Recorder().__enter__() if name in ("dense", "tc") else None
            prec = PRec().__enter__() if name in ("dense", "tc") else None
            eng = make()
            torch.cuda.synchronize()
            hot = getattr(eng, "hot", eng)
            info = {"init_s": time.perf_counter() - t0,
                    "columns": hot.columns,
                    "device_bytes": eng.device_bytes(),
                    "dense_rows": int(hot._dense_H),
                    "dense_build_s": hot.dense_build_s,
                    "n_pad_docs": int(getattr(hot, "_n_pad_docs", 0)),
                    "phrase_kv": int(hot.PRUNED_PHRASE_KV)}
            if name.startswith("staged"):
                info.update(hot_fraction=eng.hot_fraction,
                            phrase_hot_fraction=float(
                                eng.phrase_hot_mask.mean()),
                            hot_bytes_used=eng.hot_bytes_used,
                            total_full=eng.total_full)
            report[f"{name}_engine"] = info
            log(f"{name} engine: {info}")
            for mix, (pool, nq, attrs, warm) in mixes.items():
                queries = pools[pool][:nq]
                key = f"{name}_{mix}"
                for a, v in attrs.items():
                    setattr(eng, a, v)  # this instance, this mix only
                with tally:
                    res = serve(eng, queries, key, report, warm)
                for a in attrs:
                    delattr(eng, a)
                report[key]["engine_attrs"] = attrs
                report[key]["parity_checked"] = check_parity(
                    packed, queries, res, parity_sample(queries), key,
                    expected)
            tally.flush(phase_of(name))
            if rec is not None:
                rec.__exit__(None, None, None)
                prec.__exit__(None, None, None)
                for k, entry in semi_engine_timing(report, name,
                                                   rec).items():
                    kerns[k].update(entry)
                for k, entry in route_engine_timing(report, name,
                                                    prec).items():
                    kerns[k].update(entry)
                del rec, prec
            if name in ("dense", "tc"):
                for k, entry in dense_engine_timing(report, name,
                                                    hot).items():
                    kerns[k].update(entry)
            if "harness" in phases and name in ("dense", "tc"):
                keep[name] = eng
            del eng, hot, res
            torch.cuda.empty_cache()
        if "resident" in phases:
            check_windowed(report)
        if "dense" in phases:
            check_dense_routes(report, "dense")
        if "phrase" in phases:
            check_phrase_routes(report, "dense")
            check_pruned_phrases(report, "dense")
        if "tc" in phases:
            check_dense_routes(report, "tc")
            check_phrase_routes(report, "tc")
            check_pruned_phrases(report, "tc")
            check_tc_capacity(report)
        staged_runs = [name for name, _, _ in runs
                       if name.startswith("staged")]
        for name in staged_runs:
            if name != "staged":  # budget 0 admits no dense rows
                check_staging(report, name)
            check_staged_phrases(report, name)
        kern["launches"] = sum(
            report[f"{name}_{mix}"]["launches"]["unpack_delta_blocks"]
            for name, _, mixes in runs if name in staged_runs
            for mix in mixes)
        for name, _, mixes in runs:
            bs_by_phase[phase_of(name)] = bs_by_phase.get(
                phase_of(name), 0) + sum(
                report[f"{name}_{mix}"]["launches"]["bs_search"]
                for mix in mixes)
            for mix in mixes:
                add_dense(phase_of(name), report[f"{name}_{mix}"])
        route_keys = ("route_", "flag_", "prune_rescued", "forced_host",
                      "host_exact_s", "rescue_s", "phrase_", "windowed_s",
                      "bs_s", "cold_host_fallback_q", "cold_phrase_")
        summary = {}
        for name, _, mixes in runs:
            for mix in mixes:
                r = report[f"{name}_{mix}"]
                summary[f"{name}_{mix}"] = dict(
                    queries=r["queries"], qps=r["qps"],
                    peak_device_bytes=r["peak_device_bytes"],
                    **{k: v for k, v in r["stats"].items()
                       if any(k.startswith(p) or k.startswith("hot_" + p)
                              for p in route_keys)})
        print(json.dumps({"routes": summary}), flush=True)
    if "harness" in phases:
        with tally:
            kern["launches"] += harness_phase(report, packed, pairs, keep,
                                              args.trace_dir)
        tally.flush("harness")
        bs_by_phase["harness"] = report["harness"]["bs_search_launches"]
        add_dense("harness", report["harness"])
        dense_work["harness"] = 1  # its stage probe runs the pruned scan
        keep.clear()
        torch.cuda.empty_cache()
        print(json.dumps({"harness": harness_summary(report["harness"])}),
              flush=True)
    if "mesh" in phases:
        recs = {}
        with tally:
            mesh = mesh_phase(report, packed, pairs, pools, expected, Q,
                              recs)
        tally.flush("mesh")
        # the mesh's own compact and gate-off list calls (a shard's L up
        # to 524,288), held bit for bit against their plain versions and
        # timed after the phase, outside its tally and launch counts
        for name, rec in recs.items():
            for k, entry in route_engine_timing(report, name, rec).items():
                kerns[k]["mesh_calls"] = {
                    f: entry[f] for f in ("ms", "timing", "host_us",
                                          "plain_ms", "bound_ms", "share",
                                          "shape")}
            mesh[f"{name}_route_timing_s"] = \
                report[f"{name}_route_timing"]["wall_s"]
        del recs
        torch.cuda.empty_cache()
        print(json.dumps({"mesh": mesh}), flush=True)
        bs_by_phase["mesh"] = sum(
            r["launches"]["bs_search"] for k, r in report.items()
            if k.startswith("mesh_") and isinstance(r, dict)
            and "launches" in r)
        for k, r in report.items():
            if (k.startswith("mesh_") and isinstance(r, dict)
                    and "launches" in r):
                add_dense("mesh", r)
        torch.cuda.empty_cache()
    if "tools" in phases:
        tools = tools_phase(report, packed)
        mixed = kerns["unpack_mixed_blocks"]
        mixed["launches"] += tools["unpack_launches"]
        # the main path's shape: the largest column it decoded
        col = report["tools"].get("unpack_1m",
                                  report["tools"]["unpack_pipeline"])
        mixed.update(ms=min(col["single"]["ms"]),
                     host_us=min(col["single"]["host_us"]),
                     plain_ms=min(col["plain_ms"]),
                     bound_ms=col["single"]["bound_ms"],
                     shape=f"whole column, {col['blocks']} blocks")
        print(json.dumps({"tools": tools}), flush=True)
        torch.cuda.empty_cache()

    if ("headline" in phases or "serve" in phases) and not bench_done:
        bench_phases(False)

    # the new modules too: bench.headline, the factory, the server
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "wiser_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")
    report["kernel_device_ms"] = {"total": tally.totals(),
                                  "by_phase": tally.sums}
    print(json.dumps({"kernel_device_ms": report["kernel_device_ms"][
        "total"]}), flush=True)
    report["bs_search_launches"] = bs_by_phase
    report["bs_search_plane_launches"] = sum(
        r["launches"].get("bs_search_plane", 0) for r in report.values()
        if isinstance(r, dict) and isinstance(r.get("launches"), dict))
    kerns["bs_search"]["launches"] = sum(bs_by_phase.values())
    idle = [p for p in ("resident", "dense", "staged", "mesh", "headline")
            if p in phases and not bs_by_phase.get(p)]
    report["dense_launches"] = dense_by_phase
    report["dense_route_work"] = dense_work
    # the semidense and verification kernels' launches on every timed
    # pass: each run's (by its phase), the harness's, the mesh's, the
    # headline's and the serve phase's
    semi_by_phase: dict = {}
    for key, r in report.items():
        if not (isinstance(r, dict) and isinstance(r.get("launches"), dict)):
            continue
        c = semi_by_phase.setdefault(
            phase_of(key.split("_")[0]) if key != "harness" else key,
            {name: 0 for name, _, _ in SEMI_KERNELS})
        for name in c:
            c[name] += r["launches"].get(name, 0)
    report["semi_launches"] = semi_by_phase
    for name, _, _ in SEMI_KERNELS:
        kerns[name]["launches"] = sum(c[name] for c in semi_by_phase.values())
    semi_idle = [f"{p} ({name})" for p, name in (
        ("dense", "semidense"), ("tc", "semidense_tc"),
        ("dense", "phrase_verify_docs"), ("tc", "phrase_verify_docs"))
        if p in phases and (not name.startswith("phrase")
                            or "phrase" in phases)
        and not semi_by_phase.get(p, {}).get(name)]
    for name, _ in DENSE_KERNELS:
        kerns[name]["launches"] = sum(c[name]
                                      for c in dense_by_phase.values())
    # the phrase routes' kernels: launches on every timed pass, by phase
    route_by_phase: dict = {}
    for key, r in report.items():
        if not (isinstance(r, dict) and isinstance(r.get("launches"), dict)):
            continue
        c = route_by_phase.setdefault(
            phase_of(key.split("_")[0]) if key != "harness" else key,
            {name: 0 for name, _ in ROUTE_KERNELS})
        for name in c:
            c[name] += r["launches"].get(name, 0)
    report["route_launches"] = route_by_phase
    for name, _ in ROUTE_KERNELS:
        kerns[name]["launches"] = sum(c[name]
                                      for c in route_by_phase.values())
    route_idle = [f"{p} ({name})" for p, name in (
        ("dense", "semidense_phrase"), ("tc", "semidense_phrase_tc"),
        ("dense", "list_phrase"), ("tc", "list_phrase_tc"))
        if p in phases and "phrase" in phases
        and not route_by_phase.get(p, {}).get(name)]
    report["route_launch_check"], route_unlaunched = route_launches(report)
    # a scan (raw or tc) must launch on the dense, tc and mesh phases
    # (each runs the rescue or the mesh's dense step) and on every other
    # phase whose route counters show dense, pruned or rescued queries;
    # the raw one on the dense phase, the tc one on the tc phase;
    # dense_pick on the dense and tc phases
    dense_idle = sorted(
        p for p, c in dense_by_phase.items()
        if not (c["dense_scan"] or c["dense_scan_tc"])
        and (p in ("dense", "tc", "mesh") or dense_work.get(p)))
    pick_idle = sorted(p for p in ("dense", "tc")
                       if p in dense_by_phase
                       and not dense_by_phase[p]["dense_pick"])
    for p, name in (("dense", "dense_scan"), ("tc", "dense_scan_tc")):
        if p in dense_by_phase and not dense_by_phase[p][name]:
            dense_idle.append(f"{p} ({name})")
    report["total_s"] = time.perf_counter() - t_start
    log(json.dumps(report))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    # every entry a phase of this run drives must have launched there
    if {"staged", "staged_tc", "harness"} & set(phases) and not kern["launches"]:
        raise AssertionError("unpack_delta_blocks never launched on the path")
    if "tools" in phases and not kerns["unpack_mixed_blocks"]["launches"]:
        raise AssertionError("unpack_mixed_blocks never launched on the path")
    if idle:
        raise AssertionError(f"bs_search never launched on the {idle} "
                             f"phases ({bs_by_phase})")
    if dense_idle or pick_idle:
        raise AssertionError(
            f"the dense scan never launched on the {dense_idle} phases, "
            f"dense_pick on {pick_idle} ({dense_by_phase}; route work "
            f"{dense_work})")
    if semi_idle:
        raise AssertionError(f"never launched on the path: {semi_idle} "
                             f"({semi_by_phase})")
    if route_idle or route_unlaunched:
        raise AssertionError(
            f"never launched on the path: {route_idle}; a phrase route "
            f"took queries but its kernel never launched: "
            f"{route_unlaunched} ({route_by_phase})")
    for n, r in kerns.items():
        if r["host_us"] is not None:
            r["host_us_beside_build"] = (idx_proc is not None and
                                         r["host_us"] == kernel_host_us[n])
    print(json.dumps({"kernels": list(kerns.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
