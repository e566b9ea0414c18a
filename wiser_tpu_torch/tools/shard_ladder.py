"""The config ladder through the sharded engine (the port's copy of
wiser_tpu/tools/shard_ladder.py): BASELINE.json config 5's mesh path.

Runs the scale ladder's configs 1-4 (tools/scale_bench.build_configs)
through ShardedEngine over an n-shard document partition of a saved
PackedIndex and checks a sample of each config against the exact host
search (bit parity). Shards go one per card on a machine with n cards,
else all on cuda:0 (engine/shard.default_placement); --device cpu puts
them all on the CPU.

Run: python -m wiser_tpu_torch.tools.shard_ladder --index <dir> \
         [--linedoc <corpus.linedoc>] [--n-shards 8] [--n-queries 2048] \
         [--columns tc] [--device cpu] [--out X.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(packed, engine, configs: dict, batch: int, n_parity: int,
        seed: int = 11, on_config=None) -> dict:
    """Each config through engine.search_batch in batches of `batch`
    (wall in ms, QPS), then n_parity sampled queries (one rng across the
    configs, as the JAX ladder draws them) against host_exact_search.
    Returns {name: row}, passed to on_config after each config."""
    from wiser_tpu_torch.engine.host import host_exact_search

    rng = np.random.default_rng(seed)
    results = {}
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries ==")
        t0 = time.perf_counter()
        res = []
        for i in range(0, len(queries), batch):
            res += engine.search_batch(queries[i : i + batch])
        wall = time.perf_counter() - t0
        bad = 0
        idx = rng.choice(len(queries), size=min(n_parity, len(queries)),
                         replace=False)
        for i in idx:
            q = queries[int(i)]
            rows = [packed.term_to_row.get(t, -1) for t in q.terms]
            if min(rows) < 0:
                continue
            d, s = host_exact_search(
                packed, engine.cache64, rows, q.n_results,
                is_phrase=q.is_phrase and len(rows) >= 2)
            want = list(zip(d.tolist(), s.tolist()))
            have = [(e.doc_id, e.doc_score) for e in res[int(i)].entries]
            if want != have:
                bad += 1
                log(f"PARITY MISMATCH {q.terms} phrase={q.is_phrase}\n"
                    f"  want={want[:3]}\n  have={have[:3]}")
        results[name] = {"n_queries": len(queries), "wall_ms": wall * 1e3,
                         "qps": len(queries) / wall,
                         "parity_mismatches": int(bad),
                         "parity_sample": len(idx)}
        log(json.dumps({name: results[name]}))
        if on_config is not None:
            on_config(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-shards", type=int, default=8)
    ap.add_argument("--n-queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--parity-sample", type=int, default=100)
    ap.add_argument("--dense-budget", type=int, default=1 << 30)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--configs", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one shard per card, or all on "
                         "cuda:0) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu_torch.engine.shard import (ShardedEngine, ShardedIndex,
                                              default_placement)
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools.scale_bench import build_configs

    devices = (default_placement(args.n_shards) if args.device == "cuda"
               else [args.device] * args.n_shards)
    t0 = time.time()
    packed = PackedIndex.load(args.index, skip_offsets=True)
    log(f"index loaded in {time.time()-t0:.1f}s")
    t0 = time.time()
    sharded = ShardedIndex.from_packed(packed, args.n_shards)
    engine = ShardedEngine(sharded, devices=devices,
                           dense_budget_bytes=args.dense_budget,
                           columns=args.columns)
    log(f"sharded engine up in {time.time()-t0:.1f}s "
        f"(dense_H={engine._dense_H}, columns={args.columns})")

    configs = build_configs(packed, args.linedoc, args.n_queries, 10)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}
    summary = {"index": args.index, "n_docs": packed.n_docs,
               "n_shards": args.n_shards,
               "placement": [str(d) for d in engine.placement],
               "dense_H": int(engine._dense_H), "columns": args.columns}

    def write(results):
        summary["configs"] = results
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)

    write(run(packed, engine, configs, args.batch, args.parity_sample,
              on_config=write))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
