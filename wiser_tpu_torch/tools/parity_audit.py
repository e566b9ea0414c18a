"""Exhaustive engine-vs-host parity audit at scale (the port's copy of
wiser_tpu/tools/parity_audit.py).

Runs N queries per config (tools/scale_bench.build_configs) through a
TorchEngine in strict_parity mode (every FLAG_TRUNC truncation takes the
exact host path) and verifies every result against the exact host search
(memoized: repeated queries are cheap). Per config it reports:

  - mismatches (must be 0);
  - flag counts per class (trunc / overflow / tf_sat / prune_miss) and the
    rows forced to the host, counted by wrapping the engine's
    _flags_to_force;
  - with --compare-default, the throughput of the default (non-strict)
    mode beside the strict one.

Run: python -m wiser_tpu_torch.tools.parity_audit --index <dir> \
         --linedoc <corpus.linedoc> --n-queries 100000 [--device cpu] \
         [--out PARITY.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class FlagCounter:
    """Wraps an engine's _flags_to_force to count its flag words per class.

    Every call is counted, the rescue's second pass (rescue=True) too:
    the wrapper forwards rescue= (the JAX package's counter takes one
    argument, so its audit raises TypeError once a rescue runs)."""

    def __init__(self, engine):
        from wiser_tpu_torch.engine import kernels as K

        self.engine = engine
        self.counts = {"trunc": 0, "overflow": 0, "tf_sat": 0,
                       "prune_miss": 0, "forced": 0, "total": 0}
        self._orig = engine._flags_to_force
        self._K = K

    def __enter__(self):
        K, counts, orig = self._K, self.counts, self._orig

        def counted(flags, rescue=False):
            flags = np.asarray(flags)
            counts["total"] += len(flags)
            counts["trunc"] += int(((flags & K.FLAG_TRUNC) != 0).sum())
            counts["overflow"] += int(((flags & K.FLAG_OVERFLOW) != 0).sum())
            counts["tf_sat"] += int(((flags & K.FLAG_TF_SAT) != 0).sum())
            counts["prune_miss"] += int(
                ((flags & K.FLAG_PRUNE_MISS) != 0).sum())
            force = orig(flags, rescue=rescue)
            counts["forced"] += int(np.asarray(force).sum())
            return force

        self.engine._flags_to_force = counted
        return self

    def __exit__(self, *exc):
        self.engine._flags_to_force = self._orig
        return False


def verify_config(engine, packed, queries, batch):
    """Run all queries batched, then check every result against the exact
    host search. Returns (mismatches, wall_s, examples)."""
    from wiser_tpu_torch.engine.host import host_exact_search

    t0 = time.time()
    results = []
    for i in range(0, len(queries), batch):
        results.extend(engine.search_batch(queries[i : i + batch]))
    wall = time.time() - t0

    host_memo = {}
    bad = 0
    examples = []
    for q, got in zip(queries, results):
        rows = tuple(packed.term_to_row.get(t, -1) for t in q.terms)
        if min(rows) < 0:
            if got.entries:
                bad += 1
            continue
        key = (rows, q.n_results, q.is_phrase and len(rows) >= 2)
        want = host_memo.get(key)
        if want is None:
            d, s = host_exact_search(packed, engine.cache64, list(rows),
                                     q.n_results, is_phrase=key[2])
            want = list(zip(d.tolist(), s.tolist()))
            host_memo[key] = want
        have = [(e.doc_id, e.doc_score) for e in got.entries]
        if want != have:
            bad += 1
            if len(examples) < 5:
                examples.append({"terms": q.terms, "phrase": q.is_phrase,
                                 "want": want[:3], "have": have[:3]})
    return bad, wall, examples


def audit_config(engine, packed, queries, batch, default_engine=None) -> dict:
    """One config's row: a warm pass, then the counted, verified pass; with
    default_engine, its warm and timed passes for default_qps."""
    for i in range(0, len(queries), batch):  # warm pass
        engine.search_batch(queries[i : i + batch])
    with FlagCounter(engine) as fc:
        bad, wall, examples = verify_config(engine, packed, queries, batch)
    row = {
        "n_queries": len(queries),
        "unique": len({(tuple(q.terms), q.n_results, q.is_phrase)
                       for q in queries}),
        "mismatches": bad,
        "strict_qps": round(len(queries) / wall, 1),
        "flags": dict(fc.counts),
    }
    if examples:
        row["examples"] = examples
    if default_engine is not None:
        for i in range(0, len(queries), batch):  # warm pass
            default_engine.search_batch(queries[i : i + batch])
        t0 = time.time()
        for i in range(0, len(queries), batch):
            default_engine.search_batch(queries[i : i + batch])
        row["default_qps"] = round(len(queries) / (time.time() - t0), 1)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-queries", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--configs", default=None)
    ap.add_argument("--compare-default", action="store_true",
                    help="also time the default (non-strict) mode")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools.scale_bench import build_configs

    packed = PackedIndex.load(args.index, skip_offsets=True)
    engine = TorchEngine(packed, device=args.device, columns=args.columns,
                         strict_parity=True)
    log(f"strict-parity engine up on {engine.device}; device bytes "
        f"{json.dumps(engine.device_bytes())}")
    default_engine = (TorchEngine(packed, device=args.device,
                                  columns=args.columns)
                      if args.compare_default else None)
    configs = build_configs(packed, args.linedoc, args.n_queries, args.k)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}

    summary = {"index": args.index, "columns": args.columns,
               "strict_parity": True, "n_queries": args.n_queries,
               "device": str(engine.device), "configs": {}}
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries (strict, every result "
            f"verified on the host) ==")
        row = audit_config(engine, packed, queries, args.batch,
                           default_engine)
        summary["configs"][name] = row
        log(json.dumps({name: row}))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
