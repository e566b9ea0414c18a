"""Benchmark runner (the port's copy of wiser_tpu/tools/engine_bench.py) —
reference: engine_bench.cc (modes local / locallog / grpc / grpclog,
flags at :21-25, Treatment / Executor at :240-345, result rows at
:255-279).

Modes:
  local     a synthetic AOL-mix workload against a local TorchEngine
  locallog  a query log replayed against a local TorchEngine (batched,
            pipelined)
  grpc      closed-loop streaming gRPC client against a running server
  grpclog   the same with one unary round trip per query
grpc and protobuf are imported only by the gRPC modes.

Run: python -m wiser_tpu_torch.tools.engine_bench --mode locallog \
       --index <dir> --query-log q.txt [--batch 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _load_engine(index_dir: str, device="cuda"):
    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex

    return TorchEngine(PackedIndex.load(index_dir, skip_offsets=True),
                       device=device)


def run_locallog(engine, queries, batch: int, pipeline: int = 2) -> dict:
    """A warm pass, then a timed pass with `pipeline` batches in flight;
    finalizers run through engine.run_pending (barrier ones last)."""
    for i in range(0, len(queries), batch):
        engine.search_batch(queries[i : i + batch])
    lat = []
    done = 0
    in_flight = []

    def finish():
        nonlocal done
        bt0, (res, pending) = in_flight.pop(0)
        engine.run_pending(res, pending)
        lat.append(time.time() - bt0)
        done += len(res)

    t0 = time.time()
    for i in range(0, len(queries), batch):
        bt = time.time()
        in_flight.append((bt, engine.submit_batch(queries[i : i + batch])))
        while len(in_flight) > pipeline:
            finish()
    while in_flight:
        finish()
    wall = time.time() - t0
    return {
        "mode": "locallog",
        "queries": done,
        "wall_s": round(wall, 3),
        "qps": round(done / wall, 1),
        "batch_p50_s": round(float(np.median(lat)), 3),
        "batch_p99_s": round(float(np.percentile(lat, 99)), 3),
    }


def run_local_synth(engine, n_queries: int, batch: int) -> dict:
    from wiser_tpu_torch.data.synth_log import aol_shape_mixed_log

    packed = engine.packed
    queries = aol_shape_mixed_log(packed.terms, packed.df, n_queries)
    return run_locallog(engine, queries, batch) | {"mode": "local"}


def run_grpc(target: str, query_log: str, n_threads: int, duration: float,
             streaming: bool = True) -> dict:
    from wiser_tpu_torch.bench.query_pool import QueryLogReader, QueryProducer
    from wiser_tpu_torch.serve.client import Client

    queries = QueryLogReader(query_log).read_all(n_results=10)
    producer = QueryProducer(queries, n_threads)
    client = Client(target, producer, n_threads=n_threads,
                    streaming=streaming, duration_s=duration)
    stats = client.run()
    h = stats["histogram"]
    return {
        "mode": "grpc" if streaming else "grpclog",
        "qps": round(stats["qps"], 1),
        "total": stats["total"],
        "errors": stats["errors"],
        "latency_us": {f"p{p}": round(h.percentile(p) / 1e3, 1)
                       for p in (50, 90, 95, 99)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="wiser_tpu_torch engine benchmark")
    ap.add_argument("--mode", required=True,
                    choices=["local", "locallog", "grpc", "grpclog"])
    ap.add_argument("--index")
    ap.add_argument("--query-log")
    ap.add_argument("--target", default="localhost:50051")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--n-queries", type=int, default=16384)
    ap.add_argument("--n-results", type=int, default=10)
    ap.add_argument("--n-threads", type=int, default=8)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="the local engine's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode in ("local", "locallog"):
        engine = _load_engine(args.index, args.device)
        if args.mode == "local":
            out = run_local_synth(engine, args.n_queries, args.batch)
        else:
            from wiser_tpu_torch.bench.query_pool import QueryLogReader

            queries = QueryLogReader(args.query_log).read_all(args.n_results)
            out = run_locallog(engine, queries, args.batch)
        out["device"] = str(engine.device)
    else:
        out = run_grpc(args.target, args.query_log, args.n_threads,
                       args.duration, streaming=(args.mode == "grpc"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
