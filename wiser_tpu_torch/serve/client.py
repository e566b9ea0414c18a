"""Closed-loop multithreaded benchmark client (the port's copy of
wiser_tpu/serve/client.py; the reference's grpc_client_impl.h:
SyncStreamingClient :557, SyncUnaryClient :728, per-thread latency
histograms merged for percentiles :468-492, QPS = round trips / duration
:448-466). grpc is imported when a client is made.

Run: python -m wiser_tpu_torch.serve.client --target localhost:50051 \\
       --query-log queries.txt --n-threads 8 --duration 10 [--unary]
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional

from wiser_tpu_torch.bench.histogram import Histogram, format_latency_table
from wiser_tpu_torch.bench.query_pool import QueryLogReader, QueryProducer
from wiser_tpu_torch.serve.protocol import WiserEngineStub, request_from_query


class Client:
    """The reference's Client (grpc_client_impl.h:342-554)."""

    def __init__(self, target: str, producer: QueryProducer,
                 n_threads: int = 8, streaming: bool = True,
                 duration_s: float = 10.0, n_channels: int = 4,
                 wire_batch: int = 1, warmup_s: float = 0.0):
        import grpc

        self.target = target
        self.producer = producer
        self.n_threads = n_threads
        self.streaming = streaming
        self.duration_s = duration_s
        self.wire_batch = wire_batch
        # round trips that end in the first warmup_s keep the loop loaded
        # but are not recorded (channel set-up lands outside the window)
        self.warmup_s = warmup_s
        self.channels = [grpc.insecure_channel(target)
                         for _ in range(n_channels)]
        self.hists = [Histogram() for _ in range(n_threads)]
        self.counts = [0] * n_threads
        # streams that ended in an exception before the run's end
        self.errors: List[str] = []
        self._stop = threading.Event()
        self._record = threading.Event()
        if warmup_s <= 0:
            self._record.set()

    def _closed_loop(self, replies, hist: Histogram, tid: int, per_reply) -> None:
        """Time each round trip of a bidirectional stream."""
        t0 = time.monotonic_ns()
        for reply in replies:
            t1 = time.monotonic_ns()
            if self._record.is_set():
                hist.add(t1 - t0)
                self.counts[tid] += per_reply(reply)
            t0 = t1
            if self._stop.is_set():
                break

    def _thread_fn(self, tid: int) -> None:
        try:
            self._drive(tid)
        except Exception as e:  # counted in run()'s "errors", not raised
            if not self._stop.is_set():
                self.errors.append(f"thread {tid}: {e!r}")

    def _drive(self, tid: int) -> None:
        from wiser_tpu_torch.serve import wiser_pb2 as pb

        stub = WiserEngineStub(self.channels[tid % len(self.channels)])
        hist = self.hists[tid]
        if self.wire_batch > 1:
            # one message per wire_batch queries (SearchRequestBatch): the
            # loop times the message and counts its queries
            def gen():
                while not self._stop.is_set():
                    b = pb.SearchRequestBatch()
                    for _ in range(self.wire_batch):
                        b.requests.append(request_from_query(
                            self.producer.next_query(tid)))
                    yield b

            self._closed_loop(stub.BatchSearch(gen()), hist, tid,
                              lambda reply: len(reply.replies))
        elif self.streaming:
            def gen():
                while not self._stop.is_set():
                    yield request_from_query(self.producer.next_query(tid))

            self._closed_loop(stub.StreamingSearch(gen()), hist, tid,
                              lambda reply: 1)
        else:
            while not self._stop.is_set():
                q = self.producer.next_query(tid)
                t0 = time.monotonic_ns()
                stub.UnarySearch(request_from_query(q))
                if self._record.is_set():
                    hist.add(time.monotonic_ns() - t0)
                    self.counts[tid] += 1

    def run(self) -> dict:
        threads = [threading.Thread(target=self._thread_fn, args=(i,))
                   for i in range(self.n_threads)]
        for t in threads:
            t.start()
        if not self._record.is_set():
            time.sleep(self.warmup_s)
            self._record.set()
        t0 = time.time()
        time.sleep(self.duration_s)
        self._stop.set()
        for t in threads:
            t.join(timeout=10)
        wall = time.time() - t0
        total = sum(self.counts)
        return {"qps": total / wall, "total": total, "wall_s": wall,
                "errors": len(self.errors), "error_messages": self.errors[:5],
                "histogram": Histogram.merged(self.hists)}


def _proc_worker(target, queries, n_threads, streaming, duration,
                 n_channels, out_q, wire_batch=1, warmup_s=0.0) -> None:
    """One load process: a threaded Client, whose mergeable histogram
    state goes back over the queue."""
    client = Client(target, QueryProducer(queries, n_threads),
                    n_threads=n_threads, streaming=streaming,
                    duration_s=duration, n_channels=n_channels,
                    wire_batch=wire_batch, warmup_s=warmup_s)
    stats = client.run()
    h = stats["histogram"]
    out_q.put((stats["total"], stats["wall_s"], stats["errors"],
               h.buckets, h.count, h.sum, h.min, h.max))


def run_multiprocess(target, queries, n_procs, n_threads, streaming,
                     duration, n_channels, wire_batch: int = 1,
                     warmup_s: float = 0.0) -> dict:
    """Closed-loop load from n_procs spawned processes x n_threads streams
    (one CPython process is GIL-bound on proto + gRPC work, so offered
    concurrency scales with processes); histogram buckets merge exactly."""
    import multiprocessing as mp

    # spawn: a forked child would inherit the parent's gRPC threads
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_proc_worker,
                         args=(target, queries, n_threads, streaming,
                               duration, n_channels, out_q, wire_batch,
                               warmup_s), daemon=True)
             for _ in range(n_procs)]
    t0 = time.time()
    for p in procs:
        p.start()
    merged = Histogram()
    total = errors = 0
    walls = []
    for _ in procs:
        t, w, err, buckets, count, s, mn, mx = out_q.get(
            timeout=duration + warmup_s + 120)
        total += t
        errors += err
        walls.append(w)
        other = Histogram()
        other.buckets = list(buckets)
        other.count, other.sum, other.min, other.max = count, s, mn, mx
        merged.merge(other)
    for p in procs:
        p.join(timeout=30)
    wall = max(walls) if walls else time.time() - t0
    return {"qps": total / wall, "total": total, "wall_s": wall,
            "errors": errors, "histogram": merged, "n_procs": n_procs}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="wiser_tpu_torch benchmark client")
    ap.add_argument("--target", default="localhost:50051")
    ap.add_argument("--query-log", required=True)
    ap.add_argument("--n-procs", type=int, default=1,
                    help="load-generating processes (past the GIL)")
    ap.add_argument("--n-threads", type=int, default=8,
                    help="closed-loop streams per process")
    ap.add_argument("--n-channels", type=int, default=4)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--n-results", type=int, default=10)
    ap.add_argument("--unary", action="store_true")
    ap.add_argument("--wire-batch", type=int, default=1,
                    help="queries per wire message (BatchSearch); 1 = one "
                         "query per message, as the reference client")
    ap.add_argument("--warmup-s", type=float, default=0.0,
                    help="drive but do not record the first N seconds")
    args = ap.parse_args(argv)

    queries = QueryLogReader(args.query_log).read_all(n_results=args.n_results)
    if args.n_procs > 1:
        stats = run_multiprocess(
            args.target, queries, args.n_procs, args.n_threads,
            not args.unary, args.duration, args.n_channels,
            wire_batch=args.wire_batch, warmup_s=args.warmup_s)
    else:
        client = Client(args.target, QueryProducer(queries, args.n_threads),
                        n_threads=args.n_threads, streaming=not args.unary,
                        duration_s=args.duration, n_channels=args.n_channels,
                        wire_batch=args.wire_batch, warmup_s=args.warmup_s)
        stats = client.run()
    print(f"QPS\t{stats['qps']:.1f}")
    print(f"total\t{stats['total']}")
    print(f"errors\t{stats['errors']}")
    print(format_latency_table(stats["histogram"]))


if __name__ == "__main__":
    main()
