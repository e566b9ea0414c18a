"""Micro-benchmarks (the port's copy of wiser_tpu/tools/micro_bench.py) —
reference: intersect_bench.cc, packing_bench.cc, sorting_bench.cc,
trie_bench.cc, grpc_bench.cc, snippet_bench.cc.

Times the primitive layers alone: the host codecs (the native library
and the numpy specification in codecs.py), host intersection, snippet
generation, single- and two-term batches through TorchEngine on a
device, and the raw gRPC echo. The row names are the JAX harness's.

Run: python -m wiser_tpu_torch.tools.micro_bench [--device \
         [--device-name cpu]] [--echo-target host:port]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from wiser_tpu_torch.utils import ResultTable


def _rate(n, t):
    return f"{n / max(t, 1e-9) / 1e6:.1f} M/s"


def bench_codecs(table: ResultTable) -> None:
    from wiser_tpu_torch.codecs import pack_block
    from wiser_tpu_torch.native import lib as native

    rng = np.random.default_rng(0)
    n_blocks = 2000
    vals = rng.integers(0, 1 << 13, size=n_blocks * 128, dtype=np.uint64).astype(np.uint32)
    widths = np.full(n_blocks, 13, dtype=np.uint8)

    t0 = time.perf_counter()
    words = native.pack_blocks(vals, widths)
    t1 = time.perf_counter()
    native.unpack_blocks(words, widths)
    t2 = time.perf_counter()
    table.add_row(bench="pack128_native", n=len(vals), rate=_rate(len(vals), t1 - t0))
    table.add_row(bench="unpack128_native", n=len(vals), rate=_rate(len(vals), t2 - t1))

    t0 = time.perf_counter()
    for b in range(200):
        pack_block(vals[b * 128 : (b + 1) * 128], 13)
    table.add_row(bench="pack128_python", n=200 * 128,
                  rate=_rate(200 * 128, time.perf_counter() - t0))

    nv = min(len(vals), 200_000)
    t0 = time.perf_counter()
    enc = native.varint_encode_array(vals[:nv])
    t1 = time.perf_counter()
    native.varint_decode_array(enc, nv)
    t2 = time.perf_counter()
    table.add_row(bench="varint_encode", n=nv, rate=_rate(nv, t1 - t0))
    table.add_row(bench="varint_decode", n=nv, rate=_rate(nv, t2 - t1))

    doc = (b"the quick brown fox jumps over the lazy dog " * 400)
    t0 = time.perf_counter()
    for _ in range(100):
        c = native.lz4_compress(doc)
    t1 = time.perf_counter()
    for _ in range(100):
        native.lz4_decompress(c, len(doc))
    t2 = time.perf_counter()
    table.add_row(bench="lz4_compress", n=100 * len(doc),
                  rate=f"{100 * len(doc) / (t1 - t0) / 1e6:.0f} MB/s",
                  ratio=round(len(c) / len(doc), 3))
    table.add_row(bench="lz4_decompress", n=100 * len(doc),
                  rate=f"{100 * len(doc) / (t2 - t1) / 1e6:.0f} MB/s")


def bench_intersection_host(table: ResultTable) -> None:
    # intersect_bench.cc's analog at the numpy level
    rng = np.random.default_rng(1)
    a = np.unique(rng.integers(0, 10_000_000, 1_000_000))
    b = np.unique(rng.integers(0, 10_000_000, 1_000_000))
    t0 = time.perf_counter()
    idx = np.minimum(np.searchsorted(b, a), len(b) - 1)
    n = int((b[idx] == a).sum())
    t = time.perf_counter() - t0
    table.add_row(bench="host_intersect_1M", matches=n, rate=_rate(len(a), t))


def bench_snippets(table: ResultTable) -> None:
    from wiser_tpu_torch.highlighter import SimpleHighlighter

    doc = ("Sentence one about search engines. " * 20
           + "Another passage mentioning queries. " * 20)
    offsets = [[(i * 35, i * 35 + 7) for i in range(20)]]
    t0 = time.perf_counter()
    for _ in range(200):
        SimpleHighlighter().highlight(offsets, 3, doc)
    t = time.perf_counter() - t0
    table.add_row(bench="snippet_200x", total_s=round(t, 3),
                  per_call_ms=round(1000 * t / 200, 2))


def bench_device(table: ResultTable, device="cuda") -> None:
    """1,024 single-term and 1,024 two-term queries through TorchEngine on
    `device` over a 2,000-doc synthetic index: a warm pass, then a timed
    one (search_batch returns the finalized host results)."""
    from wiser_tpu_torch.data.synth import synth_docinfos
    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.builder import build_index
    from wiser_tpu_torch.runtime import resolve_device
    from wiser_tpu_torch.types import SearchQuery

    resolve_device(device)  # before the build, not after it
    packed, _ = build_index(synth_docinfos(2000, 500, 60, seed=0))
    engine = TorchEngine(packed, device=device)
    for name, queries in (
            ("device_1k_single_term",
             [SearchQuery([f"t{i % 400}"], n_results=10) for i in range(1024)]),
            ("device_1k_two_term",
             [SearchQuery([f"t{i % 200}", f"t{(i + 7) % 200}"], n_results=10)
              for i in range(1024)])):
        engine.search_batch(queries)  # warm
        t0 = time.perf_counter()
        engine.search_batch(queries)
        t = time.perf_counter() - t0
        table.add_row(bench=name, total_s=round(t, 3), qps=round(1024 / t))


def bench_echo(table: ResultTable, target: str) -> None:
    # grpc_bench.cc's analog: raw echo round trips
    import grpc

    from wiser_tpu_torch.serve import wiser_pb2 as pb
    from wiser_tpu_torch.serve.protocol import WiserEngineStub

    with grpc.insecure_channel(target) as channel:
        stub = WiserEngineStub(channel)
        stub.Echo(pb.EchoData(message="warm"))
        t0 = time.perf_counter()
        n = 500
        for _ in range(n):
            stub.Echo(pb.EchoData(message="x"))
        t = time.perf_counter() - t0
    table.add_row(bench="grpc_echo", rtts=n, per_call_us=round(1e6 * t / n, 1))


def main(argv=None) -> ResultTable:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="include the engine rows")
    ap.add_argument("--device-name", default="cuda",
                    help="the torch device of the engine rows")
    ap.add_argument("--echo-target", help="host:port of a running server")
    args = ap.parse_args(argv)

    table = ResultTable()
    bench_codecs(table)
    bench_intersection_host(table)
    bench_snippets(table)
    if args.device:
        bench_device(table, args.device_name)
    if args.echo_target:
        bench_echo(table, args.echo_target)
    print(table.to_str())
    return table


if __name__ == "__main__":
    main()
