"""The unpack kernel's own device time, at the staged engine's shapes and
over whole doc columns, with the wrapper's host cost per call beside it.

A kernel's device time comes from torch.profiler (utils.trace): the
device time of the launches whose kernel name holds "unpack", summed over
the traced calls and divided by them. If the trace misses some of them
three times over, a CUDA graph of the calls is replayed between CUDA
events instead (the row says which). The host cost is the host clock
over many calls with one synchronize at the end: `host_us` until the
last call returns, `call_us` until the card is done, per call.

    python -m wiser_tpu_torch.tools.unpack_bench --columns DIR \
        --trees OLD,.,.,OLD --out report.json

It first writes the doc columns of two indexes into DIR as .npy files,
unless they are there: `pipeline`, the raw-text pipeline's index at
100,000 docs (the chip smoke's `tools` phase), and `1m`, the 1M-doc
wiki-shaped corpus of data/scale_corpus at its defaults (the smoke's
engine phases; its postings do not depend on the bloom columns, so it
is built without them). `--trees` measures once per entry, in turns,
each in its own process importing wiser_tpu_torch from that tree (a
checkout of another commit, e.g. unpacked from `git archive`), so that
two versions compare within one call on one card. Each measurement:
w = 16 at every G of the staged engine's buckets (warm, and at the
largest G also after a 256 MB write that flushes the 50 MB L2 before
each launch), then each column: the per-width loop of
`unpack_delta_blocks` and, where the tree has it, the single
`unpack_mixed_blocks` launch, held equal to each other.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM HBM3 rate (NVIDIA's data sheet) for the bytes bound
HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 << 20
COLUMNS = ("pipeline", "1m")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, calls: int, launches: int, between=None,
              match: str = "unpack") -> dict:
    """Device time per call of the kernels named `match` that fn()
    launches, `launches` times a call: torch.profiler (utils.trace) over
    `calls` calls (after a warm one), with between() run before each call
    (not counted: another kernel); the newest calls * launches of the
    trace's device events so named, by start. A trace with fewer is taken
    again, up to three times; then a CUDA graph of the calls is timed
    instead. `events` lists how many each trace held."""
    import torch
    from torch.autograd import DeviceType

    from wiser_tpu_torch.utils import trace

    if between is not None:
        between()
    fn()
    torch.cuda.synchronize()
    want = calls * launches
    seen = []
    for _ in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                for _ in range(calls):
                    if between is not None:
                        between()
                    fn()
            events = sorted(
                (e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA and match in e.name)
        seen.append(len(events))
        if len(events) >= want:
            events = events[-want:]
            return {"ms": sum(b - a for a, b, _ in events) / 1e3 / calls,
                    "launches_per_call": launches, "source": "profiler",
                    "events": seen,
                    "kernels": sorted({n.split("(")[0] for *_, n in events})}
    return {"ms": graph_ms(fn, calls), "launches_per_call": launches,
            "source": "cuda_graph", "events": seen, "kernels": []}


def graph_ms(fn, calls: int) -> float:
    """Device time per call of a CUDA graph of `calls` calls of fn(),
    replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int) -> dict:
    """Host clock per call over `calls` calls of fn() (after a warm one),
    one synchronize at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_us": (t1 - t0) / calls * 1e6,
            "call_us": (t2 - t0) / calls * 1e6}


def timed(fn, calls: int, host_calls: int, bytes_moved: int,
          launches: int = 1, between=None) -> dict:
    """device_ms + host_us of fn() beside the bytes bound."""
    row = device_ms(fn, calls, launches, between)
    if between is None:
        row.update(host_us(fn, host_calls))
    row["bound_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
    row["share"] = row["bound_ms"] / row["ms"]
    return row


def uniform_inputs(G: int, width: int, seed: int, dev):
    """(G, 4*width) random packed words and (G,) first ids on dev."""
    import torch

    from wiser_tpu_torch.native import lib as native

    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**width, size=G * 128, dtype=np.uint64
                        ).astype(np.uint32)
    words = native.pack_blocks(vals, np.full(G, width, dtype=np.uint8))
    d_words = torch.from_numpy(words.reshape(G, 4 * width).view(np.int32)
                               ).to(dev)
    d_first = torch.from_numpy(
        rng.integers(0, 2**30, size=G).astype(np.int32)).to(dev)
    return d_words, d_first


def uniform_bytes(G: int, width: int) -> int:
    # each word and first id read once, each decoded id written once
    return G * 16 * width + G * 4 + G * 128 * 4


def bench_uniform(U, dev, buckets, width: int = 16, calls: int = 200,
                  host_calls: int = 1000) -> list:
    """unpack_delta_blocks at `width` over each G of `buckets`, into a
    given out (as the staged engine calls it); the largest G also after
    an L2 flush before each launch."""
    import torch

    rows = []
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for G in buckets:
        d_words, d_first = uniform_inputs(G, width, G, dev)
        out = torch.empty(G * 128, dtype=torch.int32, device=dev)

        def fn():
            U.unpack_delta_blocks(d_words, d_first, width, out=out)

        row = {"G": G, "width": width, "l2": "warm"}
        row.update(timed(fn, calls, host_calls, uniform_bytes(G, width)))
        rows.append(row)
        log(f"uniform {row}")
        if G == max(buckets):
            row = {"G": G, "width": width, "l2": "flushed"}
            row.update(timed(fn, calls // 4, 0, uniform_bytes(G, width),
                             between=lambda: flush.fill_(1)))
            rows.append(row)
            log(f"uniform {row}")
    return rows


def column_forms(U, cols: dict, dev):
    """The decode forms of a packed column on dev, each (fn, result):
    "loop", one unpack_delta_blocks launch per width, each into a new
    output (the whole-column decode before the single launch), and,
    where the module has it, "single", one unpack_mixed_blocks launch;
    result() assembles the form's last decode into the column."""
    import torch

    G = len(cols["block_first"])
    groups = {w: (torch.from_numpy(np.ascontiguousarray(words).view(
        np.int32)).to(dev), torch.from_numpy(cols["block_first"][sel]).to(dev),
        torch.from_numpy(sel.astype(np.int64)).to(dev))
        for w, (sel, words) in cols["groups"].items()}
    last = {}

    def loop():
        for w, (d_words, d_first, _) in groups.items():
            last[w] = U.unpack_delta_blocks(d_words, d_first, w)

    def loop_column():
        col = torch.empty((G, 128), dtype=torch.int32, device=dev)
        for w, (_, _, d_sel) in groups.items():
            col[d_sel] = last[w].reshape(-1, 128)
        return col.reshape(-1)

    forms = {"loop": (loop, loop_column)}
    if hasattr(U, "unpack_mixed_blocks"):
        table = U.upload_table(U.doc_block_table(cols), dev)
        out = torch.empty(G * 128, dtype=torch.int32, device=dev)
        forms["single"] = (lambda: U.unpack_mixed_blocks(*table, out=out),
                           lambda: out)
    return forms


def column_bytes(cols: dict, table: bool) -> int:
    """Bytes the column's decode must move: every packed word and first id
    read once, every decoded id written once; the single launch also
    reads its table's width, offset and destination per block."""
    G = len(cols["block_first"])
    words = sum(4 * w.size for _, w in cols["groups"].values())
    return words + 4 * G + 512 * G + (13 * G if table else 0)


def bench_column(U, postings_doc, dev, calls: int = 20) -> dict:
    """Each decode form of a doc column timed, the forms held equal."""
    cols = U.pack_doc_blocks(postings_doc)
    forms = column_forms(U, cols, dev)
    row = {"blocks": len(cols["block_first"]), "widths": len(cols["groups"])}
    got = {}
    for name in sorted(forms):
        fn, result = forms[name]
        row[name] = timed(fn, calls, calls, column_bytes(cols, name == "single"),
                          launches=1 if name == "single" else row["widths"])
        got[name] = result().cpu().numpy()
        log(f"column {name} {row[name]}")
    if "single" in got and not np.array_equal(got["single"], got["loop"]):
        raise AssertionError("the single launch != the per-width loop")
    return row


def measure(root: str, columns_dir: str) -> dict:
    """One tree's readings, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.engine.staged import _G16_BUCKETS
    from wiser_tpu_torch.ops import unpack as U

    if not torch.cuda.is_available():
        raise RuntimeError("unpack_bench measures a card: none is available")
    dev = torch.device("cuda", 0)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(U.__file__),
           "single_launch": hasattr(U, "unpack_mixed_blocks"),
           "uniform": bench_uniform(U, dev, _G16_BUCKETS)}
    for name in COLUMNS:
        path = os.path.join(columns_dir, f"{name}.npy")
        if os.path.exists(path):
            out[name] = bench_column(U, np.load(path), dev)
            torch.cuda.empty_cache()
    return out


def make_columns(columns_dir: str, n_docs: int = 1_000_000,
                 pipe_docs: int = 100_000) -> None:
    """The pipeline index's and the scale corpus's doc columns as .npy."""
    from wiser_tpu_torch.data.scale_corpus import generate_linedoc
    from wiser_tpu_torch.index.fast_builder import build_packed_fast
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools.wiki_pipeline import run_pipeline

    os.makedirs(columns_dir, exist_ok=True)
    path = os.path.join(columns_dir, "pipeline.npy")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        work = os.path.join(columns_dir, "wikipipe")
        run_pipeline(work, pipe_docs, with_engine=False)
        packed = PackedIndex.load(os.path.join(work, "idx"),
                                  skip_offsets=True)
        np.save(path, packed.postings_doc)
        log(f"pipeline column: {len(packed.postings_doc)} lanes in "
            f"{time.perf_counter() - t0:.1f}s")
    path = os.path.join(columns_dir, "1m.npy")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        linedoc = os.path.join(columns_dir, "scale.linedoc")
        generate_linedoc(linedoc, n_docs, verbose=False)
        packed = build_packed_fast(linedoc)
        os.remove(linedoc)
        np.save(path, packed.postings_doc)
        log(f"1m column: {len(packed.postings_doc)} lanes in "
            f"{time.perf_counter() - t0:.1f}s")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--columns", required=True,
                    help="directory of the doc columns (.npy)")
    ap.add_argument("--trees", default=".",
                    help="comma-separated trees, measured in turns")
    ap.add_argument("--root", help="measure this tree in this process")
    ap.add_argument("--out", help="also write the readings here (JSON)")
    args = ap.parse_args(argv)
    if args.root:
        res = measure(args.root, args.columns)
        print(json.dumps(res), flush=True)
        return res
    make_columns(args.columns)
    runs = []
    for tree in args.trees.split(","):
        # -P: this file's directory stays off sys.path, so the child
        # imports wiser_tpu_torch from `tree` alone
        proc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--root", tree,
             "--columns", args.columns], capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"measuring {tree} failed ({proc.returncode})")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    res = {"runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(summary(runs)), flush=True)
    return res


def summary(runs: list) -> dict:
    """Per run: device ms, host us and bound share of each shape."""
    out = []
    for r in runs:
        s = {"tree": r["tree"], "card": r["card"]}
        for u in r["uniform"]:
            s[f"w16_G{u['G']}_{u['l2']}"] = [u["ms"], u.get("host_us"),
                                             u["share"]]
        for name in COLUMNS:
            for form, t in r.get(name, {}).items():
                if isinstance(t, dict):
                    s[f"{name}_{form}"] = [t["ms"], t["host_us"], t["share"],
                                           t["launches_per_call"]]
        out.append(s)
    return {"unpack_bench": out}


if __name__ == "__main__":
    main()
