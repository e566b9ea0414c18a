"""Timing and tracing utilities (the port's copy of wiser_tpu/utils.py, the
analog of the reference's gperftools hooks and its tab-separated
ResultTable, utils.h:112-143).

- PhaseTimer: named wall-clock phases with a report table.
- trace(): a torch.profiler capture of the CPU and, on a card, the CUDA
  activity inside a `with` block, exported as a Chrome trace (open it in
  chrome://tracing or Perfetto); summarize() reads the top device ops and
  the device busy share from it.
- ResultTable: tab-separated experiment rows.

Not carried: enable_compile_cache and serial_jit, which guard remote XLA
compiles; torch launches compile nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional


class PhaseTimer:
    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = ["phase\ttotal_s\tcalls\tavg_ms"]
        for name, tot in self.totals.items():
            n = self.counts[name]
            rows.append(f"{name}\t{tot:.3f}\t{n}\t{1000*tot/n:.2f}")
        return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block: CPU activity, and CUDA activity when `device` is
    a CUDA device ("cuda" by default: raises without a card; pass "cpu"
    for the CPU alone). Yields the torch.profiler.profile object; on exit
    the card is synchronized, the trace is written to
    <log_dir>/trace.json and the block's wall time is set as
    prof.wall_s (summarize reads it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wiser_tpu_torch.runtime import resolve_device

    cuda = resolve_device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        prof.wall_s = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _interval_union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0]


def summarize(prof, top: int = 10) -> dict:
    """The top ops of a trace() capture — the device's own events
    (kernels, copies, memsets) by their device time, or with no device
    activity the CPU ops by self CPU time — and the device busy share:
    the union of the device events' intervals over the block's wall.
    device is "cuda" when the capture holds device events, else "cpu"
    with busy_share None."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    cuda = bool(dev_events)
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    rows = []
    for a in prof.key_averages():
        if cuda:
            if a.device_type != DeviceType.CUDA:
                continue  # a CPU op: its kernels are counted themselves
            us = a.self_device_time_total
        else:
            us = a.self_cpu_time_total
        if us > 0:
            rows.append({"name": _short_name(a.key), "self_ms": us / 1e3,
                         "calls": a.count, "kernel": a.key})
    rows.sort(key=lambda r: -r["self_ms"])
    wall_s = getattr(prof, "wall_s", None)
    out = {"device": "cuda" if cuda else "cpu", "ranked_by": key,
           "top_ops": rows[:top], "wall_s": wall_s, "busy_share": None,
           "device_busy_ms": None, "device_events": len(dev_events)}
    if cuda:
        busy_us = _interval_union_us(
            (e.time_range.start, e.time_range.end) for e in dev_events)
        out["device_busy_ms"] = busy_us / 1e3
        if wall_s:
            out["busy_share"] = busy_us / 1e6 / wall_s
    return out


class ResultTable:
    """reference: utils::ResultTable/ResultRow (utils.h:112-143) —
    tab-separated rows with a header derived from the union of keys."""

    def __init__(self):
        self.rows: List[Dict[str, object]] = []

    def add_row(self, **kv) -> None:
        self.rows.append(kv)

    def to_str(self) -> str:
        cols: List[str] = []
        for r in self.rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        out = ["\t".join(cols)]
        for r in self.rows:
            out.append("\t".join(str(r.get(c, "NA")) for c in cols))
        return "\n".join(out)


def device_peak_bytes(device) -> Optional[int]:
    """Peak device memory allocated since the last reset on a CUDA device;
    None on the CPU (there is no device memory to read)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def reset_device_peak(device) -> None:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def device_timer(device):
    """A (start, stop) pair timing device work: CUDA events on a card (stop
    returns the elapsed seconds after synchronizing), the host clock on
    the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        def start():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def stop(ev):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return ev.elapsed_time(end) / 1e3
    else:
        start = time.perf_counter

        def stop(t0):
            return time.perf_counter() - t0
    return start, stop
