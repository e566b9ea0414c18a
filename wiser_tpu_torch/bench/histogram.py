"""Latency histograms (the port's copy of wiser_tpu/bench/histogram.py)
— reference: histogram.h + gpr_histogram usage in
grpc_client_impl.h:468-492 (per-thread histograms merged into percentiles
0/25/50/75/90/95/99/100).

Log-bucketed like gpr_histogram: bucket edges grow geometrically, so the
histogram covers nanoseconds..minutes with bounded error.
"""

from __future__ import annotations

import math
from typing import Iterable

DEFAULT_RESOLUTION = 0.01  # 1% buckets, gpr default
DEFAULT_MAX = 60e9  # 60s in ns

PERCENTILES = (0, 25, 50, 75, 90, 95, 99, 100)


class Histogram:
    def __init__(self, resolution: float = DEFAULT_RESOLUTION,
                 max_value: float = DEFAULT_MAX):
        self.resolution = resolution
        self.max_value = max_value
        self._log_base = math.log(1.0 + resolution)
        n = int(math.log(max_value) / self._log_base) + 2
        self.buckets = [0] * n
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def _bucket_of(self, value: float) -> int:
        v = max(value, 1.0)
        return min(int(math.log(v) / self._log_base), len(self.buckets) - 1)

    def add(self, value: float) -> None:
        self.buckets[self._bucket_of(value)] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def merge(self, other: "Histogram") -> None:
        assert len(self.buckets) == len(other.buckets)
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        if p <= 0:
            return self.min
        if p >= 100:
            return self.max
        target = self.count * p / 100.0
        seen = 0
        for i, c in enumerate(self.buckets):
            if seen + c >= target:
                return math.exp(i * self._log_base)
            seen += c
        return self.max

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {f"p{p}": self.percentile(p) for p in PERCENTILES} | {
            "mean": self.mean(), "count": self.count,
        }

    @staticmethod
    def merged(hists: Iterable["Histogram"]) -> "Histogram":
        hists = list(hists)
        out = Histogram(hists[0].resolution, hists[0].max_value) if hists else Histogram()
        for h in hists:
            out.merge(h)
        return out


def format_latency_table(hist: Histogram, unit_div: float = 1e3,
                         unit: str = "us") -> str:
    """reference output shape: percentile rows in a tab table
    (grpc_client_impl.h:476-489, utils::ResultTable)."""
    rows = [f"percentile\tlatency_{unit}"]
    for p in PERCENTILES:
        rows.append(f"p{p}\t{hist.percentile(p) / unit_div:.1f}")
    rows.append(f"mean\t{hist.mean() / unit_div:.1f}")
    return "\n".join(rows)
