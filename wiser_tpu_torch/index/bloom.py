"""Bloom filter geometry (the port's copy of wiser_tpu/index/bloom.py's
BloomConfig, a field of PackedIndex). The port has no phrase path yet, so
it carries the configuration and the stored filter rows, not the probe
hashing."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BloomConfig:
    """libbloom sizing (bloom.c:83-117); the defaults are the reference
    indexer's (tools/indexer.py:43-44)."""

    expected_entries: int = 5
    error_ratio: float = 0.0009
