"""Elasticsearch-compatible BM25 in f64 (the port's copy of the parts of
wiser_tpu/scoring.py it calls; the reference's scoring.h).

  idf     = log(1 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))
  lossy tfnorm cache[code] = k1*(1 - b + b*Char4ToUint(code)/avg_len)
"""

from __future__ import annotations

import numpy as np

from wiser_tpu_torch.codecs import CHAR4_DECODE_TABLE

K1 = 1.2
B = 0.75


def calc_es_idf(doc_count: int, doc_freq) -> np.ndarray:
    """idf in float64 for an array of doc_freq (scoring.h:21-25)."""
    df = np.asarray(doc_freq, dtype=np.float64)
    n = np.float64(doc_count)
    return np.log(1.0 + (n - df + 0.5) / (df + 0.5))


class Bm25Similarity:
    """The 256-entry f64 cache keyed by the lossy length code, in the
    C++ operation order k1 * (1 - b + b * field_length / avg)
    (scoring.h:85-90)."""

    def __init__(self, avg_field_length: float = 1.0):
        self.reset(avg_field_length)

    def reset(self, avg_field_length: float) -> None:
        self.avg_field_length = float(avg_field_length)
        lengths = CHAR4_DECODE_TABLE.astype(np.float64)
        self.cache = K1 * (1.0 - B + B * lengths
                           / np.float64(self.avg_field_length))


class RunningAvgLength:
    """Running mean of doc lengths in insertion order, float64
    (doc_length_store.h:105-110): avg = avg + (len - avg) / (n + 1)."""

    def __init__(self):
        self.avg = np.float64(0.0)
        self.n = 0

    def add(self, length: int) -> None:
        self.avg = self.avg + (np.float64(length) - self.avg) / np.float64(self.n + 1)
        self.n += 1
