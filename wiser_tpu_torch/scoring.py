"""Elasticsearch-compatible BM25 in f64 (the port's copy of
wiser_tpu/scoring.py; the reference's scoring.h), every expression in the
C++ operation order:

  idf     = log(1 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))
  tfnorm  = (freq*(k1+1)) / (freq + k1*(1 - b + b*field_len/avg_len))
  lossy tfnorm cache[code] = k1*(1 - b + b*Char4ToUint(code)/avg_len)
  doc score = sum over query terms, in order, of idf*tfnorm
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


def calc_es_tfnorm(freq, field_length, avg_field_length) -> np.ndarray:
    """Non-lossy tfnorm in float64 (scoring.h:28-40), in the C++ order
    (freq*(k1+1)) / (freq + k1*(1 - b + ((b*field_length)/avg_len)))."""
    f = np.asarray(freq, dtype=np.float64)
    fl = np.asarray(field_length, dtype=np.float64)
    return (f * (K1 + 1)) / (f + K1 * (1 - B + ((B * fl) / np.float64(avg_field_length))))


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

    def tf_norm_lossy(self, freq, length_code) -> np.ndarray:
        """TfNormLossy (scoring.h:65-69); length_code is the raw 1-byte
        code."""
        f = np.asarray(freq, dtype=np.float64)
        c = np.asarray(length_code, dtype=np.int64) & 0xFF
        return (f * (K1 + 1)) / (f + self.cache[c])

    def tf_norm(self, freq, field_length) -> np.ndarray:
        return calc_es_tfnorm(freq, field_length, self.avg_field_length)

    @staticmethod
    def idf(doc_count: int, doc_freq) -> np.ndarray:
        return calc_es_idf(doc_count, doc_freq)


def calc_doc_score_lossy(tfs, idfs, length_code: int,
                         similarity: Bm25Similarity) -> float:
    """CalcDocScoreLossy (scoring.h:124-145): the sum of idf * tfnorm over
    the query's terms in order (tfs, idfs: one per term), in f64."""
    score = np.float64(0.0)
    cache_val = similarity.cache[int(length_code) & 0xFF]
    for tf, idf in zip(np.asarray(tfs, dtype=np.float64),
                       np.asarray(idfs, dtype=np.float64)):
        tfnorm = (tf * (K1 + 1)) / (tf + cache_val)
        score = score + idf * tfnorm
    return float(score)


def calc_doc_scores_lossy_batch(tfs: np.ndarray, idfs: np.ndarray,
                                length_codes: np.ndarray,
                                similarity: Bm25Similarity) -> np.ndarray:
    """calc_doc_score_lossy for many docs of one query: tfs (n_docs,
    n_terms), length_codes (n_docs,). The sum runs term by term in query
    order, so each doc's f64 bits equal the per-doc loop's."""
    tfs = np.asarray(tfs, dtype=np.float64)
    codes = np.asarray(length_codes, dtype=np.int64) & 0xFF
    cache_vals = similarity.cache[codes]
    score = np.zeros(tfs.shape[0], dtype=np.float64)
    for t in range(tfs.shape[1]):
        f = tfs[:, t]
        tfnorm = (f * (K1 + 1)) / (f + cache_vals)
        score = score + np.float64(idfs[t]) * tfnorm
    return score


class RunningAvgLength:
    """Running mean of doc lengths in insertion order, float64
    (doc_length_store.h:105-110): avg = avg + (len - avg) / (n + 1)."""

    def __init__(self):
        self.avg = np.float64(0.0)
        self.n = 0

    def add(self, length: int) -> None:
        self.avg = self.avg + (np.float64(length) - self.avg) / np.float64(self.n + 1)
        self.n += 1

    @staticmethod
    def of(lengths) -> float:
        """The running mean of lengths, in their order."""
        r = RunningAvgLength()
        for x in lengths:
            r.add(int(x))
        return float(r.avg)
