"""Exact top-k finalization: the host f64 re-rank of device candidates
(the port's copy of wiser_tpu/engine/topk.py).

The device ranks in f32 and returns the top-M candidate docs with their
per-term tfs; the host recomputes the exact f64 BM25 score in the
reference's operation order (CalcDocScoreLossy, scoring.h:124-145) and
orders by (score desc, doc asc).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from wiser_tpu_torch.scoring import K1


def rescore_topk(
    top_docs: np.ndarray,  # (M,) int32, -1 = invalid
    top_tfs: np.ndarray,  # (T, M) int32, slot-major, query-term order
    n_real_terms: int,
    idf64: np.ndarray,  # (n_real_terms,) float64
    doc_len_code: np.ndarray,  # (N,) uint8
    cache64: np.ndarray,  # (256,) float64 tfnorm cache
    k: int,
) -> List[Tuple[float, int]]:
    """One query's exact re-rank: [(score, doc_id)] of length <= k in
    (score desc, doc asc) order."""
    valid = top_docs >= 0
    docs = top_docs[valid].astype(np.int64)
    if docs.size == 0:
        return []
    tfs = top_tfs[:n_real_terms, valid].astype(np.float64)
    cache_val = cache64[doc_len_code[docs] & 0xFF]
    score = np.zeros(docs.size, dtype=np.float64)
    for t in range(n_real_terms):
        f = tfs[t]
        score = score + np.float64(idf64[t]) * ((f * (K1 + 1)) / (f + cache_val))
    order = np.lexsort((docs, -score))[:k]
    return [(float(score[i]), int(docs[i])) for i in order]


def rescore_sorted_arrays(
    top_docs: np.ndarray,  # (B, M) int32, -1 = invalid
    top_tfs_q: np.ndarray,  # (B, T, M) int32, query-term order
    idf64_q: np.ndarray,  # (B, T) float64, 0.0 on padded slots
    doc_len_code: np.ndarray,
    cache64: np.ndarray,
) -> tuple:
    """Exact f64 re-rank of a group: returns (docs (B,M) int64 sorted by
    (score desc, doc asc), scores (B,M) f64, n_valid (B,) int64). The
    f64 sum runs over slots in query-term order; padded slots add exactly
    +0.0, so the bits equal the per-query reference sum."""
    B, T, M = top_tfs_q.shape
    valid = (top_docs >= 0) & (top_docs < doc_len_code.shape[0])
    docs = np.where(valid, top_docs, 0).astype(np.int64)
    cache_val = cache64[doc_len_code[docs] & 0xFF]
    score = np.zeros((B, M), dtype=np.float64)
    for t in range(T):
        f = top_tfs_q[:, t, :].astype(np.float64)
        score = score + idf64_q[:, t : t + 1] * ((f * (K1 + 1)) / (f + cache_val))
    # flat-index gathers (take_along_axis builds np.indices per call)
    off = (np.arange(B, dtype=np.int64) * M)[:, None]
    docs_sorted_idx = np.argsort(docs, axis=1, kind="stable")
    flat = docs_sorted_idx + off
    score_d = np.where(valid.ravel()[flat], score.ravel()[flat], -np.inf)
    final_idx = np.argsort(-score_d, axis=1, kind="stable")
    order = flat.ravel()[final_idx + off].reshape(B, M)
    return docs.ravel()[order], score.ravel()[order], valid.sum(axis=1)


def truncation_suspects(score_f: np.ndarray, n_valid: np.ndarray,
                        ks: np.ndarray, rel_eps: float = 1e-6) -> np.ndarray:
    """(B,) bool: rows whose f32 summation error may have moved a
    candidate across the buffer boundary — a full buffer whose k-th and
    last f64 scores are distinct but within rel_eps. Exact f64 ties at
    the boundary are the device's FLAG_TRUNC (kernels.boundary_truncated);
    the two checks together cover every possible parity break, and the
    caller re-runs flagged rows exactly on the host."""
    B, M = score_f.shape
    full = n_valid >= M
    if not full.any():
        return full
    k_idx = np.minimum(np.maximum(ks, 1) - 1, M - 1)
    kth = np.take_along_axis(score_f, k_idx[:, None].astype(np.int64), 1)[:, 0]
    last = score_f[:, M - 1]
    near = np.abs(kth - last) <= rel_eps * np.maximum(np.abs(kth), 1e-30)
    return full & near & (kth != last)


def rescore_topk_batch(
    top_docs: np.ndarray,  # (B, M) int32, -1 = invalid
    top_tfs: np.ndarray,  # (B, T, M) int32, slot-major, query-term order
    idf64_slots: np.ndarray,  # (B, T) float64, 0.0 on padded slots
    doc_len_code: np.ndarray,  # (N,) uint8
    cache64: np.ndarray,  # (256,) float64
    ks: np.ndarray,  # (B,) per-query k
) -> List[List[Tuple[float, int]]]:
    """rescore_topk for a whole group: per query, [(score, doc_id)] of
    length <= k. Padded slots add exactly +0.0 to the f64 sum, so each
    score equals the per-query reference order's (CalcDocScoreLossy)."""
    docs_f, score_f, n_valid = rescore_sorted_arrays(
        top_docs, top_tfs, idf64_slots, doc_len_code, cache64)
    return [[(float(score_f[b, m]), int(docs_f[b, m]))
             for m in range(min(int(ks[b]), int(n_valid[b])))]
            for b in range(top_docs.shape[0])]
