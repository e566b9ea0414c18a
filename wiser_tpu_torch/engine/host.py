"""Host-side helpers of the engine (ported from wiser_tpu/engine/device.py,
which imports jax.numpy and so cannot be imported by the port): shape
buckets, the exact host search (conjunctive and phrase), the single-term
impact table, query slot planning, the padded device columns (raw and
tc) and the f64 bound of the tc score the dense tier's block planes
hold."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from wiser_tpu_torch.engine.kernels import (
    B_F32,
    FLAG_TRUNC,
    INT32_MAX,
    K1_F32,
    K1_PLUS_1,
    ONE_MINUS_B_F32,
    TF_SAT,
    _char4_length,
)
from wiser_tpu_torch.index.format import SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.scoring import K1
from wiser_tpu_torch.types import SearchQuery

L_BUCKETS = [128, 512, 2048, 8192, 32768, 131072, 524288, 2097152]
B_BUCKETS = [8, 32, 128, 1024, 4096]
B_CHUNK = 4096
T_BUCKETS = [1, 2, 3, 4, 8]
PP_BUCKETS = [8, 32, 128, 512, 2048, 8192]  # position-bag bounds (max_tf)
DEFAULT_MARGIN = 54  # M = k + margin


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def host_exact_search(packed: PackedIndex, cache64: np.ndarray,
                      rows: Sequence[int], k: int, is_phrase: bool = False):
    """Exact host conjunctive or phrase search over the packed columns:
    the fallback for guard-flagged and saturated queries, and the
    reference semantics for one-off queries. Returns (docs int64[<=k],
    scores f64[<=k]) in final (score desc, doc asc) order.

    A phrase scores as the AND of its terms (BM25 over the term tfs; the
    phrase only filters), so the AND matches are walked in final order and
    verified for adjacency chunk by chunk until k survive: a later
    candidate can never displace an earlier verified one. Before that, the
    bi-bloom pre-gate (the reference's IsPossibleToPresent on the host
    path, query_processing.h:796-807) drops candidates whose term t
    "followers" filter lacks term t+1: a definite no, so the gate only
    shrinks the verify set."""
    dfs = [int(packed.df[r]) for r in rows]
    cand = int(np.argmin(dfs))
    cs = int(packed.term_starts[rows[cand]])
    docs = packed.postings_doc[cs : cs + dfs[cand]].astype(np.int64)
    mask = np.ones(len(docs), dtype=bool)
    tfs = np.zeros((len(rows), len(docs)), dtype=np.int64)
    pidx = np.zeros((len(rows), len(docs)), dtype=np.int64)
    for t, r in enumerate(rows):
        st, n = int(packed.term_starts[r]), dfs[t]
        arr = packed.postings_doc[st : st + n]
        idx = np.searchsorted(arr, docs)
        idc = np.minimum(idx, n - 1)
        mask &= (idx < n) & (arr[idc] == docs)
        tfs[t] = packed.postings_tf[st + idc]
        pidx[t] = st + idc
    docs_m = docs[mask]
    if docs_m.size == 0:
        return docs_m, np.zeros(0, dtype=np.float64)
    tfs_m = tfs[:, mask].astype(np.float64)
    cache_val = cache64[packed.doc_len_code[docs_m] & 0xFF]
    score = np.zeros(docs_m.size, dtype=np.float64)
    for t, r in enumerate(rows):
        f = tfs_m[t]
        score = score + np.float64(packed.idf64[r]) * ((f * (K1 + 1)) / (f + cache_val))
    order = np.lexsort((docs_m, -score))
    if not (is_phrase and len(rows) >= 2):
        order = order[:k]
        return docs_m[order], score[order]
    pidx_m = pidx[:, mask]
    if packed.bloom_ends is not None:
        cfg = packed.bloom_cfg
        keep = np.ones(docs_m.size, dtype=bool)
        for t in range(len(rows) - 1):
            widx, wmask = cfg.probe_word_masks(packed.terms[rows[t + 1]])
            filt = packed.bloom_ends[pidx_m[t]]  # (n_cand, W)
            for h in range(len(widx)):
                keep &= (filt[:, widx[h]] & wmask[h]) == wmask[h]
            if not keep.any():
                break
        sel = np.nonzero(keep)[0]
        docs_m, score, pidx_m = docs_m[sel], score[sel], pidx_m[:, sel]
        if docs_m.size == 0:
            return docs_m, np.zeros(0, dtype=np.float64)
        order = np.lexsort((docs_m, -score))
    kept: list = []
    i, chunk = 0, 2048
    while i < order.size and len(kept) < k:
        take = order[i : i + chunk]
        ok = _host_phrase_mask(packed.positions, packed.pos_starts,
                               docs_m[take], pidx_m[:, take], len(rows))
        kept.extend(take[ok])
        i += chunk
        chunk *= 4  # phrase-rare pairs: reach the full set's cost fast
    order = np.asarray(kept[:k], dtype=np.int64)
    return docs_m[order], score[order]


def _host_phrase_mask(positions: np.ndarray, pos_starts: np.ndarray,
                      docs: np.ndarray, pidx: np.ndarray,
                      n_terms: int) -> np.ndarray:
    """(n,) bool: which candidate docs hold the phrase, by the adjusted
    position rule (term t at x + t for every t, query_processing.h:
    266-362). Term t's positions are keyed doc * SHIFT + (pos - t); a
    match is a key in every term's key set, found by iterated sorted
    intersection. pidx: (n_terms, n) posting indices of the docs."""
    if docs.size == 0:
        return np.zeros(0, dtype=bool)
    shift = np.int64(positions.max(initial=0)) + np.int64(n_terms) + 1

    def keys(t: int) -> np.ndarray:
        p = pidx[t]
        s = pos_starts[p].astype(np.int64)
        cnt = pos_starts[p + 1].astype(np.int64) - s
        out_starts = np.zeros(len(p) + 1, dtype=np.int64)
        np.cumsum(cnt, out=out_starts[1:])
        idx = (np.repeat(s, cnt) + np.arange(int(out_starts[-1]))
               - np.repeat(out_starts[:-1], cnt))
        return (np.repeat(docs, cnt) * shift
                + (positions[idx].astype(np.int64) - t))

    base = keys(0)
    for t in range(1, n_terms):
        base = np.intersect1d(base, keys(t), assume_unique=False)
        if base.size == 0:
            break
    return np.isin(docs, np.unique(base // shift))


def tie_class_cut(flags: np.ndarray, score_f: np.ndarray, n_valid: np.ndarray,
                  ks: np.ndarray, rel_eps: float) -> np.ndarray:
    """(B,) bool: rows whose f32 boundary class was truncated (FLAG_TRUNC)
    and whose k-th kept f64 score ties the last kept one within rel_eps,
    exact ties included.

    Such a row's top-k reaches into the truncated class, so which of its
    tied lanes the device kept decides the answer. The JAX engine leaves
    exact ties to lax.top_k's lowest-index tie-break; torch.topk has no
    tie-break, so these rows take the exact host path. Rows whose k-th
    score clears the boundary by more than rel_eps are exact whichever
    tied lanes were kept (truncation_suspects covers the distinct near
    ties)."""
    B, M = score_f.shape
    full = n_valid >= M
    k_idx = np.minimum(np.maximum(ks, 1) - 1, M - 1).astype(np.int64)
    kth = score_f[np.arange(B), k_idx]
    last = score_f[:, M - 1]
    near = np.abs(kth - last) <= rel_eps * np.maximum(np.abs(kth), 1e-30)
    return ((flags & FLAG_TRUNC) != 0) & full & near


def build_single_term_table(packed: PackedIndex, scores64: np.ndarray,
                            depth: int):
    """Impact-ordered per-term top tables: each term's first min(df,
    depth) postings in the exact (f64 score desc, doc asc) canon, so a
    single-term query with k <= depth (or k >= df) is a host slice.

    Returns (tt_starts int64[T+1], tt_docs int64[...], tt_scores f64).

    The reference takes one lexsort of every posting by (term, -score,
    doc); this sorts each run on its own, runs of one padded length
    together as the rows of a 2-D array: a stable sort by -score keeps
    the run's ascending doc order among equal scores, so the order is
    the lexsort's at a fraction of its cost (a few seconds of each
    engine's start at 1M docs)."""
    lens = np.diff(packed.term_starts).astype(np.int64)
    # cap by actual run length too: a staged hot view keeps global df
    # for cold rows but gives them zero-length runs
    cnt = np.minimum(np.minimum(packed.df, lens), depth).astype(np.int64)
    tt_starts = np.zeros(packed.n_terms + 1, dtype=np.int64)
    np.cumsum(cnt, out=tt_starts[1:])
    idx = np.empty(int(tt_starts[-1]), dtype=np.int64)
    starts = packed.term_starts[:-1].astype(np.int64)
    live = cnt > 0
    for L in np.unique(lens[live]).tolist():
        rows_L = np.nonzero(live & (lens == L))[0]
        step = max(1, (1 << 24) // L)  # bound the (rows, L) temporaries
        for r0 in range(0, len(rows_L), step):
            rows = rows_L[r0 : r0 + step]
            pos = starts[rows, None] + np.arange(L, dtype=np.int64)
            # sentinel pads score exactly 0.0 < any real score -> last
            order = np.argsort(-scores64[pos], axis=1, kind="stable")
            c = cnt[rows]
            m = int(c.max())
            keep = np.arange(m) < c[:, None]
            dest = tt_starts[rows, None] + np.arange(m)
            idx[dest[keep]] = np.take_along_axis(pos, order[:, :m], 1)[keep]
    return tt_starts, packed.postings_doc[idx].astype(np.int64), scores64[idx]


def padded_host_columns(packed: PackedIndex, scores64: np.ndarray,
                        l_buckets: Sequence[int] = L_BUCKETS):
    """The raw device columns as host arrays: (doc int32, score f32, tf
    int32), each padded past the real data by one max-L bucket + 4096
    (doc pad INT32_MAX, score/tf pad 0) so no candidate slice starting
    inside the data is ever clamped."""
    pad = _bucket(int(packed.df.max(initial=1)), l_buckets) + 4096
    h_doc = np.pad(packed.postings_doc, (0, pad),
                   constant_values=INT32_MAX).astype(np.int32)
    h_score = np.pad(scores64.astype(np.float32), (0, pad))
    h_tf = np.pad(packed.postings_tf, (0, pad)).astype(np.int32)
    return h_doc, h_score, h_tf


def padded_tc_column(packed: PackedIndex,
                     l_buckets: Sequence[int] = L_BUCKETS) -> np.ndarray:
    """The tc device column as a host uint16 array: doc_len_code << 8 |
    min(tf, 255) per posting, 0 on sentinel pads, padded as the doc
    column (padded_host_columns) with 0 lanes, which score exactly 0."""
    pad = _bucket(int(packed.df.max(initial=1)), l_buckets) + 4096
    real = packed.postings_doc != SENTINEL_DOC
    code = packed.doc_len_code[
        np.where(real, packed.postings_doc, 0).astype(np.int64)]
    tf8 = np.minimum(packed.postings_tf, TF_SAT).astype(np.uint16)
    tc = (code.astype(np.uint16) << 8) | tf8
    return np.pad(np.where(real, tc, 0).astype(np.uint16), (0, pad))


def _tc_score64_ub(tc: torch.Tensor, idf64: torch.Tensor,
                   avg64: torch.Tensor) -> torch.Tensor:
    """f32 upper bound on the device's f32 tc_score of int32 tc lanes: the
    f64 reconstruction x (1 + 2e-6), which dominates its ~9 f32 rounding
    steps, in the reference's f64 operation order (so the planes equal
    the reference's on any device). idf64: the f64 value of the f32 idf
    the kernel uses, broadcastable; avg64: 0-d f64 tensor of the f32
    average length, on tc's device."""
    tf_i = tc & 0xFF
    tf = tf_i.to(torch.float64)
    length = _char4_length((tc >> 8) & 0xFF)
    cache = K1_F32 * (ONE_MINUS_B_F32
                      + B_F32 * length.to(torch.float64) / avg64)
    norm = (tf * K1_PLUS_1) / (tf + cache)
    norm = torch.where(tf_i == 0, 0.0, norm)
    norm = torch.where(tf_i >= TF_SAT, K1_PLUS_1, norm)
    return (idf64 * norm * (1 + 2e-6)).to(torch.float32)


@dataclass
class _PlannedQuery:
    qi: int  # index into the input batch
    rows: List[int]  # term dictionary rows, query order
    query: SearchQuery
    slot_rows: List[int] = field(default_factory=list)  # candidate-first
    slot_of_term: List[int] = field(default_factory=list)  # query t -> slot

    def plan_slots(self, df: np.ndarray) -> None:
        cand = int(np.argmin([df[r] for r in self.rows]))
        order = [cand] + [t for t in range(len(self.rows)) if t != cand]
        self.slot_rows = [self.rows[t] for t in order]
        self.slot_of_term = [0] * len(self.rows)
        for slot, t in enumerate(order):
            self.slot_of_term[t] = slot
