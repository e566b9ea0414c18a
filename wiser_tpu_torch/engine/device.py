"""TorchEngine — the device-resident search engine in torch (port of
wiser_tpu/engine/device.py TpuEngine, raw and tc columns).

The posting columns (doc, f32 partial score, tf), the position bags, the
sparse folded bi-bloom columns and the dense head-term tier live on the
device. The host does what hosts are good at: term lookup, request
coalescing, shape bucketing, batch assembly, the exact f64 re-rank and
its guards.

columns="tc" (as TpuEngine(columns="tc")): one uint16 lane doc_len_code
<< 8 | min(tf, 255) replaces the (f32 score, i32 tf) pair (6 B per
posting instead of 12), and a dense head-term row is one uint8 tf per doc
beside a shared len-code row (1 B instead of 8). The kernels rebuild the
f32 score from the lane (kernels.tc_score) with per-slot f32 idfs, so the
guards widen to rel_eps = 1e-5, and a kept lane whose tf byte saturated
sends its query to the exact host path (FLAG_TF_SAT). Every route below
runs in either mode.

Routing (as TpuEngine at its defaults):
  1 term            -> host impact table (deeper k: the bs kernel)
  all terms dense   -> doc-space dense scan; past PRUNED_DENSE_MIN_NB doc
                       blocks the block-max pruned scan, whose prune-guard
                       misses re-run as one batched full scan per batch
                       (the rescue); sparse all-dense combos with a small
                       candidate list take semidense instead
  a dense other     -> semidense (candidate run x dense rows, short bs
                       for the non-dense others)
  long, similar-length lists (candidate L bucket in [WINDOWED_MIN_L,
  WINDOWED_MAX_L], longest list's bucket <= WINDOWED_MAX_RATIO x L)
                    -> windowed block intersection
                       (kernels.windowed_search_body), grouped by (T, L,
                       longest list's bucket); FLAG_OVERFLOW rows take
                       the exact host search
  2..8 terms        -> binary-search intersection (kernels.search_body),
                       grouped by (T bucket, candidate L bucket)
  > 8 terms         -> the same kernel with the exact slot count
  saturated, or candidate L bucket >= HOST_MERGE_MIN_L and not
  windowed-eligible -> memoized exact host search

Phrase queries (2+ terms, is_phrase; as TpuEngine._submit_phrase):
  every term dense, candidate df > PHRASE_MAX_L, bags within bounds
                    -> mega phrase: the full scan (every doc lane scored
                       from the dense rows, the KV best verified) or, with
                       FULL_PHRASE_SCAN off, the block-pruned scan of the
                       PRUNED_PHRASE_C highest-bound blocks; its
                       prune-guard misses re-run once at KV =
                       PRUNED_PHRASE_RETRY_KV (pruned: and
                       PRUNED_PHRASE_RETRY_C blocks) in the batch's rescue
  candidate L bucket > KV, every other term dense -> semidense phrase
  candidate L bucket > KV  -> compact phrase (bi-bloom gate, compaction
                              to the KV best, window verify)
  candidate L bucket <= KV -> list chain: match + bi-bloom gate, position
                              verify, top-M select
  saturated, lane budget or bag bounds exceeded -> exact host phrase
Every device result goes through the f64 re-rank (engine/topk.py);
guard-flagged rows take the exact host search. With doc_bodies, a query
that asks for snippets gets them from `snippet_for` over the full index
(host_packed), after every route's finalizer and the rescue.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wiser_tpu_torch.engine import kernels as K
from wiser_tpu_torch.engine.host import (
    B_BUCKETS,
    B_CHUNK,
    DEFAULT_MARGIN,
    L_BUCKETS,
    PP_BUCKETS,
    T_BUCKETS,
    _bucket,
    _PlannedQuery,
    build_single_term_table,
    host_exact_search,
    _tc_score64_ub,
    padded_host_columns,
    padded_tc_column,
    tie_class_cut,
)
from wiser_tpu_torch.engine.topk import rescore_sorted_arrays, truncation_suspects
from wiser_tpu_torch.highlighter import SimpleHighlighter
from wiser_tpu_torch.index.format import PackedIndex
from wiser_tpu_torch.runtime import resolve_device
from wiser_tpu_torch.scoring import Bm25Similarity
from wiser_tpu_torch.types import SearchQuery, SearchResult

# Lanes one bs group may hold, B * (T-1) * L. The binary search keeps
# about a dozen live (B, T-1, L) 4-byte tensors (lo, hi, mid, the
# gathered values, the compare, the where results), so 2^28 lanes is
# ~12 GB of intermediates: room on an 80 GB card beside the resident
# columns (~1 GB at 1M docs) and a staged scratch, and wide enough that
# L = 131072 groups still run at B = 1024 for T = 3.
BS_LANE_BUDGET = 1 << 28
# Window lanes one windowed group may hold, B * (T-1) * L * WIN: the
# gathered window docs and their int64 indices per other slot
WINDOWED_LANE_BUDGET = 1 << 27
# The dense tier's lane budgets are the reference's (sized for a 16 GB
# TPU); rebudgeting them for an 80 GB card is measured work (ROADMAP).
SEMIDENSE_LANE_BUDGET = 1 << 27  # B * (T-1) * L per semidense group
PRUNED_LANE_BUDGET = 1 << 27  # B * T * C * 128 per pruned-dense group
RESCUE_LANE_BUDGET = 1 << 28  # B * N_pad per full-scan rescue chunk
# Phrase groups: the compact / semidense / list routes keep ~10 L-wide
# planes per query and (B, KV, PP, PW) verify compares under 2^27 lanes;
# the mega route's (B, N_pad) planes under 2^29 (B = 128 at 1M docs).
PHRASE_LANE_BUDGET = 1 << 27
PRUNED_PHRASE_LANE_BUDGET = 1 << 29


def _chunk_within(budget: int, lanes_per_row: int, buckets) -> int:
    """Widest bucket b with b * lanes_per_row <= budget (else the
    smallest bucket)."""
    fit = budget // max(lanes_per_row, 1)
    chunk = buckets[0]
    for b in buckets:
        if b <= fit:
            chunk = b
    return chunk


def bs_chunk(T: int, L: int) -> int:
    """Widest B bucket whose bs group stays within BS_LANE_BUDGET."""
    return _chunk_within(BS_LANE_BUDGET, max(T - 1, 1) * L,
                         [b for b in B_BUCKETS if b <= B_CHUNK])


def windowed_chunk(T: int, L: int, L2: int) -> int:
    """Widest B bucket whose windowed group's (B, T-1, L, WIN) window
    lanes stay within WINDOWED_LANE_BUDGET (the reference's cap)."""
    win = K.default_win(L, L2 // 128)
    return _chunk_within(WINDOWED_LANE_BUDGET, max(T - 1, 1) * L * win,
                         B_BUCKETS)


def positions_column(positions: np.ndarray, max_t: int,
                     pos_pad: int) -> np.ndarray:
    """The device positions column: 2-byte int16 bits of uint16 when the
    largest position + max_t fits below 2^16 - 1 (kernels._pos_gather
    widens them), else int32; with a pos_pad tail (65535 / -1) that never
    equals a target, so a verify window starting inside the data is never
    clamped."""
    if int(positions.max(initial=0)) + max_t < 2**16 - 1:
        return np.concatenate([
            np.asarray(positions).astype(np.uint16),
            np.full(pos_pad, 2**16 - 1, dtype=np.uint16)]).view(np.int16)
    return np.concatenate([np.asarray(positions, dtype=np.int32),
                           np.full(pos_pad, -1, dtype=np.int32)])


def fold_bloom_columns(bloom_ends: np.ndarray, bloom_begins: np.ndarray,
                       gate: np.ndarray):
    """Sparse folded bloom columns (kernels._bloom_gate's layout): each
    posting's filter row ORed into one word, stored only where nonzero and
    gate (bool per posting, a multiple of 32 long) holds, addressed
    through a presence bitmap and a per-32-group rank, following side then
    preceding side. Returns (rows u32, bitmap u32, rank i32)."""
    rows_parts, bitmap_parts, rank_parts = [], [], []
    base = 0
    for rows in (bloom_ends, bloom_begins):
        fold = rows[:, 0].copy()
        for w in range(1, rows.shape[1]):
            np.bitwise_or(fold, rows[:, w], out=fold)
        stored = (fold != 0) & gate
        rows_parts.append(fold[stored])
        bitmap_parts.append(np.packbits(stored, bitorder="little").view("<u4"))
        cnt = stored.reshape(-1, 32).sum(axis=1)
        rank = np.zeros(len(cnt), dtype=np.int64)
        np.cumsum(cnt[:-1], out=rank[1:])
        rank_parts.append((rank + base).astype(np.int32))
        base += int(stored.sum())
    return ((np.concatenate(rows_parts) if base
             else np.zeros(1, dtype=np.uint32)),
            np.concatenate(bitmap_parts).astype(np.uint32),
            np.concatenate(rank_parts))


def admit_dense_rows(packed: PackedIndex, budget_bytes: int,
                     columns: str = "raw",
                     min_df_floor: Optional[int] = None,
                     eligible_fraction: Optional[int] = None) -> np.ndarray:
    """The term rows TorchEngine's dense tier admits, in slot order.
    Eligible: df >= max(min_df_floor, n_docs // eligible_fraction) (the
    engine's DENSE_MIN_DF_FLOOR / DENSE_ELIGIBLE_FRACTION by default) with
    a non-empty run; admitted by df, largest first, while a row (8 B per
    doc raw, 1 B tc, + 9 B per 128-doc block of bound planes) fits the
    budget, and while H * NB < 2^31 (the reference's bound on the pruned
    scan's block-row index, kept so both engines admit the same rows).
    Uncapped, the eligible rows stay in row order."""
    if min_df_floor is None:
        min_df_floor = TorchEngine.DENSE_MIN_DF_FLOOR
    if eligible_fraction is None:
        eligible_fraction = TorchEngine.DENSE_ELIGIBLE_FRACTION
    n = packed.n_docs
    dense_min = max(min_df_floor, n // eligible_fraction)
    lens = np.diff(packed.term_starts)
    rows = np.nonzero((packed.df >= dense_min) & (lens > 0))[0]
    NBLK = (n + 127) // 128
    per_row = NBLK * 128 * (1 if columns == "tc" else 8) + NBLK * 9
    cap = min(int(budget_bytes // per_row),
              (2**31 - 1) // max(NBLK, 1) - 1)
    if len(rows) > cap:
        rows = rows[np.argsort(packed.df[rows])[::-1][:cap]]
    return rows


class TorchEngine:
    MAX_T = 8  # slot buckets of the vectorized flat path
    # routing thresholds, as TpuEngine
    WINDOWED_MIN_L = 1024
    WINDOWED_MAX_RATIO = 4
    WINDOWED_MAX_L = 131072
    HOST_MERGE_MIN_L = 131072
    # dense-tier eligibility: df >= max(DENSE_MIN_DF_FLOOR,
    # n_docs // DENSE_ELIGIBLE_FRACTION), admitted by df within the budget
    DENSE_ELIGIBLE_FRACTION = 384
    DENSE_MIN_DF_FLOOR = 1024
    # all-dense conjunctions take the doc-space scan only when matches are
    # plentiful (candidate df above this, or expected matches >= 4k);
    # sparse ones go semidense, where the prune guard has no tail to flag
    SEMI_FROM_DENSE_MAX_CAND_L = 16384
    # the block-max pruned scan engages past this many 128-doc blocks and
    # examines PRUNED_DENSE_C blocks per query
    PRUNED_DENSE_MIN_NB = 2048
    PRUNED_DENSE_C = 512
    PRUNED_DENSE_B_BUCKETS = [8, 128, 512, 1024]
    DENSE_CHUNK = 128  # (B, N_pad) f32 planes: 512 MB at B=128, 1M docs
    # prune-guard misses re-run on the exact full scan (one batched call
    # per (T, M) per batch) instead of the host merge
    DENSE_RESCUE = True
    HOST_CACHE_CAP = 200_000
    # phrases (as TpuEngine): verify tensors are (B, PP, L) per term, so
    # candidate lists past PHRASE_MAX_L take the exact host phrase search
    # unless the full-scan mega route takes them
    PHRASE_MAX_L = 32768
    PHRASE_B_BUCKETS = [8, 32, 128, 1024, 4096]
    # the mega route engages where the pruned dense scan does (NB >=
    # max(PRUNED_DENSE_MIN_NB, PRUNED_PHRASE_C + 1)); C also caps KV
    PRUNED_PHRASE_C = 256
    # compaction width of the compact / semidense / mega routes, and the
    # mega rescue's: the (KV+1)-th candidate score bounds the rest
    PRUNED_PHRASE_KV = 1024
    PRUNED_PHRASE_RETRY_KV = 4096
    # the mega route scans every doc lane; False selects the block-pruned
    # mega phrase (the C highest-bound blocks), whose misses retry at
    # PRUNED_PHRASE_RETRY_C blocks and KV min(RETRY_KV, RETRY_C*128 - 1)
    FULL_PHRASE_SCAN = True
    PRUNED_PHRASE_RETRY_C = 1024
    PRUNED_PHRASE_MAX_PP = 128  # anchor bag bound of the mega route
    PHRASE_MAX_PW = 128  # every term's bag bound of the window verify
    POS_PAD = 1024  # trailing pad of the positions column (>= any PW)
    # bloom rows live on the device only for terms with df <= this (the
    # mega route has no bloom gate); a probe of a term above it is off
    BLOOM_DF_CEILING = 32768

    def __init__(self, packed: PackedIndex, *, device="cuda",
                 margin: int = DEFAULT_MARGIN,
                 single_term_depth: int = 64,
                 dense_budget_bytes: int = 7 << 29,
                 strict_parity: bool = False,
                 columns: str = "raw",
                 bloom_enable_factor: Optional[int] = 1,
                 dense_from: Optional[PackedIndex] = None,
                 host_packed: Optional[PackedIndex] = None,
                 doc_bodies: Optional[Sequence[str]] = None):
        """packed: the index whose posting runs go to the device.
        host_packed: the index the exact host fallback searches (a staged
        hot view passes the full index here). dense_from: the index the
        dense tier is built from (a staged hot view passes the full
        index, so head terms are served dense-only while their CSR runs
        are cold). bloom_enable_factor: the cost-aware bi-bloom side
        choice of 2-term phrases probes the rarer term's filter when the
        other is at least this many times as frequent; None disables the
        probes. columns: "raw" or "tc" (see the module docstring).
        doc_bodies: the document bodies by doc id (a list, or
        doc_store.LazyDocBodies), for snippets; None leaves them empty.
        device: "cuda" (default; raises without a card) or "cpu"."""
        if columns not in ("raw", "tc"):
            raise ValueError(f"unknown columns mode {columns!r}")
        self.device = resolve_device(device)
        self.columns = columns
        self.tc = columns == "tc"
        self.packed = packed
        self._host_packed = host_packed if host_packed is not None else packed
        self.doc_bodies = doc_bodies
        self.strict_parity = strict_parity
        self.bloom_enable_factor = bloom_enable_factor
        self.margin = margin
        # f32 slop bound of the device scores: one rounding per baked raw
        # score; the tc reconstruction's ~9 roundings per term plus the
        # T-term sum stay under 4.8e-6 at T = 8
        self.rel_eps = 1e-5 if self.tc else 1e-6
        self._lb = list(L_BUCKETS)
        self._tb = list(T_BUCKETS)
        if packed.n_postings >= 2**31 or len(packed.positions) >= 2**31:
            raise ValueError("index too large for int32 device addressing")

        self.similarity = Bm25Similarity(packed.avg_len)
        self.cache64 = self.similarity.cache  # (256,) f64
        scores64 = packed.partial_scores(self.cache64)
        self._h_doc, self._h_score, self._h_tf = padded_host_columns(
            packed, scores64, self._lb)
        self.d_postings_doc = self._to_dev(self._h_doc)
        self.d_postings_score = self.d_postings_tf = self.d_postings_tc = None
        if self.tc:
            self._h_score = self._h_tf = None
            self._h_tc = padded_tc_column(packed, self._lb)
            # int16 bits of the uint16 lanes (kernels._u16 widens them)
            self.d_postings_tc = self._to_dev(self._h_tc.view(np.int16))
            # a device tensor: CUDA divides by a CPU scalar through its
            # reciprocal, which the score's f32 op order does not allow
            self.d_avg32 = torch.tensor(np.float32(packed.avg_len),
                                        device=self.device)
        else:
            self.d_postings_score = self._to_dev(self._h_score)
            self.d_postings_tf = self._to_dev(self._h_tf)
        self._upload_phrase_columns()

        self._max_df = int(packed.df.max(initial=1))
        self._starts32 = packed.term_starts.astype(np.int32)
        self._df32 = packed.df.astype(np.int32)
        # csr-cold rows of a staged hot view keep their df on zero-length
        # runs; list routes must not read them
        self._csr_ok = np.diff(packed.term_starts) >= packed.df
        self._st_depth = single_term_depth
        if single_term_depth:
            self._tt_starts, self._tt_docs, self._tt_scores = \
                build_single_term_table(packed, scores64, single_term_depth)
        # memo over exact host executions: the index is immutable
        self._host_cache: Dict[tuple, tuple] = {}
        self.stats: Dict[str, float] = {}

        self._dense_H = 0
        self._dense_slot = np.full(packed.n_terms, -1, dtype=np.int32)
        self.dense_build_s = 0.0
        if dense_budget_bytes:
            t0 = time.perf_counter()
            self._build_dense_rows(
                dense_from if dense_from is not None else packed,
                dense_budget_bytes)
            self.dense_build_s = time.perf_counter() - t0

    # -- dense head-term rows ---------------------------------------------

    def _build_dense_rows(self, packed: PackedIndex, budget_bytes: int) -> None:
        """(N_pad,) rows for the head terms — f32 score and int32 tf rows
        (raw), or one uint8 tf row each plus a shared uint8 len-code row
        (tc) — and per-128-doc-block bound planes for the pruned scan,
        uploaded to the device, for the rows admit_dense_rows admits from
        the source index."""
        self._dense_slot = np.full(packed.n_terms, -1, dtype=np.int32)
        self._n_pad_docs = (packed.n_docs + 127) // 128 * 128
        NBLK = self._n_pad_docs // 128
        rows = admit_dense_rows(packed, budget_bytes, self.columns,
                                self.DENSE_MIN_DF_FLOOR,
                                self.DENSE_ELIGIBLE_FRACTION)
        if len(rows) == 0:
            return
        lens = np.diff(packed.term_starts)
        H = len(rows)
        if self.tc:
            self._build_dense_rows_tc(packed, rows, lens)
            return
        dense_sc = np.zeros((H, self._n_pad_docs), dtype=np.float32)
        dense_tf = np.zeros((H, self._n_pad_docs), dtype=np.int32)
        for slot, r in enumerate(rows.tolist()):
            s = int(packed.term_starts[r])
            m = min(int(packed.df[r]), int(lens[r]))
            docs = packed.postings_doc[s : s + m]
            # the partial score of the posting columns: f64, then f32
            tf_m = packed.postings_tf[s : s + m]
            tf64 = tf_m.astype(np.float64)
            code = packed.doc_len_code[docs.astype(np.int64)] & 0xFF
            sc64 = packed.idf64[r] * ((tf64 * 2.2) / (tf64 + self.cache64[code]))
            dense_sc[slot, docs] = sc64.astype(np.float32)
            dense_tf[slot, docs] = tf_m.astype(np.int32)
            self._dense_slot[r] = slot
        self._dense_H = H
        # block maxima of the very f32 values the kernels sum (an exact
        # bound), the second-largest value with multiplicity (max ties
        # keep bm2 == bm) and the argmax lane
        sc3 = dense_sc.reshape(H, NBLK, 128)
        top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
        blockmax = top2[:, :, 1].copy()
        blockmax2 = top2[:, :, 0].copy()
        del top2
        argpos = np.argmax(sc3, axis=2).astype(np.uint8)
        self.d_dense_sc = torch.from_numpy(dense_sc).to(self.device)
        self.d_dense_tf = torch.from_numpy(dense_tf).to(self.device)
        self.d_dense_blockmax = torch.from_numpy(blockmax).to(self.device)
        self.d_dense_blockmax2 = torch.from_numpy(blockmax2).to(self.device)
        self.d_dense_argpos = torch.from_numpy(argpos).to(self.device)

    # rows per chunk of the tc bound planes' f64 pass: ~2^24 lanes, so a
    # chunk's f64 temporaries stay ~1 GB at any doc count
    DENSE_UB_CHUNK_LANES = 1 << 24

    def _build_dense_rows_tc(self, packed: PackedIndex, rows: np.ndarray,
                             lens: np.ndarray) -> None:
        """The tc dense tier: the (H, N_pad) uint8 tf plane (tf capped at
        255) and the shared (N_pad,) uint8 len-code row (pad docs code 0,
        so their lanes stay 0), uploaded; then the block planes computed
        on the device from the composed lanes — the f64 bound of the
        in-kernel f32 score (host._tc_score64_ub, with the f32 idf of
        self.packed as the kernels use it), its block max, second max with
        multiplicity (topk(2)) and argmax lane (first maximum)."""
        H = len(rows)
        N_pad = self._n_pad_docs
        NBLK = N_pad // 128
        dense_tf8 = np.zeros((H, N_pad), dtype=np.uint8)
        for slot, r in enumerate(rows.tolist()):
            s = int(packed.term_starts[r])
            m = min(int(packed.df[r]), int(lens[r]))
            dense_tf8[slot, packed.postings_doc[s : s + m]] = np.minimum(
                packed.postings_tf[s : s + m], K.TF_SAT).astype(np.uint8)
            self._dense_slot[r] = slot
        len_code = np.zeros(N_pad, dtype=np.uint8)
        len_code[: packed.n_docs] = packed.doc_len_code[: packed.n_docs]
        self._dense_H = H
        self.d_dense_tf8 = self._to_dev(dense_tf8)
        self.d_len_code = self._to_dev(len_code)
        del dense_tf8

        dev = self.device
        idf64 = self._to_dev(
            self.packed.idf64[rows].astype(np.float32).astype(np.float64))
        avg64 = torch.tensor(float(np.float32(self.packed.avg_len)),
                             dtype=torch.float64, device=dev)
        code_hi = self.d_len_code.to(torch.int32) << 8
        bm = torch.empty((H, NBLK), dtype=torch.float32, device=dev)
        bm2 = torch.empty((H, NBLK), dtype=torch.float32, device=dev)
        ap = torch.empty((H, NBLK), dtype=torch.uint8, device=dev)
        step = max(1, self.DENSE_UB_CHUNK_LANES // N_pad)
        for h0 in range(0, H, step):
            h1 = min(h0 + step, H)
            tc = K._compose_tc(self.d_dense_tf8[h0:h1], code_hi[None, :])
            ub3 = _tc_score64_ub(tc, idf64[h0:h1, None], avg64).view(
                h1 - h0, NBLK, 128)
            top2 = torch.topk(ub3, 2, dim=2).values
            bm[h0:h1] = top2[:, :, 0]
            bm2[h0:h1] = top2[:, :, 1]
            ap[h0:h1] = torch.argmax(ub3, dim=2).to(torch.uint8)
        self.d_dense_blockmax = bm
        self.d_dense_blockmax2 = bm2
        self.d_dense_argpos = ap

    # -- phrase columns -----------------------------------------------------

    def _upload_phrase_columns(self) -> None:
        """Position bags (int32 pos_starts; positions as 2-byte int16 bits
        of uint16 when max position + MAX_T < 2^16 - 1, else int32) with a
        POS_PAD trailing pad, so a PW-wide verify window starting inside
        the data is never clamped (pad values 65535 / -1 never equal a
        target), and the sparse folded bloom columns."""
        packed = self.packed
        self.d_positions = self._to_dev(
            positions_column(packed.positions, self.MAX_T, self.POS_PAD))
        self.d_pos_starts = self._to_dev(packed.pos_starts.astype(np.int32))
        rows, bitmap, rank = self._build_bloom_sparse()
        self.d_bloom_rows = self._to_dev(rows.view(np.int32))
        self.d_bloom_bitmap = self._to_dev(bitmap.view(np.int32))
        self.d_bloom_rank = self._to_dev(rank)

    def _build_bloom_sparse(self):
        """Sparse folded bloom columns of this index (fold_bloom_columns),
        stored for the terms with df <= BLOOM_DF_CEILING. Returns (rows
        u32, bitmap u32, rank i32)."""
        pk = self.packed
        if pk.bloom_ends is None:
            return (np.zeros(1, dtype=np.uint32), np.zeros(2, dtype=np.uint32),
                    np.zeros(2, dtype=np.int32))
        lens = np.diff(pk.term_starts)
        return fold_bloom_columns(
            pk.bloom_ends, pk.bloom_begins,
            np.repeat(pk.df <= self.BLOOM_DF_CEILING, lens))

    # -- accounting -------------------------------------------------------

    def device_bytes(self) -> dict:
        """Device-resident index bytes per column family."""
        def nbytes(*ts):
            return int(sum(t.numel() * t.element_size() for t in ts))

        if self.tc:
            lanes = (self.d_postings_tc,)
            rows = (self.d_dense_tf8, self.d_len_code) if self._dense_H else ()
        else:
            lanes = (self.d_postings_score, self.d_postings_tf)
            rows = (self.d_dense_sc, self.d_dense_tf) if self._dense_H else ()
        out = {
            "postings": nbytes(self.d_postings_doc, *lanes),
            "positions": nbytes(self.d_positions, self.d_pos_starts),
            "dense_tier": nbytes(
                *rows, self.d_dense_blockmax, self.d_dense_blockmax2,
                self.d_dense_argpos)
            if self._dense_H else 0,
            "blooms": nbytes(self.d_bloom_rows, self.d_bloom_bitmap,
                             self.d_bloom_rank),
        }
        out["total"] = sum(out.values())
        return out

    def _bump(self, **deltas) -> None:
        for k, v in deltas.items():
            self.stats[k] = self.stats.get(k, 0) + v

    def stats_take(self) -> Dict[str, float]:
        """Return and reset the counters. route_* count queries by route;
        <route>_s is the host time of that route's dispatches and
        finalizers (device waits, the re-rank and host fallbacks of its
        rows included); rescue_s is the batched full-scan rescue."""
        out, self.stats = self.stats, {}
        return out

    def clear_result_memos(self) -> None:
        self._host_cache.clear()

    def fill_snippets(self, res: SearchResult, rows, q: SearchQuery) -> None:
        """Snippets of res's entries; posting bags come from the full index
        (a staged hot view holds offset bags only for csr-hot terms)."""
        for e in res.entries:
            e.snippet = snippet_for(self._host_packed, self.doc_bodies, rows,
                                    q, e.doc_id)

    def _host_exact(self, rows, k: int, is_phrase: bool = False):
        """Memoized exact host search."""
        key = (tuple(rows), int(k), bool(is_phrase))
        hit = self._host_cache.get(key)
        if hit is None:
            if len(self._host_cache) >= self.HOST_CACHE_CAP:
                self._host_cache.clear()
            t0 = time.perf_counter()
            hit = host_exact_search(self._host_packed, self.cache64, rows, k,
                                    is_phrase=is_phrase)
            self._bump(host_exact_calls=1,
                       host_exact_s=time.perf_counter() - t0)
            self._host_cache[key] = hit
        else:
            self._bump(host_exact_hits=1)
        return hit

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """One device-to-host copy; the wait covers device compute still
        in flight + the copy."""
        t0 = time.perf_counter()
        arr = out.cpu().numpy()
        self._bump(fetch_wait_s=time.perf_counter() - t0)
        return arr

    # -- batch API --------------------------------------------------------

    def search(self, query: SearchQuery) -> SearchResult:
        return self.search_batch([query])[0]

    def search_batch(self, queries: List[SearchQuery]) -> List[SearchResult]:
        results, pending = self.submit_batch(queries)
        self.run_pending(results, pending)
        return results

    @staticmethod
    def run_pending(results, pending) -> None:
        """Run the finalizers; those marked .barrier (they read other
        queries' results or a queue the others fill) run last, in the
        order they were appended."""
        for f in pending:
            if not getattr(f, "barrier", False):
                f(results)
        for f in pending:
            if getattr(f, "barrier", False):
                f(results)

    def _serve_single_term(self, qi: int, row: int, q: SearchQuery,
                           results: List[SearchResult]) -> bool:
        """Answer a single-term query from the impact table; False when it
        needs more depth than the table holds."""
        k = q.n_results
        s, e = int(self._tt_starts[row]), int(self._tt_starts[row + 1])
        cnt = e - s
        if k > cnt and int(self.packed.df[row]) > cnt:
            return False
        take = min(k, cnt)
        results[qi].set_arrays(self._tt_docs[s : s + take],
                               self._tt_scores[s : s + take])
        return True

    def submit_batch(self, queries: List[SearchQuery]):
        """Dispatch a batch: device work is queued on the card's stream
        and the host returns (results, finalizers); each finalizer copies
        its group's packed output back and fills the results."""
        results = [SearchResult() for _ in queries]
        lookup = self.packed.term_to_row.get
        flat_qi: List[int] = []
        flat_rows: List[List[int]] = []
        phrase: List[_PlannedQuery] = []
        long_tail: List[_PlannedQuery] = []
        # request coalescing: identical (rows, k, phrase, snippets)
        # queries run once
        dedup: Dict[tuple, int] = {}
        dups: List[tuple] = []
        snips: List[tuple] = []  # (qi, rows, query) of primaries to snippet
        n_single = 0
        for qi, q in enumerate(queries):
            terms = q.terms
            if q.n_results <= 0 or not terms:
                continue
            rows = [lookup(t, -1) for t in terms]
            if min(rows) < 0:
                continue  # missing term -> empty result
            key = (tuple(rows), q.n_results, q.is_phrase, q.return_snippets,
                   q.n_snippet_passages)
            prim = dedup.get(key)
            if prim is not None:
                dups.append((qi, prim))
                continue
            dedup[key] = qi
            if q.return_snippets and self.doc_bodies is not None:
                snips.append((qi, rows, q))
            if (len(rows) == 1 and self._st_depth
                    and self._serve_single_term(qi, rows[0], q, results)):
                n_single += 1
                continue
            if q.is_phrase and len(rows) >= 2:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                phrase.append(pq)
            elif len(rows) > self.MAX_T:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                long_tail.append(pq)
            else:
                flat_qi.append(qi)
                flat_rows.append(rows)
        self._bump(q_coalesced=len(dups), route_single_table=n_single)

        # prune-guard misses of every dense and mega-phrase group collect
        # here and re-run as one batched call per shape in a barrier
        # finalizer
        rq: List[dict] = []
        pending = self._submit_flat_vec(flat_qi, flat_rows, queries, rq)
        pending += self._submit_flat(long_tail)
        pending += self._submit_phrase(phrase, rq)

        def drain_rescues(res_list, rq=rq):
            self._drain_rescues(rq)

        drain_rescues.barrier = True  # after every plain finalizer
        pending.append(drain_rescues)
        if snips:
            def fill_snippets(res_list, snips=snips):
                for qi, rows, q in snips:
                    self.fill_snippets(res_list[qi], rows, q)

            # every route's answer is final once the rescue has run
            fill_snippets.barrier = True
            pending.append(fill_snippets)
        if dups:
            def copy_dups(res_list, dups=dups):
                for dqi, pqi in dups:
                    src, dst = res_list[pqi], res_list[dqi]
                    if src._docs is not None:
                        dst.set_arrays(src._docs, src._scores)
                    dst._entries = list(src._entries)

            # reads primaries' results, rescued and snippeted ones
            # included: appended after those barriers, so it runs last
            copy_dups.barrier = True
            pending.append(copy_dups)
        return results, pending

    def _submit_flat_vec(self, flat_qi, flat_rows, queries, rq):
        """Vectorized planning + assembly for <= MAX_T-term queries."""
        N = len(flat_qi)
        if N == 0:
            return []
        MT = self.MAX_T
        qi_arr = np.asarray(flat_qi, dtype=np.int64)
        n_terms = np.fromiter((len(r) for r in flat_rows), dtype=np.int32, count=N)
        rows_pad = np.zeros((N, MT), dtype=np.int32)
        for i, r in enumerate(flat_rows):
            rows_pad[i, : len(r)] = r
        ks = np.fromiter((queries[qi].n_results for qi in flat_qi),
                         dtype=np.int32, count=N)

        slot_idx = np.arange(MT, dtype=np.int32)[None, :]
        valid = slot_idx < n_terms[:, None]  # (N, MT)
        dfs = self._df32[rows_pad]
        dfs_m = np.where(valid, dfs, np.int32(2**31 - 1))
        cand = np.argmin(dfs_m, axis=1).astype(np.int32)
        cand_df = np.take_along_axis(dfs_m, cand[:, None], 1)[:, 0]
        csr_bad = ~self._csr_ok[rows_pad] & valid  # (N, MT)
        any_missing = csr_bad.any(axis=1)

        lb = np.asarray(self._lb, dtype=np.int64)
        L_idx = np.minimum(np.searchsorted(lb, cand_df), len(lb) - 1)
        l2 = np.max(np.where(valid, dfs, 0), axis=1)
        L2_idx = np.minimum(np.searchsorted(lb, l2), len(lb) - 1)
        L2val = lb[L2_idx]
        Lval = lb[L_idx]
        windowed = ((n_terms > 1) & (Lval >= self.WINDOWED_MIN_L)
                    & (Lval <= self.WINDOWED_MAX_L)
                    & (L2val // Lval <= self.WINDOWED_MAX_RATIO))
        tb = np.asarray(self._tb, dtype=np.int64)
        T_idx = np.minimum(np.searchsorted(tb, n_terms), len(tb) - 1)

        def keep_only(keep):
            nonlocal qi_arr, n_terms, rows_pad, ks, valid, dfs, cand, \
                cand_df, csr_bad, any_missing, Lval, windowed, T_idx, \
                L_idx, L2_idx, flat_rows
            (qi_arr, n_terms, rows_pad, ks, valid, dfs, cand, cand_df,
             csr_bad, any_missing, Lval, windowed, T_idx, L_idx, L2_idx) = (
                a[keep] for a in (
                    qi_arr, n_terms, rows_pad, ks, valid, dfs, cand,
                    cand_df, csr_bad, any_missing, Lval, windowed, T_idx,
                    L_idx, L2_idx))
            flat_rows = [flat_rows[i] for i in np.nonzero(keep)[0]]

        pending = []
        if self._dense_H:
            # all-head conjunctions -> the doc-space (pruned) dense scan,
            # unless sparse (expected matches under independence
            # N * prod(df_i / N) < 4k) with a small candidate list: those
            # take semidense, exact with no prune-guard tail. Csr-missing
            # all-dense queries stay dense (semidense needs the candidate
            # term's run).
            slot_dense = self._dense_slot[rows_pad] >= 0
            all_dense = np.all(slot_dense | ~valid, axis=1) & (n_terms > 1)
            with np.errstate(divide="ignore"):
                log_df = np.where(valid, np.log(np.maximum(dfs, 1)), 0.0)
            logN = np.log(max(self.packed.n_docs, 1))
            exp_matches = np.exp(log_df.sum(axis=1) - (n_terms - 1) * logN)
            all_dense &= ((cand_df.astype(np.int64)
                           > self.SEMI_FROM_DENSE_MAX_CAND_L)
                          | (exp_matches >= 4.0 * ks)
                          | any_missing)
            if all_dense.any():
                pending += self._submit_dense(
                    np.nonzero(all_dense)[0], qi_arr, flat_rows, n_terms,
                    ks, rq)
                if all_dense.all():
                    return pending
                keep_only(~all_dense)

        # candidate lists past the largest L bucket would be scanned only
        # in part: exact host path, single terms included
        saturated = cand_df.astype(np.int64) > int(lb[-1])
        semi = np.zeros(len(qi_arr), dtype=bool)
        if self._dense_H:
            # tail candidate x (dense + short-bs) others: any dense other
            # qualifies. The candidate's run seeds the lanes and non-dense
            # others are searched in their runs, so every non-dense term
            # needs its CSR run.
            slot_dense = self._dense_slot[rows_pad] >= 0
            any_dense_other = np.any(
                slot_dense & valid & (slot_idx != cand[:, None]), axis=1)
            cand_ok = np.take_along_axis(
                self._csr_ok[rows_pad], cand[:, None].astype(np.int64), 1)[:, 0]
            semi = ((n_terms > 1) & any_dense_other & ~saturated & cand_ok
                    & np.all(slot_dense | ~csr_bad, axis=1))
            if semi.any():
                pending += self._submit_semidense(
                    np.nonzero(semi)[0], qi_arr, flat_rows, rows_pad,
                    n_terms, cand, ks, Lval)
        host_merge = (((n_terms > 1) & (Lval >= self.HOST_MERGE_MIN_L)
                       & ~windowed & ~semi) | saturated
                      | (any_missing & ~semi))  # bs/single need every run
        bs = ~host_merge & ~semi
        self._bump(route_host_merge=int(host_merge.sum()),
                   route_windowed=int((windowed & bs).sum()),
                   route_bs=int((~windowed & bs).sum()))
        if host_merge.any():
            hm = np.nonzero(host_merge)[0]

            def run_host_merge(res_list, hm=hm, qi_arr=qi_arr,
                               flat_rows=flat_rows, ks=ks):
                for i in hm:
                    d, s = self._host_exact(flat_rows[i], int(ks[i]))
                    res_list[int(qi_arr[i])].set_arrays(d, s)

            pending.append(run_host_merge)
        if not bs.any():
            return pending
        keep_only(bs)

        # windowed groups carry their longest list's bucket: L2 sizes G
        key = (T_idx.astype(np.int64) * 1000 + L_idx * 10
               + np.where(windowed, L2_idx + 1, 0))
        uniq_keys, inverse = np.unique(key, return_inverse=True)

        # slot order: candidate first, remaining real terms in query order,
        # padding last (stable argsort of a rank key)
        rank = np.where(slot_idx == cand[:, None], np.int32(-1),
                        np.where(valid, slot_idx, np.int32(MT + 1)))
        order = np.argsort(rank, axis=1, kind="stable")  # (N, MT)
        slot_rows_all = np.take_along_axis(rows_pad, order, 1)
        slot_rows_all = np.where(slot_idx < n_terms[:, None], slot_rows_all,
                                 slot_rows_all[:, :1])
        slot_of_all = np.argsort(order, axis=1, kind="stable")  # query t -> slot
        idf64_all = self.packed.idf64[rows_pad] * valid  # query-term order

        for gi, gkey in enumerate(uniq_keys):
            members_all = np.nonzero(inverse == gi)[0]
            T = int(tb[gkey // 1000])
            L = int(lb[(gkey % 1000) // 10])
            L2 = int(lb[gkey % 10 - 1]) if gkey % 10 else 0
            chunk = windowed_chunk(T, L, L2) if L2 else bs_chunk(T, L)
            for ci in range(0, len(members_all), chunk):
                m = members_all[ci : ci + chunk]
                B = _bucket(len(m), B_BUCKETS)
                slot_rows = np.zeros((B, T), dtype=np.int32)
                slot_rows[: len(m)] = slot_rows_all[m, :T]
                starts = self._starts32[slot_rows]
                ends = starts + self._df32[slot_rows]
                starts[len(m):] = 0
                ends[len(m):] = 0
                use_score = np.zeros((B, T), dtype=np.float32)
                use_score[: len(m)] = (
                    np.arange(T)[None, :] < n_terms[m, None]).astype(np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                idf64_q[: len(m)] = idf64_all[m, :T]
                slot_of = np.zeros((B, T), dtype=np.int64)
                slot_of[: len(m)] = slot_of_all[m, :T]
                ks_g = np.zeros(B, dtype=np.int32)
                ks_g[: len(m)] = ks[m]
                pending.append(self._dispatch_flat(
                    T, L, starts, ends, self._weights(slot_rows, use_score),
                    idf64_q, slot_of, ks_g, qi_arr[m], flat_rows, m, L2=L2))
        return pending

    def _weights(self, rows: np.ndarray, use: np.ndarray) -> np.ndarray:
        """The kernels' per-slot weights of term rows (B, T): use_score
        itself on raw columns; on tc columns the f32 idfs, 0 where use is
        0 (padded slots)."""
        if not self.tc:
            return use
        return (self.packed.idf64[rows] * use).astype(np.float32)

    # kernel family -> the column arguments of its kernels, (raw, tc), by
    # attribute name: the list kernels take them after the doc column, the
    # dense, pruned and full-scan kernels first
    _COLS = {
        "list": (("d_postings_score", "d_postings_tf"),
                 ("d_postings_tc", "d_avg32")),
        "dense": (("d_dense_sc", "d_dense_tf"),
                  ("d_dense_tf8", "d_len_code", "d_avg32")),
        "semidense": (("d_dense_sc", "d_dense_tf"), ("d_dense_tf8",)),
        "semidense_phrase": (("d_dense_sc",), ("d_dense_tf8",)),
    }

    def _cols(self, family: str) -> tuple:
        return tuple(getattr(self, a) for a in self._COLS[family][self.tc])

    def _make(self, name: str, *cfg):
        """K.<name>(*cfg) on this engine's columns: its `_tc` twin on tc
        columns where the kernels have one, else `name` with mode= (the
        reference's two conventions). Looked up per call."""
        twin = getattr(K, name + "_tc", None)
        if twin is None:
            return getattr(K, name)(*cfg, mode=self.columns)
        return twin(*cfg) if self.tc else getattr(K, name)(*cfg)

    def _finalizer(self, route: str, out: torch.Tensor, T: int, slot_of,
                   idf64_q, ks, qis, flat_rows, members, on_flags=None,
                   is_phrase: bool = False):
        """The finalizer of one device group: fetch the packed output,
        derive the host-fallback mask, re-rank. on_flags(packed,
        res_list), if given, may take rows out of this finalize (the
        prune-miss rescue) and returns the rows to finalize here."""

        def finalize(res_list):
            t0 = time.perf_counter()
            n = len(qis)
            packed = self._fetch(out)[:n]
            flags = packed[:, T + 1, 0]
            force = self._flags_to_force(flags)
            rows = np.arange(n)
            if on_flags is not None:
                rows = on_flags(packed, res_list)
            if len(rows):
                self._finalize_arrays(
                    packed[rows, 0, :], packed[rows, 1 : T + 1, :],
                    flags[rows], slot_of[rows], idf64_q[rows], ks[rows],
                    qis[rows], flat_rows, members[rows], res_list,
                    force_host=force[rows], is_phrase=is_phrase)
            self._bump(**{f"{route}_s": time.perf_counter() - t0})

        return finalize

    def _dispatch_flat(self, T, L, starts, ends, weights, idf64_q,
                       slot_of, ks, qis, flat_rows, members, L2: int = 0):
        """One bs group, or with L2 (its longest list's bucket) one
        windowed group."""
        M = min(L, int(ks.max(initial=1)) + self.margin)
        if L2:
            route = "windowed"
            kern = self._make("make_windowed_search_kernel", T, L, L2 // 128,
                              M)
        else:
            route = "bs"
            kern = self._make("make_search_kernel", T, L, M,
                              K.n_iters_for(self._max_df))
        t0 = time.perf_counter()
        out = kern(self.d_postings_doc, *self._cols("list"),
                   self._to_dev(starts), self._to_dev(ends),
                   self._to_dev(weights))
        # host time to enqueue the group (it blocks when the card's launch
        # queue is full, so device-bound batches show up here too)
        dt = time.perf_counter() - t0
        self._bump(**{"dispatch_s": dt, f"{route}_s": dt})
        return self._finalizer(route, out, T, slot_of, idf64_q, ks,
                               np.asarray(qis), flat_rows,
                               np.asarray(members))

    # -- the dense head-term tier -------------------------------------------

    def _submit_dense(self, dm, qi_arr, flat_rows, n_terms, ks, rq):
        """All-head conjunctions: the block-max pruned scan past
        PRUNED_DENSE_MIN_NB doc blocks (prune-guard misses deferred to
        the batch's rescue queue), else the full doc-space scan."""
        pending = []
        NB = self._n_pad_docs // 128
        C = self.PRUNED_DENSE_C
        pruned = NB >= max(self.PRUNED_DENSE_MIN_NB, C + 1)
        route = "pruned" if pruned else "dense"
        self._bump(**{f"route_{route}": len(dm)})
        groups: Dict[int, list] = {}
        for i in dm:
            groups.setdefault(_bucket(int(n_terms[i]), self._tb), []).append(int(i))
        eps3 = 3.0 * self.rel_eps
        for T, members in groups.items():
            if pruned:
                buckets = self.PRUNED_DENSE_B_BUCKETS
                chunk = _chunk_within(PRUNED_LANE_BUDGET, T * C * 128, buckets)
            else:
                buckets = [8, self.DENSE_CHUNK]
                chunk = self.DENSE_CHUNK
            for ci in range(0, len(members), chunk):
                m = np.asarray(members[ci : ci + chunk], dtype=np.int64)
                n = len(m)
                B = _bucket(n, buckets)
                trows = np.zeros((B, T), dtype=np.int64)
                use = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                for bi, i in enumerate(m):
                    rows = flat_rows[i]
                    # query-term order; padded slots repeat the first term
                    trows[bi] = rows + [rows[0]] * (T - len(rows))
                    use[bi, : len(rows)] = 1.0
                    idf64_q[bi, : len(rows)] = self.packed.idf64[rows]
                slots = np.zeros((B, T), dtype=np.int32)  # padding rows: 0
                slots[:n] = self._dense_slot[trows[:n]]
                w = self._weights(trows, use)
                slot_of = np.tile(np.arange(T, dtype=np.int64), (B, 1))
                ks_g = np.zeros(B, dtype=np.int32)
                ks_g[:n] = ks[m]
                M = min(int(ks_g.max(initial=1)) + self.margin,
                        self._n_pad_docs)
                t0 = time.perf_counter()
                if pruned:
                    out = self._make("make_pruned_dense_kernel",
                                     T, NB, C, M, eps3)(
                        *self._cols("dense"), self.d_dense_blockmax,
                        self.d_dense_blockmax2, self.d_dense_argpos,
                        self._to_dev(slots), self._to_dev(w),
                        self._to_dev(ks_g))
                else:
                    out = self._dense_scan(T, M, slots, w)
                dt = time.perf_counter() - t0
                self._bump(**{"dispatch_s": dt, f"{route}_s": dt})
                qis = qi_arr[m]
                on_flags = None
                if pruned and self.DENSE_RESCUE:
                    on_flags = self._defer_prune_misses(
                        rq, ("dense", T, M), T, flat_rows, dict(
                            slots=slots, w=w, slot_of=slot_of,
                            idf64_q=idf64_q, ks=ks_g, qis=qis, members=m))
                pending.append(self._finalizer(
                    route, out, T, slot_of, idf64_q, ks_g, qis, flat_rows,
                    m, on_flags=on_flags))
        return pending

    @staticmethod
    def _defer_prune_misses(rq, key: tuple, T: int, flat_rows, per_row: dict):
        """on_flags hook of a pruned dense or mega-phrase group: queue its
        FLAG_PRUNE_MISS rows for the batch's rescue (key: ("dense", T, M)
        or ("phrase", T, PP, PW, M); per_row: the group's per-row arrays,
        the rescue's inputs and the finalize metadata) and finalize the
        rest now."""

        def on_flags(packed, res_list):
            miss = (packed[:, T + 1, 0] & K.FLAG_PRUNE_MISS) != 0
            if miss.any():
                sub = np.nonzero(miss)[0]
                rq.append(dict(key=key, flat_rows=flat_rows,
                               res_list=res_list,
                               **{k: v[sub] for k, v in per_row.items()}))
            return np.nonzero(~miss)[0]

        return on_flags

    def _dense_scan(self, T: int, M: int, slots: np.ndarray,
                    w: np.ndarray) -> torch.Tensor:
        """The full doc-space dense scan of one group (slots, weights
        (B, T))."""
        return self._make("make_dense_search_kernel", T, self._n_pad_docs, M)(
            *self._cols("dense"), self._to_dev(slots), self._to_dev(w))

    def _dense_full_rescue(self, T: int, M: int, slots: np.ndarray,
                           w: np.ndarray) -> np.ndarray:
        """The exact full-scan dense kernel over prune-guard-flagged rows,
        chunked so B * N_pad <= RESCUE_LANE_BUDGET. Returns packed
        (n, T+2, M) rows in the pruned kernel's layout; no prune bit can
        recur (every block is examined)."""
        n = len(slots)
        t0 = time.perf_counter()
        fit = RESCUE_LANE_BUDGET // max(self._n_pad_docs, 1)
        buckets = [b for b in [8, self.DENSE_CHUNK] if b <= max(fit, 8)]
        chunk = buckets[-1]
        outs = []
        for ci in range(0, n, chunk):
            cn = min(chunk, n - ci)
            B = _bucket(cn, buckets)
            s_p = np.zeros((B, T), dtype=np.int32)
            s_p[:cn] = slots[ci : ci + cn]
            w_p = np.zeros((B, T), dtype=np.float32)
            w_p[:cn] = w[ci : ci + cn]
            outs.append((ci, cn, self._dense_scan(T, M, s_p, w_p)))
        out = np.empty((n, T + 2, M), dtype=np.int32)
        for ci, cn, o in outs:
            out[ci : ci + cn] = self._fetch(o)[:cn]
        self._bump(prune_rescued=n, rescue_s=time.perf_counter() - t0)
        return out

    def _drain_rescues(self, rq: List[dict]) -> None:
        """Barrier finalizer: the prune-guard misses deferred by every
        group of the batch re-run together, then finalize (rows the rescue
        still flags take the exact host path): dense rows as one full-scan
        call per (T, M), mega-phrase rows as one retry at
        PRUNED_PHRASE_RETRY_KV per (T, PP, PW, M)."""
        ctxs, rq[:] = list(rq), []
        groups: Dict[tuple, List[dict]] = {}
        for c in ctxs:
            groups.setdefault(c["key"], []).append(c)
        for key, cs in groups.items():
            def cat(name, cs=cs):
                return np.concatenate([c[name] for c in cs])

            T = key[1]
            if key[0] == "dense":
                rescued = self._dense_full_rescue(T, key[2], cat("slots"),
                                                  cat("w"))
            else:
                _, T, PP, PW, M = key
                rescued = self._phrase_rescue(
                    T, PP, PW, M, cat("starts"), cat("ends"), cat("slots"),
                    cat("w"), cat("anchor"), cat("ks"))
            off = 0
            for c in cs:
                sub = rescued[off : off + len(c["qis"])]
                off += len(c["qis"])
                flags = sub[:, T + 1, 0]
                self._finalize_arrays(
                    sub[:, 0, :], sub[:, 1 : T + 1, :], flags, c["slot_of"],
                    c["idf64_q"], c["ks"], c["qis"], c["flat_rows"],
                    c["members"], c["res_list"],
                    force_host=self._flags_to_force(flags, rescue=True),
                    is_phrase=key[0] == "phrase")

    def _submit_semidense(self, sm, qi_arr, flat_rows, rows_pad, n_terms,
                          cand, ks, Lval):
        """Tail candidate x (dense + short-bs) others. Slot layout: 0 =
        candidate, 1..n_bs = non-dense others (binary search over their
        runs), then the dense others; padded slots repeat the first dense
        slot with use 0. Layout and group split are vectorized (stable
        argsort of a per-(query, term) class rank)."""
        pending = []
        self._bump(route_semidense=len(sm))
        MT = rows_pad.shape[1]
        rp = rows_pad[sm]  # (S, MT) term rows
        nt = n_terms[sm]
        cs = cand[sm]
        col = np.arange(MT, dtype=np.int64)[None, :]
        v = col < nt[:, None]
        ds = self._dense_slot[rp]  # dense slot or -1
        is_cand = col == cs[:, None]
        is_bs = v & ~is_cand & (ds < 0)
        nbs = is_bs.sum(axis=1).astype(np.int64)
        # slot order: candidate, bs others (query order), dense others
        # (query order), padding
        rank = np.where(is_cand, np.int32(-1),
                        np.where(is_bs, np.int32(0),
                                 np.where(v, np.int32(1), np.int32(2))))
        order = np.argsort(rank, axis=1, kind="stable")  # (S, MT)
        slot_of_s = np.argsort(order, axis=1, kind="stable")
        sr = np.take_along_axis(rp, order, 1)  # slot-order rows
        ds_s = np.take_along_axis(ds, order, 1)
        idf64_q_s = self.packed.idf64[rp] * v  # query order
        tb = np.asarray(self._tb, dtype=np.int64)
        T_of = tb[np.searchsorted(tb, nt)]
        dfb = np.where(is_bs, self.packed.df[rp], 0).max(axis=1)

        gkey = (T_of * (MT + 1) + nbs) * np.int64(1 << 40) \
            + Lval[sm].astype(np.int64)
        uniq_keys, inverse = np.unique(gkey, return_inverse=True)
        for gi in range(len(uniq_keys)):
            sel = np.nonzero(inverse == gi)[0]
            T = int(T_of[sel[0]])
            L = int(Lval[sm[sel[0]]])
            NBs = int(nbs[sel[0]])
            # bs depth quantized to an L bucket so shapes stay few
            n_it = K.n_iters_for(_bucket(max(int(dfb[sel].max()), 1),
                                         self._lb)) if NBs else 0
            chunk = _chunk_within(SEMIDENSE_LANE_BUDGET, (T - 1) * L,
                                  B_BUCKETS)
            first_dense = 1 + NBs
            slotcol = np.arange(T, dtype=np.int64)[None, :]
            for ci in range(0, len(sel), chunk):
                gsel = sel[ci : ci + chunk]
                m = sm[gsel]
                n = len(gsel)
                B = _bucket(n, B_BUCKETS)
                live = slotcol < nt[gsel][:, None]  # (n, T) slot live
                srt = sr[gsel, :T]
                csbs = slotcol < first_dense  # candidate + bs slots
                starts = np.zeros((B, T), dtype=np.int32)
                ends = np.zeros((B, T), dtype=np.int32)
                st = np.where(csbs, self._starts32[srt], 0)
                starts[:n] = st
                ends[:n] = st + np.where(csbs, self._df32[srt], 0)
                slots = np.zeros((B, T), dtype=np.int32)
                sl = np.where(live & ~csbs, ds_s[gsel, :T], 0)
                # padded slots repeat the first dense slot (use 0)
                sl = np.where(live | csbs, sl,
                              sl[:, first_dense : first_dense + 1])
                slots[:n] = sl
                w = np.zeros((B, T), dtype=np.float32)
                w[:n] = self._weights(srt, live.astype(np.float32))
                idf64_q = np.zeros((B, T), dtype=np.float64)
                idf64_q[:n] = idf64_q_s[gsel, :T]
                slot_of = np.zeros((B, T), dtype=np.int64)
                slot_of[:n] = np.where(v[gsel], slot_of_s[gsel], 0)[:, :T]
                ks_g = np.zeros(B, dtype=np.int32)
                ks_g[:n] = ks[m]
                M = min(L, int(ks_g.max(initial=1)) + self.margin)
                t0 = time.perf_counter()
                out = self._make("make_semidense_kernel", T, L, M,
                                 self._n_pad_docs, NBs, n_it)(
                    self.d_postings_doc, *self._cols("list"),
                    *self._cols("semidense"), self._to_dev(starts),
                    self._to_dev(ends), self._to_dev(w), self._to_dev(slots))
                dt = time.perf_counter() - t0
                self._bump(dispatch_s=dt, semidense_s=dt)
                pending.append(self._finalizer(
                    "semidense", out, T, slot_of, idf64_q, ks_g, qi_arr[m],
                    flat_rows, m))
        return pending

    # -- phrases -------------------------------------------------------------

    def _assemble_bloom_probes(self, group: List[_PlannedQuery], T: int,
                               B: int):
        """Folded probes of the sparse bloom gate (C = T-1 per query): a
        2-term phrase probes one side by cost (query_processing.h:
        796-807: the rarer term's filter, if the other is at least
        bloom_enable_factor times as frequent), 3+ terms chain term c's
        following-word filter for term c+1 (:784-794). A probe is active
        only if its term has device rows (df <= BLOOM_DF_CEILING);
        inactive probes pass. Returns (probe_slot i32, probe_begins bool,
        probe_mask u32, probe_active bool), each (B, C)."""
        cfg = self.packed.bloom_cfg
        C = max(1, T - 1)
        probe_slot = np.zeros((B, C), dtype=np.int32)
        probe_begins = np.zeros((B, C), dtype=bool)
        probe_mask = np.zeros((B, C), dtype=np.uint32)
        probe_active = np.zeros((B, C), dtype=bool)
        factor = self.bloom_enable_factor
        ceil = self.BLOOM_DF_CEILING
        if self.packed.bloom_ends is None or factor is None:
            return probe_slot, probe_begins, probe_mask, probe_active
        for i, pq in enumerate(group):
            terms, rows, slot = pq.query.terms, pq.rows, pq.slot_of_term
            dfs = [int(self.packed.df[r]) for r in rows]
            if len(rows) == 2:
                s1, s2 = dfs
                if factor * s1 <= s2 and s1 <= ceil:
                    probe_slot[i, 0], probe_begins[i, 0] = slot[0], False
                    probe_mask[i, 0] = cfg.probe_mask_folded(terms[1])
                    probe_active[i, 0] = True
                elif factor * s2 < s1 and s2 <= ceil:
                    probe_slot[i, 0], probe_begins[i, 0] = slot[1], True
                    probe_mask[i, 0] = cfg.probe_mask_folded(terms[0])
                    probe_active[i, 0] = True
            else:
                for c in range(len(rows) - 1):
                    if dfs[c] > ceil:
                        continue
                    probe_slot[i, c], probe_begins[i, c] = slot[c], False
                    probe_mask[i, c] = cfg.probe_mask_folded(terms[c + 1])
                    probe_active[i, c] = True
        return probe_slot, probe_begins, probe_mask, probe_active

    def _run_host_phrases(self, group: List[_PlannedQuery]):
        """Finalizer answering phrase queries with the memoized exact host
        phrase search."""

        def run(res_list):
            t0 = time.perf_counter()
            for pq in group:
                d, s = self._host_exact(pq.rows, pq.query.n_results, True)
                res_list[pq.qi].set_arrays(d, s)
            self._bump(phrase_host_s=time.perf_counter() - t0)

        return run

    def _submit_phrase(self, planned: List[_PlannedQuery], rq):
        """Route phrase queries (see the module docstring) as
        TpuEngine._submit_phrase does at its defaults."""
        if not planned:
            return []
        pending = []
        df, max_tf, lb = self.packed.df, self.packed.max_tf, self._lb
        if self._dense_H:
            NB = self._n_pad_docs // 128
            if NB >= max(self.PRUNED_DENSE_MIN_NB, self.PRUNED_PHRASE_C + 1):
                mega, rest = [], []
                for pq in planned:
                    tfs = [int(max_tf[r]) for r in pq.rows]
                    ok = (int(df[pq.slot_rows[0]]) > self.PHRASE_MAX_L
                          and all(self._dense_slot[r] >= 0 for r in pq.rows)
                          # recovery + verify read the CSR runs
                          and all(self._csr_ok[r] for r in pq.rows)
                          and min(tfs) <= self.PRUNED_PHRASE_MAX_PP
                          and max(tfs) <= self.PHRASE_MAX_PW)
                    (mega if ok else rest).append(pq)
                if mega:
                    pending += self._submit_mega_phrase(mega, rq)
                planned = rest
        # exact host: saturated candidates or csr-cold terms; (L, PP) keys
        # whose verify tensor exceeds the lane budget at the smallest B;
        # window routes (L > KV) with a bag over PHRASE_MAX_PW
        KV = self.PRUNED_PHRASE_KV
        max_l = min(self.PHRASE_MAX_L, lb[-1])
        host, keep = [], []
        for pq in planned:
            cand = int(df[pq.slot_rows[0]])
            L = _bucket(cand, lb)
            if (cand > max_l or not all(self._csr_ok[r] for r in pq.rows)
                    or L * _bucket(int(max_tf[pq.rows[0]]), PP_BUCKETS)
                    > PHRASE_LANE_BUDGET // self.PHRASE_B_BUCKETS[0]
                    or (L > KV and max(int(max_tf[r]) for r in pq.rows)
                        > self.PHRASE_MAX_PW)):
                host.append(pq)
            else:
                keep.append(pq)
        self._bump(route_phrase_host=len(host))
        if host:
            pending.append(self._run_host_phrases(host))

        def key_of(pq):
            L = _bucket(int(df[pq.slot_rows[0]]), lb)
            return (len(pq.rows), L,
                    _bucket(int(max_tf[pq.rows[0]]), PP_BUCKETS),
                    _bucket(max(int(max_tf[r]) for r in pq.rows), PP_BUCKETS),
                    L > KV and all(self._dense_slot[r] >= 0
                                   for r in pq.slot_rows[1:]))

        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in keep:
            groups.setdefault(key_of(pq), []).append(pq)
        for (T, L, PP, PW, sd), members in groups.items():
            # compact / semidense: ~10 L-wide planes and (KV, PP, PW)
            # verify compares per query; list chain: (PP, L) per query
            lanes = (max(10 * L, T * KV * PW, KV * PP * PW // 4) if L > KV
                     else L * max(PP, 1))
            chunk = _chunk_within(PHRASE_LANE_BUDGET, lanes,
                                  self.PHRASE_B_BUCKETS)
            for ci in range(0, len(members), chunk):
                pending.append(self._dispatch_phrase(
                    members[ci : ci + chunk], T, L, PP, PW, sd))
        return pending

    def _dispatch_phrase(self, group: List[_PlannedQuery], T: int, L: int,
                         PP: int, PW: int, sd: bool):
        """One semidense, compact or list-chain phrase group (T exact)."""
        starts, ends, w, idf64_q, slot_of, ks = self._assemble(
            group, T, self.PHRASE_B_BUCKETS)
        qis = np.asarray([pq.qi for pq in group], dtype=np.int64)
        B = starts.shape[0]
        KV = self.PRUNED_PHRASE_KV
        eps3 = 3.0 * self.rel_eps
        n_bs = K.n_iters_for(self._max_df)
        d_starts, d_ends, d_w = (self._to_dev(a) for a in (starts, ends, w))
        d_ks = self._to_dev(ks)
        d_slot_of = self._to_dev(slot_of.astype(np.int32))
        cols = self._cols("list")
        t0 = time.perf_counter()
        if L > KV:
            assert PW <= self.POS_PAD, "verify windows need POS_PAD >= PW"
            M = min(KV, int(ks.max(initial=1)) + self.margin)
        else:
            M = min(L, int(ks.max(initial=1)) + self.margin)
        if sd:
            route = "phrase_semidense"
            slots = np.zeros((B, T), dtype=np.int32)
            for bi, pq in enumerate(group):
                slots[bi, 1:] = self._dense_slot[pq.slot_rows[1:]]
            out = self._make("make_semidense_phrase_kernel",
                             T, L, KV, PP, PW, M, self._n_pad_docs, n_bs,
                             eps3)(
                self.d_postings_doc, *cols, *self._cols("semidense_phrase"),
                self.d_positions, self.d_pos_starts, d_starts, d_ends, d_w,
                self._to_dev(slots), d_slot_of, d_ks)
        else:
            probe_slot, probe_begins, probe_mask, probe_active = \
                self._assemble_bloom_probes(group, T, B)
            probes = (self._to_dev(probe_slot), self._to_dev(probe_begins),
                      self._to_dev(probe_mask.view(np.int32)),
                      self._to_dev(probe_active))
            blooms = (self.d_bloom_rows, self.d_bloom_bitmap,
                      self.d_bloom_rank)
            if L > KV:
                route = "phrase_compact"
                out = self._make("make_compact_phrase_kernel",
                                 T, L, KV, PP, PW, M, n_bs, eps3)(
                    self.d_postings_doc, *cols, self.d_positions,
                    self.d_pos_starts, d_starts, d_ends, d_w, d_slot_of,
                    d_ks, *blooms, *probes)
            else:
                route = "phrase_list"
                col, extra = cols  # raw: (score, tf); tc: (tc, avg32)
                out = K.list_phrase(
                    self.d_postings_doc, col, self.d_positions,
                    self.d_pos_starts, d_starts, d_ends, d_w, d_slot_of,
                    *blooms, *probes, T=T, L=L, PP=PP, M=M, n_bs_iters=n_bs,
                    n_pos_iters=K.n_iters_for(
                        int(self.packed.max_tf.max(initial=1))),
                    postings_tf=None if self.tc else extra,
                    avg32=extra if self.tc else None)
        dt = time.perf_counter() - t0
        self._bump(**{"dispatch_s": dt, f"{route}_s": dt,
                      f"route_{route}": len(group)})
        return self._finalizer(route, out, T, slot_of, idf64_q, ks, qis,
                               [pq.rows for pq in group],
                               np.arange(len(group)), is_phrase=True)

    def _submit_mega_phrase(self, planned: List[_PlannedQuery], rq):
        """All-dense mega phrases through the full-scan kernel (or, with
        FULL_PHRASE_SCAN off, the block-pruned one), grouped by (T, anchor
        bag bucket PP, every-bag bucket PW). Arrays are in query-term
        order (adjacency is order-dependent); the anchor is the term with
        the smallest max_tf. Prune-guard misses are deferred to the
        batch's rescue."""
        pending = []
        route = "phrase_full" if self.FULL_PHRASE_SCAN else "phrase_pruned"
        self._bump(**{f"route_{route}": len(planned)})
        n_pad = self._n_pad_docs
        C = self.PRUNED_PHRASE_C
        KV = min(self.PRUNED_PHRASE_KV, C * 128 - 1, n_pad - 1)
        scan = n_pad if self.FULL_PHRASE_SCAN else C * 128
        max_tf = self.packed.max_tf
        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in planned:
            tfs = [int(max_tf[r]) for r in pq.rows]
            groups.setdefault((len(pq.rows), _bucket(min(tfs), PP_BUCKETS),
                               _bucket(max(tfs), PP_BUCKETS)), []).append(pq)
        for (T, PP, PW), members in groups.items():
            chunk = _chunk_within(
                PRUNED_PHRASE_LANE_BUDGET,
                max(T * scan, T * KV * PW, KV * PP * PW // 4),
                self.PHRASE_B_BUCKETS)
            for ci in range(0, len(members), chunk):
                group = members[ci : ci + chunk]
                B = _bucket(len(group), self.PHRASE_B_BUCKETS)
                starts = np.zeros((B, T), dtype=np.int32)
                ends = np.zeros((B, T), dtype=np.int32)
                trows = np.zeros((B, T), dtype=np.int64)
                use = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                anchor = np.zeros(B, dtype=np.int32)
                ks = np.zeros(B, dtype=np.int32)
                for i, pq in enumerate(group):
                    r = pq.rows
                    ks[i] = pq.query.n_results
                    anchor[i] = int(np.argmin(max_tf[r]))
                    starts[i] = self._starts32[r]
                    ends[i] = self._starts32[r] + self._df32[r]
                    trows[i] = r
                    use[i] = 1.0
                    idf64_q[i] = self.packed.idf64[r]
                slots = np.zeros((B, T), dtype=np.int32)  # padding rows: 0
                slots[: len(group)] = self._dense_slot[trows[: len(group)]]
                w = self._weights(trows, use)
                M = min(KV, int(ks.max(initial=1)) + self.margin)
                t0 = time.perf_counter()
                out = self._mega_phrase_dispatch(T, PP, PW, M, C, KV, starts,
                                                 ends, slots, w, anchor, ks)
                dt = time.perf_counter() - t0
                self._bump(**{"dispatch_s": dt, f"{route}_s": dt})
                # tfs come back in query-term order: identity slot_of
                slot_of = np.tile(np.arange(T, dtype=np.int64), (B, 1))
                qis = np.asarray([pq.qi for pq in group], dtype=np.int64)
                m = np.arange(len(group))
                on_flags = self._defer_prune_misses(
                    rq, ("phrase", T, PP, PW, M), T,
                    [pq.rows for pq in group],
                    dict(starts=starts, ends=ends, slots=slots, w=w,
                         anchor=anchor, ks=ks, slot_of=slot_of,
                         idf64_q=idf64_q, qis=qis, members=m))
                pending.append(self._finalizer(
                    route, out, T, slot_of, idf64_q, ks, qis,
                    [pq.rows for pq in group], m, on_flags=on_flags,
                    is_phrase=True))
        return pending

    def _mega_phrase_dispatch(self, T, PP, PW, M, C, KV, starts, ends,
                              slots, w, anchor, ks) -> torch.Tensor:
        """The mega-phrase kernel at compaction width KV: the full scan,
        or with FULL_PHRASE_SCAN off the block-pruned scan of C blocks."""
        assert PW <= self.POS_PAD, "verify windows need POS_PAD >= PW"
        KV = min(KV, self._n_pad_docs - 1)
        n_bs, eps3 = K.n_iters_for(self._max_df), 3.0 * self.rel_eps
        if self.FULL_PHRASE_SCAN:
            kern = self._make("make_full_phrase_kernel", T, self._n_pad_docs,
                              KV, PP, PW, M, n_bs, eps3)
            planes = self._cols("dense")
        else:
            kern = self._make("make_pruned_phrase_kernel", T,
                              self._n_pad_docs // 128, C, KV, PP, PW, M, n_bs,
                              eps3)
            planes = self._cols("dense") + (
                self.d_dense_blockmax, self.d_dense_blockmax2,
                self.d_dense_argpos)
        return kern(*planes, self.d_postings_doc, self.d_positions,
                    self.d_pos_starts, self._to_dev(starts),
                    self._to_dev(ends), self._to_dev(slots), self._to_dev(w),
                    self._to_dev(anchor), self._to_dev(ks))

    def _phrase_rescue(self, T, PP, PW, M, starts, ends, slots, w, anchor,
                       ks) -> np.ndarray:
        """The batch's mega-phrase misses re-run once at KV =
        PRUNED_PHRASE_RETRY_KV (a deeper compaction tightens the
        unverified-lane bound; the block-pruned scan also examines
        PRUNED_PHRASE_RETRY_C blocks, which lowers the unexamined-block
        bound), chunked within the mega lane budget. Returns packed (n,
        T+2, M) rows; rows it still flags take the exact host path."""
        n = len(ks)
        t0 = time.perf_counter()
        if self.FULL_PHRASE_SCAN:
            C2 = self.PRUNED_PHRASE_C  # unused by the full scan
            KV2 = min(self.PRUNED_PHRASE_RETRY_KV, self._n_pad_docs - 1)
            scan = self._n_pad_docs
        else:
            C2 = min(self.PRUNED_PHRASE_RETRY_C, self._n_pad_docs // 128 - 1)
            KV2 = min(self.PRUNED_PHRASE_RETRY_KV, C2 * 128 - 1)
            scan = C2 * 128
        chunk = _chunk_within(
            PRUNED_PHRASE_LANE_BUDGET,
            max(T * scan, T * KV2 * PW, KV2 * PP * PW // 4),
            self.PHRASE_B_BUCKETS)
        outs = []
        for ci in range(0, n, chunk):
            cn = min(chunk, n - ci)
            B = _bucket(cn, self.PHRASE_B_BUCKETS)

            def pad(a, ci=ci, cn=cn, B=B):
                out = np.zeros((B,) + a.shape[1:], dtype=a.dtype)
                out[:cn] = a[ci : ci + cn]
                return out

            outs.append((ci, cn, self._mega_phrase_dispatch(
                T, PP, PW, M, C2, KV2, pad(starts), pad(ends), pad(slots),
                pad(w), pad(anchor), pad(ks))))
        out = np.empty((n, T + 2, M), dtype=np.int32)
        for ci, cn, o in outs:
            out[ci : ci + cn] = self._fetch(o)[:cn]
        self._bump(prune_rescued=n, rescue_s=time.perf_counter() - t0)
        return out

    # -- guards and the re-rank ---------------------------------------------

    def _flags_to_force(self, flags: np.ndarray,
                        rescue: bool = False) -> np.ndarray:
        """Kernel flag word -> host-fallback mask. Window overflow (a
        windowed query whose candidate block overlaps more blocks than its
        window holds), tf saturation (a kept tc lane's tf byte saturated:
        its score was the optimistic bound and its tf is wrong) and prune
        misses always force the exact path;
        FLAG_TRUNC forces only under strict_parity — a truncated tie
        class breaks parity only when an excluded member f32-collides
        with a distinct f64 score. rescue=True: the rescue's second pass,
        which counts only what still forces."""
        force = (flags & (K.FLAG_OVERFLOW | K.FLAG_TF_SAT
                          | K.FLAG_PRUNE_MISS)) != 0
        if self.strict_parity:
            force = force | ((flags & K.FLAG_TRUNC) != 0)
        if rescue:
            self._bump(forced_host_after_rescue=int(force.sum()))
            return force

        def count(bit):
            return int(((flags & bit) != 0).sum())

        self._bump(q_flag_seen=len(flags),
                   flag_trunc=count(K.FLAG_TRUNC),
                   flag_overflow=count(K.FLAG_OVERFLOW),
                   flag_tf_sat=count(K.FLAG_TF_SAT),
                   flag_prune_miss=count(K.FLAG_PRUNE_MISS),
                   forced_host=int(force.sum()))
        return force

    def _finalize_arrays(self, top_docs, top_tfs_slot, flags, slot_of,
                         idf64_q, ks, qis, flat_rows, members, results,
                         force_host, is_phrase: bool = False):
        n = len(qis)
        t0 = time.perf_counter()
        B, T, M = top_tfs_slot.shape
        flat = ((np.arange(B, dtype=np.int64)[:, None] * T
                 + slot_of.astype(np.int64))[:, :, None] * M
                + np.arange(M, dtype=np.int64)[None, None, :])
        tf_q = top_tfs_slot.reshape(-1)[flat]
        docs_f, score_f, n_valid = rescore_sorted_arrays(
            top_docs, tf_q, idf64_q, self.packed.doc_len_code, self.cache64)
        cut = tie_class_cut(flags, score_f, n_valid, ks, self.rel_eps)
        suspects = (truncation_suspects(score_f, n_valid, ks,
                                        rel_eps=self.rel_eps)
                    | cut | force_host)
        self._bump(host_fallback_q=int(suspects[:n].sum()),
                   forced_host_tie_cut=int(cut[:n].sum()),
                   rescore_s=time.perf_counter() - t0)
        cnts = np.minimum(ks[:n], n_valid[:n])
        for i in range(n):
            res = results[int(qis[i])]
            if suspects[i]:
                d, s = self._host_exact(flat_rows[int(members[i])], int(ks[i]),
                                        is_phrase)
                res.set_arrays(d, s)
            else:
                res.set_arrays(docs_f[i, : cnts[i]], score_f[i, : cnts[i]])

    # -- long tail: more than MAX_T terms --------------------------------

    def _flat_key(self, pq: _PlannedQuery):
        n = len(pq.rows)
        # past the largest T bucket the slot count is exact (a bucket
        # smaller than the query would drop terms)
        T = n if n > self._tb[-1] else _bucket(n, self._tb)
        L = _bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb)
        return T, L

    def _assemble(self, group: List[_PlannedQuery], T: int,
                  buckets=B_BUCKETS):
        """Slot-ordered (starts, ends, weights: use_score raw or idf32 tc)
        + query-order f64 metadata for the re-rank."""
        B = _bucket(len(group), buckets)
        starts = np.zeros((B, T), dtype=np.int32)
        ends = np.zeros((B, T), dtype=np.int32)
        srows_all = np.zeros((B, T), dtype=np.int64)
        use_score = np.zeros((B, T), dtype=np.float32)
        idf64_q = np.zeros((B, T), dtype=np.float64)  # query-term order
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        for i, pq in enumerate(group):
            ks[i] = pq.query.n_results
            srows = pq.slot_rows
            for t in range(T):
                r = srows[t] if t < len(srows) else srows[0]
                srows_all[i, t] = r
                starts[i, t] = self._starts32[r]
                ends[i, t] = self._starts32[r] + self._df32[r]
                if t < len(srows):
                    use_score[i, t] = 1.0
            for t, qr in enumerate(pq.rows):
                idf64_q[i, t] = self.packed.idf64[qr]
                slot_of[i, t] = pq.slot_of_term[t]
        return (starts, ends, self._weights(srows_all, use_score), idf64_q,
                slot_of, ks)

    def _submit_flat(self, planned: List[_PlannedQuery]):
        pending = []
        keep: List[_PlannedQuery] = []
        over: List[_PlannedQuery] = []
        for pq in planned:
            # saturated candidates and csr-cold rows: exact host path
            if (int(self.packed.df[pq.slot_rows[0]]) > self._lb[-1]
                    or not all(self._csr_ok[r] for r in pq.rows)):
                over.append(pq)
            else:
                keep.append(pq)
        self._bump(route_long_tail=len(keep), route_host_merge=len(over))
        if over:
            def run_host(res_list, over=over):
                for pq in over:
                    d, s = self._host_exact(pq.rows, pq.query.n_results)
                    res_list[pq.qi].set_arrays(d, s)

            pending.append(run_host)
        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in keep:
            groups.setdefault(self._flat_key(pq), []).append(pq)
        for (T, L), group in groups.items():
            chunk = bs_chunk(T, L)
            for ci in range(0, len(group), chunk):
                pending.append(self._dispatch_group(group[ci : ci + chunk], T, L))
        return pending

    def _dispatch_group(self, group: List[_PlannedQuery], T: int, L: int):
        starts, ends, w, idf64_q, slot_of, ks = self._assemble(group, T)
        return self._dispatch_flat(
            T, L, starts, ends, w, idf64_q, slot_of, ks,
            np.asarray([pq.qi for pq in group], dtype=np.int64),
            [pq.rows for pq in group], np.arange(len(group)))


def _posting_index(packed: PackedIndex, row: int, doc: int) -> int:
    ts, te = int(packed.term_starts[row]), int(packed.term_starts[row + 1])
    return ts + int(np.searchsorted(packed.postings_doc[ts:te], doc))


def snippet_for(pk: PackedIndex, doc_bodies, rows, query: SearchQuery,
                doc: int) -> str:
    """The snippet of one result doc from the index's offset bags (the
    port's copy of wiser_tpu/engine/device.py's; vacuum_engine.h:243-255).
    A phrase keeps only the offsets at its match positions
    (ResultDocEntry::FilterOffsetByPosition, query_processing.h:469-492)."""
    offset_table = []
    pidxs = [_posting_index(pk, r, doc) for r in rows]
    if query.is_phrase and len(rows) >= 2:
        pos_lists = [pk.positions[pk.pos_starts[p] : pk.pos_starts[p + 1]]
                     for p in pidxs]
        base = set(int(x) for x in pos_lists[0])
        for t in range(1, len(pos_lists)):
            base &= set(int(x) - t for x in pos_lists[t])
        for t, p in enumerate(pidxs):
            pos_to_j = {int(x): j for j, x in enumerate(pos_lists[t])}
            s, e = int(pk.off_starts[p]), int(pk.off_starts[p + 1])
            pairs = []
            for m in sorted(base):
                j = pos_to_j.get(m + t)
                if j is not None and s + j < e:
                    pairs.append((int(pk.off_begin[s + j]),
                                  int(pk.off_end[s + j])))
            offset_table.append(pairs)
    else:
        for p in pidxs:
            s, e = int(pk.off_starts[p]), int(pk.off_starts[p + 1])
            offset_table.append(list(zip(pk.off_begin[s:e].tolist(),
                                         pk.off_end[s:e].tolist())))
    return SimpleHighlighter().highlight(offset_table,
                                         query.n_snippet_passages,
                                         doc_bodies[doc])
