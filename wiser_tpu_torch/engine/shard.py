"""ShardedEngine — the document-partitioned engine over D shards (port of
wiser_tpu/engine/shard.py).

Postings are partitioned by contiguous, equal-width, 128-aligned doc
ranges (ShardedIndex.from_packed); every shard runs the same batched step
on its own columns, and the per-shard top-M results merge into a global
top-M (engine/shard_steps.py: the local steps and merge_shards).

The JAX engine is one program over a jax.sharding.Mesh (shard_map, an
all_gather over the mesh axis). This is the same single-controller
model: one process, one torch.device per shard. Shard s lives on
devices[s]; by default on cuda:s when the machine has D cards, else
every shard on cuda:0. A group runs its D local steps, one per shard on
its device, then copies their outputs to devices[0] (no copy where the
shards share it) and merges there; every group therefore launches D
local steps. Global statistics (df, idf, avg_len, doc length codes) are
the same on every shard.

Routes (the JAX engine's, with TorchEngine's host-side machinery: the
memoized exact host search, the f64 re-rank with tie_class_cut, the flag
policy and the counters):
  1 term                -> host impact table (deeper k: bs)
  all terms dense       -> dense scan of each shard's (H, Npd) slice of
                           the dense tier; past PRUNED_DENSE_MIN_NB blocks
                           per shard the block-max pruned scan, whose guard
                           runs after the merge (misses take the host)
  a dense other         -> semidense
  else                  -> bs, grouped by (T, per-shard candidate L bucket)
  phrase, L > PHRASE_COMPACT_KV with bloom columns
                        -> compact phrase (bi-bloom gate, KV compaction,
                           window verify; flags merge by OR)
  phrase                -> phrase_body per shard (route_phrase_list)
  a per-shard candidate run past the largest L bucket -> exact host
The departures from the JAX engine change no answer: groups run in
chunks under TorchEngine's lane budgets, a phrase group too large for
its lane budget at the smallest B takes the exact host path (as in
TorchEngine), queries of more than 8 terms keep their exact slot count,
and a merged FLAG_TRUNC whose tie class reaches place k takes the host
(tie_class_cut: a card's top-k keeps no tie order).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wiser_tpu_torch.engine import kernels as K
from wiser_tpu_torch.engine import shard_steps as S
from wiser_tpu_torch.engine.device import (
    PHRASE_LANE_BUDGET,
    PRUNED_LANE_BUDGET,
    SEMIDENSE_LANE_BUDGET,
    TorchEngine,
    _chunk_within,
    bs_chunk,
    fold_bloom_columns,
    positions_column,
)
from wiser_tpu_torch.engine.host import (
    B_BUCKETS,
    DEFAULT_MARGIN,
    L_BUCKETS,
    PP_BUCKETS,
    T_BUCKETS,
    _bucket,
    _host_phrase_mask,
    _PlannedQuery,
    _tc_score64_ub,
    build_single_term_table,
)
from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.runtime import resolve_device
from wiser_tpu_torch.scoring import K1, Bm25Similarity
from wiser_tpu_torch.types import SearchQuery, SearchResult


@dataclass
class ShardedIndex:
    """Per-shard CSR posting columns stacked on a leading shard axis (host
    arrays; the engine uploads each shard's row to its device)."""

    n_shards: int
    doc_bounds: np.ndarray  # int64[D+1] contiguous doc ranges
    postings_doc: np.ndarray  # int32[D, P_pad] global doc ids, pad SENTINEL
    postings_tf: np.ndarray  # int32[D, P_pad]
    postings_score: np.ndarray  # f32[D, P_pad] partial scores (global stats)
    term_starts: np.ndarray  # int32[D, T+1] 128-aligned per-shard CSR
    df_shard: np.ndarray  # int32[D, T] real per-shard posting counts
    pos_starts: np.ndarray  # int32[D, P_pad+1] per-shard position bags
    positions: np.ndarray  # int32[D, PP_pad]
    # global (replicated) metadata
    terms: List[str]
    df: np.ndarray
    idf64: np.ndarray
    n_docs: int
    avg_len: float
    doc_len_code: np.ndarray  # uint8[N]
    # per-shard bi-bloom rows (the per-posting rows regathered, uint32
    # [D, P_pad, W]); None when the source index has no bloom columns.
    # Host only: the engine uploads their sparse fold.
    bloom_ends: Optional[np.ndarray] = None
    bloom_begins: Optional[np.ndarray] = None
    max_tf: np.ndarray = None  # int32[T] global (phrase PP bucketing)
    # the source index: exact host searches and snippets (host only)
    source: Optional[PackedIndex] = None

    @classmethod
    def from_packed(cls, packed: PackedIndex, n_shards: int) -> "ShardedIndex":
        N, T = packed.n_docs, packed.n_terms
        # equal-width 128-aligned ranges: shard s owns docs
        # [s*Npd, (s+1)*Npd). The dense tier partitions on the same grid,
        # so a shard's postings reference exactly its dense rows' range.
        npd = (N + n_shards * BLOCK - 1) // (n_shards * BLOCK) * BLOCK
        bounds = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * npd, N)
        scores = packed.partial_scores(
            Bm25Similarity(packed.avg_len).cache).astype(np.float32)
        lens = np.diff(packed.term_starts)
        term_of = np.repeat(np.arange(T, dtype=np.int64), lens)
        real = packed.postings_doc != SENTINEL_DOC
        shard_of = np.full(packed.n_postings, -1, dtype=np.int64)
        if n_shards > 1:
            shard_of[real] = np.searchsorted(
                bounds[1:-1], packed.postings_doc[real], side="right")
        else:
            shard_of[real] = 0

        per = []
        for s in range(n_shards):
            sel = shard_of == s
            cnt = np.bincount(term_of[sel], minlength=T).astype(np.int64)
            padded = (cnt + BLOCK - 1) // BLOCK * BLOCK
            ts = np.zeros(T + 1, dtype=np.int64)
            np.cumsum(padded, out=ts[1:])
            per.append((sel, cnt, ts))

        # slack past the largest shard: one largest L bucket, so a
        # candidate slice starting inside the data is never clamped
        lmax = _bucket(int(packed.df.max(initial=1)), L_BUCKETS)
        p_pad = max(int(ts[-1]) for _, _, ts in per) + lmax
        p_pad = (p_pad + BLOCK - 1) // BLOCK * BLOCK
        D = n_shards
        out_doc = np.full((D, p_pad), SENTINEL_DOC, dtype=np.int32)
        out_tf = np.zeros((D, p_pad), dtype=np.int32)
        out_sc = np.zeros((D, p_pad), dtype=np.float32)
        have_blooms = packed.bloom_ends is not None
        if have_blooms:
            W = packed.bloom_ends.shape[1]
            out_be = np.zeros((D, p_pad, W), dtype=np.uint32)
            out_bb = np.zeros((D, p_pad, W), dtype=np.uint32)
        df_shard = np.zeros((D, T), dtype=np.int32)
        pos_counts_global = np.diff(packed.pos_starts)
        shard_positions = []
        shard_pos_counts = []
        for s, (sel, cnt, ts) in enumerate(per):
            t_sel = term_of[sel]
            # rank of each selected posting within its term run
            csum = np.zeros(T + 1, dtype=np.int64)
            np.cumsum(cnt, out=csum[1:])
            rank = np.arange(t_sel.size) - csum[t_sel]
            dest = ts[t_sel] + rank
            out_doc[s, dest] = packed.postings_doc[sel]
            out_tf[s, dest] = packed.postings_tf[sel]
            out_sc[s, dest] = scores[sel]
            if have_blooms:
                out_be[s, dest] = packed.bloom_ends[sel]
                out_bb[s, dest] = packed.bloom_begins[sel]
            df_shard[s] = cnt
            # ragged gather of each selected posting's position bag
            sel_idx = np.nonzero(sel)[0]
            cnts = pos_counts_global[sel_idx]
            csum2 = np.zeros(len(cnts) + 1, dtype=np.int64)
            np.cumsum(cnts, out=csum2[1:])
            total = int(csum2[-1])
            src = (np.repeat(packed.pos_starts[sel_idx], cnts)
                   + np.arange(total) - np.repeat(csum2[:-1], cnts))
            shard_positions.append(packed.positions[src])
            counts_padded = np.zeros(p_pad, dtype=np.int64)
            counts_padded[dest] = cnts
            shard_pos_counts.append(counts_padded)
        pp_pad = max(1, max(len(x) for x in shard_positions))
        out_pos = np.zeros((D, pp_pad), dtype=np.int32)
        out_ps = np.zeros((D, p_pad + 1), dtype=np.int32)
        for s in range(D):
            out_pos[s, : len(shard_positions[s])] = shard_positions[s]
            out_ps[s, 1:] = np.cumsum(shard_pos_counts[s]).astype(np.int32)
        return cls(
            n_shards=D,
            doc_bounds=bounds,
            postings_doc=out_doc,
            postings_tf=out_tf,
            postings_score=out_sc,
            term_starts=np.stack([ts for _, _, ts in per]).astype(np.int32),
            df_shard=df_shard,
            pos_starts=out_ps,
            positions=out_pos,
            bloom_ends=out_be if have_blooms else None,
            bloom_begins=out_bb if have_blooms else None,
            max_tf=packed.max_tf.copy(),
            terms=packed.terms,
            df=packed.df.copy(),
            idf64=packed.idf64.copy(),
            n_docs=N,
            avg_len=packed.avg_len,
            doc_len_code=packed.doc_len_code.copy(),
            source=packed,
        )


def host_exact_search_sharded(sh: ShardedIndex, cache64: np.ndarray,
                              rows, k: int, is_phrase: bool = False):
    """Exact host search over the sharded host columns. Shards hold
    contiguous ascending doc ranges, so per-shard matches concatenate in
    doc order and the final lexsort gives the (score desc, doc asc)
    canon. Returns (docs int64[<=k], scores f64[<=k])."""
    docs_parts, tf_parts = [], []
    for s in range(sh.n_shards):
        dfs = [int(sh.df_shard[s, r]) for r in rows]
        if min(dfs) == 0:
            continue
        cand = int(np.argmin(dfs))
        cs = int(sh.term_starts[s, rows[cand]])
        docs = sh.postings_doc[s, cs : cs + dfs[cand]].astype(np.int64)
        mask = np.ones(len(docs), dtype=bool)
        tfs = np.zeros((len(rows), len(docs)), dtype=np.int64)
        pidx = np.zeros((len(rows), len(docs)), dtype=np.int64)
        for t, r in enumerate(rows):
            st, n = int(sh.term_starts[s, r]), dfs[t]
            arr = sh.postings_doc[s, st : st + n]
            idx = np.searchsorted(arr, docs)
            idc = np.minimum(idx, n - 1)
            mask &= (idx < n) & (arr[idc] == docs)
            tfs[t] = sh.postings_tf[s, st + idc]
            pidx[t] = st + idc
        if is_phrase and len(rows) >= 2:
            sel = np.nonzero(mask)[0]
            mask[sel] = _host_phrase_mask(sh.positions[s], sh.pos_starts[s],
                                          docs[sel], pidx[:, sel], len(rows))
        docs_parts.append(docs[mask])
        tf_parts.append(tfs[:, mask])
    if not docs_parts:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)
    docs_m = np.concatenate(docs_parts)
    tfs_m = np.concatenate(tf_parts, axis=1).astype(np.float64)
    if docs_m.size == 0:
        return docs_m, np.zeros(0, dtype=np.float64)
    cache_val = cache64[sh.doc_len_code[docs_m] & 0xFF]
    score = np.zeros(docs_m.size, dtype=np.float64)
    for t, r in enumerate(rows):
        f = tfs_m[t]
        score = score + np.float64(sh.idf64[r]) * ((f * (K1 + 1))
                                                   / (f + cache_val))
    order = np.lexsort((docs_m, -score))[:k]
    return docs_m[order], score[order]


def default_placement(n_shards: int) -> List[str]:
    """cuda:s for shard s on a machine with n_shards cards or more, else
    every shard on cuda:0."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= n_shards:
        return [f"cuda:{s}" for s in range(n_shards)]
    return ["cuda:0"] * n_shards


def _tbucket(n: int) -> int:
    """The slot count of an n-term group: a T bucket, exact past the
    largest (a smaller bucket would drop terms)."""
    return n if n > T_BUCKETS[-1] else _bucket(n, T_BUCKETS)


class ShardedEngine:
    """Single-term, AND and phrase search over a ShardedIndex, one shard per
    device (see the module docstring). The index must carry its source
    PackedIndex (from_packed sets it): the exact host path, the dense tier,
    the impact table and snippets read it."""

    # the tier constants of the JAX mesh engine
    DENSE_MIN_DF_FRACTION = 96
    DENSE_MIN_DF_FLOOR = 1024
    PRUNED_DENSE_MIN_NB = 2048
    PRUNED_DENSE_C = 512
    # the compact phrase pipeline engages past this per-shard candidate L
    PHRASE_COMPACT_KV = 1024
    # TorchEngine's host-side constants
    MAX_T = TorchEngine.MAX_T
    POS_PAD = TorchEngine.POS_PAD
    BLOOM_DF_CEILING = TorchEngine.BLOOM_DF_CEILING
    HOST_CACHE_CAP = TorchEngine.HOST_CACHE_CAP
    DENSE_CHUNK = TorchEngine.DENSE_CHUNK
    PRUNED_DENSE_B_BUCKETS = TorchEngine.PRUNED_DENSE_B_BUCKETS
    PHRASE_B_BUCKETS = TorchEngine.PHRASE_B_BUCKETS

    # TorchEngine's host-side machinery, shared as is: the counters, the
    # finalizer order, the memoized exact host search, the flag policy,
    # the f64 re-rank with its guards, the impact table, snippets and the
    # bloom probe assembly
    _bump = TorchEngine._bump
    stats_take = TorchEngine.stats_take
    clear_result_memos = TorchEngine.clear_result_memos
    fill_snippets = TorchEngine.fill_snippets
    _host_exact = TorchEngine._host_exact
    _fetch = TorchEngine._fetch
    search = TorchEngine.search
    search_batch = TorchEngine.search_batch
    run_pending = staticmethod(TorchEngine.run_pending)
    _serve_single_term = TorchEngine._serve_single_term
    _flags_to_force = TorchEngine._flags_to_force
    _finalize_arrays = TorchEngine._finalize_arrays
    _assemble_bloom_probes = TorchEngine._assemble_bloom_probes

    def __init__(self, sharded: ShardedIndex, *,
                 devices: Optional[Sequence] = None,
                 margin: int = DEFAULT_MARGIN,
                 doc_bodies: Optional[Sequence[str]] = None,
                 strict_parity: bool = False,
                 dense_budget_bytes: int = 7 << 29,
                 single_term_depth: int = 64,
                 columns: str = "raw"):
        """devices: one torch device (or name) per shard; default
        default_placement(D) ("cuda": raises without a card). Tests pass
        ["cpu"] * D. columns: "raw" or "tc" (per-shard uint16 tc lanes and
        the uint8 dense tf plane, as TorchEngine(columns="tc"))."""
        if columns not in ("raw", "tc"):
            raise ValueError(f"unknown columns mode {columns!r}")
        if sharded.source is None:
            raise ValueError("the ShardedIndex has no source index "
                             "(build it with ShardedIndex.from_packed)")
        D = sharded.n_shards
        if devices is None:
            devices = default_placement(D)
        if len(devices) != D:
            raise ValueError(f"{len(devices)} devices for {D} shards")
        self.placement = [resolve_device(d) for d in devices]
        self.device = self.placement[0]  # where the merge runs
        self.columns = columns
        self.tc = columns == "tc"
        self.sharded = sharded
        self.packed = self._host_packed = sharded.source
        self.margin = margin
        self.doc_bodies = doc_bodies
        self.strict_parity = strict_parity
        self.bloom_enable_factor = 1
        self.rel_eps = 1e-5 if self.tc else 1e-6
        self.similarity = Bm25Similarity(sharded.avg_len)
        self.cache64 = self.similarity.cache
        self.term_to_row = {t: i for i, t in enumerate(sharded.terms)}
        self._avg32 = float(np.float32(sharded.avg_len))
        if (sharded.postings_doc.shape[1] >= 2**31
                or sharded.positions.shape[1] >= 2**31):
            raise ValueError("shard too large for int32 device addressing")
        self._max_df = int(sharded.df.max(initial=1))
        self._max_tf = int(sharded.max_tf.max(initial=1))
        # per-shard max df per term: the L bucket and the saturation check
        self._df_shard_max = sharded.df_shard.max(axis=0).astype(np.int64)
        self._npd = (sharded.n_docs + D * BLOCK - 1) // (D * BLOCK) * BLOCK
        self._host_cache: Dict[tuple, tuple] = {}
        self.stats: Dict[str, float] = {}
        self._upload_shards()

        self._dense_H = 0
        self._dense_slot = np.full(len(sharded.df), -1, dtype=np.int32)
        self.dense_build_s = 0.0
        src = sharded.source
        scores64 = src.partial_scores(self.cache64)
        if dense_budget_bytes:
            t0 = time.perf_counter()
            self._build_dense_rows(src, scores64, dense_budget_bytes)
            self.dense_build_s = time.perf_counter() - t0
        self._st_depth = single_term_depth
        if single_term_depth:
            self._tt_starts, self._tt_docs, self._tt_scores = \
                build_single_term_table(src, scores64, single_term_depth)

    # -- device columns ----------------------------------------------------

    def _upload_shards(self) -> None:
        """Each shard's posting columns (raw f32 score + int32 tf, or the
        uint16 tc lane (doc_len_code << 8 | min(tf, 255), 0 on pads) as
        int16 bits), CSR, position bags (with a tail as long as the widest
        verify window, positions_column) and sparse folded bloom columns
        (one fold per shard, stored for terms with df <= BLOOM_DF_CEILING)
        to its device."""
        sh = self.sharded
        D = sh.n_shards
        if self.tc:
            real = sh.postings_doc != SENTINEL_DOC
            docs_safe = np.where(real, sh.postings_doc, 0)
            tc_col = np.where(
                real,
                (sh.doc_len_code[docs_safe].astype(np.uint16) << 8)
                | np.minimum(sh.postings_tf, K.TF_SAT).astype(np.uint16),
                np.uint16(0))
        pos_pad = max(self.POS_PAD, _bucket(self._max_tf, PP_BUCKETS))
        gate_term = sh.df <= self.BLOOM_DF_CEILING
        self.shards: List[S.ShardColumns] = []
        for s in range(D):
            dev = self.placement[s]

            def put(a, dev=dev):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            n_pos = int(sh.pos_starts[s, -1])
            cols = S.ShardColumns(
                device=dev, doc_base=s * self._npd,
                doc=put(sh.postings_doc[s]),
                term_starts=put(sh.term_starts[s]),
                df=put(sh.df_shard[s]),
                positions=put(positions_column(sh.positions[s, :n_pos],
                                               self.MAX_T, pos_pad)),
                pos_starts=put(sh.pos_starts[s]))
            if self.tc:
                cols.tc = put(tc_col[s].view(np.int16))
                # a device tensor: CUDA divides by a CPU scalar through its
                # reciprocal, which the score's f32 op order does not allow
                cols.avg32 = torch.tensor(np.float32(sh.avg_len), device=dev)
            else:
                cols.score = put(sh.postings_score[s])
                cols.tf = put(sh.postings_tf[s])
            if sh.bloom_ends is not None:
                ts_s = sh.term_starts[s].astype(np.int64)
                gate = np.zeros(sh.postings_doc.shape[1], dtype=bool)
                gate[: int(ts_s[-1])] = np.repeat(gate_term, np.diff(ts_s))
                rows, bitmap, rank = fold_bloom_columns(
                    sh.bloom_ends[s], sh.bloom_begins[s], gate)
                cols.bloom_rows = put(rows.view(np.int32))
                cols.bloom_bitmap = put(bitmap.view(np.int32))
                cols.bloom_rank = put(rank)
            self.shards.append(cols)

    def _build_dense_rows(self, src: PackedIndex, scores64: np.ndarray,
                          budget_bytes: int) -> None:
        """The dense head-term tier, (H, D*Npd) rows split on the shard doc
        grid: shard s holds lanes [s*Npd, (s+1)*Npd). raw: f32 score and
        int32 tf planes; tc: the uint8 tf plane and the shared len-code
        row. Per-128-doc-block maxima for the pruned scan: the f32 scores'
        (raw), the f64 bound of the in-kernel tc score (tc, computed on
        each shard's device from its composed lanes, host._tc_score64_ub).
        Eligible: df >= max(DENSE_MIN_DF_FLOOR, n // DENSE_MIN_DF_FRACTION);
        admitted by df, largest first, while a row (8 B per doc raw, 1 B
        tc) fits the budget."""
        sh = self.sharded
        n, D, npd = sh.n_docs, sh.n_shards, self._npd
        dense_min = max(self.DENSE_MIN_DF_FLOOR,
                        n // self.DENSE_MIN_DF_FRACTION)
        rows = np.nonzero(sh.df >= dense_min)[0]
        if len(rows) == 0:
            return
        N_pad = npd * D
        row_bytes = 1 if self.tc else 8
        cap = max(1, int(budget_bytes // (N_pad * row_bytes)))
        if len(rows) > cap:
            rows = rows[np.argsort(sh.df[rows])[::-1][:cap]]
        H = len(rows)
        lens = np.diff(src.term_starts)
        plane = np.zeros((H, N_pad), dtype=np.uint8 if self.tc else np.float32)
        tfp = None if self.tc else np.zeros((H, N_pad), dtype=np.int32)
        scores32 = None if self.tc else scores64.astype(np.float32)
        for slot, r in enumerate(rows.tolist()):
            s0 = int(src.term_starts[r])
            m = min(int(src.df[r]), int(lens[r]))
            docs = src.postings_doc[s0 : s0 + m]
            if self.tc:
                plane[slot, docs] = np.minimum(
                    src.postings_tf[s0 : s0 + m], K.TF_SAT).astype(np.uint8)
            else:
                plane[slot, docs] = scores32[s0 : s0 + m]
                tfp[slot, docs] = src.postings_tf[s0 : s0 + m]
            self._dense_slot[r] = slot
        self._dense_H = H
        len_code = np.zeros(N_pad, dtype=np.uint8)
        len_code[:n] = sh.doc_len_code[:n]
        idf64 = sh.idf64[rows].astype(np.float32).astype(np.float64)
        for s, cols in enumerate(self.shards):
            lo, hi = s * npd, (s + 1) * npd
            dev = cols.device
            if not self.tc:
                sc = np.ascontiguousarray(plane[:, lo:hi])
                cols.dense_sc = torch.from_numpy(sc).to(dev)
                cols.dense_tf = torch.from_numpy(
                    np.ascontiguousarray(tfp[:, lo:hi])).to(dev)
                cols.blockmax = torch.from_numpy(
                    sc.reshape(H, npd // BLOCK, BLOCK).max(axis=2)).to(dev)
                continue
            cols.dense_tf8 = torch.from_numpy(
                np.ascontiguousarray(plane[:, lo:hi])).to(dev)
            cols.len_code = torch.from_numpy(len_code[lo:hi].copy()).to(dev)
            code_hi = cols.len_code.to(torch.int32) << 8
            d_idf = torch.from_numpy(idf64).to(dev)
            avg64 = torch.tensor(self._avg32, dtype=torch.float64, device=dev)
            bm = torch.empty((H, npd // BLOCK), dtype=torch.float32,
                             device=dev)
            step = max(1, TorchEngine.DENSE_UB_CHUNK_LANES // npd)
            for h0 in range(0, H, step):
                h1 = min(h0 + step, H)
                tc = K._compose_tc(cols.dense_tf8[h0:h1], code_hi[None, :])
                ub = _tc_score64_ub(tc, d_idf[h0:h1, None], avg64)
                bm[h0:h1] = ub.view(h1 - h0, npd // BLOCK, BLOCK).amax(dim=2)
            cols.blockmax = bm

    def device_bytes(self) -> dict:
        """Device-resident index bytes per column family, over every shard
        (shard_bytes() splits the total by shard, placement names the
        devices)."""
        out: Dict[str, int] = {}
        for cols in self.shards:
            for k, v in cols.nbytes().items():
                out[k] = out.get(k, 0) + v
        out["total"] = sum(out.values())
        return out

    def shard_bytes(self) -> List[int]:
        return [sum(c.nbytes().values()) for c in self.shards]

    # -- helpers -------------------------------------------------------------

    def lookup(self, term: str) -> int:
        return self.term_to_row.get(term, -1)

    def _weights(self, rows: np.ndarray, use: np.ndarray) -> np.ndarray:
        """use_score (raw) or the f32 idfs, 0 where use is 0 (tc)."""
        if not self.tc:
            return use
        return (self.sharded.idf64[rows] * use).astype(np.float32)

    def _per_device(self, *arrays):
        """{device: tensors} — each host array uploaded once per distinct
        shard device (the JAX engine's replicated operands)."""
        out = {}
        for dev in self.placement:
            if dev not in out:
                out[dev] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in arrays)
        return out

    def _run_mesh(self, step, args, kw, M_out: int, shards=None,
                  guard=None) -> torch.Tensor:
        """step on every shard (default self.shards) with its device's copy
        of the host arrays args, the outputs gathered on devices[0] and
        merged (shard_steps.merge_shards). guard = (ks, M, eps3): the
        prune guard of the merged top-M against the max of the shards'
        next_ub (the step's fifth output). Returns the packed (B, T+2,
        M_out) int32 output on devices[0]."""
        shards = self.shards if shards is None else shards
        per = self._per_device(*args)
        outs = [step(cols, *per[cols.device], **kw) for cols in shards]
        dev0 = self.placement[0]
        stacked = [S.gather([o[i] for o in outs], dev0)
                   for i in range(len(outs[0]))]
        d2, s2, t2, flags = S.merge_shards(*stacked[:4], M_out=M_out)
        if guard is not None:
            ks, M, eps3 = guard
            flags = flags | K.prune_guard_flag(
                s2, stacked[4].amax(dim=0), torch.from_numpy(ks).to(dev0),
                M=M, eps3=eps3)
        return K.pack_with_flags(d2, t2, flags)

    # -- the mesh steps: host arrays in, the merged packed output out ----

    def mesh_bs(self, rows, w, *, T: int, L: int, M: int, M_out: int):
        """The bs step (make_sharded_kernel{,_tc}): rows (B, T) term rows
        in slot order, w (B, T) use_score (raw) or f32 idfs (tc)."""
        return self._run_mesh(S.bs_step, (rows, w),
                              dict(T=T, L=L, M=M,
                                   n_bs_iters=K.n_iters_for(self._max_df)),
                              M_out)

    def mesh_phrase(self, rows, w, slot_of, *, T: int, L: int, PP: int,
                    M: int, M_out: int):
        """phrase_body per shard (make_sharded_phrase_kernel{,_tc})."""
        return self._run_mesh(
            S.phrase_step, (rows, w, slot_of.astype(np.int32)),
            dict(T=T, L=L, PP=PP, M=M, n_bs_iters=K.n_iters_for(self._max_df),
                 n_pos_iters=K.n_iters_for(self._max_tf)), M_out)

    def mesh_compact_phrase(self, rows, w, slot_of, ks, probes, *, T: int,
                            L: int, PP: int, PW: int, M: int, M_out: int):
        """The compact phrase pipeline per shard
        (make_sharded_compact_phrase_kernel); probes: (probe_slot,
        probe_begins, probe_mask u32, probe_active) (B, T-1)."""
        return self._run_mesh(
            S.compact_phrase_step,
            (rows, w, slot_of.astype(np.int32), ks, probes[0], probes[1],
             probes[2].view(np.int32), probes[3]),
            dict(T=T, L=L, KV=self.PHRASE_COMPACT_KV, PP=PP, PW=PW, M=M,
                 n_bs_iters=K.n_iters_for(self._max_df),
                 eps3=3.0 * self.rel_eps), M_out)

    def mesh_dense(self, slots, w, ks, *, T: int, M: int, pruned: bool):
        """The dense scan (make_sharded_dense_kernel{,_tc}) or the pruned
        one (make_sharded_pruned_dense_kernel{,_tc}, PRUNED_DENSE_C
        blocks per shard, the guard after the merge): slots (B, T) dense
        rows in query order."""
        if not pruned:
            return self._run_mesh(S.dense_step, (slots, w), dict(T=T, M=M), M)
        return self._run_mesh(
            S.pruned_step, (slots, w),
            dict(T=T, NB=self._npd // BLOCK, C=self.PRUNED_DENSE_C, M=M), M,
            guard=(ks, M, 3.0 * self.rel_eps))

    def mesh_semidense(self, rows, w, slots, *, T: int, L: int, M: int,
                       n_bs: int, n_bs_iters: int, M_out: int):
        """The semidense step (make_sharded_semidense_kernel{,_tc})."""
        return self._run_mesh(
            S.semidense_step, (rows, w, slots),
            dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters), M_out)

    def _finalizer(self, route: str, out: torch.Tensor, T: int,
                   group: List[_PlannedQuery], slot_of, idf64_q, ks,
                   is_phrase: bool = False):
        """Fetch a group's packed output, derive the host-fallback mask and
        re-rank (TorchEngine._finalize_arrays)."""

        def finalize(res_list):
            t0 = time.perf_counter()
            n = len(group)
            packed = self._fetch(out)[:n]
            flags = packed[:, T + 1, 0]
            self._finalize_arrays(
                packed[:, 0, :], packed[:, 1 : T + 1, :], flags, slot_of[:n],
                idf64_q[:n], ks[:n],
                np.asarray([pq.qi for pq in group], dtype=np.int64),
                [pq.rows for pq in group], np.arange(n), res_list,
                force_host=self._flags_to_force(flags), is_phrase=is_phrase)
            self._bump(**{f"{route}_s": time.perf_counter() - t0})

        return finalize

    def _run_host(self, group: List[_PlannedQuery], is_phrase: bool):
        """Finalizer answering a group with the memoized exact host search."""

        def run(res_list):
            for pq in group:
                d, s = self._host_exact(pq.rows, pq.query.n_results, is_phrase)
                res_list[pq.qi].set_arrays(d, s)

        return run

    def _route_saturated(self, planned: List[_PlannedQuery]):
        """Split off the queries whose per-shard candidate run exceeds the
        largest L bucket (the device would scan only part of it)."""
        keep, over = [], []
        for pq in planned:
            (over if int(self._df_shard_max[pq.slot_rows[0]]) > L_BUCKETS[-1]
             else keep).append(pq)
        return keep, over

    def _assemble(self, group: List[_PlannedQuery], T: int, B: int):
        """Slot-ordered term rows (padded slots repeat slot 0, padded
        queries row 0), weights, query-order f64 idfs, slot_of and ks."""
        rows = np.zeros((B, T), dtype=np.int64)
        use = np.zeros((B, T), dtype=np.float32)
        idf64_q = np.zeros((B, T), dtype=np.float64)
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        for i, pq in enumerate(group):
            ks[i] = pq.query.n_results
            n = len(pq.slot_rows)
            rows[i] = pq.slot_rows + [pq.slot_rows[0]] * (T - n)
            use[i, :n] = 1.0
            idf64_q[i, : len(pq.rows)] = self.sharded.idf64[pq.rows]
            slot_of[i, : len(pq.rows)] = pq.slot_of_term
        return rows, self._weights(rows, use), idf64_q, slot_of, ks

    # -- the batch API ---------------------------------------------------------

    def submit_batch(self, queries: List[SearchQuery]):
        """Dispatch every group of the batch, then return (results,
        finalizers) — TorchEngine's pipelined contract: run_pending runs
        the finalizers, barriers (snippets, duplicate fan-out) last."""
        results = [SearchResult() for _ in queries]
        df = self.sharded.df
        planned: List[_PlannedQuery] = []
        phrase: List[_PlannedQuery] = []
        dedup: Dict[tuple, int] = {}
        dups: List[tuple] = []
        snips: List[tuple] = []
        n_single = 0
        for qi, q in enumerate(queries):
            if q.n_results <= 0 or not q.terms:
                continue
            rows = [self.lookup(t) for t in q.terms]
            if min(rows) < 0:
                continue
            # request coalescing: identical queries run once
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
            pq = _PlannedQuery(qi, rows, q)
            pq.plan_slots(df)
            (phrase if q.is_phrase and len(rows) >= 2 else planned).append(pq)
        self._bump(q_coalesced=len(dups), route_single_table=n_single)

        pending = self._submit_phrase(phrase)
        planned, over = self._route_saturated(planned)
        if over:
            pending.append(self._run_host(over, False))
        # df-tier routing: all-head -> dense scan; a dense other ->
        # semidense; the rest -> bs
        dense, semi, bs = [], [], []
        for pq in planned:
            if self._dense_H and len(pq.rows) > 1:
                ds = self._dense_slot[pq.slot_rows]
                if (ds >= 0).all():
                    dense.append(pq)
                    continue
                if (ds[1:] >= 0).any():
                    semi.append(pq)
                    continue
            bs.append(pq)
        self._bump(route_host_merge=len(over), route_bs=len(bs))
        pending += self._submit_dense(dense)
        pending += self._submit_semidense(semi)
        pending += self._submit_bs(bs)

        if snips:
            def fill_snippets(res_list, snips=snips):
                for qi, rows, q in snips:
                    self.fill_snippets(res_list[qi], rows, q)

            fill_snippets.barrier = True  # every route's answer is final
            pending.append(fill_snippets)
        if dups:
            def copy_dups(res_list, dups=dups):
                for dqi, pqi in dups:
                    src, dst = res_list[pqi], res_list[dqi]
                    if src._docs is not None:
                        dst.set_arrays(src._docs, src._scores)
                    dst._entries = list(src._entries)

            copy_dups.barrier = True  # reads primaries' results: run last
            pending.append(copy_dups)
        return results, pending

    # -- routes ----------------------------------------------------------------

    def _submit_bs(self, planned: List[_PlannedQuery]) -> list:
        """bs groups by (T, per-shard candidate L bucket), in chunks within
        the bs lane budget. M covers k + margin or the whole per-shard run;
        the merge keeps k + margin (deep k spans shards)."""
        pending = []
        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in planned:
            L = _bucket(int(self._df_shard_max[pq.slot_rows[0]]), L_BUCKETS)
            groups.setdefault((_tbucket(len(pq.rows)), L), []).append(pq)
        for (T, L), members in groups.items():
            chunk = bs_chunk(T, L)
            for ci in range(0, len(members), chunk):
                group = members[ci : ci + chunk]
                B = _bucket(len(group), B_BUCKETS)
                rows, w, idf64_q, slot_of, ks = self._assemble(group, T, B)
                kmax = int(ks.max(initial=1)) + self.margin
                M = min(L, kmax)
                t0 = time.perf_counter()
                out = self.mesh_bs(rows, w, T=T, L=L, M=M,
                                   M_out=min(kmax, M * self.sharded.n_shards))
                dt = time.perf_counter() - t0
                self._bump(dispatch_s=dt, bs_s=dt)
                pending.append(self._finalizer("bs", out, T, group, slot_of,
                                               idf64_q, ks))
        return pending

    def _submit_dense(self, planned: List[_PlannedQuery]) -> list:
        """All-head conjunctions: each shard scans its slice of the dense
        tier, or, with NB >= max(PRUNED_DENSE_MIN_NB, C + 1) blocks per
        shard, ranks its own blocks and scores its top C; the prune guard
        then runs on the merged top-M against the max of the shards'
        next_ub (FLAG_PRUNE_MISS takes the host)."""
        if not planned:
            return []
        pending = []
        NB = self._npd // BLOCK
        C = self.PRUNED_DENSE_C
        pruned = NB >= max(self.PRUNED_DENSE_MIN_NB, C + 1)
        route = "pruned" if pruned else "dense"
        self._bump(**{f"route_{route}": len(planned)})
        groups: Dict[int, List[_PlannedQuery]] = {}
        for pq in planned:
            groups.setdefault(_tbucket(len(pq.rows)), []).append(pq)
        for T, members in groups.items():
            if pruned:
                buckets = self.PRUNED_DENSE_B_BUCKETS
                chunk = _chunk_within(PRUNED_LANE_BUDGET, T * C * 128, buckets)
            else:
                buckets = [8, self.DENSE_CHUNK]
                chunk = self.DENSE_CHUNK
            for ci in range(0, len(members), chunk):
                group = members[ci : ci + chunk]
                B = _bucket(len(group), buckets)
                trows = np.zeros((B, T), dtype=np.int64)
                use = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                ks = np.zeros(B, dtype=np.int32)
                for i, pq in enumerate(group):
                    # query-term order; padded slots repeat the first term
                    n = len(pq.rows)
                    trows[i] = pq.rows + [pq.rows[0]] * (T - n)
                    use[i, :n] = 1.0
                    idf64_q[i, :n] = self.sharded.idf64[pq.rows]
                    ks[i] = pq.query.n_results
                slots = self._dense_slot[trows].astype(np.int32)
                slots[len(group):] = 0
                w = self._weights(trows, use)
                slot_of = np.tile(np.arange(T, dtype=np.int64), (B, 1))
                M = min(int(ks.max(initial=1)) + self.margin, self._npd)
                t0 = time.perf_counter()
                out = self.mesh_dense(slots, w, ks, T=T, M=M, pruned=pruned)
                dt = time.perf_counter() - t0
                self._bump(**{"dispatch_s": dt, f"{route}_s": dt})
                pending.append(self._finalizer(route, out, T, group, slot_of,
                                               idf64_q, ks))
        return pending

    def _submit_semidense(self, planned: List[_PlannedQuery]) -> list:
        """Tail candidate x (dense + short-bs) others, grouped by (T, L,
        number of bs others). Slot layout: 0 = candidate, 1..n_bs = the
        non-dense others, then the dense others; padded slots repeat the
        first dense slot with weight 0."""
        if not planned:
            return []
        pending = []
        self._bump(route_semidense=len(planned))
        groups: Dict[tuple, List[tuple]] = {}
        bs_df_max: Dict[tuple, int] = {}
        for pq in planned:
            # query terms by slot: the candidate, then the others in query
            # order, split into non-dense (bs) and dense ones
            by_slot = np.argsort(pq.slot_of_term).tolist()
            others = by_slot[1:]
            bs_t = [t for t in others if self._dense_slot[pq.rows[t]] < 0]
            dn_t = [t for t in others if self._dense_slot[pq.rows[t]] >= 0]
            T = _tbucket(len(pq.rows))
            L = _bucket(int(self._df_shard_max[pq.slot_rows[0]]), L_BUCKETS)
            key = (T, L, len(bs_t))
            groups.setdefault(key, []).append((pq, [by_slot[0]] + bs_t + dn_t))
            if bs_t:
                mx = max(int(self._df_shard_max[pq.rows[t]]) for t in bs_t)
                bs_df_max[key] = max(bs_df_max.get(key, 0), mx)
        for (T, L, NBs), members in groups.items():
            n_it = (K.n_iters_for(_bucket(bs_df_max.get((T, L, NBs), 1),
                                          L_BUCKETS)) if NBs else 0)
            chunk = _chunk_within(SEMIDENSE_LANE_BUDGET, (T - 1) * L,
                                  B_BUCKETS)
            first_dense = 1 + NBs
            for ci in range(0, len(members), chunk):
                part = members[ci : ci + chunk]
                group = [pq for pq, _ in part]
                B = _bucket(len(group), B_BUCKETS)
                rows = np.zeros((B, T), dtype=np.int64)
                use = np.zeros((B, T), dtype=np.float32)
                slots = np.zeros((B, T), dtype=np.int32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                slot_of = np.zeros((B, T), dtype=np.int64)
                ks = np.zeros(B, dtype=np.int32)
                for i, (pq, order) in enumerate(part):
                    n = len(order)
                    rows[i, :n] = [pq.rows[t] for t in order]
                    use[i, :n] = 1.0
                    slots[i, first_dense:n] = self._dense_slot[
                        rows[i, first_dense:n]]
                    rows[i, n:] = rows[i, first_dense]
                    slots[i, n:] = slots[i, first_dense]
                    slot_of[i, order] = np.arange(n)
                    idf64_q[i, :n] = self.sharded.idf64[pq.rows]
                    ks[i] = pq.query.n_results
                w = self._weights(rows, use)
                kmax = int(ks.max(initial=1)) + self.margin
                M = min(L, kmax)
                t0 = time.perf_counter()
                out = self.mesh_semidense(
                    rows, w, slots, T=T, L=L, M=M, n_bs=NBs, n_bs_iters=n_it,
                    M_out=min(kmax, M * self.sharded.n_shards))
                dt = time.perf_counter() - t0
                self._bump(dispatch_s=dt, semidense_s=dt)
                pending.append(self._finalizer("semidense", out, T, group,
                                               slot_of, idf64_q, ks))
        return pending

    def _submit_phrase(self, planned: List[_PlannedQuery]) -> list:
        """Phrase groups by (T exact, per-shard candidate L bucket, anchor
        bag bucket PP, widest bag bucket PW): the compact pipeline past
        PHRASE_COMPACT_KV lanes when the shards hold bloom columns, else
        phrase_body per shard. Saturated candidates, and groups whose
        per-query lanes exceed the phrase lane budget at the smallest B,
        take the exact host phrase search."""
        if not planned:
            return []
        pending = []
        max_tf = self.sharded.max_tf
        KV = self.PHRASE_COMPACT_KV
        blooms = self.shards[0].bloom_rows is not None
        keep, host = self._route_saturated(planned)
        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in keep:
            L = _bucket(int(self._df_shard_max[pq.slot_rows[0]]), L_BUCKETS)
            PP = _bucket(int(max_tf[pq.rows[0]]), PP_BUCKETS)
            PW = _bucket(max(int(max_tf[r]) for r in pq.rows), PP_BUCKETS)
            compact = blooms and L > KV
            T = len(pq.rows)
            lanes = (max(10 * L, T * KV * PW, KV * PP * PW // 4) if compact
                     else L * PP)
            if lanes * self.PHRASE_B_BUCKETS[0] > PHRASE_LANE_BUDGET:
                host.append(pq)
                continue
            groups.setdefault((T, L, PP, PW, compact), []).append(pq)
        self._bump(route_phrase_host=len(host))
        if host:
            pending.append(self._run_host(host, True))
        for (T, L, PP, PW, compact), members in groups.items():
            lanes = (max(10 * L, T * KV * PW, KV * PP * PW // 4) if compact
                     else L * PP)
            chunk = _chunk_within(PHRASE_LANE_BUDGET, lanes,
                                  self.PHRASE_B_BUCKETS)
            for ci in range(0, len(members), chunk):
                pending.append(self._dispatch_phrase(
                    members[ci : ci + chunk], T, L, PP, PW, compact))
        return pending

    def _dispatch_phrase(self, group: List[_PlannedQuery], T: int, L: int,
                         PP: int, PW: int, compact: bool):
        B = _bucket(len(group), self.PHRASE_B_BUCKETS)
        rows, w, idf64_q, slot_of, ks = self._assemble(group, T, B)
        kmax = int(ks.max(initial=1)) + self.margin
        D = self.sharded.n_shards
        t0 = time.perf_counter()
        if compact:
            route = "phrase_compact"
            M = min(self.PHRASE_COMPACT_KV, kmax)
            out = self.mesh_compact_phrase(
                rows, w, slot_of, ks, self._assemble_bloom_probes(group, T, B),
                T=T, L=L, PP=PP, PW=PW, M=M, M_out=min(kmax, M * D))
        else:
            route = "phrase_list"
            M = min(L, kmax)
            out = self.mesh_phrase(rows, w, slot_of, T=T, L=L, PP=PP, M=M,
                                   M_out=min(kmax, M * D))
        dt = time.perf_counter() - t0
        self._bump(**{"dispatch_s": dt, f"{route}_s": dt,
                      f"route_{route}": len(group)})
        return self._finalizer(route, out, T, group, slot_of, idf64_q, ks,
                               is_phrase=True)
