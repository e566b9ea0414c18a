"""TorchEngine — the device-resident conjunctive search engine in torch
(port of wiser_tpu/engine/device.py TpuEngine, raw columns, without the
dense head-term tier).

The posting columns (doc, f32 partial score, tf) live on the device. The
host does what hosts are good at: term lookup, request coalescing, shape
bucketing, batch assembly, the exact f64 re-rank and its guards.

Routing (as TpuEngine with dense_budget_bytes=0):
  1 term            -> host impact table (deeper k: the bs kernel)
  2..8 terms        -> binary-search intersection (kernels.search_body),
                       grouped by (T bucket, candidate L bucket)
  > 8 terms         -> the same kernel with the exact slot count
  saturated, or candidate L bucket >= HOST_MERGE_MIN_L and not
  windowed-eligible -> memoized exact host search
Windowed-eligible groups take the bs kernel: the windowed block compare
exists for the TPU's slow element gathers, and bs is exact at every L.
Every device result goes through the f64 re-rank (engine/topk.py);
guard-flagged rows take the exact host search.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wiser_tpu_torch.engine import kernels as K
from wiser_tpu_torch.engine.host import (
    B_BUCKETS,
    B_CHUNK,
    DEFAULT_MARGIN,
    L_BUCKETS,
    T_BUCKETS,
    _bucket,
    _PlannedQuery,
    build_single_term_table,
    host_exact_search,
    padded_host_columns,
    tie_class_cut,
)
from wiser_tpu_torch.runtime import resolve_device
from wiser_tpu_torch.shared import (
    Bm25Similarity,
    PackedIndex,
    SearchQuery,
    SearchResult,
    rescore_sorted_arrays,
    truncation_suspects,
)

# Lanes one bs group may hold, B * (T-1) * L. The binary search keeps
# about a dozen live (B, T-1, L) 4-byte tensors (lo, hi, mid, the
# gathered values, the compare, the where results), so 2^28 lanes is
# ~12 GB of intermediates: room on an 80 GB card beside the resident
# columns (~1 GB at 1M docs) and a staged scratch, and wide enough that
# L = 131072 groups (windowed-eligible queries now take bs) still run
# at B = 1024 for T = 3.
BS_LANE_BUDGET = 1 << 28


def _not_phrase(q: SearchQuery) -> None:
    if q.is_phrase and len(q.terms) >= 2:
        raise NotImplementedError(
            "phrase queries are not ported yet (ROADMAP A.8)")


def bs_chunk(T: int, L: int) -> int:
    """Widest B bucket whose bs group stays within BS_LANE_BUDGET."""
    fit = BS_LANE_BUDGET // (max(T - 1, 1) * L)
    chunk = B_BUCKETS[0]
    for b in B_BUCKETS:
        if b <= min(fit, B_CHUNK):
            chunk = b
    return chunk


class TorchEngine:
    MAX_T = 8  # slot buckets of the vectorized flat path
    # routing thresholds, as TpuEngine
    WINDOWED_MIN_L = 1024
    WINDOWED_MAX_RATIO = 4
    WINDOWED_MAX_L = 131072
    HOST_MERGE_MIN_L = 131072
    # dense-tier eligibility, kept only to refuse budgets that would admit
    # a row (the tier is not ported)
    DENSE_ELIGIBLE_FRACTION = 384
    DENSE_MIN_DF_FLOOR = 1024
    HOST_CACHE_CAP = 200_000

    def __init__(self, packed: PackedIndex, *, device,
                 margin: int = DEFAULT_MARGIN,
                 single_term_depth: int = 64,
                 dense_budget_bytes: int = 0,
                 strict_parity: bool = False,
                 columns: str = "raw",
                 dense_from: Optional[PackedIndex] = None,
                 host_packed: Optional[PackedIndex] = None):
        """packed: the index whose posting runs go to the device.
        host_packed: the index the exact host fallback searches (a staged
        hot view passes the full index here). dense_from: the index the
        dense tier would be built from (staged). device: "cpu" or "cuda"
        (raises when CUDA is asked for and absent)."""
        if columns != "raw":
            raise NotImplementedError(
                f"columns={columns!r}: only raw columns are ported (ROADMAP A.7)")
        self.device = resolve_device(device)
        self.columns = columns
        self.packed = packed
        self._host_packed = host_packed if host_packed is not None else packed
        self.strict_parity = strict_parity
        self.margin = margin
        self.rel_eps = 1e-6  # f32 summation slop bound of the raw columns
        self._lb = list(L_BUCKETS)
        self._tb = list(T_BUCKETS)
        if packed.n_postings >= 2**31:
            raise ValueError("index too large for int32 device addressing")
        self._refuse_dense_rows(dense_from or packed, dense_budget_bytes)
        self._dense_slot = np.full(packed.n_terms, -1, dtype=np.int32)

        self.similarity = Bm25Similarity(packed.avg_len)
        self.cache64 = self.similarity.cache  # (256,) f64
        scores64 = packed.partial_scores(self.cache64)
        self._h_doc, self._h_score, self._h_tf = padded_host_columns(
            packed, scores64, self._lb)
        self.d_postings_doc = torch.from_numpy(self._h_doc).to(self.device)
        self.d_postings_score = torch.from_numpy(self._h_score).to(self.device)
        self.d_postings_tf = torch.from_numpy(self._h_tf).to(self.device)

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

    def _refuse_dense_rows(self, src: PackedIndex, budget_bytes: int) -> None:
        """Raise if TpuEngine would build at least one dense row under
        this budget; otherwise the tier is empty in both engines."""
        if not budget_bytes:
            return
        dense_min = max(self.DENSE_MIN_DF_FLOOR,
                        src.n_docs // self.DENSE_ELIGIBLE_FRACTION)
        eligible = (src.df >= dense_min) & (np.diff(src.term_starts) > 0)
        n_pad = (src.n_docs + 127) // 128 * 128
        per_row = n_pad * 8 + (n_pad // 128) * 9
        if eligible.any() and budget_bytes // per_row > 0:
            raise NotImplementedError(
                f"dense_budget_bytes={budget_bytes} admits dense head-term "
                "rows; the dense tier is not ported yet (ROADMAP A.6)")

    # -- accounting -------------------------------------------------------

    def device_bytes(self) -> dict:
        """Device-resident index bytes per column family. Only the
        posting columns the conjunctive path reads are uploaded; position
        bags and bloom columns come with the phrase path, and the dense
        tier is not ported, so those families are 0."""
        out = {
            "postings": int(sum(t.numel() * t.element_size() for t in (
                self.d_postings_doc, self.d_postings_score, self.d_postings_tf))),
            "positions": 0,
            "dense_tier": 0,
            "blooms": 0,
        }
        out["total"] = sum(out.values())
        return out

    def _bump(self, **deltas) -> None:
        for k, v in deltas.items():
            self.stats[k] = self.stats.get(k, 0) + v

    def stats_take(self) -> Dict[str, float]:
        """Return and reset the counters."""
        out, self.stats = self.stats, {}
        return out

    def clear_result_memos(self) -> None:
        self._host_cache.clear()

    def _host_exact(self, rows, k: int):
        """Memoized exact host search."""
        key = (tuple(rows), int(k))
        hit = self._host_cache.get(key)
        if hit is None:
            if len(self._host_cache) >= self.HOST_CACHE_CAP:
                self._host_cache.clear()
            t0 = time.perf_counter()
            hit = host_exact_search(self._host_packed, self.cache64, rows, k)
            self._bump(host_exact_calls=1,
                       host_exact_s=time.perf_counter() - t0)
            self._host_cache[key] = hit
        else:
            self._bump(host_exact_hits=1)
        return hit

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        queries' results) run last."""
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
        long_tail: List[_PlannedQuery] = []
        # request coalescing: identical (rows, k) queries run once
        dedup: Dict[tuple, int] = {}
        dups: List[tuple] = []
        n_single = 0
        for qi, q in enumerate(queries):
            _not_phrase(q)
            terms = q.terms
            if q.n_results <= 0 or not terms:
                continue
            rows = [lookup(t, -1) for t in terms]
            if min(rows) < 0:
                continue  # missing term -> empty result
            key = (tuple(rows), q.n_results)
            prim = dedup.get(key)
            if prim is not None:
                dups.append((qi, prim))
                continue
            dedup[key] = qi
            if (len(rows) == 1 and self._st_depth
                    and self._serve_single_term(qi, rows[0], q, results)):
                n_single += 1
                continue
            if len(rows) > self.MAX_T:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                long_tail.append(pq)
            else:
                flat_qi.append(qi)
                flat_rows.append(rows)
        self._bump(q_coalesced=len(dups), route_single_table=n_single)

        pending = self._submit_flat_vec(flat_qi, flat_rows, queries)
        pending += self._submit_flat(long_tail)
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

    def _submit_flat_vec(self, flat_qi, flat_rows, queries):
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
        any_missing = (~self._csr_ok[rows_pad] & valid).any(axis=1)

        lb = np.asarray(self._lb, dtype=np.int64)
        L_idx = np.minimum(np.searchsorted(lb, cand_df), len(lb) - 1)
        l2 = np.max(np.where(valid, dfs, 0), axis=1)
        L2val = lb[np.minimum(np.searchsorted(lb, l2), len(lb) - 1)]
        Lval = lb[L_idx]
        windowed = ((n_terms > 1) & (Lval >= self.WINDOWED_MIN_L)
                    & (Lval <= self.WINDOWED_MAX_L)
                    & (L2val // Lval <= self.WINDOWED_MAX_RATIO))
        tb = np.asarray(self._tb, dtype=np.int64)
        T_idx = np.minimum(np.searchsorted(tb, n_terms), len(tb) - 1)

        pending = []
        # candidate lists past the largest L bucket would be scanned only
        # in part: exact host path, single terms included
        saturated = cand_df.astype(np.int64) > int(lb[-1])
        host_merge = (((n_terms > 1) & (Lval >= self.HOST_MERGE_MIN_L)
                       & ~windowed) | saturated | any_missing)
        self._bump(route_host_merge=int(host_merge.sum()),
                   route_bs_windowed=int((windowed & ~host_merge).sum()),
                   route_bs=int((~host_merge).sum()))
        if host_merge.any():
            hm = np.nonzero(host_merge)[0]

            def run_host_merge(res_list, hm=hm, qi_arr=qi_arr,
                               flat_rows=flat_rows, ks=ks):
                for i in hm:
                    d, s = self._host_exact(flat_rows[i], int(ks[i]))
                    res_list[int(qi_arr[i])].set_arrays(d, s)

            pending.append(run_host_merge)
            keep = ~host_merge
            if not keep.any():
                return pending
            qi_arr, n_terms, rows_pad, ks, valid, cand, T_idx, L_idx = (
                qi_arr[keep], n_terms[keep], rows_pad[keep], ks[keep],
                valid[keep], cand[keep], T_idx[keep], L_idx[keep])
            flat_rows = [flat_rows[i] for i in np.nonzero(keep)[0]]

        key = T_idx.astype(np.int64) * 1000 + L_idx * 10
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
            chunk = bs_chunk(T, L)
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
                    T, L, starts, ends, use_score, idf64_q, slot_of, ks_g,
                    qi_arr[m], flat_rows, m))
        return pending

    def _dispatch_flat(self, T, L, starts, ends, use_score, idf64_q,
                       slot_of, ks, qis, flat_rows, members):
        M = min(L, int(ks.max(initial=1)) + self.margin)
        kern = K.make_search_kernel(T, L, M, K.n_iters_for(self._max_df))
        t0 = time.perf_counter()
        out = kern(self.d_postings_doc, self.d_postings_score,
                   self.d_postings_tf, self._to_dev(starts),
                   self._to_dev(ends), self._to_dev(use_score))
        # host time to enqueue the group (it blocks when the card's launch
        # queue is full, so device-bound batches show up here too)
        self._bump(dispatch_s=time.perf_counter() - t0)

        def finalize(res_list):
            t0 = time.perf_counter()
            packed = out.cpu().numpy()  # one device-to-host copy
            # the wait covers device compute still in flight + the copy
            self._bump(fetch_wait_s=time.perf_counter() - t0)
            self._finalize_arrays(
                packed[:, 0, :], packed[:, 1 : T + 1, :], packed[:, T + 1, 0],
                slot_of, idf64_q, ks, qis, flat_rows, members, res_list)

        return finalize

    def _flags_to_force(self, flags: np.ndarray) -> np.ndarray:
        """Kernel flag word -> host-fallback mask. Window overflow, tf
        saturation and prune misses always force the exact path (the bs
        kernel raises none of them); FLAG_TRUNC forces only under
        strict_parity — a truncated tie class breaks parity only when an
        excluded member f32-collides with a distinct f64 score."""
        force = (flags & (K.FLAG_OVERFLOW | K.FLAG_TF_SAT
                          | K.FLAG_PRUNE_MISS)) != 0
        if self.strict_parity:
            force = force | ((flags & K.FLAG_TRUNC) != 0)
        self._bump(q_flag_seen=len(flags),
                   flag_trunc=int(((flags & K.FLAG_TRUNC) != 0).sum()),
                   forced_host=int(force.sum()))
        return force

    def _finalize_arrays(self, top_docs, top_tfs_slot, flags, slot_of,
                         idf64_q, ks, qis, flat_rows, members, results):
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
                    | cut | self._flags_to_force(flags))
        self._bump(host_fallback_q=int(suspects[:n].sum()),
                   forced_host_tie_cut=int(cut[:n].sum()),
                   rescore_s=time.perf_counter() - t0)
        cnts = np.minimum(ks[:n], n_valid[:n])
        for i in range(n):
            res = results[int(qis[i])]
            if suspects[i]:
                d, s = self._host_exact(flat_rows[int(members[i])], int(ks[i]))
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

    def _assemble(self, group: List[_PlannedQuery], T: int):
        """Slot-ordered (starts, ends, use_score) + query-order f64
        metadata for the re-rank."""
        B = _bucket(len(group), B_BUCKETS)
        starts = np.zeros((B, T), dtype=np.int32)
        ends = np.zeros((B, T), dtype=np.int32)
        use_score = np.zeros((B, T), dtype=np.float32)
        idf64_q = np.zeros((B, T), dtype=np.float64)  # query-term order
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        for i, pq in enumerate(group):
            ks[i] = pq.query.n_results
            srows = pq.slot_rows
            for t in range(T):
                r = srows[t] if t < len(srows) else srows[0]
                starts[i, t] = self._starts32[r]
                ends[i, t] = self._starts32[r] + self._df32[r]
                if t < len(srows):
                    use_score[i, t] = 1.0
            for t, qr in enumerate(pq.rows):
                idf64_q[i, t] = self.packed.idf64[qr]
                slot_of[i, t] = pq.slot_of_term[t]
        return starts, ends, use_score, idf64_q, slot_of, ks

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
        starts, ends, use_score, idf64_q, slot_of, ks = self._assemble(group, T)
        members = np.arange(len(group))
        return self._dispatch_flat(
            T, L, starts, ends, use_score, idf64_q, slot_of, ks,
            np.asarray([pq.qi for pq in group], dtype=np.int64),
            [pq.rows for pq in group], members)
