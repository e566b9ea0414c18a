"""StagedEngine — host-to-device posting staging for indexes larger than
device memory (port of wiser_tpu/engine/staged.py).

The paper's "read as needed": a hot tier of posting columns, position
bags, bloom rows and dense head-term rows stays on the device (a
TorchEngine over a hot view of the index, chosen within a byte budget;
its dense rows come from the full index, so a head term is served
dense-only while its CSR run is cold). A term query or conjunction goes
hot when every term is CSR-hot or dense; a phrase query only when every
term is CSR-hot and phrase-hot (its bags and bloom rows resident), and
then takes the hot engine's phrase routes. Every other query is cold:
with COLD_COMPUTE = "host" (the default) the memoized exact host search
answers it; with "device" the posting runs it needs are staged per batch
into a scratch column set and the bs step (flat queries) or the
bloomless phrase_body (phrase queries, over staged position bags) runs
against it. With cold_transfer="packed", staged doc ids whose block
deltas fit PACK_WIDTH bits ship bit-packed and are decoded on the device
by the hand-written CUDA kernel (ops/unpack.py); wider runs ship raw in
a trailing segment. With columns="tc" the hot tier is a TorchEngine over
tc columns (6 B per posting, 1 B per dense row per doc, so a budget holds
more of the index) and the cold scratch ships one uint16 tc lane per
posting for flat queries; a chunk holding phrases also ships the raw f32
score and int32 tf columns, which phrase_body reads.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from wiser_tpu_torch.engine import kernels as K
from wiser_tpu_torch.engine.device import (
    BS_LANE_BUDGET,
    PHRASE_LANE_BUDGET,
    TorchEngine,
    _chunk_within,
    bs_chunk,
)
from wiser_tpu_torch.engine.host import (
    B_BUCKETS,
    L_BUCKETS,
    PP_BUCKETS,
    _bucket,
    build_single_term_table,
    host_exact_search,
    tie_class_cut,
)
from wiser_tpu_torch.ops.unpack import (
    combine_doc_column,
    doc_block_deltas,
    doc_block_widths,
)
from wiser_tpu_torch.engine.topk import rescore_sorted_arrays, truncation_suspects
from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.native import lib as native
from wiser_tpu_torch.runtime import resolve_device
from wiser_tpu_torch.scoring import Bm25Similarity
from wiser_tpu_torch.types import SearchQuery, SearchResult

# CHUNK_LIMIT bounds a cold chunk's staged postings; the top scratch
# bucket is 2x that because the packed-transport cap must also cover
# A_total + Grawb*BLOCK, whose raw-segment bucket rounding can add up to
# ~2^23 on top of the chunk itself.
CHUNK_LIMIT = 1 << 23
SCRATCH_BUCKETS = [1 << 15, 1 << 17, 1 << 19, 1 << 21, 1 << 23, 1 << 24]
# cold-path shape buckets (coarser than the resident engine's)
COLD_L_BUCKETS = [8192, 65536, 524288, L_BUCKETS[-1]]
COLD_B_BUCKETS = [128, 1024, B_BUCKETS[-1]]
COLD_T_BUCKETS = [1, 2, 4, 8]
# Multi-term cold queries above this candidate df take the exact host
# path. Without it a cold bs group at the top L bucket (2^21) would need
# B*(T-1)*2^21 lanes of intermediates (tens of GB at B = 4096); revisit
# once the cold bs groups are lane-budgeted like the resident ones.
COLD_L_MAX_MULTI = 524288
BYTES_PER_POSTING = 12  # doc + tf + score columns (raw layout)
BYTES_PER_POSTING_TC = 6  # doc + uint16 tc lane (compressed layout)
# the resident engine stores bloom rows only for terms up to this df
BLOOM_DF_CEILING = 32768
# packed cold transport: blocks whose delta width fits PACK_WIDTH ship
# bit-packed and decode on the device; wider blocks ship raw
PACK_WIDTH = 16
_G16_BUCKETS = [1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16]
_GRAW_BUCKETS = [1 << 6, 1 << 9, 1 << 12, 1 << 16]
# the re-rank guard width of raw f32 scores (cold phrases score from the
# raw scratch under either columns mode)
RAW_REL_EPS = 1e-6


def _is_phrase(q: SearchQuery) -> bool:
    """A phrase query in the routing sense: a single-term phrase is a
    term query."""
    return q.is_phrase and len(q.terms) >= 2


def per_term_device_cost(packed: PackedIndex, columns: str = "raw",
                         split: bool = False) -> np.ndarray:
    """int64[n_terms] device bytes a term costs when resident, as the
    JAX engine lays it out: CSR posting columns (+ the int32 pos_starts
    lane), position bags and the term's share of the sparse bloom
    columns — what the hot TorchEngine uploads for it — so the hot/cold
    split is the reference's.

    With split=True returns (core, phrase): core serves boolean/ranked
    queries, phrase (position bags + bloom rows) only phrase queries."""
    lens = np.diff(packed.term_starts).astype(np.int64)
    bpp = BYTES_PER_POSTING_TC if columns == "tc" else BYTES_PER_POSTING
    core = lens * (bpp + 4)  # +4: int32 pos_starts per posting
    s = packed.term_starts
    pos_cnt = (packed.pos_starts[s[1:]]
               - packed.pos_starts[s[:-1]]).astype(np.int64)
    pos_b = 2 if (len(packed.positions) == 0
                  or int(packed.positions.max(initial=0)) < 2**16 - 1) else 4
    phrase = pos_cnt * pos_b
    if packed.bloom_ends is not None:
        gate = packed.df <= BLOOM_DF_CEILING
        for rows in (packed.bloom_ends, packed.bloom_begins):
            fold = rows[:, 0].copy()
            for w in range(1, rows.shape[1]):
                np.bitwise_or(fold, rows[:, w], out=fold)
            stored = (fold != 0) & np.repeat(gate, lens)
            csum = np.zeros(len(stored) + 1, dtype=np.int64)
            np.cumsum(stored, out=csum[1:])
            phrase += (csum[s[1:]] - csum[s[:-1]]) * 4
        # presence bitmap + rank lane, both sides: ~0.5 B per posting
        core += (lens + 1) // 2
    if split:
        return core, phrase
    return core + phrase


def _dense_eligible(packed: PackedIndex) -> np.ndarray:
    return packed.df >= max(TorchEngine.DENSE_MIN_DF_FLOOR,
                            packed.n_docs // TorchEngine.DENSE_ELIGIBLE_FRACTION)


def _full_shares(packed: PackedIndex, cost_core: np.ndarray,
                 cost_phr: np.ndarray, columns: str = "raw"):
    """(dense, core, phrase) bytes at full residency: every eligible
    dense row (capped as TorchEngine caps the tier; tc adds the shared
    len-code row), every CSR core and every phrase component."""
    n_pad = (packed.n_docs + 127) // 128 * 128
    per_row = n_pad * (1 if columns == "tc" else 8) + (n_pad // 128) * 9
    h_cap = max(0, (2**31 - 1) // max(n_pad // 128, 1) - 1)
    full_dense = (min(int(_dense_eligible(packed).sum()), h_cap) * per_row
                  + (n_pad if columns == "tc" else 0))
    return full_dense, int(cost_core.sum()), int(cost_phr.sum())


def full_residency_bytes(packed: PackedIndex, columns: str = "raw") -> int:
    """The staged planner's full-residency byte count (StagedEngine
    .total_full), the base of its budget shares: a caller asks for a
    fraction of it. full_device_bytes counts the dense tier at
    TorchEngine's default budget instead; this counts every eligible
    dense row."""
    return max(1, sum(_full_shares(
        packed, *per_term_device_cost(packed, columns, split=True),
        columns)))


def dense_tier_bytes(packed: PackedIndex, columns: str = "raw",
                     budget_bytes: int = None) -> int:
    """Device bytes of TorchEngine's dense head-term tier under
    budget_bytes (default: TorchEngine's default dense budget), computed
    without building it: row plane + the f32 blockmax / blockmax2 and
    uint8 argpos planes (+ the shared len-code row with tc columns). The
    row cap is the JAX package's formula, so the two agree."""
    if budget_bytes is None:
        budget_bytes = TorchEngine.__init__.__kwdefaults__["dense_budget_bytes"]
    if not budget_bytes:
        return 0
    n = packed.n_docs
    n_pad = (n + 127) // 128 * 128
    dense_min = max(TorchEngine.DENSE_MIN_DF_FLOOR,
                    n // TorchEngine.DENSE_ELIGIBLE_FRACTION)
    per_row = n_pad * (1 if columns == "tc" else 8) + (n_pad // 128) * 9
    cap = min(int(budget_bytes // per_row), (2**31 - 1) // n_pad - 1)
    H = min(int((packed.df >= dense_min).sum()), cap)
    if H <= 0:
        return 0
    return H * per_row + (n_pad if columns == "tc" else 0)


def full_device_bytes(packed: PackedIndex, columns: str = "raw") -> int:
    """Device footprint of an unconstrained TorchEngine over `packed`
    (every term resident, the dense tier at the default budget): the
    base of the memory grid's budget fractions (bench/run_exp.py), as in
    the JAX package. The staged planner's own base is
    full_residency_bytes."""
    return (int(per_term_device_cost(packed, columns).sum())
            + dense_tier_bytes(packed, columns))


def _hot_view(packed: PackedIndex, hot: np.ndarray, phrase_hot: np.ndarray):
    """A PackedIndex whose posting columns hold only the `hot` terms; cold
    terms keep their real df (global stats stay global) on zero-length
    runs. Every per-posting column (docs, tfs, position/offset bags, bloom
    rows) is remapped through the same gather; phrase-cold terms get
    empty position bags and zeroed bloom rows."""
    lens = np.diff(packed.term_starts)
    new_starts = np.zeros(packed.n_terms + 1, dtype=np.int64)
    np.cumsum(np.where(hot, lens, 0), out=new_starts[1:])
    P_hot = int(new_starts[-1])
    gather = np.empty(P_hot, dtype=np.int64)
    keep_pos = np.empty(P_hot, dtype=bool)
    for r in np.nonzero(hot)[0]:
        s_old, n = int(packed.term_starts[r]), int(lens[r])
        s_new = int(new_starts[r])
        gather[s_new : s_new + n] = np.arange(s_old, s_old + n)
        keep_pos[s_new : s_new + n] = bool(phrase_hot[r])
    doc = packed.postings_doc[gather].astype(np.int32, copy=False)
    tf = packed.postings_tf[gather].astype(np.int32, copy=False)

    def _regather_csr(starts: np.ndarray, *payloads, keep=None):
        seg_lens = np.diff(starts)[gather]
        if keep is not None:
            seg_lens[~keep] = 0
        new_csr = np.zeros(P_hot + 1, dtype=np.int64)
        np.cumsum(seg_lens, out=new_csr[1:])
        outs = tuple(np.empty(int(new_csr[-1]), dtype=p.dtype) for p in payloads)
        # slabbed ragged gather bounds the int64 index temporary
        CH = 1 << 25
        for s0 in range(0, P_hot, CH):
            s1 = min(s0 + CH, P_hot)
            t0, t1 = int(new_csr[s0]), int(new_csr[s1])
            if t1 == t0:
                continue
            lens_sl = seg_lens[s0:s1]
            idx = (np.repeat(starts[gather[s0:s1]], lens_sl)
                   + np.arange(t1 - t0, dtype=np.int64)
                   - np.repeat(new_csr[s0:s1] - t0, lens_sl))
            for p, o in zip(payloads, outs):
                o[t0:t1] = p[idx]
        return (new_csr,) + outs

    pos_starts, positions = _regather_csr(packed.pos_starts, packed.positions,
                                          keep=keep_pos)
    off_starts, off_begin, off_end = _regather_csr(
        packed.off_starts, packed.off_begin, packed.off_end)
    bloom_ends = (packed.bloom_ends[gather]
                  if packed.bloom_ends is not None else None)
    bloom_begins = (packed.bloom_begins[gather]
                    if packed.bloom_begins is not None else None)
    if bloom_ends is not None and not keep_pos.all():
        bloom_ends[~keep_pos] = 0
        bloom_begins[~keep_pos] = 0
    return replace(
        packed, term_starts=new_starts, postings_doc=doc, postings_tf=tf,
        pos_starts=pos_starts, positions=positions, off_starts=off_starts,
        off_begin=off_begin, off_end=off_end, bloom_ends=bloom_ends,
        bloom_begins=bloom_begins, term_to_row=packed.term_to_row,
        idf64=packed.idf64, max_tf=packed.max_tf)


class StagedEngine:
    # Cold compute backend: "host" answers every cold query with the
    # memoized exact host search; "device" stages the cold runs to a
    # scratch column set and runs the bs kernel on the card. The default
    # is the reference's; changing it is a measured decision.
    COLD_COMPUTE = "host"
    COLD_HOST_CACHE_CAP = 200_000

    def __init__(self, packed: PackedIndex, hbm_budget_bytes: int, *,
                 device="cuda", margin: int = 54, strict_parity: bool = False,
                 columns: str = "raw", cold_transfer: str = "packed",
                 doc_bodies=None, term_weights=None):
        """hbm_budget_bytes: the total device budget. It splits across the
        dense rows, CSR cores and phrase components by their
        full-residency byte shares (total_full), spilling unspendable
        remainders dense -> core -> phrase (the reference's
        proportional-share planner). columns: "raw" or "tc" (the hot
        tier's and the cold scratch's layout). doc_bodies: the bodies by doc
        id, for snippets (hot queries get theirs from the hot engine).
        term_weights: per-term admission weights (e.g. a query log's
        per-batch presence counts); CSR terms are admitted by weight desc,
        then df desc (None: by df).
        device: "cuda" (default; raises without a card) or "cpu"."""
        if cold_transfer not in ("raw", "packed"):
            raise ValueError(f"unknown cold_transfer {cold_transfer!r}")
        if columns not in ("raw", "tc"):
            raise ValueError(f"unknown columns mode {columns!r}")
        self.device = resolve_device(device)
        self.cold_transfer = cold_transfer
        self.columns = columns
        self.packed = packed
        self.strict_parity = strict_parity
        cost_core, cost_phr = per_term_device_cost(packed, columns, split=True)
        full_dense, full_core, full_phr = _full_shares(packed, cost_core,
                                                       cost_phr, columns)
        eligible = _dense_eligible(packed)
        self.total_full = total_full = max(1, full_dense + full_core + full_phr)
        B = int(hbm_budget_bytes)
        if B >= total_full - total_full // 1000:
            dense_budget, core_budget, phrase_budget = (
                full_dense, full_core, full_phr)
        else:
            s_dense = B * full_dense // total_full
            s_core = B * full_core // total_full
            s_phr = B - s_dense - s_core
            dense_budget = min(full_dense, s_dense)
            carry = s_dense - dense_budget
            core_budget = min(full_core, s_core + carry)
            carry = s_core + carry - core_budget
            phrase_budget = s_phr + carry

        # CSR admission: weight desc (df when unweighted), then df desc,
        # dense-eligible terms last (their dense rows serve every
        # non-phrase shape)
        w = (np.asarray(term_weights, dtype=np.float64)
             if term_weights is not None else packed.df.astype(np.float64))
        order = np.lexsort((-packed.df, -w, eligible))
        hot = np.zeros(packed.n_terms, dtype=bool)
        used = 0
        for r in order:
            run = int(cost_core[r])
            if used + run > core_budget:
                continue
            used += run
            hot[r] = True
        phrase_hot = np.zeros(packed.n_terms, dtype=bool)
        used_p = 0
        for r in order:
            if not hot[r]:
                continue
            run = int(cost_phr[r])
            if used_p + run > phrase_budget:
                continue
            used_p += run
            phrase_hot[r] = True
        self.hot_mask = hot
        self.phrase_hot_mask = phrase_hot
        self.hot = TorchEngine(
            _hot_view(packed, hot, phrase_hot), device=self.device,
            margin=margin, strict_parity=strict_parity, columns=columns,
            dense_budget_bytes=dense_budget, dense_from=packed,
            host_packed=packed, single_term_depth=0, doc_bodies=doc_bodies)
        self.doc_bodies = doc_bodies
        self.dense_mask = self.hot._dense_slot >= 0
        self.hot_bytes_used = int(
            used + used_p + self.hot.device_bytes()["dense_tier"])
        self.margin = margin
        self.similarity = Bm25Similarity(packed.avg_len)
        self.cache64 = self.similarity.cache
        scores64 = packed.partial_scores(self.cache64)
        # the raw cold scratch's score column; tc stages tc lanes for flat
        # queries and computes the raw scores of a phrase chunk's runs
        # (_run_scores32)
        self._scores32 = (scores64.astype(np.float32) if columns == "raw"
                          else None)
        self._n_pos_iters = K.n_iters_for(int(packed.max_tf.max(initial=1)))
        # full-index single-term impact table (host RAM, any budget)
        self._st_depth = 64
        self._tt_starts, self._tt_docs, self._tt_scores = \
            build_single_term_table(packed, scores64, self._st_depth)
        del scores64
        self._starts32 = packed.term_starts.astype(np.int32)
        self._df32 = packed.df.astype(np.int32)
        self._lens = np.diff(packed.term_starts).astype(np.int64)
        self._max_df = int(packed.df.max(initial=1))
        self._cold_host_cache: Dict[tuple, tuple] = {}
        self.stats: Dict[str, float] = {}
        if cold_transfer == "packed":
            # per-term "every block packs at PACK_WIDTH" flag (runs are
            # 128-aligned, so a term's blocks are one contiguous range)
            bw = doc_block_widths(packed.postings_doc)
            tb0 = (packed.term_starts[:-1] // BLOCK).astype(np.int64)
            self._pack16 = (np.maximum.reduceat(bw, tb0) <= PACK_WIDTH
                            if len(bw) else np.zeros(0, dtype=bool))
        if columns == "tc":
            self._code_u16 = packed.doc_len_code.astype(np.uint16)

    @property
    def hot_fraction(self) -> float:
        return float(self.hot_mask.mean()) if len(self.hot_mask) else 0.0

    @property
    def phrase_hot_fraction(self) -> float:
        """Share of terms whose phrase components (position bags and bloom
        rows) are resident."""
        return (float(self.phrase_hot_mask.mean())
                if len(self.phrase_hot_mask) else 0.0)

    def device_bytes(self) -> dict:
        """Resident (hot-tier) device bytes."""
        return self.hot.device_bytes()

    def search(self, query: SearchQuery) -> SearchResult:
        return self.search_batch([query])[0]

    def search_batch(self, queries: List[SearchQuery]) -> List[SearchResult]:
        results, pending = self.submit_batch(queries)
        self.run_pending(results, pending)
        return results

    def run_pending(self, results, pending) -> None:
        self.hot.run_pending(results, pending)

    def _bump(self, **deltas) -> None:
        for k, v in deltas.items():
            self.stats[k] = self.stats.get(k, 0) + v

    def stats_take(self) -> Dict[str, float]:
        """Return and reset the cold-path counters merged with the hot
        engine's (hot keys prefixed "hot_")."""
        out, self.stats = self.stats, {}
        for k, v in self.hot.stats_take().items():
            out[f"hot_{k}"] = v
        return out

    def _serve_single(self, qi: int, row: int, q: SearchQuery,
                      results: List[SearchResult]) -> bool:
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
        results = [SearchResult() for _ in queries]
        lookup = self.packed.term_to_row.get
        hot_q: List[SearchQuery] = []
        hot_qi: List[int] = []
        cold: List[Tuple[int, List[int], SearchQuery]] = []
        snips: List[Tuple[int, List[int], SearchQuery]] = []  # off the hot tier
        hot_mask, phrase_mask = self.hot_mask, self.phrase_hot_mask
        for qi, q in enumerate(queries):
            if q.n_results <= 0 or not q.terms:
                continue
            rows = [lookup(t, -1) for t in q.terms]
            if min(rows) < 0:
                continue
            if len(rows) == 1 and self._serve_single(qi, rows[0], q, results):
                self._bump(route_single_table=1)
                if q.return_snippets:
                    snips.append((qi, rows, q))
                continue
            if _is_phrase(q):
                # the phrase routes read CSR runs, position bags and bloom
                # rows: the hot view holds the latter two only for
                # phrase-hot terms
                ok = all(hot_mask[r] and phrase_mask[r] for r in rows)
            else:
                # a dense row serves every non-phrase shape (the hot
                # engine's planner fences csr-cold rows off list routes)
                ok = all(hot_mask[r] or self.dense_mask[r] for r in rows)
            if ok:
                hot_q.append(q)
                hot_qi.append(qi)
            else:
                cold.append((qi, rows, q))
                if q.return_snippets:
                    snips.append((qi, rows, q))

        hot_results, hot_pending = self.hot.submit_batch(hot_q)
        for j, qi in enumerate(hot_qi):
            results[qi] = hot_results[j]  # shared objects, filled below
        # inner finalizers index the inner batch: bind them to hot_results
        pending = []
        for f in hot_pending:
            w = (lambda res_list, f=f: f(hot_results))
            if getattr(f, "barrier", False):
                w.barrier = True
            pending.append(w)
        pending += self._submit_cold(cold)
        if snips and self.doc_bodies is not None:
            # the cold and saturated answers share memoized arrays, but
            # each result makes its own entries: a snippet stays with the
            # query that asked for it
            def fill_snippets(res_list, snips=snips):
                for qi, rows, q in snips:
                    self.hot.fill_snippets(res_list[qi], rows, q)

            fill_snippets.barrier = True  # after every cold finalizer
            pending.append(fill_snippets)
        return results, pending

    # -- cold path -------------------------------------------------------

    def _host_exact_memo(self, rows, k: int, is_phrase: bool = False):
        key = (tuple(rows), int(k), bool(is_phrase))
        hit = self._cold_host_cache.get(key)
        if hit is None:
            if len(self._cold_host_cache) >= self.COLD_HOST_CACHE_CAP:
                self._cold_host_cache.clear()
            hit = host_exact_search(self.packed, self.cache64, rows, k,
                                    is_phrase=is_phrase)
            self._cold_host_cache[key] = hit
        return hit

    def clear_result_memos(self) -> None:
        self._cold_host_cache.clear()
        self.hot.clear_result_memos()

    def _submit_cold(self, cold):
        """Chunk the cold set so each chunk's staged postings fit the
        largest scratch bucket, then stage chunk by chunk."""
        if not cold:
            return []
        if self.COLD_COMPUTE == "host":
            self._bump(route_cold_host=len(cold))

            def run_host_cold(res_list, cold=cold):
                for qi, rows, q in cold:
                    res_list[qi].set_arrays(*self._host_exact_memo(
                        rows, q.n_results, _is_phrase(q)))

            return [run_host_cold]

        pending = []

        def _is_sat(item):
            rows = item[1]
            mn = min(int(self._df32[r]) for r in rows)
            return mn > (COLD_L_MAX_MULTI if len(rows) > 1 else L_BUCKETS[-1])

        sat = [it for it in cold if _is_sat(it)]
        if sat:
            cold = [it for it in cold if not _is_sat(it)]
            self._bump(route_cold_sat_host=len(sat))

            def run_host_sat(res_list, sat=sat):
                t0 = time.perf_counter()
                for qi, rows, q in sat:
                    res_list[qi].set_arrays(*host_exact_search(
                        self.packed, self.cache64, rows, q.n_results,
                        is_phrase=_is_phrase(q)))
                self._bump(cold_sat_host_s=time.perf_counter() - t0)

            pending.append(run_host_sat)
        slack = _bucket(
            max((int(self._df32[r]) for it in cold for r in it[1]),
                default=1), COLD_L_BUCKETS)
        limit = CHUNK_LIMIT - slack
        # queries that share their longest runs go in one chunk: ordered by
        # their rows, longest run first, a batch restages each head run
        # once per chunk of its queries, not once per chunk of the batch
        # (the chunks differ from the reference's; no result does)
        cold = sorted(cold, key=lambda it: sorted(
            it[1], key=lambda r: (-int(self._lens[r]), r)))
        chunk, seen, tot = [], set(), 0
        for item in cold:
            new = sorted(set(item[1]) - seen)
            add = int(self._lens[new].sum()) if new else 0
            if chunk and tot + add > limit:
                pending += self._submit_cold_chunk(chunk)
                chunk, seen, tot = [], set(), 0
                new = sorted(set(item[1]))
                add = int(self._lens[new].sum())
            if add > limit and not chunk:
                raise ValueError(
                    f"single cold query stages {add} postings > scratch "
                    f"capacity {limit}; raise SCRATCH_BUCKETS")
            chunk.append(item)
            seen.update(new)
            tot += add
        if chunk:
            pending += self._submit_cold_chunk(chunk)
        return pending

    def _run_scores32(self, r: int, src: int, n: int) -> np.ndarray:
        """The f32 partial-score column of term r's padded run (n postings
        from src): a slice of the raw engine's baked column, or under tc
        the same f64 expression (PackedIndex.partial_scores) computed for
        this run only, so the tc engine keeps no per-posting score array."""
        if self._scores32 is not None:
            return self._scores32[src : src + n]
        pk = self.packed
        docs = pk.postings_doc[src : src + n]
        valid = docs != SENTINEL_DOC
        code = pk.doc_len_code[np.where(valid, docs, 0).astype(np.int64)] & 0xFF
        tf = pk.postings_tf[src : src + n].astype(np.float64)
        sc = pk.idf64[r] * ((tf * 2.2) / (tf + self.cache64[code]))
        return np.where(valid, sc, 0.0).astype(np.float32)

    def _stage_scratch(self, staged_terms: List[int], raw_cols: bool,
                       tc_col: bool):
        """Host scratch columns for one chunk, laid out as the reference
        lays them out. raw_cols: stage the f32 score and int32 tf columns
        (raw flat queries and every phrase query read them); tc_col: stage
        the uint16 tc lanes (tc flat queries). Returns (d_doc, raw (d_sc,
        d_tf) or None, d_tc (int16 bits) or None, scratch_start, cap)."""
        packed_mode = self.cold_transfer == "packed"
        if packed_mode:
            # pack-eligible runs first: the packed segment must be a
            # contiguous prefix so decoded blocks land in place
            staged_terms.sort(key=lambda r: (not self._pack16[r], r))
        run_lens = self._lens[staged_terms]
        offs = np.zeros(len(staged_terms) + 1, dtype=np.int64)
        np.cumsum(run_lens, out=offs[1:])
        total = int(offs[-1])
        lmax = _bucket(int(self._df32[staged_terms].max(initial=1)),
                       COLD_L_BUCKETS)
        cap = _bucket(total + lmax, SCRATCH_BUCKETS)
        nA = int(np.searchsorted(
            np.fromiter((not self._pack16[r] for r in staged_terms),
                        dtype=bool, count=len(staged_terms)), True)) \
            if packed_mode else 0
        A_total = int(offs[nA])
        if packed_mode:
            G16b = _bucket(max(A_total // BLOCK, 1), _G16_BUCKETS)
            graw = (total - A_total + BLOCK - 1) // BLOCK
            Grawb = _bucket(graw, _GRAW_BUCKETS) if graw else 0
            cap = _bucket(max(total + lmax, G16b * BLOCK,
                              A_total + Grawb * BLOCK), SCRATCH_BUCKETS)
        s_doc = np.full(cap, SENTINEL_DOC, dtype=np.int32)
        if tc_col:
            s_tc = np.zeros(cap, dtype=np.uint16)
        if raw_cols:
            s_tf = np.zeros(cap, dtype=np.int32)
            s_sc = np.zeros(cap, dtype=np.float32)
        scratch_start: Dict[int, int] = {}
        pk = self.packed
        for i, r in enumerate(staged_terms):
            a, n = int(offs[i]), int(run_lens[i])
            src = int(self._starts32[r])
            docs = pk.postings_doc[src : src + n]
            s_doc[a : a + n] = docs
            if tc_col:
                m = int(self._df32[r])  # real postings; run pads stay 0
                s_tc[a : a + m] = (self._code_u16[docs[:m]] << np.uint16(8)) \
                    | np.minimum(pk.postings_tf[src : src + m],
                                 K.TF_SAT).astype(np.uint16)
            if raw_cols:
                s_tf[a : a + n] = pk.postings_tf[src : src + n]
                s_sc[a : a + n] = self._run_scores32(r, src, n)
            scratch_start[r] = a
        if packed_mode:
            w = PACK_WIDTH
            deltas, first = doc_block_deltas(s_doc[:A_total])
            G16 = len(first)
            words = np.zeros((G16b, 4 * w), dtype=np.uint32)
            if G16:
                words[:G16] = native.pack_blocks(
                    deltas.reshape(-1), np.full(G16, w, dtype=np.uint8),
                ).reshape(G16, 4 * w)
            f16 = np.zeros(G16b, dtype=np.int32)
            f16[:G16] = first
            rawf = np.zeros(max(Grawb, 1) * BLOCK, dtype=np.int32)
            rawf[: total - A_total] = s_doc[A_total:total]
            d_doc = combine_doc_column(
                self._to_dev(words.view(np.int32)), self._to_dev(f16),
                self._to_dev(rawf), A_total, cap, w, Grawb)
            self._bump(cold_packed_blocks=G16, cold_raw_postings=total - A_total)
        else:
            d_doc = self._to_dev(s_doc)
        raw = (self._to_dev(s_sc), self._to_dev(s_tf)) if raw_cols else None
        d_tc = self._to_dev(s_tc.view(np.int16)) if tc_col else None
        return d_doc, raw, d_tc, scratch_start, cap

    def _stage_positions(self, terms, scratch_start, cap: int):
        """The position bags of `terms` staged beside the scratch columns:
        int32 pos_starts CSR-indexed by scratch posting index (cap + 1
        entries; other postings get empty bags) and the bags concatenated
        as int32. Returns (d_positions, d_pos_starts)."""
        pk = self.packed
        counts = np.zeros(cap, dtype=np.int64)
        parts = []
        for r in sorted(terms, key=scratch_start.get):
            a, n = scratch_start[r], int(self._lens[r])
            src = int(self._starts32[r])
            ps = pk.pos_starts[src : src + n + 1]
            counts[a : a + n] = np.diff(ps)
            parts.append(pk.positions[int(ps[0]) : int(ps[-1])])
        pos_starts = np.zeros(cap + 1, dtype=np.int64)
        np.cumsum(counts, out=pos_starts[1:])
        # one entry at least: the verify's clamped gathers read index 0
        positions = np.concatenate(
            parts + [np.zeros(1, dtype=np.int32)]).astype(np.int32)
        return (self._to_dev(positions),
                self._to_dev(pos_starts.astype(np.int32)))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _submit_cold_chunk(self, cold):
        """Stage one chunk's runs once and run its flat queries (bs, in
        the engine's columns) and its phrase queries (phrase_body over the
        raw score / tf scratch and the staged position bags)."""
        phrase = [it for it in cold if _is_phrase(it[2])]
        flat = [it for it in cold if not _is_phrase(it[2])]
        tc = self.columns == "tc"
        staged_terms = sorted({r for _, rows, _ in cold for r in rows})
        t0 = time.perf_counter()
        d_doc, raw, d_tc, scratch_start, cap = self._stage_scratch(
            staged_terms, raw_cols=bool(phrase) or not tc,
            tc_col=tc and bool(flat))
        if phrase:
            bags = self._stage_positions(
                {r for _, rows, _ in phrase for r in rows}, scratch_start,
                cap)
        self._bump(route_cold_device=len(cold), cold_chunks=1,
                   cold_stage_s=time.perf_counter() - t0)
        pending = []
        if phrase:
            pending += self._submit_cold_phrase(phrase, scratch_start, d_doc,
                                                raw, *bags)
        cols = (d_tc, self.hot.d_avg32) if tc else raw

        groups: Dict[tuple, list] = {}
        for qi, rows, q in flat:
            dfs = [int(self._df32[r]) for r in rows]
            cslot = int(np.argmin(dfs))
            # past the largest T bucket the slot count is exact
            T = (len(rows) if len(rows) > COLD_T_BUCKETS[-1]
                 else _bucket(len(rows), COLD_T_BUCKETS))
            L = _bucket(dfs[cslot], COLD_L_BUCKETS)
            groups.setdefault((T, L), []).append((qi, rows, q, cslot))
        for (T, L), group in groups.items():
            step = bs_chunk(T, L)
            for ci in range(0, len(group), step):
                pending.append(self._dispatch_cold(
                    group[ci : ci + step], T, L, d_doc, cols, scratch_start))
        return pending

    def _dispatch_cold(self, chunk, T, L, d_doc, cols, scratch_start):
        B = _bucket(len(chunk), COLD_B_BUCKETS)
        if B * max(T - 1, 1) * L > BS_LANE_BUDGET:
            # the coarse cold buckets would pad past the lane budget; the
            # fine buckets stay within it (len(chunk) <= bs_chunk(T, L))
            B = _bucket(len(chunk), B_BUCKETS)
        starts = np.zeros((B, T), dtype=np.int32)
        ends = np.zeros((B, T), dtype=np.int32)
        srows = np.zeros((B, T), dtype=np.int64)
        use_score = np.zeros((B, T), dtype=np.float32)
        idf64_q = np.zeros((B, T), dtype=np.float64)
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        qis = np.zeros(B, dtype=np.int64)
        rows_of = []
        for i, (qi, rows, q, cslot) in enumerate(chunk):
            ks[i] = q.n_results
            qis[i] = qi
            rows_of.append(rows)
            order = [cslot] + [t for t in range(len(rows)) if t != cslot]
            for slot in range(T):
                r = rows[order[slot] if slot < len(order) else order[0]]
                srows[i, slot] = r
                starts[i, slot] = scratch_start[r]
                ends[i, slot] = scratch_start[r] + self._df32[r]
                if slot < len(order):
                    use_score[i, slot] = 1.0
            for slot, t in enumerate(order):
                slot_of[i, t] = slot
            for t, r in enumerate(rows):
                idf64_q[i, t] = self.packed.idf64[r]
        M = min(L, int(ks.max(initial=1)) + self.margin)
        kern = K.make_search_kernel(T, L, M, K.n_iters_for(self._max_df),
                                    mode=self.columns)
        t0 = time.perf_counter()
        out = kern(d_doc, *cols, self._to_dev(starts), self._to_dev(ends),
                   self._to_dev(self.hot._weights(srows, use_score)))
        self._bump(cold_dispatch_s=time.perf_counter() - t0)
        return self._cold_finalizer(out, T, slot_of, idf64_q, ks, qis,
                                    rows_of, self.hot.rel_eps, False)

    def _cold_finalizer(self, out, T, slot_of, idf64_q, ks, qis, rows_of,
                        rel_eps: float, is_phrase: bool):
        """Fetch one cold group's packed output, re-rank in f64 and send
        the suspect rows (near ties at the cut, truncated tie classes
        reaching the k-th place, kept saturated tc lanes, and under
        strict_parity any flag) to the exact host search."""
        n = len(rows_of)

        def finalize(res_list):
            t0 = time.perf_counter()
            packed_out = out.cpu().numpy()
            self._bump(cold_fetch_wait_s=time.perf_counter() - t0)
            tfs_slot = packed_out[:, 1 : T + 1, :]
            tf_q = np.take_along_axis(
                tfs_slot, np.broadcast_to(slot_of[:, :, None], tfs_slot.shape),
                axis=1)
            docs_f, score_f, n_valid = rescore_sorted_arrays(
                packed_out[:, 0, :], tf_q, idf64_q, self.packed.doc_len_code,
                self.cache64)
            flags = packed_out[:, T + 1, 0]
            # a kept saturated tc lane scored the optimistic bound
            suspects = (truncation_suspects(score_f, n_valid, ks,
                                            rel_eps=rel_eps)
                        | tie_class_cut(flags, score_f, n_valid, ks, rel_eps)
                        | ((flags & K.FLAG_TF_SAT) != 0))
            if self.strict_parity:
                suspects = suspects | (flags != 0)
            self._bump(cold_host_fallback_q=int(suspects[:n].sum()))
            for i in range(n):
                res = res_list[int(qis[i])]
                if suspects[i]:
                    res.set_arrays(*host_exact_search(
                        self.packed, self.cache64, rows_of[i], int(ks[i]),
                        is_phrase=is_phrase))
                else:
                    cnt = min(int(ks[i]), int(n_valid[i]))
                    res.set_arrays(docs_f[i, :cnt], score_f[i, :cnt])

        return finalize

    def _submit_cold_phrase(self, phrase, scratch_start, d_doc, raw, d_pos,
                            d_ps):
        """Cold phrase queries against the staged scratch: phrase_body
        (bloomless: the gate only prunes) over the raw score / tf scratch
        and the staged bags, grouped by (exact T, cold L bucket, PP bucket
        of query term 0's max tf) and chunked so B x max(T, PP) x L stays
        within PHRASE_LANE_BUDGET. A key whose smallest B does not fit
        takes the memoized exact host phrase search."""
        groups: Dict[tuple, list] = {}
        for qi, rows, q in phrase:
            dfs = [int(self._df32[r]) for r in rows]
            cslot = int(np.argmin(dfs))
            T = len(rows)  # exact T: adjacency needs the true slots
            L = _bucket(dfs[cslot], COLD_L_BUCKETS)
            PP = _bucket(int(self.packed.max_tf[rows[0]]), PP_BUCKETS)
            groups.setdefault((T, L, PP), []).append((qi, rows, q, cslot))
        pending, host = [], []
        for (T, L, PP), group in groups.items():
            lanes = max(T, PP) * L
            if B_BUCKETS[0] * lanes > PHRASE_LANE_BUDGET:
                host += group
                continue
            step = _chunk_within(PHRASE_LANE_BUDGET, lanes, B_BUCKETS)
            for ci in range(0, len(group), step):
                pending.append(self._dispatch_cold_phrase(
                    group[ci : ci + step], T, L, PP, d_doc, raw, d_pos, d_ps,
                    scratch_start))
        self._bump(route_cold_phrase=len(phrase) - len(host),
                   route_cold_phrase_host=len(host))
        if host:
            def run_host(res_list, host=host):
                for qi, rows, q, _ in host:
                    res_list[qi].set_arrays(
                        *self._host_exact_memo(rows, q.n_results, True))

            pending.append(run_host)
        return pending

    def _dispatch_cold_phrase(self, chunk, T, L, PP, d_doc, raw, d_pos, d_ps,
                              scratch_start):
        # the fine B buckets: every padded row costs max(T, PP) x L lanes
        B = _bucket(len(chunk), B_BUCKETS)
        starts = np.zeros((B, T), dtype=np.int32)
        ends = np.zeros((B, T), dtype=np.int32)
        use_score = np.zeros((B, T), dtype=np.float32)
        idf64_q = np.zeros((B, T), dtype=np.float64)
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        qis = np.zeros(B, dtype=np.int64)
        rows_of = []
        for i, (qi, rows, q, cslot) in enumerate(chunk):
            ks[i] = q.n_results
            qis[i] = qi
            rows_of.append(rows)
            order = [cslot] + [t for t in range(T) if t != cslot]
            for slot, t in enumerate(order):
                r = rows[t]
                starts[i, slot] = scratch_start[r]
                ends[i, slot] = scratch_start[r] + self._df32[r]
                use_score[i, slot] = 1.0
                slot_of[i, t] = slot
            idf64_q[i] = self.packed.idf64[rows]
        M = min(L, int(ks.max(initial=1)) + self.margin)
        kern = K.make_phrase_kernel(T, L, PP, M, K.n_iters_for(self._max_df),
                                    self._n_pos_iters)
        t0 = time.perf_counter()
        out = kern(d_doc, *raw, d_pos, d_ps, self._to_dev(starts),
                   self._to_dev(ends), self._to_dev(use_score),
                   self._to_dev(slot_of.astype(np.int32)))
        self._bump(cold_phrase_dispatch_s=time.perf_counter() - t0)
        # raw f32 scores whatever the columns: the raw guard width
        return self._cold_finalizer(out, T, slot_of, idf64_q, ks, qis,
                                    rows_of, RAW_REL_EPS, True)
