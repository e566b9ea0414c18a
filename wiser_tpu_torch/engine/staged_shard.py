"""ShardedStagedEngine — indexes bigger than device memory over the mesh
(port of wiser_tpu/engine/staged_shard.py).

Postings are doc-partitioned across the shards (engine/shard.py) and only
a df-hot tier is resident; cold posting runs are staged from the host per
batch:

- hot tier: terms admitted greedily by df under the budget (each charged
  its full resident cost, staged.per_term_device_cost; the dense tier its
  proportional share); the view is re-sharded and served by a plain
  ShardedEngine whose source is the full index (exact host searches and
  snippets see every term). All-hot queries take the resident mesh path.
- cold conjunctions: every staged term's per-shard padded run is copied
  into a (D, cap) scratch column triple (cap bucketed by SCRATCH_BUCKETS),
  uploaded to the shards' devices, and the mesh bs step and merge run
  over it in B_CHUNK chunks; the hot engine's finalizer (f64 re-rank,
  guards, host fallback) is shared.
- cold phrases take the exact host search, as in the JAX engine.

Raw columns only, as in the JAX engine. One departure, where the JAX
engine's answer falls short: the cold merge keeps k + margin lanes across
shards (the resident path's deep-k fix). The JAX cold merge keeps only
the local M = min(L, k + margin), so a cold query whose k + margin
exceeds its per-shard L bucket returns at most L results there
(tests/test_torch_staged_shard.py holds the port to the oracle).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wiser_tpu_torch.engine import kernels as K
from wiser_tpu_torch.engine import shard_steps as S
from wiser_tpu_torch.engine.device import TorchEngine, bs_chunk
from wiser_tpu_torch.engine.host import (
    B_BUCKETS,
    B_CHUNK,
    DEFAULT_MARGIN,
    L_BUCKETS,
    _bucket,
    _PlannedQuery,
)
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex, _tbucket
from wiser_tpu_torch.engine.staged import (
    SCRATCH_BUCKETS,
    _hot_view,
    per_term_device_cost,
)
from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.types import SearchQuery, SearchResult


def df_greedy_hot(packed: PackedIndex, budget: int,
                  cost: np.ndarray) -> np.ndarray:
    """The JAX staged engine's default admission (staged._hot_view without
    term weights): terms by df, largest first (the same numpy argsort),
    each admitted while its cost fits what is left of the budget."""
    hot = np.zeros(packed.n_terms, dtype=bool)
    used = 0
    for r in np.argsort(packed.df)[::-1]:
        c = int(cost[r])
        if used + c > budget:
            continue
        used += c
        hot[r] = True
    return hot


def _budget_base(packed: PackedIndex, n_shards: int):
    """(per_term_device_cost, bytes of a raw mesh dense row, every eligible
    dense row's bytes): the budget split's inputs."""
    cost = per_term_device_cost(packed)
    npd = ((packed.n_docs + n_shards * BLOCK - 1)
           // (n_shards * BLOCK) * BLOCK)
    n_pad = npd * n_shards
    # a raw mesh dense row: f32 score plane + i32 tf plane + blockmax
    per_row = n_pad * 8 + (n_pad // BLOCK) * 4
    dense_min = max(ShardedEngine.DENSE_MIN_DF_FLOOR,
                    packed.n_docs // ShardedEngine.DENSE_MIN_DF_FRACTION)
    return cost, per_row, int((packed.df >= dense_min).sum()) * per_row


def full_residency_bytes(packed: PackedIndex, n_shards: int) -> int:
    """The device bytes of every term and every eligible dense row on the
    mesh: the base a caller takes a budget fraction of."""
    cost, _, full_dense = _budget_base(packed, n_shards)
    return max(1, full_dense + int(cost.sum()))


class ShardedStagedEngine:
    def __init__(self, packed: PackedIndex, n_shards: int,
                 hbm_budget_bytes: int, *,
                 devices: Optional[Sequence] = None,
                 doc_bodies: Optional[Sequence[str]] = None,
                 margin: int = DEFAULT_MARGIN,
                 strict_parity: bool = False,
                 full: Optional[ShardedIndex] = None):
        """hbm_budget_bytes: device bytes over every shard. devices: as
        ShardedEngine's (default "cuda"). full: ShardedIndex.from_packed(
        packed, n_shards) if the caller has it already (the staging
        source, host only)."""
        self.packed = packed
        cost, per_row, full_dense = _budget_base(packed, n_shards)
        full_core = int(cost.sum())
        self.total_full = max(1, full_dense + full_core)
        budget = int(hbm_budget_bytes)
        if budget >= self.total_full - self.total_full // 1000:
            dense_budget, core_budget = full_dense, full_core
        else:
            dense_budget = min(full_dense,
                               budget * full_dense // self.total_full)
            core_budget = budget - dense_budget
        self.hot_mask = df_greedy_hot(packed, core_budget, cost)
        hot_view = _hot_view(packed, self.hot_mask, self.hot_mask)
        hot_sh = ShardedIndex.from_packed(hot_view, n_shards)
        # exact fallbacks and snippets see the full index, not the view
        hot_sh.source = packed
        self.hot = ShardedEngine(hot_sh, devices=devices, margin=margin,
                                 doc_bodies=doc_bodies,
                                 dense_budget_bytes=dense_budget,
                                 strict_parity=strict_parity)
        self.cache64 = self.hot.cache64
        self.hot_bytes_used = int(
            cost[self.hot_mask].sum()
            + int((self.hot._dense_slot >= 0).sum()) * per_row)
        self.full = (full if full is not None
                     else ShardedIndex.from_packed(packed, n_shards))
        self.n_shards = n_shards
        self.margin = margin
        self.doc_bodies = doc_bodies
        self._lens_sh = np.diff(self.full.term_starts.astype(np.int64),
                                axis=1)  # padded per-shard runs
        self._max_df = int(packed.df.max(initial=1))
        self.stats: Dict[str, float] = {}

    _bump = TorchEngine._bump
    search = TorchEngine.search
    search_batch = TorchEngine.search_batch
    run_pending = staticmethod(TorchEngine.run_pending)

    @property
    def hot_fraction(self) -> float:
        return float(self.hot_mask.mean()) if len(self.hot_mask) else 0.0

    @property
    def placement(self):
        return self.hot.placement

    def device_bytes(self) -> dict:
        """The resident (hot) tier's device bytes; the cold scratch lives
        only while its batch runs."""
        return self.hot.device_bytes()

    def clear_result_memos(self) -> None:
        self.hot.clear_result_memos()

    def stats_take(self) -> Dict[str, float]:
        """The hot engine's counters (its routes, and the flag and fallback
        counts of every finalized group, cold groups included) with the
        cold path's: route_hot / route_cold queries, cold_chunks,
        cold_stage_s, route_cold_phrase_host."""
        out = self.hot.stats_take()
        for k, v in self.stats.items():
            out[k] = out.get(k, 0) + v
        self.stats = {}
        return out

    def submit_batch(self, queries: List[SearchQuery]):
        results = [SearchResult() for _ in queries]
        lookup = self.packed.term_to_row.get
        hot_q: List[SearchQuery] = []
        hot_qi: List[int] = []
        cold: List[_PlannedQuery] = []
        for qi, q in enumerate(queries):
            if q.n_results <= 0 or not q.terms:
                continue
            rows = [lookup(t, -1) for t in q.terms]
            if min(rows) < 0:
                continue
            if all(self.hot_mask[r] for r in rows):
                hot_q.append(q)
                hot_qi.append(qi)
            else:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                cold.append(pq)
        self._bump(route_hot=len(hot_q), route_cold=len(cold))

        hot_results, hot_pending = self.hot.submit_batch(hot_q)
        for j, qi in enumerate(hot_qi):
            results[qi] = hot_results[j]
        pending = []
        for f in hot_pending:
            def on_hot(res_list, f=f):
                f(hot_results)

            on_hot.barrier = getattr(f, "barrier", False)
            pending.append(on_hot)
        pending += self._submit_cold(cold)
        snips = [pq for pq in cold
                 if pq.query.return_snippets and self.doc_bodies is not None]
        if snips:
            def fill_snippets(res_list, snips=snips):
                for pq in snips:
                    self.hot.fill_snippets(res_list[pq.qi], pq.rows, pq.query)

            fill_snippets.barrier = True
            pending.append(fill_snippets)
        return results, pending

    # -- the cold path: stage per-shard runs, run the mesh bs step ---------

    def _submit_cold(self, cold: List[_PlannedQuery]) -> list:
        if not cold:
            return []
        pending = []
        phrase = [pq for pq in cold
                  if pq.query.is_phrase and len(pq.rows) >= 2]
        flat = [pq for pq in cold
                if not (pq.query.is_phrase and len(pq.rows) >= 2)]
        if phrase:
            self._bump(route_cold_phrase_host=len(phrase))
            pending.append(self.hot._run_host(phrase, True))
        if not flat:
            return pending

        t0 = time.perf_counter()
        full, D = self.full, self.n_shards
        staged_terms = sorted({r for pq in flat for r in pq.rows})
        lens = self._lens_sh[:, staged_terms]  # (D, S) padded runs
        ts = np.zeros((D, len(staged_terms) + 1), dtype=np.int64)
        np.cumsum(lens, axis=1, out=ts[:, 1:])
        # candidate slice slack: the largest candidate L bucket
        cand_rows = [pq.slot_rows[0] for pq in flat]
        lmax = _bucket(max(int(self._lens_sh[:, cand_rows].max(initial=1)), 1),
                       L_BUCKETS)
        need = int(ts[:, -1].max()) + lmax
        cap = max(_bucket(need, SCRATCH_BUCKETS), need)
        s_doc = np.full((D, cap), SENTINEL_DOC, dtype=np.int32)
        s_tf = np.zeros((D, cap), dtype=np.int32)
        s_sc = np.zeros((D, cap), dtype=np.float32)
        for s in range(D):
            for i, r in enumerate(staged_terms):
                n = int(lens[s, i])
                if n == 0:
                    continue
                a, src = int(ts[s, i]), int(full.term_starts[s, r])
                s_doc[s, a : a + n] = full.postings_doc[s, src : src + n]
                s_tf[s, a : a + n] = full.postings_tf[s, src : src + n]
                s_sc[s, a : a + n] = full.postings_score[s, src : src + n]
        df_sc = full.df_shard[:, staged_terms].astype(np.int32)
        scratch = []
        for s, dev in enumerate(self.hot.placement):
            def put(a, dev=dev):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            scratch.append(S.ShardColumns(
                device=dev, doc_base=s * self.hot._npd, doc=put(s_doc[s]),
                term_starts=put(ts[s].astype(np.int32)), df=put(df_sc[s]),
                score=put(s_sc[s]), tf=put(s_tf[s])))
        scratch_row = {r: i for i, r in enumerate(staged_terms)}
        self._bump(cold_stage_s=time.perf_counter() - t0)

        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in flat:
            L = _bucket(int(self._lens_sh[:, pq.slot_rows[0]].max(initial=1)),
                        L_BUCKETS)
            groups.setdefault((_tbucket(len(pq.rows)), L), []).append(pq)
        n_it = K.n_iters_for(self._max_df)
        hot = self.hot
        for (T, L), members in groups.items():
            chunk = min(B_CHUNK, bs_chunk(T, L))
            for ci in range(0, len(members), chunk):
                group = members[ci : ci + chunk]
                B = _bucket(len(group), B_BUCKETS)
                rows, w, idf64_q, slot_of, ks = hot._assemble(group, T, B)
                srows = np.vectorize(scratch_row.__getitem__, otypes=[np.int64])(
                    rows[: len(group)])
                rows[: len(group)] = srows
                rows[len(group):] = 0
                kmax = int(ks.max(initial=1)) + self.margin
                M = min(L, kmax)
                out = hot._run_mesh(S.bs_step, (rows, w),
                                    dict(T=T, L=L, M=M, n_bs_iters=n_it),
                                    min(kmax, M * D), shards=scratch)
                self._bump(cold_chunks=1)
                pending.append(hot._finalizer("cold", out, T, group, slot_of,
                                              idf64_q, ks))
        return pending
