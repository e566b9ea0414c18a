"""The mesh's per-shard steps and their merge (port of the shard_map
bodies of wiser_tpu/engine/shard.py).

JAX runs each step as one program under shard_map: every device runs the
local body on its shard, then an all_gather over the mesh axis and a
re-top-k. Here the same split is two plain functions over tensors: a
local step, run once per shard on the shard's device (each calls the
single-card step of engine/kernels.py on the shard's columns), and
merge_shards, run on the first shard's device over the gathered (D, B, M)
outputs. gather() is the all_gather's counterpart: a copy to that device,
no copy at all where the shards share it.

Every local step returns (docs (B, M) int32 global doc ids or -1, score
(B, M) f32, tfs (B, T, M) int32 in slot order, flags (B,) int32); a
shard owns the docs [doc_base, doc_base + Npd), and the dense steps'
lane l is doc doc_base + l.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from wiser_tpu_torch.engine import kernels as K


@dataclass
class ShardColumns:
    """One shard's device tensors (None where the engine's mode or tier
    has no such column)."""

    device: torch.device
    doc_base: int  # first doc id of the shard's range: s * Npd
    doc: torch.Tensor  # int32 (P_pad,) global doc ids, SENTINEL pads
    term_starts: torch.Tensor  # int32 (n_terms + 1,) per-shard CSR
    df: torch.Tensor  # int32 (n_terms,) per-shard posting counts
    # int16 bits of uint16 or int32, with a POS_PAD tail
    positions: Optional[torch.Tensor] = None
    pos_starts: Optional[torch.Tensor] = None  # int32 (P_pad + 1,)
    score: Optional[torch.Tensor] = None  # raw: f32 partial scores
    tf: Optional[torch.Tensor] = None  # raw: int32 tfs
    tc: Optional[torch.Tensor] = None  # tc: int16 bits of the uint16 lanes
    avg32: Optional[torch.Tensor] = None  # tc: 0-d f32 average length
    bloom_rows: Optional[torch.Tensor] = None  # sparse folded bi-blooms
    bloom_bitmap: Optional[torch.Tensor] = None
    bloom_rank: Optional[torch.Tensor] = None
    dense_sc: Optional[torch.Tensor] = None  # raw: (H, Npd) f32
    dense_tf: Optional[torch.Tensor] = None  # raw: (H, Npd) int32
    dense_tf8: Optional[torch.Tensor] = None  # tc: (H, Npd) uint8
    len_code: Optional[torch.Tensor] = None  # tc: (Npd,) uint8
    blockmax: Optional[torch.Tensor] = None  # (H, Npd // 128) f32

    def nbytes(self) -> dict:
        def n(*ts):
            return int(sum(t.numel() * t.element_size()
                           for t in ts if t is not None))

        return {
            "postings": n(self.doc, self.score, self.tf, self.tc),
            "csr": n(self.term_starts, self.df),
            "positions": n(self.positions, self.pos_starts),
            "dense_tier": n(self.dense_sc, self.dense_tf, self.dense_tf8,
                            self.len_code, self.blockmax),
            "blooms": n(self.bloom_rows, self.bloom_bitmap, self.bloom_rank),
        }


def _bounds(sh: ShardColumns, rows: torch.Tensor):
    """Per-shard CSR bounds (B, T) of term rows (B, T)."""
    starts = sh.term_starts[rows]
    return starts, starts + sh.df[rows]


def _split_packed(packed: torch.Tensor, T: int):
    """A packed (B, T+2, M) step output -> (docs, tfs, flags)."""
    return packed[:, 0, :], packed[:, 1 : T + 1, :], packed[:, T + 1, 0]


def _to_global(sh: ShardColumns, lanes: torch.Tensor) -> torch.Tensor:
    """Plane lanes (-1 = empty) -> global doc ids."""
    return torch.where(lanes >= 0, lanes + sh.doc_base, -1)


def bs_step(sh: ShardColumns, rows, weights, *, T: int, L: int, M: int,
            n_bs_iters: int):
    """kernels.search_body on one shard. weights: use_score (raw) or the
    slot-order f32 idfs (tc)."""
    starts, ends = _bounds(sh, rows)
    if sh.tc is not None:
        docs, score, tfs, _, flags = K.search_body(
            sh.doc, None, None, starts, ends, None, T=T, L=L, M=M,
            n_bs_iters=n_bs_iters, tc=sh.tc, idf32=weights, avg32=sh.avg32)
    else:
        docs, score, tfs, _, flags = K.search_body(
            sh.doc, sh.score, sh.tf, starts, ends, weights, T=T, L=L, M=M,
            n_bs_iters=n_bs_iters)
    return docs, score, tfs, flags


def phrase_step(sh: ShardColumns, rows, weights, slot_of, *, T: int, L: int,
                PP: int, M: int, n_bs_iters: int, n_pos_iters: int):
    """kernels.phrase_body (the bloomless phrase pipeline) on one shard:
    positional verification is doc-local, so the shards are
    independent."""
    starts, ends = _bounds(sh, rows)
    kw = dict(T=T, L=L, PP=PP, M=M, n_bs_iters=n_bs_iters,
              n_pos_iters=n_pos_iters)
    if sh.tc is not None:
        packed, score = K.phrase_body(
            sh.doc, None, None, sh.positions, sh.pos_starts, starts, ends,
            None, slot_of, tc=sh.tc, idf32=weights, avg32=sh.avg32, **kw)
    else:
        packed, score = K.phrase_body(
            sh.doc, sh.score, sh.tf, sh.positions, sh.pos_starts, starts,
            ends, weights, slot_of, **kw)
    docs, tfs, flags = _split_packed(packed, T)
    return docs, score, tfs, flags


def compact_phrase_step(sh: ShardColumns, rows, weights, slot_of, ks,
                        *probes, T: int, L: int, KV: int, PP: int, PW: int,
                        M: int, n_bs_iters: int, eps3: float):
    """kernels.compact_phrase_body on one shard: the bi-bloom gate over the
    shard's sparse folded bloom columns, the compaction to the KV best
    AND scores and the window verify. FLAG_PRUNE_MISS compares the shard's
    (KV+1)-th surviving score with its own k-th kept one."""
    starts, ends = _bounds(sh, rows)
    tc_mode = sh.tc is not None
    packed, score = K.compact_phrase_body(
        sh.doc, sh.tc if tc_mode else sh.score, sh.tf, sh.positions,
        sh.pos_starts, starts, ends, weights, slot_of, ks, sh.bloom_rows,
        sh.bloom_bitmap, sh.bloom_rank, *probes, T=T, L=L, KV=KV, PP=PP,
        PW=PW, M=M, n_bs_iters=n_bs_iters, eps3=eps3, tc_mode=tc_mode,
        avg32=sh.avg32)
    docs, tfs, flags = _split_packed(packed, T)
    return docs, score, tfs, flags


def dense_step(sh: ShardColumns, slots, weights, *, T: int, M: int):
    """The doc-space dense scan of the shard's (H, Npd) slice of the dense
    tier (kernels.dense_scan_body / dense_scan_body_tc)."""
    if sh.dense_tf8 is not None:
        docs, score, tfs, flags = K.dense_scan_body_tc(
            sh.dense_tf8, sh.len_code, sh.avg32, slots, weights, T=T,
            N_pad=sh.dense_tf8.shape[1], M=M)
    else:
        docs, score, tfs, flags = K.dense_scan_body(
            sh.dense_sc, sh.dense_tf, slots, weights, T=T,
            N_pad=sh.dense_sc.shape[1], M=M)
    return _to_global(sh, docs), score, tfs, flags


def pruned_step(sh: ShardColumns, slots, weights, *, T: int, NB: int,
                C: int, M: int):
    """The block-max pruned scan of the shard's slice: the shard ranks its
    own NB blocks by the plain sum of block maxima and scores its top C
    (kernels.pruned_scan_body). Returns the four step outputs and the
    shard's next_ub (B,): the prune guard runs after the merge, against
    the max of the shards' bounds."""
    tc_mode = sh.dense_tf8 is not None
    docs, score, tfs, flags, next_ub = K.pruned_scan_body(
        sh.dense_tf8 if tc_mode else sh.dense_sc, sh.dense_tf, sh.len_code,
        sh.avg32 if tc_mode else None, sh.blockmax, None, None, slots,
        weights, T=T, NB=NB, C=C, M=M)
    return _to_global(sh, docs), score, tfs, flags, next_ub


def semidense_step(sh: ShardColumns, rows, weights, slots, *, T: int, L: int,
                   M: int, n_bs: int, n_bs_iters: int):
    """kernels._semidense_step on one shard: the candidate's local run,
    the non-dense others by binary search over their local runs, the dense
    others by one gather of the shard's slice at doc - doc_base."""
    starts, ends = _bounds(sh, rows)
    kw = dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters,
              doc_base=sh.doc_base)
    if sh.tc is not None:
        return K._semidense_step(sh.doc, sh.tc, sh.dense_tf8, starts, ends,
                                 weights, slots, avg32=sh.avg32, **kw)
    return K._semidense_step(sh.doc, sh.score, sh.dense_sc, starts, ends,
                             weights, slots, postings_tf=sh.tf,
                             dense_tf=sh.dense_tf, **kw)


def gather(parts, device: torch.device) -> torch.Tensor:
    """The all_gather: the shards' outputs stacked on `device` (D, ...)."""
    return torch.stack([p.to(device, non_blocking=True) for p in parts])


def merge_shards(docs, score, tfs, flags, *, M_out: int):
    """The global top-M_out over the gathered shard outputs: docs / score
    (D, B, M), tfs (D, B, T, M), flags (D, B) int32 flag words.

    The lanes are shard-major (lane s*M + m) and the shards own ascending
    doc ranges, so a stable sort on score descending keeps the (score
    desc, doc asc) canon among equal f32 scores; a top-k whose tie order
    is free (torch.topk on a card) would not. M_out may exceed M (a query
    whose k spans shards). The flag words merge by bitwise OR, with
    FLAG_TRUNC where the merge's own cut truncates a boundary class of the
    gathered lanes. Returns (docs (B, M_out), score, tfs (B, T, M_out),
    flags (B,))."""
    D, B, M = docs.shape
    T = tfs.shape[2]
    gd = docs.permute(1, 0, 2).reshape(B, D * M)
    gs = score.permute(1, 0, 2).reshape(B, D * M)
    gt = tfs.permute(1, 2, 0, 3).reshape(B, T, D * M)
    s2, i2 = K._top_stable(gs, M_out)
    d2 = torch.gather(gd, 1, i2)
    t2 = torch.gather(gt, 2, i2[:, None, :].expand(B, T, M_out))
    merged = flags[0]
    for s in range(1, D):
        merged = merged | flags[s]
    merged = merged | (K.boundary_truncated(gs, s2, M_out).to(torch.int32)
                       * K.FLAG_TRUNC)
    return d2, s2, t2, merged
