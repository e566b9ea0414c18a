"""Batched conjunctive search step in plain torch (raw-column subset of
wiser_tpu/engine/kernels.py).

A batch of B queries runs over the global CSR posting columns: load each
query's candidate run (slot 0, its least-frequent term) as a contiguous
(B, L) slice, score it from the per-posting f32 partial-score column,
intersect by vectorized lower-bound binary search into every other
slot's run, take the exact top-M lanes, and gather the per-slot tfs at
the winners for the host's f64 re-rank (engine/topk.py).

Slot convention (host assembly): slot 0 is the candidate term; the other
terms fill slots 1..T-1; padded slots repeat slot 0 with use_score 0.

These functions are the XLA programs of the JAX package written out as
torch operations; they run on whatever device their tensors live on.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
INT32_MAX = 2**31 - 1
FLAG_TRUNC = 1  # f32 boundary class truncated
FLAG_OVERFLOW = 2  # windowed-kernel window overflow (lanes missing)
FLAG_TF_SAT = 4  # a kept lane's tf byte saturated (tc mode)
FLAG_PRUNE_MISS = 8  # pruned-dense: an unexamined block could beat the kept set


def _gather1d(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with idx clipped into range (callers mask separately). A
    CUDA gather out of range is a device-side assert, so the clip is what
    keeps the reference's semantics."""
    return arr[idx.clamp(0, arr.shape[0] - 1)]


def _slice_rows(arr: torch.Tensor, starts: torch.Tensor, L: int) -> torch.Tensor:
    """Contiguous (B, L) loads arr[s : s+L], each start clamped to
    [0, n-L] exactly as dynamic_slice clamps it."""
    n = arr.shape[0]
    s = starts.to(torch.int64).clamp(0, max(0, n - L))
    lane = torch.arange(L, dtype=torch.int64, device=arr.device)
    return arr[s[:, None] + lane[None, :]]


def _binary_search(postings_doc, targets, lo0, hi0, n_iters: int):
    """Vectorized lower bound: the first position in [lo0, hi0) whose
    value is >= target, after a fixed n_iters halvings."""
    lo = lo0.expand(targets.shape).to(torch.int32)
    hi = hi0.expand(targets.shape).to(torch.int32)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        less = _gather1d(postings_doc, mid) < targets
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def _candidates(postings_doc, postings_score, starts, ends, L: int):
    """Slot-0 contiguous candidate load -> (cdocs, cscore, cvalid, cs)."""
    cs = starts[:, 0]
    n_valid = ends[:, 0] - cs
    lane = torch.arange(L, dtype=torch.int32, device=starts.device)
    cvalid = lane[None, :] < n_valid[:, None]
    cdocs = torch.where(cvalid, _slice_rows(postings_doc, cs, L), INT32_MAX)
    cscore = _slice_rows(postings_score, cs, L)
    return cdocs, cscore, cvalid, cs


def boundary_truncated(score, top_score, M: int):
    """(B,) bool: the f32 selection's boundary class extends past the
    M-lane buffer (some lane with score == the kept minimum was dropped).
    Counted over the full plane, so it does not depend on which tied
    lanes top-k kept."""
    boundary = top_score[:, M - 1]
    full = boundary > NEG_INF
    n_ge = (score >= boundary[:, None]).sum(dim=1)
    return full & (n_ge > M)


def two_level_top_m(score_flat, M: int):
    """Exact top-M lane selection over (B, NBLK*128) f32 lanes through
    per-128-block maxima: top-(M+1) blocks, re-sorted ascending, then
    top-M over their (M+1)*128 lanes. Returns (top_score, top_lane).

    Neither topk breaks ties by index on CUDA. The selected set is still
    exact whenever the boundary class fits the buffer (all blocks holding
    a lane >= the M-th value number <= M); when it does not, the caller's
    boundary_truncated flag fires, exactly as for the flat selection."""
    B, NL = score_flat.shape
    NBLK = NL // 128
    if NBLK < M + 1 or NL % 128:
        return torch.topk(score_flat, M, dim=1)
    s3 = score_flat.reshape(B, NBLK, 128)
    _, blk = torch.topk(s3.amax(dim=2), M + 1, dim=1)
    blk, _ = torch.sort(blk, dim=1)
    rows3 = torch.gather(s3, 1, blk[:, :, None].expand(B, M + 1, 128))
    top_score, fl = torch.topk(rows3.reshape(B, (M + 1) * 128), M, dim=1)
    top_lane = torch.gather(blk, 1, fl // 128) * 128 + fl % 128
    return top_score, top_lane


def search_body(postings_doc, postings_score, postings_tf, starts, ends,
                use_score, *, T: int, L: int, M: int, n_bs_iters: int):
    """The batched AND / single-term step over raw columns.

    starts/ends: (B, T) int32 CSR bounds in slot order; use_score: (B, T)
    f32 0/1. Returns (top_docs (B,M) i32, top_score (B,M) f32,
    top_tfs (B,T,M) i32, top_pidx (B,T,M) i32, flags (B,) i32)."""
    B = starts.shape[0]
    cdocs, cscore, cvalid, cs = _candidates(
        postings_doc, postings_score, starts, ends, L)

    if T == 1:
        score = torch.where(cvalid, cscore, NEG_INF)
    else:
        targets = cdocs[:, None, :].expand(B, T - 1, L)
        lo = _binary_search(postings_doc, targets, starts[:, 1:, None],
                            ends[:, 1:, None], n_bs_iters)
        found = (lo < ends[:, 1:, None]) & (_gather1d(postings_doc, lo) == targets)
        match = found.all(dim=1) & cvalid
        partial = torch.where(found, _gather1d(postings_score, lo), 0.0)
        partial = partial * use_score[:, 1:, None]
        # slot-order sequential sum: the same f32 rounding as the
        # reference's reduction on every device (a tree order would move
        # scores by an ulp and with them the boundary flags)
        acc = partial[:, 0]
        for t in range(1, T - 1):
            acc = acc + partial[:, t]
        score = torch.where(match, cscore * use_score[:, 0:1] + acc, NEG_INF)

    top_score, top_l = two_level_top_m(score, M)
    kept = top_score > NEG_INF
    top_docs = torch.where(kept, torch.gather(cdocs, 1, top_l), -1)
    # posting index of each winner per slot: the candidate lane itself in
    # slot 0, the binary-search hit in the others
    top_pidx = (cs[:, None] + top_l.to(torch.int32))[:, None, :]
    if T > 1:
        top_lo = torch.gather(lo, 2, top_l[:, None, :].expand(B, T - 1, M))
        top_pidx = torch.cat([top_pidx, top_lo], dim=1)
    flags = boundary_truncated(score, top_score, M).to(torch.int32)
    top_tfs = torch.where(kept[:, None, :], _gather1d(postings_tf, top_pidx), 0)
    return top_docs, top_score, top_tfs, top_pidx, flags


def pack_with_flags(top_docs, top_tfs, flags):
    """(B, T+2, M) int32: row 0 docs, rows 1..T per-slot tfs, row T+1 the
    per-query flag word — one device-to-host copy per group."""
    B, _, M = top_tfs.shape
    flag_row = flags[:, None, None].expand(B, 1, M)
    return torch.cat([top_docs[:, None, :], top_tfs, flag_row], dim=1)


def make_search_kernel(T: int, L: int, M: int, n_bs_iters: int):
    """search_body at fixed shapes, returning the packed (B, T+2, M)
    int32 array. A plain function: torch runs eagerly, nothing to cache."""

    def kernel(postings_doc, postings_score, postings_tf, starts, ends,
               use_score):
        top_docs, _, top_tfs, _, flags = search_body(
            postings_doc, postings_score, postings_tf, starts, ends,
            use_score, T=T, L=L, M=M, n_bs_iters=n_bs_iters)
        return pack_with_flags(top_docs, top_tfs, flags)

    return kernel


def n_iters_for(max_len: int) -> int:
    """Binary-search iteration count covering lists up to max_len."""
    return max(1, int(np.ceil(np.log2(max(2, int(max_len) + 1)))))
