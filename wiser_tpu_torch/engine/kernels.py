"""Batched conjunctive and phrase search steps in plain torch (port of
wiser_tpu/engine/kernels.py: raw and tc columns).

The bs step: load each query's candidate run (slot 0, its least-frequent
term) as a contiguous (B, L) slice, score it from the per-posting f32
partial-score column, intersect by vectorized lower-bound binary search
into every other slot's run, take the exact top-M lanes, and gather the
per-slot tfs at the winners for the host's f64 re-rank (engine/topk.py).
On CUDA tensors search_body runs that step as one hand-written kernel
(ops/search.py, csrc/search.cu; two launches a group); search_body_torch
is its plain version, which CPU tensors take. Long, similar-length lists take the windowed block intersection instead
(windowed_search_body: each candidate block placed against the other
list's block summaries, a searchsorted into a WIN-block window, and a
per-query FLAG_OVERFLOW where the window is too narrow).

The dense head-term tier: head terms keep (N_pad,) f32 score and int32
tf rows (lane = doc id, 0 = absent). All-head conjunctions scan the doc
space (make_dense_search_kernel) or, past PRUNED_DENSE_MIN_NB doc
blocks, only the C blocks with the highest joint upper bounds
(make_pruned_dense_kernel) under a provable guard; tail x head queries
probe the dense rows at their candidate docs (make_semidense_kernel).
On CUDA tensors the scans (dense_scan_body{,_tc}, pruned_scan_body),
the block pick (_select_ub_blocks) and the full-scan mega phrase's two
passes (full_phrase_select, full_phrase_band) run as hand-written
kernels (ops/dense.py, csrc/dense.cu: a block-list scan that keeps each
query's top K in shared memory, a one-CTA-a-query pick, the phrase's
selection at K = KV + 1, threshold first, and its band pass), or raise;
CPU tensors take the plain versions (the *_torch functions) after the
same argument checks. So do the semidense step (_semidense_step:
ops/semidense.py, csrc/semidense.cu), the position verification the
mega phrase routes end in (_verify_docs from kept docs: ops/phrase.py,
csrc/phrase.cu; the reference _verify_pos_windows_torch verifies from
bag bounds, _verify_pidx_torch, the compact and semidense phrase
routes' plain versions, from posting indices), and the semidense phrase
route, the list
chain (with its gate, and without it: phrase_body, the mesh's list
route) and the compact route from their candidate slices to their
packed outputs (semidense_phrase_body, list_phrase, compact_phrase_body:
ops/phrase_route.py, csrc/phrase_route.cu).

Phrases (raw columns): the list chain (make_match_kernel with the
bi-bloom gate, make_phrase_verify_kernel, make_select_topk_kernel); the
compact route (make_compact_phrase_kernel: bloom gate, compaction to the
KV best AND scores, window verify); the semidense phrase route (dense
membership before the compaction, no bloom gate); and the full-scan mega
phrase (make_full_phrase_kernel: every doc lane scored from the dense
rows, the KV best verified, the rest bounded by the exact (KV+1)-th
value) or its block-pruned form (make_pruned_phrase_kernel: only the C
highest-bound blocks scored); and the bloomless self-contained
phrase_body (make_phrase_kernel), which the staged cold tier runs over
its scratch columns. Compaction keeps lax.top_k's index-ascending tie order through a
stable descending sort, so the compacted set is the canonical one on
every device; positions may live on the device as 2-byte int16 bits and
are widened at load (_pos_gather).

Compressed (tc) columns: one uint16 lane doc_len_code << 8 | min(tf, 255)
replaces the (f32 score, i32 tf) pair of a posting, held on the device as
int16 bits and widened at load (_u16); the dense tier keeps one uint8 tf
plane and one shared uint8 len-code row, recomposed per lane. tc_score
rebuilds the f32 selection score from a lane with per-slot f32 idfs (0 on
padded slots); a tf byte of 255 scores the optimistic idf * (k1 + 1) and
any query keeping such a lane raises FLAG_TF_SAT for the exact host path.
Each tc step is its reference's (make_search_kernel(mode="tc"),
make_match_kernel_tc, make_select_topk_kernel_tc, the tc modes of the
compact and semidense phrase kernels, make_semidense_kernel_tc,
make_dense_search_kernel_tc, make_pruned_dense_kernel_tc,
make_full_phrase_kernel_tc with its exact payload-tie refinement,
make_pruned_phrase_kernel_tc, and the tc modes of phrase_body and
windowed_search_body).

Slot convention (host assembly): slot 0 is the candidate term; the other
terms fill slots 1..T-1; padded slots repeat slot 0 with use_score 0
(idf32 0 in tc mode). Phrase verification runs in query-term order
(slot_of re-permutes).

The bodies (search_body, dense_scan_body{,_tc}, pruned_scan_body,
_semidense_step, phrase_body, compact_phrase_body) also return the kept
f32 scores: the mesh (engine/shard_steps.py) runs them per shard and
merges on them.

These functions are the XLA programs of the JAX package written out as
torch operations; they run on whatever device their tensors live on
(search_body apart, as above). f32
sums are written as sequential adds in slot order, one addend per slot,
as the reference sums them (eager torch runs each add as its own
operation, so nothing contracts into an FMA): the prune guard's proof
needs the score and its bound summed in the same order, and the flag
words then equal the reference's. In tc mode the other slots of the bs,
match, compact, windowed and phrase_body steps sum first and are then
added to the candidate's
score, as the reference writes it. A divisor is always a tensor on the
operands' device: CUDA divides by a CPU scalar as a multiply by its
reciprocal, which may round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from wiser_tpu_torch.ops import dense as _dense_op
from wiser_tpu_torch.ops import phrase as _phrase_op
from wiser_tpu_torch.ops import phrase_route as _route_op
from wiser_tpu_torch.ops import search as _search_op
from wiser_tpu_torch.ops import semidense as _semi_op

NEG_INF = float("-inf")
INT32_MAX = 2**31 - 1
FLAG_TRUNC = 1  # f32 boundary class truncated
FLAG_OVERFLOW = 2  # windowed-kernel window overflow (lanes missing)
FLAG_TF_SAT = 4  # a kept lane's tf byte saturated (tc mode)
FLAG_PRUNE_MISS = 8  # pruned-dense: an unexamined block could beat the kept set
# BM25 constants of the tc decode, as f32 values
K1_PLUS_1 = float(np.float32(2.2))
K1_F32 = float(np.float32(1.2))
B_F32 = float(np.float32(0.75))
ONE_MINUS_B_F32 = float(np.float32(0.25))
TF_SAT = 255


def _char4_length(code: torch.Tensor) -> torch.Tensor:
    """The 1-byte lossy length code's decoded length (CHAR4: 3 mantissa
    bits, shift = code >> 3 - 1, capped at 27 for valid codes)."""
    bits = code & 7
    shift = ((code >> 3) - 1).clamp(max=27)
    return torch.where(shift < 0, bits, (bits | 8) << shift.clamp(min=0))


def tc_score(tc: torch.Tensor, idf32: torch.Tensor,
             avg32: torch.Tensor) -> torch.Tensor:
    """The f32 selection score of int32 tc lanes (code8 << 8 | tf8), in
    the reference's operation order. idf32: broadcastable f32 per-slot
    idf (0 on padded slots); avg32: 0-d f32 average field length on the
    lanes' device. A tf byte of 0 scores exactly 0; 255 scores the
    optimistic bound idf * (k1 + 1)."""
    tf_i = tc & 0xFF
    tf = tf_i.to(torch.float32)
    length = _char4_length((tc >> 8) & 0xFF)
    cache = K1_F32 * (ONE_MINUS_B_F32
                      + B_F32 * length.to(torch.float32) / avg32)
    norm = (tf * K1_PLUS_1) / (tf + cache)
    norm = torch.where(tf_i >= TF_SAT, K1_PLUS_1, norm)
    return idf32 * norm


def tc_saturated(top_tc: torch.Tensor, top_docs: torch.Tensor) -> torch.Tensor:
    """(B,) bool: a kept lane (top_docs >= 0) carries a saturated tf
    byte, so its score was the optimistic bound and its tf is wrong.
    top_tc: (B, M) or (B, T, M) int32 lanes."""
    sat = (top_tc & 0xFF) >= TF_SAT
    if sat.dim() == 3:
        sat = sat.any(dim=1)
    return (sat & (top_docs >= 0)).any(dim=1)


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int16 bits of a uint16 column (tc lanes, positions) widened to
    int32 values; other dtypes pass through."""
    return x.to(torch.int32) & 0xFFFF if x.dtype == torch.int16 else x


def _compose_tc(tf8: torch.Tensor, code_hi: torch.Tensor) -> torch.Tensor:
    """A dense-tier tc lane from a uint8 tf and the doc's len code
    already shifted left by 8: code << 8 | tf, and 0 where tf is 0."""
    tf = tf8.to(torch.int32)
    return torch.where(tf > 0, code_hi | tf, 0)


def _gather1d(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with idx clipped into range (callers mask separately). A
    CUDA gather out of range is a device-side assert, so the clip is what
    keeps the reference's semantics."""
    return arr[idx.clamp(0, arr.shape[0] - 1)]


def _dense_gather(plane: torch.Tensor, slots_t: torch.Tensor,
                  doc_idx: torch.Tensor) -> torch.Tensor:
    """plane[slot, doc] from an (H, N_pad) dense plane, broadcasting
    slots_t (B, 1) against doc_idx (B, L), doc ids clamped into range.
    Indices are int64, so there is one form at every plane size (the
    reference's flat-int32 / 2D branch exists because JAX runs with x64
    disabled)."""
    doc = doc_idx.to(torch.int64).clamp(0, plane.shape[1] - 1)
    return plane[slots_t.to(torch.int64), doc]


def _slice_rows(arr: torch.Tensor, starts: torch.Tensor, L: int) -> torch.Tensor:
    """Contiguous (B, L) loads arr[s : s+L], each start clamped to
    [0, n-L] exactly as dynamic_slice clamps it."""
    n = arr.shape[0]
    s = starts.to(torch.int64).clamp(0, max(0, n - L))
    lane = torch.arange(L, dtype=torch.int64, device=arr.device)
    return arr[s[:, None] + lane[None, :]]


def _pos_gather(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """positions[idx] (clipped) as int32. The device column holds 2-byte
    int16 bits of uint16 positions when they fit (half the bytes), widened
    here with & 0xFFFF, so the 65535 pad reads as 65535 as in the
    reference's uint16 column."""
    return _u16(_gather1d(positions, idx)).to(torch.int32)


def _binary_search(postings_doc, targets, lo0, hi0, n_iters: int,
                   gather=_gather1d):
    """Vectorized lower bound: the first position in [lo0, hi0) whose
    value is >= target, after a fixed n_iters halvings (gather reads the
    searched column; _pos_gather for positions)."""
    lo = lo0.expand(targets.shape).to(torch.int32)
    hi = hi0.expand(targets.shape).to(torch.int32)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        less = gather(postings_doc, mid) < targets
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def _candidates(postings_doc, postings_score, starts, ends, L: int):
    """Slot-0 contiguous candidate load -> (cdocs, cscore, cvalid, cs);
    with a tc column in place of the score column, cscore is the int32
    tc lanes."""
    cs = starts[:, 0]
    n_valid = ends[:, 0] - cs
    lane = torch.arange(L, dtype=torch.int32, device=starts.device)
    cvalid = lane[None, :] < n_valid[:, None]
    cdocs = torch.where(cvalid, _slice_rows(postings_doc, cs, L), INT32_MAX)
    cscore = _u16(_slice_rows(postings_score, cs, L))
    return cdocs, cscore, cvalid, cs


def _seq_sum(partial: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 as sequential adds in slot order (the reference's
    reduction order on every device)."""
    acc = partial[:, 0]
    for t in range(1, partial.shape[1]):
        acc = acc + partial[:, t]
    return acc


def _others(postings_doc, col, cdocs, starts, ends, n_iters: int, *,
            weights, avg32=None):
    """Binary search of the candidate docs into S other slots' runs
    (starts/ends (B, S)), their f32 score contributions summed in slot
    order, and for tc columns the hit lanes. weights: (B, S) use_score
    (raw) or idf32 (tc, avg32 given). Returns (lo (B, S, L), found, acc
    (B, L), hit_tc or None)."""
    S = starts.shape[1]
    targets = cdocs[:, None, :].expand(cdocs.shape[0], S, cdocs.shape[1])
    lo = _binary_search(postings_doc, targets, starts[:, :, None],
                        ends[:, :, None], n_iters)
    found = (lo < ends[:, :, None]) & (_gather1d(postings_doc, lo) == targets)
    if avg32 is None:
        partial = (torch.where(found, _gather1d(col, lo), 0.0)
                   * weights[:, :, None])
        hit_tc = None
    else:
        hit_tc = _u16(_gather1d(col, lo))
        partial = torch.where(found, tc_score(hit_tc, weights[:, :, None],
                                              avg32), 0.0)
    return lo, found, _seq_sum(partial), hit_tc


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
                use_score, *, T: int, L: int, M: int, n_bs_iters: int,
                tc=None, idf32=None, avg32=None):
    """The batched AND / single-term step.

    starts/ends: (B, T) int32 CSR bounds in slot order; use_score: (B, T)
    f32 0/1. tc mode: pass the tc column as tc, idf32 ((B, T) f32 in slot
    order, 0 on padded slots) and avg32 instead of the score / tf columns
    and use_score; kept saturated lanes raise FLAG_TF_SAT. Returns
    (top_docs (B,M) i32, top_score (B,M) f32, top_tfs (B,T,M) i32,
    top_pidx (B,T,M) i32, flags (B,) i32).

    On CUDA tensors the hand-written kernel (ops/search.bs_search) runs
    it, or raises; on CPU tensors the plain version, search_body_torch.
    Both check their arguments first (ValueError)."""
    kw = dict(T=T, L=L, M=M, n_bs_iters=n_bs_iters, tc=tc, idf32=idf32,
              avg32=avg32)
    args = (postings_doc, postings_score, postings_tf, starts, ends,
            use_score)
    if isinstance(postings_doc, torch.Tensor) and postings_doc.is_cuda:
        return _search_op.bs_search(*args, **kw)
    _search_op.check_inputs(*args, **kw)
    return search_body_torch(*args, **kw)


def search_body_torch(postings_doc, postings_score, postings_tf, starts,
                      ends, use_score, *, T: int, L: int, M: int,
                      n_bs_iters: int, tc=None, idf32=None, avg32=None):
    """search_body's plain torch version: the reference's operations one
    by one (on any device; the tests and the chip smoke hold the kernel
    against it). On a card, torch.topk breaks no ties by index, so a row
    with FLAG_TRUNC may keep other boundary lanes than the kernel."""
    B = starts.shape[0]
    tc_mode = tc is not None
    cdocs, cscore, cvalid, cs = _candidates(
        postings_doc, tc if tc_mode else postings_score, starts, ends, L)
    if tc_mode:
        cscore = tc_score(cscore, idf32[:, 0:1], avg32)

    if T == 1:
        score = torch.where(cvalid, cscore, NEG_INF)
    else:
        # slot-order sequential sums: the same f32 rounding as the
        # reference's reduction on every device (a tree order would move
        # scores by an ulp and with them the boundary flags)
        lo, found, acc, _ = _others(
            postings_doc, tc if tc_mode else postings_score, cdocs,
            starts[:, 1:], ends[:, 1:], n_bs_iters,
            weights=(idf32 if tc_mode else use_score)[:, 1:], avg32=avg32)
        match = found.all(dim=1) & cvalid
        if not tc_mode:
            cscore = cscore * use_score[:, 0:1]
        score = torch.where(match, cscore + acc, NEG_INF)

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
    if tc_mode:
        top_tc = _u16(_gather1d(tc, top_pidx))
        top_tfs = torch.where(kept[:, None, :], top_tc & 0xFF, 0)
        flags = flags | (tc_saturated(top_tc, top_docs).to(torch.int32)
                         * FLAG_TF_SAT)
    else:
        top_tfs = torch.where(kept[:, None, :],
                              _gather1d(postings_tf, top_pidx), 0)
    return top_docs, top_score, top_tfs, top_pidx, flags


def pack_with_flags(top_docs, top_tfs, flags):
    """(B, T+2, M) int32: row 0 docs, rows 1..T per-slot tfs, row T+1 the
    per-query flag word — one device-to-host copy per group."""
    B, _, M = top_tfs.shape
    flag_row = flags[:, None, None].expand(B, 1, M)
    return torch.cat([top_docs[:, None, :], top_tfs, flag_row], dim=1)


def make_search_kernel(T: int, L: int, M: int, n_bs_iters: int,
                       mode: str = "raw"):
    """search_body at fixed shapes, returning the packed (B, T+2, M)
    int32 array. A plain function: torch runs eagerly, nothing to cache.

    raw: fn(postings_doc, postings_score, postings_tf, starts, ends,
            use_score); tc: fn(postings_doc, postings_tc, avg32, starts,
            ends, idf32)."""

    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32):
            top_docs, _, top_tfs, _, flags = search_body(
                postings_doc, None, None, starts, ends, None, T=T, L=L, M=M,
                n_bs_iters=n_bs_iters, tc=postings_tc, idf32=idf32,
                avg32=avg32)
            return pack_with_flags(top_docs, top_tfs, flags)
    else:
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


# -- the windowed block intersection ------------------------------------------


def default_win(L: int, G: int) -> int:
    """Window width in blocks: ~2x the other list's blocks per candidate
    block, at most 16."""
    ratio = max(1, (G * 128) // max(L, 1))
    return min(16, 2 * ratio + 2)


def windowed_search_body(postings_doc, postings_score, postings_tf, starts,
                         ends, use_score, *, T: int, L: int, G: int, M: int,
                         WIN: int, tc=None, idf32=None, avg32=None):
    """AND of long, similar-length lists by windowed block intersection.

    Each 128-lane candidate block is placed against the other list's block
    summaries (first doc of each block, G blocks cover its run): the
    window starts at the last block whose first doc is <= the candidate
    block's min and spans WIN blocks. A query whose candidate block
    overlaps more than WIN blocks (from the summaries alone) raises
    FLAG_OVERFLOW and takes the exact host path; no other query pays for
    it. Inside the window a candidate doc matches at most one lane (doc
    ids are unique in a run, the window row ascends and masked lanes hold
    INT32_MAX), found by a searchsorted into the window row and gathered:
    the same function as the reference's 0/1 equality contraction,
    without its (128 x WIN*128) tensor per block. Partial scores and tc
    lanes of real postings are > 0, so a nonzero payload is membership.

    Scores sum as the bs step sums them: raw cscore * use + the others in
    slot order; tc the others' tc_score in slot order, then added to the
    candidate's. tc mode as in search_body. Returns (top_docs (B, M) i32,
    top_score (B, M) f32, top_tfs (B, T, M) i32, 0 outside the kept lanes,
    flags (B,) i32)."""
    B = starts.shape[0]
    I = L // 128
    tc_mode = tc is not None
    dev = starts.device
    cdocs, cval, cvalid, cs = _candidates(
        postings_doc, tc if tc_mode else postings_score, starts, ends, L)
    cblocks = cdocs.view(B, I, 128)
    cbmin = cblocks[:, :, 0].contiguous()  # the first lane is the min
    cbmax = torch.where(cblocks < INT32_MAX, cblocks, -1).amax(dim=2)
    has_cand = cbmax >= 0
    real = cblocks < INT32_MAX
    g = torch.arange(G, dtype=torch.int64, device=dev)
    w = torch.arange(WIN, dtype=torch.int64, device=dev)
    lane = torch.arange(128, dtype=torch.int64, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    others = []  # per other slot: (B, L) matched payload (score, tf) or tc
    for t in range(1, T):
        st = starts[:, t].to(torch.int64)
        nblocks = (ends[:, t].to(torch.int64) - st + 127) >> 7
        sblock = st >> 7  # runs are 128-aligned
        gvalid = g[None, :] < nblocks[:, None]  # (B, G)
        rows_idx = (sblock[:, None]
                    + torch.minimum(g[None, :], nblocks[:, None] - 1)).clamp(min=0)
        obfirst = torch.where(gvalid, _gather1d(postings_doc, rows_idx * 128),
                              INT32_MAX).to(torch.int32)

        def last_block_le(x):
            # count(obfirst <= x) over the valid blocks - 1, at least 0
            n_le = torch.searchsorted(obfirst, x, right=True)
            return (torch.minimum(n_le, nblocks[:, None]) - 1).clamp(min=0)

        j_lo = last_block_le(cbmin)  # (B, I)
        j_hi = last_block_le(cbmax.contiguous())
        overflow |= ((j_hi - j_lo + 1 > WIN) & has_cand).any(dim=1)
        j = j_lo[:, :, None] + w  # (B, I, WIN)
        wvalid = j < nblocks[:, None, None]
        wrow = sblock[:, None, None] + torch.minimum(
            j, (nblocks - 1).clamp(min=0)[:, None, None])
        widx = (wrow[..., None] * 128 + lane).view(B, I, WIN * 128)
        wdocs = torch.where(wvalid.repeat_interleave(128, dim=2),
                            _gather1d(postings_doc, widx), INT32_MAX)
        pos = torch.searchsorted(wdocs, cblocks).clamp(max=WIN * 128 - 1)
        hit = real & (torch.gather(wdocs, 2, pos) == cblocks)
        pidx = torch.gather(widx, 2, pos).view(B, L)
        hit = hit.view(B, L)
        if tc_mode:
            others.append(torch.where(hit, _u16(_gather1d(tc, pidx)), 0))
        else:
            others.append((torch.where(hit, _gather1d(postings_score, pidx), 0.0),
                           torch.where(hit, _gather1d(postings_tf, pidx), 0)))
    if tc_mode:
        tc_lanes = torch.stack(others, dim=1)  # (B, T-1, L)
        match = (tc_lanes > 0).all(dim=1) & cvalid
        score = tc_score(cval, idf32[:, 0:1], avg32) + _seq_sum(
            tc_score(tc_lanes, idf32[:, 1:, None], avg32))
    else:
        partial = torch.stack([p for p, _ in others], dim=1)
        match = (partial > 0).all(dim=1) & cvalid
        score = cval * use_score[:, 0:1] + _seq_sum(
            partial * use_score[:, 1:, None])
    score = torch.where(match, score, NEG_INF)
    top_score, top_l = two_level_top_m(score, M)
    kept = top_score > NEG_INF
    top_docs = torch.where(kept, torch.gather(cdocs, 1, top_l), -1)
    flags = (boundary_truncated(score, top_score, M).to(torch.int32)
             | overflow.to(torch.int32) * FLAG_OVERFLOW)
    top_rest_l = top_l[:, None, :].expand(B, T - 1, M)
    if tc_mode:
        top_tc = torch.cat([torch.gather(cval, 1, top_l)[:, None, :],
                            torch.gather(tc_lanes, 2, top_rest_l)], dim=1)
        top_tfs = top_tc & 0xFF
        flags = flags | (tc_saturated(top_tc, top_docs).to(torch.int32)
                         * FLAG_TF_SAT)
    else:
        cand_tf = _gather1d(postings_tf, cs[:, None] + top_l.to(torch.int32))
        rest_tf = torch.stack([f for _, f in others], dim=1)
        top_tfs = torch.cat([cand_tf[:, None, :],
                             torch.gather(rest_tf, 2, top_rest_l)], dim=1)
    top_tfs = torch.where(kept[:, None, :], top_tfs, 0)
    return top_docs, top_score, top_tfs, flags


def make_windowed_search_kernel(T: int, L: int, G: int, M: int,
                                mode: str = "raw"):
    """windowed_search_body at fixed shapes (WIN = default_win(L, G)),
    returning the packed (B, T+2, M) int32 array; the arguments are
    make_search_kernel's."""
    win = default_win(L, G)

    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32):
            top_docs, _, top_tfs, flags = windowed_search_body(
                postings_doc, None, None, starts, ends, None, T=T, L=L, G=G,
                M=M, WIN=win, tc=postings_tc, idf32=idf32, avg32=avg32)
            return pack_with_flags(top_docs, top_tfs, flags)
    else:
        def kernel(postings_doc, postings_score, postings_tf, starts, ends,
                   use_score):
            top_docs, _, top_tfs, flags = windowed_search_body(
                postings_doc, postings_score, postings_tf, starts, ends,
                use_score, T=T, L=L, G=G, M=M, WIN=win)
            return pack_with_flags(top_docs, top_tfs, flags)

    return kernel


# -- the dense head-term tier ------------------------------------------------


def dense_scan_body(dense_sc, dense_tf, slots, use_score, *, T: int,
                    N_pad: int, M: int):
    """The raw doc-space dense scan (dense_scan_body_torch's outputs):
    on CUDA tensors the block-list kernel over every block
    (ops/dense.dense_scan), or it raises; on CPU tensors the plain
    version. Both check their arguments first (ValueError)."""
    args = (dense_sc, dense_tf, slots, use_score)
    kw = dict(T=T, N_pad=N_pad, M=M)
    if isinstance(dense_sc, torch.Tensor) and dense_sc.is_cuda:
        return _dense_op.dense_scan(*args, **kw)
    _dense_op.check_inputs(*args, **kw)
    return dense_scan_body_torch(*args, **kw)


def dense_scan_body_torch(dense_sc, dense_tf, slots, use_score, *, T: int,
                          N_pad: int, M: int):
    """The raw doc-space dense scan's plain version: sum the T
    row-gathered (B, N_pad) f32 score rows in slot order from zeros,
    match where every row is nonzero, take the exact top-M lanes (lane =
    doc id within the plane) and gather the per-slot tfs from the dense
    tf rows; the count-based FLAG_TRUNC runs over the full plane.
    Returns (top_docs (B, M) int32 lanes or -1, top_score (B, M) f32,
    tfs (B, T, M) int32, flags (B,))."""
    B = slots.shape[0]
    rows = slots.to(torch.int64)
    score = torch.zeros((B, N_pad), dtype=torch.float32,
                        device=dense_sc.device)
    match = torch.ones((B, N_pad), dtype=torch.bool, device=dense_sc.device)
    for t in range(T):
        sc_t = dense_sc[rows[:, t]]  # (B, N_pad) rows
        match &= sc_t > 0
        score += sc_t * use_score[:, t : t + 1]
    score = torch.where(match, score, NEG_INF)
    del match
    top_score, top_docs = two_level_top_m(score, M)  # lane = doc id
    top_docs = torch.where(top_score > NEG_INF, top_docs, -1).to(torch.int32)
    tfs = torch.stack([
        torch.where(top_docs >= 0,
                    _dense_gather(dense_tf, slots[:, t : t + 1], top_docs), 0)
        for t in range(T)], dim=1)
    trunc = boundary_truncated(score, top_score, M)
    return top_docs, top_score, tfs, trunc.to(torch.int32)


def make_dense_search_kernel(T: int, N_pad: int, M: int):
    """Doc-space dense scan for all-head-term conjunctions
    (dense_scan_body, packed).

    fn(dense_sc (H, N_pad) f32, dense_tf (H, N_pad) i32, slots (B, T)
       i32 rows into H (padded slots repeat slot 0), use_score (B, T) f32)
      -> packed (B, T+2, M) int32."""

    def kernel(dense_sc, dense_tf, slots, use_score):
        top_docs, _, tfs, flags = dense_scan_body(
            dense_sc, dense_tf, slots, use_score, T=T, N_pad=N_pad, M=M)
        return pack_with_flags(top_docs, tfs, flags)

    return kernel


def _dense_tc_lanes(dense_tf, code_hi, slots_t, docs):
    """Composed tc lanes of dense rows slots_t (B, 1) at docs (B, L):
    the uint8 tf plane re-joined with the shared len-code row (code_hi =
    len_code << 8, int32). Lanes out of range clamp (callers mask)."""
    return _compose_tc(_dense_gather(dense_tf, slots_t, docs),
                       _gather1d(code_hi, docs))


def dense_scan_body_tc(dense_tf, len_code, avg32, slots, idf32, *, T: int,
                       N_pad: int, M: int):
    """dense_scan_body over tc columns (dense_scan_body_tc_torch's
    outputs): on CUDA tensors the block-list kernel, or it raises; on CPU
    tensors the plain version, after the same checks."""
    kw = dict(T=T, N_pad=N_pad, M=M, len_code=len_code, avg32=avg32)
    if isinstance(dense_tf, torch.Tensor) and dense_tf.is_cuda:
        return _dense_op.dense_scan(dense_tf, None, slots, idf32, **kw)
    _dense_op.check_inputs(dense_tf, None, slots, idf32, **kw)
    return dense_scan_body_tc_torch(dense_tf, len_code, avg32, slots, idf32,
                                    T=T, N_pad=N_pad, M=M)


def dense_scan_body_tc_torch(dense_tf, len_code, avg32, slots, idf32, *,
                             T: int, N_pad: int, M: int):
    """dense_scan_body_torch over the (H, N_pad) uint8 tf plane and the shared
    (N_pad,) uint8 len-code row: each slot's composed lane (code << 8 |
    tf, 0 where absent) scores by tc_score, summed in slot order from
    zeros (padded slots idf 0); tfs and saturation (FLAG_TF_SAT) from the
    kept lanes, recomposed at the winners. Returns (top_docs, top_score,
    tfs, flags) as dense_scan_body."""
    B = slots.shape[0]
    rows = slots.to(torch.int64)
    code_hi = len_code.to(torch.int32) << 8
    score = torch.zeros((B, N_pad), dtype=torch.float32,
                        device=dense_tf.device)
    match = torch.ones((B, N_pad), dtype=torch.bool, device=dense_tf.device)
    for t in range(T):
        tc_t = _compose_tc(dense_tf[rows[:, t]], code_hi[None, :])
        match &= tc_t > 0
        score += tc_score(tc_t, idf32[:, t : t + 1], avg32)
        del tc_t
    score = torch.where(match, score, NEG_INF)
    del match
    top_score, top_docs = two_level_top_m(score, M)  # lane = doc id
    top_docs = torch.where(top_score > NEG_INF, top_docs, -1).to(torch.int32)
    tfs, flags = _dense_tc_tfs(
        dense_tf, code_hi, slots, top_docs,
        boundary_truncated(score, top_score, M).to(torch.int32), T)
    return top_docs, top_score, tfs, flags


def make_dense_search_kernel_tc(T: int, N_pad: int, M: int):
    """make_dense_search_kernel over tc columns (dense_scan_body_tc,
    packed).

    fn(dense_tf, len_code, avg32, slots (B, T), idf32 (B, T))
      -> packed (B, T+2, M) int32."""

    def kernel(dense_tf, len_code, avg32, slots, idf32):
        return pack_with_flags(*_drop_score(dense_scan_body_tc(
            dense_tf, len_code, avg32, slots, idf32, T=T, N_pad=N_pad, M=M)))

    return kernel


def _drop_score(parts):
    """(top_docs, top_score, tfs, flags) -> (top_docs, tfs, flags), the
    arguments of pack_with_flags."""
    top_docs, _, tfs, flags = parts
    return top_docs, tfs, flags


def _dense_tc_tfs(dense_tf, code_hi, slots, top_docs, flags, T: int):
    """Per-slot tfs of the kept docs (top_docs >= 0, lanes of the plane)
    of a dense tc route from their composed lanes, and the flag word ORed
    with FLAG_TF_SAT where a kept lane is saturated."""
    top_tc = torch.stack([
        _dense_tc_lanes(dense_tf, code_hi, slots[:, t : t + 1], top_docs)
        for t in range(T)], dim=1)
    kept = top_docs >= 0
    flags = flags | tc_saturated(top_tc, top_docs).to(torch.int32) * FLAG_TF_SAT
    return torch.where(kept[:, None, :], top_tc & 0xFF, 0), flags


def _pack_dense_tc(dense_tf, code_hi, slots, top_docs, flags, T: int):
    """Packed output of a dense tc route (_dense_tc_tfs)."""
    return pack_with_flags(top_docs, *_dense_tc_tfs(dense_tf, code_hi, slots,
                                                    top_docs, flags, T))


def make_semidense_kernel(T: int, L: int, M: int, N_pad: int,
                          n_bs: int = 0, n_bs_iters: int = 0):
    """Tail candidate x head others: the candidate run loads
    contiguously; slots 1..n_bs are non-dense others resolved by binary
    search over their (short) CSR runs; every later slot is a dense
    other, whose membership and score per lane is one doc-indexed gather
    into its (N_pad,) row.

    fn(postings_doc, postings_score, postings_tf, dense_sc (H, N_pad),
       dense_tf (H, N_pad), starts (B,T), ends (B,T), use_score (B,T),
       slots (B,T) dense rows for slots 1+n_bs..; others ignored)
      -> packed (B, T+2, M) int32."""

    def kernel(postings_doc, postings_score, postings_tf, dense_sc,
               dense_tf, starts, ends, use_score, slots):
        return pack_with_flags(*_drop_score(_semidense_step(
            postings_doc, postings_score, dense_sc, starts, ends, use_score,
            slots, T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters,
            postings_tf=postings_tf, dense_tf=dense_tf)))

    return kernel


def make_semidense_kernel_tc(T: int, L: int, M: int, N_pad: int,
                             n_bs: int = 0, n_bs_iters: int = 0):
    """make_semidense_kernel over tc columns: the dense rows are the
    (H, N_pad) uint8 tf plane, and a lane's len code comes from the
    candidate's own tc lane (ctc & 0xFF00), so each dense other is still
    one gather per lane. Scores by tc_score; tfs and saturation from the
    kept lanes.

    fn(postings_doc, postings_tc, avg32, dense_tf (H, N_pad) u8, starts,
       ends, idf32 (B, T) slot order, slots) -> packed (B, T+2, M)."""

    def kernel(postings_doc, postings_tc, avg32, dense_tf, starts, ends,
               idf32, slots):
        return pack_with_flags(*_drop_score(_semidense_step(
            postings_doc, postings_tc, dense_tf, starts, ends, idf32, slots,
            T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters, avg32=avg32)))

    return kernel


def _semidense_step(postings_doc, col, dense, starts, ends, weights, slots,
                    *, T, L, M, n_bs, n_bs_iters, postings_tf=None,
                    dense_tf=None, avg32=None, doc_base: int = 0):
    """The semidense step of both column modes. raw: col / dense are the
    score column and plane, weights use_score, tfs gathered from
    postings_tf / dense_tf; tc (avg32 given): col is the tc column, dense
    the uint8 tf plane, weights idf32, tfs from the kept tc lanes.
    doc_base: the doc id of the planes' lane 0 (a mesh shard's first
    doc; a doc's lane is doc - doc_base). Returns (top_docs (B, M) i32 doc
    ids or -1, top_score (B, M) f32, tfs (B, T, M) i32, flags (B,)).

    On CUDA tensors the hand-written kernel (ops/semidense.semidense)
    runs it, or raises; on CPU tensors the plain version,
    _semidense_step_torch. Both check their arguments first
    (ValueError)."""
    args = (postings_doc, col, dense, starts, ends, weights, slots)
    kw = dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters,
              postings_tf=postings_tf, dense_tf=dense_tf, avg32=avg32,
              doc_base=doc_base)
    if isinstance(postings_doc, torch.Tensor) and postings_doc.is_cuda:
        return _semi_op.semidense(*args, **kw)
    _semi_op.check_inputs(*args, **kw)
    return _semidense_step_torch(*args, **kw)


def _semidense_step_torch(postings_doc, col, dense, starts, ends, weights,
                          slots, *, T, L, M, n_bs, n_bs_iters,
                          postings_tf=None, dense_tf=None, avg32=None,
                          doc_base: int = 0):
    """_semidense_step's plain torch version: the reference's operations
    one by one, on any device (the tests and the chip smoke hold the
    kernel against it). The f32 score sums as s0 + (b1 + ... + bn) + d1 +
    d2 + ...: the searched others among themselves first, then each
    dense other in slot order."""
    tc_mode = avg32 is not None
    cdocs, cval, cvalid, cs = _candidates(postings_doc, col, starts, ends, L)
    dense_docs = cdocs - doc_base if doc_base else cdocs
    # sentinel cdocs clamp to lane N_pad-1; cvalid masks them out of
    # the match whatever that lane holds
    match = cvalid
    score = (tc_score(cval, weights[:, 0:1], avg32) if tc_mode
             else cval * weights[:, 0:1])
    lanes = [cval]  # tc lanes per slot (tc mode)
    if n_bs:
        lo, found, acc, hit_tc = _others(
            postings_doc, col, cdocs, starts[:, 1 : 1 + n_bs],
            ends[:, 1 : 1 + n_bs], n_bs_iters,
            weights=weights[:, 1 : 1 + n_bs], avg32=avg32)
        match = match & found.all(dim=1)
        score = score + acc
        if tc_mode:
            lanes += list(hit_tc.unbind(1))
    for t in range(1 + n_bs, T):
        p = _dense_gather(dense, slots[:, t : t + 1], dense_docs)  # (B, L)
        if tc_mode:
            p = _compose_tc(p, cval & 0xFF00)
            lanes.append(p)
            score = score + tc_score(p, weights[:, t : t + 1], avg32)
        else:
            score = score + p * weights[:, t : t + 1]
        match = match & (p > 0)
    score = torch.where(match, score, NEG_INF)
    top_score, top_l = two_level_top_m(score, M)
    kept = top_score > NEG_INF
    top_docs = torch.where(kept, torch.gather(cdocs, 1, top_l), -1)
    top_lanes = top_docs - doc_base if doc_base else top_docs
    flags = boundary_truncated(score, top_score, M).to(torch.int32)
    if tc_mode:
        top_tc = torch.stack([torch.gather(x, 1, top_l) for x in lanes], dim=1)
        tfs = top_tc & 0xFF
        flags = flags | (tc_saturated(top_tc, top_docs).to(torch.int32)
                         * FLAG_TF_SAT)
    else:
        tfs = [_gather1d(postings_tf, cs[:, None] + top_l)]
        for t in range(1, 1 + n_bs):
            tfs.append(_gather1d(postings_tf,
                                 torch.gather(lo[:, t - 1], 1, top_l)))
        for t in range(1 + n_bs, T):
            tfs.append(_dense_gather(dense_tf, slots[:, t : t + 1],
                                     top_lanes))
        tfs = torch.stack(tfs, dim=1)
    return (top_docs, top_score, torch.where(kept[:, None, :], tfs, 0),
            flags)


def _select_ub_blocks(blockmax, slots, weights, *, T: int, NB: int, C: int,
                      blockmax2=None, argpos=None):
    """Per-query 128-doc-block upper bounds and the top-C block pick
    (_select_ub_blocks_torch's outputs): on CUDA tensors the pick kernel
    (ops/dense.dense_pick), or it raises; on CPU tensors the plain
    version, after the same checks (ValueError)."""
    kw = dict(T=T, NB=NB, C=C, blockmax2=blockmax2, argpos=argpos)
    if isinstance(blockmax, torch.Tensor) and blockmax.is_cuda:
        return _dense_op.dense_pick(blockmax, slots, weights, **kw)
    _dense_op.check_pick_inputs(blockmax, slots, weights, **kw)
    return _select_ub_blocks_torch(blockmax, slots, weights, **kw)


def _select_ub_blocks_torch(blockmax, slots, weights, *, T: int, NB: int,
                            C: int, blockmax2=None, argpos=None):
    """_select_ub_blocks's plain version.

    A match needs every live term (weight > 0) present, and a term is
    present in a block iff its blockmax there is > 0, so a block missing
    a live term has joint bound 0. With blockmax2 (each term's
    second-largest block score, with multiplicity) and argpos (the
    argmax lane, uint8), the bound is the max over anchor terms t* of
    bm_t* + sum over t != t* of (bm_t if argpos_t == argpos_t* else
    bm2_t), summed anchor first and then in slot order: it bounds every
    doc of the block (docs at no term's argmax are covered because each
    anchor's bound >= sum bm2).

    Returns (blk (B, C) int64 block ids in ascending order, next_ub (B,)
    f32: the (C+1)-th largest bound, which bounds every unexamined
    block). Of several tied blocks at the cut the lowest ids are kept, as
    lax.top_k keeps them (a stable sort: torch.topk orders ties freely on
    CUDA), so the examined blocks and the flags are the reference's."""
    B = slots.shape[0]
    rows = slots.to(torch.int64)
    feas = torch.ones((B, NB), dtype=torch.bool, device=blockmax.device)
    bms, bm2s, aps = [], [], []
    for t in range(T):
        bm = blockmax[rows[:, t]]
        w = weights[:, t : t + 1]
        bms.append(bm * w)
        feas &= (bm > 0.0) | (w == 0.0)
        if blockmax2 is not None:
            bm2s.append(blockmax2[rows[:, t]] * w)
            aps.append(argpos[rows[:, t]])
    if blockmax2 is None:
        ub = bms[0]
        for t in range(1, T):
            ub = ub + bms[t]
    else:
        ub = torch.full((B, NB), NEG_INF, dtype=torch.float32,
                        device=blockmax.device)
        for ts in range(T):
            bound = bms[ts]  # the anchor's own full max
            for t in range(T):
                if t != ts:
                    bound = bound + torch.where(aps[t] == aps[ts],
                                                bms[t], bm2s[t])
            ub = torch.maximum(ub, bound)
    ub = torch.where(feas, ub, 0.0)
    top_ub, top_idx = _top_stable(ub, C + 1)
    blk, _ = torch.sort(top_idx[:, :C], dim=1)
    return blk, top_ub[:, C]


def prune_guard_flag(top_score, next_ub, ks, *, M: int, eps3: float):
    """FLAG_PRUNE_MISS word: raised unless next_ub < kth * (1 - eps3),
    kth = the per-query k-th kept f32 score (NEG_INF when fewer than k
    matches, so then any nonzero unexamined bound flags). 1 - eps3 is
    rounded to f32 first, as the reference's np.float32 constant."""
    k_idx = (ks.to(torch.int64) - 1).clamp(0, M - 1)
    kth = torch.gather(top_score, 1, k_idx[:, None])[:, 0]
    miss = (next_ub > 0) & (next_ub >= kth * float(np.float32(1.0 - eps3)))
    return miss.to(torch.int32) * FLAG_PRUNE_MISS


def make_pruned_dense_kernel(T: int, NB: int, C: int, M: int, eps3: float):
    """Block-max pruned dense scan (raw columns; pruned_scan_body), with
    FLAG_PRUNE_MISS where an unexamined block could reach or tie the k-th
    kept score.

    fn(dense_sc (H, NB*128) f32, dense_tf (H, NB*128) i32, blockmax,
       blockmax2 (H, NB) f32, argpos (H, NB) u8, slots (B, T) i32,
       use_score (B, T) f32, ks (B,) i32) -> packed (B, T+2, M) int32."""

    def kernel(dense_sc, dense_tf, blockmax, blockmax2, argpos, slots,
               use_score, ks):
        return _pack_pruned(pruned_scan_body(
            dense_sc, dense_tf, None, None, blockmax, blockmax2, argpos,
            slots, use_score, T=T, NB=NB, C=C, M=M), ks, M, eps3)

    return kernel


def make_pruned_dense_kernel_tc(T: int, NB: int, C: int, M: int,
                                eps3: float):
    """make_pruned_dense_kernel over the uint8 tf plane and the shared
    len-code row (pruned_scan_body's tc mode).

    fn(dense_tf (H, NB*128) u8, len_code (NB*128,) u8, avg32, blockmax,
       blockmax2 (H, NB) f32, argpos (H, NB) u8, slots (B, T), idf32
       (B, T) f32, ks (B,)) -> packed (B, T+2, M) int32."""

    def kernel(dense_tf, len_code, avg32, blockmax, blockmax2, argpos,
               slots, idf32, ks):
        return _pack_pruned(pruned_scan_body(
            dense_tf, None, len_code, avg32, blockmax, blockmax2, argpos,
            slots, idf32, T=T, NB=NB, C=C, M=M), ks, M, eps3)

    return kernel


def _pack_pruned(parts, ks, M: int, eps3: float):
    """Packed output of a pruned scan, its flags ORed with the prune
    guard of its own next_ub."""
    top_docs, top_score, tfs, flags, next_ub = parts
    return pack_with_flags(
        top_docs, tfs,
        flags | prune_guard_flag(top_score, next_ub, ks, M=M, eps3=eps3))


def pruned_scan_body(dense, dense_tf, len_code, avg32, blockmax, blockmax2,
                     argpos, slots, weights, *, T: int, NB: int, C: int,
                     M: int):
    """The block-max pruned scan (pruned_scan_body_torch's outputs): on
    CUDA tensors the pick kernel, then the block-list scan kernel over
    the C picked blocks (ops/dense), or it raises; on CPU tensors the
    plain version, after the same checks (ValueError)."""
    tc_mode = avg32 is not None
    if not tc_mode:
        len_code = None  # raw planes carry no len-code row
    args = (dense, dense_tf, len_code, avg32, blockmax, blockmax2, argpos,
            slots, weights)
    kw = dict(T=T, NB=NB, C=C, M=M)
    if isinstance(dense, torch.Tensor) and dense.is_cuda:
        if not _dense_op.pruned_args_ok(*args, **kw):
            _dense_op.check_pruned_inputs(*args, **kw)
        blk, next_ub = _select_ub_blocks(
            blockmax, slots, (weights > 0).to(torch.float32) if tc_mode
            else weights, T=T, NB=NB, C=C, blockmax2=blockmax2,
            argpos=argpos)
        top_docs, top_score, tfs, flags = _dense_op.dense_scan(
            dense, dense_tf, slots, weights, T=T, N_pad=NB * 128, M=M,
            blocks=blk, len_code=len_code, avg32=avg32)
        return top_docs, top_score, tfs, flags, next_ub
    _dense_op.check_pruned_inputs(*args, **kw)
    return pruned_scan_body_torch(*args, **kw)


def pruned_scan_body_torch(dense, dense_tf, len_code, avg32, blockmax,
                           blockmax2, argpos, slots, weights, *, T: int,
                           NB: int, C: int, M: int):
    """The block-max pruned scan's plain version, both column modes:
    the C highest-bound blocks per query, their lanes scored in slot
    order from zeros (the same order as the bound, one addend per slot,
    so every lane's f32 score <= its block's bound), exact top-M, tfs and
    FLAG_TRUNC.

    raw (avg32 None): dense is the f32 score plane, dense_tf the tf
    plane, weights use_score. tc: dense is the uint8 tf plane composed per
    selected block with the len-code row, weights idf32; the block planes
    hold the host's f64 bound on the in-kernel f32 tc_score x (1 + 2e-6)
    (idf included), so the bound's weights are idf32 > 0 (padded slots
    add no bound), and kept saturated lanes raise FLAG_TF_SAT. Without
    blockmax2 / argpos the bound is the plain sum of the block maxima.

    Returns (top_docs (B, M) int32 lanes of the plane or -1, top_score
    (B, M) f32, tfs (B, T, M) i32, flags (B,) i32, next_ub (B,) f32: the
    bound of every unexamined block, for the prune guard)."""
    B = slots.shape[0]
    rows = slots.to(torch.int64)
    tc_mode = avg32 is not None
    if tc_mode:
        code_hi = len_code.to(torch.int32) << 8
        code_rows = code_hi.view(NB, 128)
        bound_w = (weights > 0).to(torch.float32)
    else:
        bound_w = weights
    blk, next_ub = _select_ub_blocks_torch(
        blockmax, slots, bound_w, T=T, NB=NB, C=C,
        blockmax2=blockmax2, argpos=argpos)
    plane_rows = dense.view(dense.shape[0] * NB, 128)
    lane = torch.arange(128, dtype=torch.int64, device=blk.device)
    cand_docs = (blk[:, :, None] * 128 + lane).reshape(B, C * 128)
    match = torch.ones((B, C, 128), dtype=torch.bool, device=blk.device)
    score = torch.zeros((B, C, 128), dtype=torch.float32, device=blk.device)
    for t in range(T):
        p = plane_rows[rows[:, t : t + 1] * NB + blk]  # (B, C, 128)
        if tc_mode:
            p = _compose_tc(p, code_rows[blk])
            contrib = tc_score(p, weights[:, t, None, None], avg32)
        else:
            contrib = p * weights[:, t, None, None]
        match &= p > 0
        score += contrib
    score = torch.where(match, score, NEG_INF).reshape(B, C * 128)
    del match
    top_score, top_l = two_level_top_m(score, M)
    top_docs = torch.where(top_score > NEG_INF,
                           torch.gather(cand_docs, 1, top_l), -1
                           ).to(torch.int32)
    flags = boundary_truncated(score, top_score, M).to(torch.int32)
    if tc_mode:
        tfs, flags = _dense_tc_tfs(dense, code_hi, slots, top_docs, flags, T)
    else:
        tfs = torch.stack([
            torch.where(top_docs >= 0,
                        _dense_gather(dense_tf, slots[:, t : t + 1], top_docs),
                        0)
            for t in range(T)], dim=1)
    return top_docs, top_score, tfs, flags, next_ub


# -- phrases -------------------------------------------------------------------


def _top_stable(x: torch.Tensor, k: int):
    """Top-k along dim 1 with lax.top_k's tie order (equal values by
    ascending index): a stable descending sort, then the first k."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 lanes holding 32-bit values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _bloom_gate(pidx, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
                probe_begins, probe_mask, probe_active):
    """Chained bi-bloom probes over per-lane posting indices (the
    IsPossibleToPresent analog, query_processing.h:784-807) against the
    sparse folded bloom columns (the BloomBoxWriter presence-bitmap layout,
    flash_containers.h:532-561). uint32 words are held as int32 bits:

      bloom_bitmap: (2*P/32,) presence bits, following side then
                    preceding side; a set bit = a filter row is stored
      bloom_rank:   (2*P/32,) int32 stored rows before each 32-group
      bloom_rows:   (NNZ,) single-word folded filter rows
      probe_slot (B, C) i32 slot of pidx probed; probe_begins (B, C) bool
      side; probe_mask (B, C) folded masks (pass iff (row & m) == m);
      probe_active (B, C) bool (an inactive probe passes)

    An absent row is an empty filter (prune). Returns (B, L) pass flags;
    a failing lane has no phrase match."""
    B, C = probe_slot.shape
    L = pidx.shape[2]
    Pw = bloom_bitmap.shape[0] // 2  # bitmap words per side
    slot_pidx = torch.gather(
        pidx, 1, probe_slot.to(torch.int64)[:, :, None].expand(B, C, L))
    sp = slot_pidx.to(torch.int64) + torch.where(
        probe_begins[:, :, None], Pw * 32, 0)  # (B, C, L)
    w_idx = sp >> 5
    word = _gather1d(bloom_bitmap, w_idx).to(torch.int64) & 0xFFFFFFFF
    bit = sp & 31
    present = ((word >> bit) & 1) != 0
    below = word & (torch.bitwise_left_shift(torch.ones_like(bit), bit) - 1)
    rank = _gather1d(bloom_rank, w_idx).to(torch.int64) + _popcount32(below)
    row = _gather1d(bloom_rows, rank)
    m = probe_mask[:, :, None]
    probe_pass = (present & ((row & m) == m)) | ~probe_active[:, :, None]
    return probe_pass.all(dim=1)


def _match_step(postings_doc, col, starts, ends, weights, *, T: int, L: int,
                n_bs_iters: int, avg32=None):
    """Candidate load + bs intersection of slots 1.. -> (cdocs, match,
    pidx (B, T, L) i32 posting index per slot, score f32 in slot order,
    sat_lane). raw: col is the score column, weights use_score, sat_lane
    None; tc (avg32 given): col is the tc column, weights idf32, and
    sat_lane (B, L) marks lanes with a saturated tf byte in a matched
    slot."""
    cdocs, cval, cvalid, cs = _candidates(postings_doc, col, starts, ends, L)
    lane = torch.arange(L, dtype=torch.int32, device=starts.device)
    lo, found, acc, hit_tc = _others(
        postings_doc, col, cdocs, starts[:, 1:], ends[:, 1:], n_bs_iters,
        weights=weights[:, 1:], avg32=avg32)
    match = found.all(dim=1) & cvalid
    pidx = torch.cat([(cs[:, None] + lane[None, :])[:, None, :], lo], dim=1)
    sat_lane = None
    if avg32 is None:
        score = cval * weights[:, 0:1] + acc
    else:
        score = tc_score(cval, weights[:, 0:1], avg32) + acc
        sat_lane = (((cval & 0xFF) >= TF_SAT)
                    | (found & ((hit_tc & 0xFF) >= TF_SAT)).any(dim=1))
    return cdocs, match, pidx, score, sat_lane


def make_match_kernel_tc(T: int, L: int, n_bs_iters: int):
    """make_match_kernel over the tc column, returning also the (B, L)
    sat_lane mask the select step flags kept lanes by.

    fn(postings_doc, postings_tc, avg32, starts, ends, idf32, bloom_rows,
       bloom_bitmap, bloom_rank, probe_slot, probe_begins, probe_mask,
       probe_active) -> (match, bloom_pass, cdocs, pidx, score, sat_lane)."""

    def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32,
               bloom_rows, bloom_bitmap, bloom_rank, *probes):
        cdocs, match, pidx, score, sat_lane = _match_step(
            postings_doc, postings_tc, starts, ends, idf32, T=T, L=L,
            n_bs_iters=n_bs_iters, avg32=avg32)
        bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap, bloom_rank,
                                 *probes)
        return match, bloom_pass, cdocs, pidx, score, sat_lane

    return kernel


def make_match_kernel(T: int, L: int, n_bs_iters: int):
    """Phase 1 of the list-chain phrase: intersection, per-lane posting
    indices and the bloom gate. T >= 2; slot 0 = candidate.

    fn(postings_doc, postings_score, starts, ends, use_score, bloom_rows,
       bloom_bitmap, bloom_rank, probe_slot, probe_begins, probe_mask,
       probe_active) -> (match (B, L) bool, bloom_pass (B, L) bool,
       cdocs (B, L) i32, pidx (B, T, L) i32, score (B, L) f32)."""

    def kernel(postings_doc, postings_score, starts, ends, use_score,
               bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
               probe_begins, probe_mask, probe_active):
        cdocs, match, pidx, score, _ = _match_step(
            postings_doc, postings_score, starts, ends, use_score,
            T=T, L=L, n_bs_iters=n_bs_iters)
        bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap, bloom_rank,
                                 probe_slot, probe_begins, probe_mask,
                                 probe_active)
        return match, bloom_pass, cdocs, pidx, score

    return kernel


def make_phrase_verify_kernel(T: int, L: int, PP: int, n_pos_iters: int):
    """Adjusted-position phrase verification over matched lanes
    (PhraseQueryProcessor2, query_processing.h:266-362): a phrase occurs
    at base x iff term t is at x + t for every t. Bases come from query
    term 0's bag (at most PP positions); membership of x + t in term t's
    bag is a binary search over the positions column. pidx is in query
    term order.

    fn(positions, pos_starts i32, pidx (B, T, L), active (B, L))
      -> n_matches (B, L) int32."""

    def kernel(positions, pos_starts, pidx, active):
        ps = _gather1d(pos_starts, pidx)
        pe = _gather1d(pos_starts, pidx + 1)
        lane = torch.arange(PP, dtype=torch.int32, device=pidx.device)
        base_idx = ps[:, 0, None, :] + lane[None, :, None]  # (B, PP, L)
        base_valid = base_idx < pe[:, 0, None, :]
        base_pos = torch.where(base_valid, _pos_gather(positions, base_idx),
                               INT32_MAX - T)
        ok = base_valid
        for t in range(1, T):
            tgt = base_pos + t
            lo = _binary_search(positions, tgt, ps[:, t, None, :],
                                pe[:, t, None, :], n_pos_iters,
                                gather=_pos_gather)
            ok = ok & (lo < pe[:, t, None, :]) & (_pos_gather(positions, lo)
                                                  == tgt)
        return (ok & active[:, None, :]).sum(dim=1).to(torch.int32)

    return kernel


def _gather_slots(pidx, lanes):
    """pidx (B, T, N) at lanes (B, M) -> (B, T, M)."""
    B, T, _ = pidx.shape
    return torch.gather(pidx, 2, lanes.to(torch.int64)[:, None, :].expand(
        B, T, lanes.shape[1]))


def make_select_topk_kernel(T: int, L: int, M: int):
    """Phase 3 of the list chain: exact top-M over the verified lanes (a
    stable sort: lax.top_k's order, equal scores by ascending lane) and
    the per-slot tfs at the winners.

    fn(postings_tf, cdocs, pidx, score, match) -> packed (B, T+2, M)."""

    def kernel(postings_tf, cdocs, pidx, score, match):
        score = torch.where(match, score, NEG_INF)
        top_score, top_l = _top_stable(score, M)
        top_docs = torch.where(top_score > NEG_INF,
                               torch.gather(cdocs, 1, top_l), -1)
        top_tfs = torch.where(top_docs[:, None, :] >= 0,
                              _gather1d(postings_tf, _gather_slots(pidx, top_l)),
                              0)
        trunc = boundary_truncated(score, top_score, M)
        return pack_with_flags(top_docs, top_tfs, trunc.to(torch.int32))

    return kernel


def make_select_topk_kernel_tc(T: int, L: int, M: int):
    """make_select_topk_kernel over the tc column: tfs from the tc lanes
    at the winning posting indices; FLAG_TF_SAT where a kept lane's
    sat_lane (make_match_kernel_tc) is set.

    fn(postings_tc, cdocs, pidx, score, match, sat_lane)
      -> packed (B, T+2, M)."""

    def kernel(postings_tc, cdocs, pidx, score, match, sat_lane):
        score = torch.where(match, score, NEG_INF)
        top_score, top_l = _top_stable(score, M)
        top_docs = torch.where(top_score > NEG_INF,
                               torch.gather(cdocs, 1, top_l), -1)
        return _pack_tc_lanes(postings_tc, _gather_slots(pidx, top_l),
                              torch.gather(sat_lane, 1, top_l), top_docs,
                              boundary_truncated(score, top_score, M)
                              .to(torch.int32))

    return kernel


def _pack_tc_lanes(postings_tc, top_pidx, top_sat, top_docs, flags):
    """Packed output of a tc list route: per-slot tfs from the tc lanes
    at the winners' posting indices (B, T, M), the flag word ORed with
    FLAG_TF_SAT where a kept lane's saturation mask top_sat (B, M) is
    set."""
    kept = top_docs >= 0
    top_tfs = torch.where(kept[:, None, :],
                          _u16(_gather1d(postings_tc, top_pidx)) & 0xFF, 0)
    sat = (top_sat & kept).any(dim=1)
    return pack_with_flags(top_docs, top_tfs,
                           flags | sat.to(torch.int32) * FLAG_TF_SAT)


def list_phrase(postings_doc, col, positions, pos_starts, starts, ends,
                weights, slot_of, bloom_rows, bloom_bitmap, bloom_rank,
                probe_slot, probe_begins, probe_mask, probe_active, *, T: int,
                L: int, PP: int, M: int, n_bs_iters: int, n_pos_iters: int,
                postings_tf=None, avg32=None, gate: bool = True):
    """The list-chain phrase (L <= PRUNED_PHRASE_KV) as one call: match
    with the bi-bloom gate, the adjusted-position verify of the active
    lanes in query-term order (slot_of), the exact top-M with tfs. raw:
    col the f32 scores and postings_tf; tc: col the tc lanes and avg32
    (tfs from the tc lanes, FLAG_TF_SAT from the kept lanes'
    saturation). Returns the packed (B, T+2, M) int32 output. gate=False
    is the bloomless chain (phrase_body, the mesh's list route): the
    bloom and probe arguments are not read and may be None, and it
    returns (packed, top_score (B, M) f32), as phrase_body does.

    On CUDA tensors the hand-written kernel (ops/phrase_route.
    list_phrase) runs it, or raises; on CPU tensors the plain version,
    list_phrase_torch with the gate, phrase_body without it. Both check
    their arguments first (ValueError)."""
    kw = dict(T=T, L=L, PP=PP, M=M, n_bs_iters=n_bs_iters,
              n_pos_iters=n_pos_iters, postings_tf=postings_tf, avg32=avg32)
    args = (postings_doc, col, positions, pos_starts, starts, ends, weights,
            slot_of, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
            probe_begins, probe_mask, probe_active)
    if isinstance(postings_doc, torch.Tensor) and postings_doc.is_cuda:
        return _route_op.list_phrase(*args, gate=gate, **kw)
    _route_op.check_list_inputs(*args, gate=gate, **kw)
    if gate:
        return list_phrase_torch(*args, **kw)
    tc = avg32 is not None
    return phrase_body(
        postings_doc, None if tc else col, postings_tf, positions, pos_starts,
        starts, ends, None if tc else weights, slot_of, T=T, L=L, PP=PP, M=M,
        n_bs_iters=n_bs_iters, n_pos_iters=n_pos_iters,
        tc=col if tc else None, idf32=weights if tc else None, avg32=avg32)


def list_phrase_torch(postings_doc, col, positions, pos_starts, starts, ends,
                      weights, slot_of, bloom_rows, bloom_bitmap, bloom_rank,
                      probe_slot, probe_begins, probe_mask, probe_active, *,
                      T: int, L: int, PP: int, M: int, n_bs_iters: int,
                      n_pos_iters: int, postings_tf=None, avg32=None):
    """list_phrase's plain torch version: the reference's three steps
    (make_match_kernel{,_tc}, make_phrase_verify_kernel,
    make_select_topk_kernel{,_tc}) with the torch steps between them, on
    any device (the tests and the chip smoke hold the kernel against
    it)."""
    blooms = (bloom_rows, bloom_bitmap, bloom_rank, probe_slot, probe_begins,
              probe_mask, probe_active)
    if avg32 is None:
        match, bloom_pass, cdocs, pidx, score = make_match_kernel(
            T, L, n_bs_iters)(postings_doc, col, starts, ends, weights,
                              *blooms)
        sat_lane = ()
    else:
        match, bloom_pass, cdocs, pidx, score, sat = make_match_kernel_tc(
            T, L, n_bs_iters)(postings_doc, col, avg32, starts, ends,
                              weights, *blooms)
        sat_lane = (sat,)
    active = match & bloom_pass
    n_matches = make_phrase_verify_kernel(T, L, PP, n_pos_iters)(
        positions, pos_starts, _slot_gather_q(pidx, slot_of), active)
    final = active & (n_matches > 0)
    if avg32 is None:
        return make_select_topk_kernel(T, L, M)(postings_tf, cdocs, pidx,
                                                score, final)
    return make_select_topk_kernel_tc(T, L, M)(col, cdocs, pidx, score,
                                               final, *sat_lane)


def phrase_body(postings_doc, postings_score, postings_tf, positions,
                pos_starts, starts, ends, use_score, slot_of, *, T: int,
                L: int, PP: int, M: int, n_bs_iters: int, n_pos_iters: int,
                tc=None, idf32=None, avg32=None):
    """The self-contained bloomless phrase pipeline: bs match of slots 1..
    against the slot-0 candidate run, adjusted-position verify of the
    matched lanes in query-term order (bases from query term 0's bag, at
    most PP of them), exact top-M. The bi-bloom gate only prunes, so a
    scratch column set without bloom rows gives the same answers.

    slot_of: (B, T) query term -> kernel slot. tc mode: pass the tc
    column as tc, idf32 ((B, T) f32 in slot order, 0 on padded slots)
    and avg32 instead of the score / tf columns and use_score; kept lanes
    with a saturated tf byte in a matched slot raise FLAG_TF_SAT. Returns
    (packed (B, T+2, M) int32, top_score (B, M) f32)."""
    tc_mode = tc is not None
    cdocs, match, pidx, score, sat_lane = _match_step(
        postings_doc, tc if tc_mode else postings_score, starts, ends,
        idf32 if tc_mode else use_score, T=T, L=L, n_bs_iters=n_bs_iters,
        avg32=avg32 if tc_mode else None)
    n_matches = make_phrase_verify_kernel(T, L, PP, n_pos_iters)(
        positions, pos_starts, _slot_gather_q(pidx, slot_of), match)
    score = torch.where(match & (n_matches > 0), score, NEG_INF)
    top_score, top_l = two_level_top_m(score, M)
    top_docs = torch.where(top_score > NEG_INF,
                           torch.gather(cdocs, 1, top_l), -1)
    top_pidx = _gather_slots(pidx, top_l)
    flags = boundary_truncated(score, top_score, M).to(torch.int32)
    if tc_mode:
        packed = _pack_tc_lanes(tc, top_pidx, torch.gather(sat_lane, 1, top_l),
                                top_docs, flags)
    else:
        packed = pack_with_flags(
            top_docs, torch.where(top_docs[:, None, :] >= 0,
                                  _gather1d(postings_tf, top_pidx), 0), flags)
    return packed, top_score


def make_phrase_kernel(T: int, L: int, PP: int, M: int, n_bs_iters: int,
                       n_pos_iters: int):
    """phrase_body (raw columns) at fixed shapes: the staged cold tier's
    phrase step over a scratch column set, which carries no bloom rows.

    fn(postings_doc, postings_score, postings_tf, positions, pos_starts,
       starts, ends, use_score, slot_of) -> packed (B, T+2, M) int32."""

    def kernel(postings_doc, postings_score, postings_tf, positions,
               pos_starts, starts, ends, use_score, slot_of):
        packed, _ = phrase_body(
            postings_doc, postings_score, postings_tf, positions, pos_starts,
            starts, ends, use_score, slot_of, T=T, L=L, PP=PP, M=M,
            n_bs_iters=n_bs_iters, n_pos_iters=n_pos_iters)
        return packed

    return kernel


def _verify_pos_windows_torch(positions, ps, pe, anchor, *, T: int, NL: int,
                              PP: int, PW: int):
    """Adjusted-position verification by windows, in plain torch (the
    reference's _verify_pos_windows, on any device): each (term, lane) bag
    loads as one contiguous PW-wide window at its start, then a dense
    (PP x PW) equality compare per lane. ps/pe: (B, T, NL) int32 bag
    bounds; anchor: (B,) int32, the query term whose bag gives the bases
    y = pos - anchor; term t must hold y + t. PP bounds the anchor's bag,
    PW every term's. A window start is clamped to [0, n - PW] as
    dynamic_slice clamps it: the engine pads the positions column with
    POS_PAD >= PW entries that never equal a target, so a real window is
    never clamped. Returns (B, NL) int32 phrase occurrence counts. The
    kernel (_verify_docs) finds the bag bounds itself; its plain version
    and _verify_pidx_torch end here."""
    B = ps.shape[0]
    n = positions.shape[0]
    j = torch.arange(PW, dtype=torch.int64, device=ps.device)
    start = ps.to(torch.int64).clamp(0, max(0, n - PW))
    win = _pos_gather(positions, start[..., None] + j)  # (B, T, NL, PW)
    valid = j < (pe - ps).to(torch.int64)[..., None]
    a = anchor.to(torch.int64)
    rows = torch.arange(B, device=ps.device)
    win_a = win[rows, a]  # (B, NL, PW)
    valid_a = valid[rows, a]
    y = win_a[:, :, :PP] - anchor.to(torch.int32)[:, None, None]
    ok = valid_a[:, :, :PP]  # (B, NL, PP)
    for t in range(T):
        eq = ((y + t)[:, :, :, None] == win[:, t][:, :, None, :]) \
            & valid[:, t][:, :, None, :]
        ok = ok & eq.any(dim=3)
    return ok.sum(dim=2).to(torch.int32)


def _verify_docs(postings_doc, positions, pos_starts, docs, starts, ends,
                 anchor, *, T: int, NL: int, PP: int, PW: int, n_iters: int):
    """The mega routes' verification from kept docs: each doc's posting
    index in each query term's run [starts, ends) by the fixed-count
    search (_binary_search, n_iters halvings), its bag bounds from
    pos_starts, then the window verification (_verify_pos_windows_torch)
    anchored on anchor (B,). docs
    (B, NL) int32 (a lane past the matched ones recovers in-range
    garbage, masked by the caller); starts, ends (B, T) in query-term
    order. Returns (B, NL) int32 counts.

    On CUDA tensors the hand-written kernel (ops/phrase.phrase_verify_docs:
    the search and the gathers inside it), or it raises; on CPU tensors
    the plain version, _verify_docs_torch. Both check their arguments
    first (ValueError)."""
    kw = dict(T=T, NL=NL, PP=PP, PW=PW)
    if isinstance(positions, torch.Tensor) and positions.is_cuda:
        return _phrase_op.phrase_verify_docs(
            postings_doc, positions, pos_starts, docs, starts, ends, anchor,
            n_iters=n_iters, **kw)
    _phrase_op.check_docs_inputs(postings_doc, positions, pos_starts, docs,
                                 starts, ends, anchor, n_iters=n_iters, **kw)
    return _verify_docs_torch(postings_doc, positions, pos_starts, docs,
                              starts, ends, anchor, n_iters=n_iters, **kw)


def _verify_docs_torch(postings_doc, positions, pos_starts, docs, starts,
                       ends, anchor, *, T: int, NL: int, PP: int, PW: int,
                       n_iters: int):
    """_verify_docs's plain torch version: the (B, T, NL) search planes,
    the two pos_starts gathers and _verify_pos_windows_torch (on any
    device; the tests and the chip smoke hold the kernel against it)."""
    B = docs.shape[0]
    lo = _binary_search(postings_doc, docs[:, None, :].expand(B, T, NL),
                        starts[:, :, None], ends[:, :, None], n_iters)
    return _verify_pos_windows_torch(
        positions, _gather1d(pos_starts, lo), _gather1d(pos_starts, lo + 1),
        anchor, T=T, NL=NL, PP=PP, PW=PW)


def _verify_pidx_torch(positions, pos_starts, pidx, slot_of, *, T: int,
                       NL: int, PP: int, PW: int):
    """The verification from posting indices that the compact and
    semidense phrase routes' plain versions end in (_verify_and_select;
    their kernels verify in csrc/phrase_route.cu), in plain torch on any
    device: pidx (B, T, NL) int32 in slot order, slot_of (B, T) (query
    term -> slot), the slot gather (_slot_gather_q), the two pos_starts
    gathers and _verify_pos_windows_torch anchored on query term 0.
    Returns (B, NL) int32 counts."""
    pidx_q = _slot_gather_q(pidx, slot_of)
    return _verify_pos_windows_torch(
        positions, _gather1d(pos_starts, pidx_q),
        _gather1d(pos_starts, pidx_q + 1),
        torch.zeros(pidx.shape[0], dtype=torch.int32, device=pidx.device),
        T=T, NL=NL, PP=PP, PW=PW)


def _slot_gather_q(sel_pidx, slot_of):
    """sel_pidx (B, T, N) in slot order -> query-term order via slot_of
    (B, T) (query term t -> slot)."""
    B, T, N = sel_pidx.shape
    return torch.gather(sel_pidx, 1, slot_of.to(torch.int64)[:, :, None]
                        .expand(B, T, N))


def _verify_and_select(positions, pos_starts, sel_score, sel_docs,
                       sel_pidx, slot_of, ks, unseen, *, T, KV, PP, PW, M,
                       eps3):
    """Shared tail of the compact and semidense phrase routes: window
    verify of the KV compacted lanes in query-term order (anchored on
    query term 0), the stable top-M of the verified (lax.top_k's order, so
    the first M verified in selection order) and the flag word (FLAG_TRUNC
    over the KV lanes; FLAG_PRUNE_MISS where the (KV+1)-th surviving
    score `unseen` could reach the k-th kept). Returns (top_docs (B, M),
    top_l (B, M) indices into the KV lanes, flags (B,), top_score (B, M))."""
    n_matches = _verify_pidx_torch(positions, pos_starts, sel_pidx,
                                   slot_of, T=T, NL=KV, PP=PP, PW=PW)
    final_score = torch.where((sel_score > NEG_INF) & (n_matches > 0),
                              sel_score, NEG_INF)
    top_score, top_l = _top_stable(final_score, M)
    top_docs = torch.where(top_score > NEG_INF,
                           torch.gather(sel_docs, 1, top_l), -1)
    flags = (boundary_truncated(final_score, top_score, M).to(torch.int32)
             | prune_guard_flag(top_score, unseen, ks, M=M, eps3=eps3))
    return top_docs, top_l, flags, top_score


def compact_phrase_body(postings_doc, postings_score, postings_tf, positions,
                        pos_starts, starts, ends, use_score, slot_of, ks,
                        bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
                        probe_begins, probe_mask, probe_active, *, T: int,
                        L: int, KV: int, PP: int, PW: int, M: int,
                        n_bs_iters: int, eps3: float, tc_mode: bool = False,
                        avg32=None):
    """The compact phrase route's (packed (B, T+2, M), top_score (B, M)
    f32); the arguments as compact_phrase_body_torch takes them.

    On CUDA tensors the hand-written kernels (ops/phrase_route.
    compact_phrase) run it, or raise; on CPU tensors the plain version,
    compact_phrase_body_torch. Both check their arguments first
    (ValueError)."""
    args = (postings_doc, postings_score, positions, pos_starts, starts,
            ends, use_score, slot_of, ks, bloom_rows, bloom_bitmap,
            bloom_rank, probe_slot, probe_begins, probe_mask, probe_active)
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters,
              eps3=eps3, postings_tf=None if tc_mode else postings_tf,
              avg32=avg32 if tc_mode else None)
    if isinstance(postings_doc, torch.Tensor) and postings_doc.is_cuda:
        return _route_op.compact_phrase(*args, **kw)
    _route_op.check_compact_inputs(*args, **kw)
    return compact_phrase_body_torch(
        postings_doc, postings_score, postings_tf, positions, pos_starts,
        starts, ends, use_score, slot_of, ks, bloom_rows, bloom_bitmap,
        bloom_rank, probe_slot, probe_begins, probe_mask, probe_active, T=T,
        L=L, KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters, eps3=eps3,
        tc_mode=tc_mode, avg32=avg32)


def compact_phrase_body_torch(postings_doc, postings_score, postings_tf,
                              positions, pos_starts, starts, ends, use_score,
                              slot_of, ks, bloom_rows, bloom_bitmap,
                              bloom_rank, probe_slot, probe_begins,
                              probe_mask, probe_active, *, T: int, L: int,
                              KV: int, PP: int, PW: int, M: int,
                              n_bs_iters: int, eps3: float,
                              tc_mode: bool = False, avg32=None):
    """compact_phrase_body's plain torch version (on any device; the
    tests and the chip smoke hold the kernels against it). The compact
    phrase pipeline: bs match + bloom gate over L lanes,
    compaction to the KV best-scored surviving lanes (stable: score desc,
    index asc, so the canonical set), window verify of those only, top-M.
    Bloom-failing lanes are proven non-matches; the (KV+1)-th surviving
    score bounds every unverified lane (the prune guard's proof).
    tc_mode: postings_score is the tc column, use_score the slot-order
    idf32 and postings_tf unused; tfs come from the tc lanes and kept
    saturated lanes raise FLAG_TF_SAT. Returns (packed (B, T+2, M), top_score
    (B, M) f32)."""
    cdocs, match, pidx, score, sat_lane = _match_step(
        postings_doc, postings_score, starts, ends, use_score,
        T=T, L=L, n_bs_iters=n_bs_iters, avg32=avg32 if tc_mode else None)
    bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap, bloom_rank,
                             probe_slot, probe_begins, probe_mask,
                             probe_active)
    mscore = torch.where(match & bloom_pass, score, NEG_INF)
    top_cs, top_cl = _top_stable(mscore, KV + 1)
    sel_l = top_cl[:, :KV]
    sel_pidx = _gather_slots(pidx, sel_l)
    top_docs, top_l, flags, top_score = _verify_and_select(
        positions, pos_starts, top_cs[:, :KV], torch.gather(cdocs, 1, sel_l),
        sel_pidx, slot_of, ks, top_cs[:, KV], T=T, KV=KV, PP=PP, PW=PW, M=M,
        eps3=eps3)
    top_pidx = _gather_slots(sel_pidx, top_l)
    if tc_mode:
        top_sat = torch.gather(torch.gather(sat_lane, 1, sel_l), 1, top_l)
        return _pack_tc_lanes(postings_score, top_pidx, top_sat, top_docs,
                              flags), top_score
    top_tfs = torch.where(top_docs[:, None, :] >= 0,
                          _gather1d(postings_tf, top_pidx), 0)
    return pack_with_flags(top_docs, top_tfs, flags), top_score


def make_compact_phrase_kernel(T: int, L: int, KV: int, PP: int, PW: int,
                               M: int, n_bs_iters: int, eps3: float,
                               mode: str = "raw"):
    """compact_phrase_body at fixed shapes.

    raw: fn(postings_doc, postings_score, postings_tf, positions,
            pos_starts, starts, ends, use_score, slot_of, ks, bloom_rows,
            bloom_bitmap, bloom_rank, probe_slot, probe_begins, probe_mask,
            probe_active) -> packed (B, T+2, M);
    tc:  fn(postings_doc, postings_tc, avg32, positions, pos_starts,
            starts, ends, idf32, slot_of, ks, bloom_rows, ..., probe_active)."""
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters,
              eps3=eps3)
    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, *rest):
            return compact_phrase_body(postings_doc, postings_tc, None, *rest,
                                       tc_mode=True, avg32=avg32, **kw)[0]
    else:
        def kernel(*args):
            return compact_phrase_body(*args, **kw)[0]

    return kernel


def make_semidense_phrase_kernel(T: int, L: int, KV: int, PP: int, PW: int,
                                 M: int, N_pad: int, n_rec_iters: int,
                                 eps3: float, mode: str = "raw"):
    """List-path phrase whose match stage is semidense: every
    non-candidate term is a dense-tier head, so membership and score per
    candidate lane is one doc-indexed gather from its dense row, and the
    lanes compact to the KV best AND scores (stable) before any
    element-gather stage: posting-index recovery by binary search over KV
    lanes (a matched doc is in every term's run: the dense rows are built
    from them) and the window verify. No bloom gate: the (KV+1)-th AND
    score bounds every unverified lane (semidense_phrase_body).

    raw: fn(postings_doc, postings_score, postings_tf, dense_sc, positions,
            pos_starts, starts, ends, use_score, slots (B, T) dense rows of
            slots 1.., slot_of, ks) -> packed (B, T+2, M); tfs from
            postings_tf at the recovered posting indices.
    tc:  fn(postings_doc, postings_tc, avg32, dense_tf (uint8 tf plane),
            positions, pos_starts, starts, ends, idf32, slots, slot_of,
            ks); each dense lane recomposed with the candidate lane's len
            code, tfs and saturation from the kept lanes."""
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_rec_iters=n_rec_iters,
              eps3=eps3)
    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, dense_tf, *rest):
            return semidense_phrase_body(postings_doc, postings_tc, dense_tf,
                                         *rest, avg32=avg32, **kw)
    else:
        def kernel(postings_doc, postings_score, postings_tf, dense_sc,
                   *rest):
            return semidense_phrase_body(postings_doc, postings_score,
                                         dense_sc, *rest,
                                         postings_tf=postings_tf, **kw)

    return kernel


def semidense_phrase_body(postings_doc, col, dense, positions, pos_starts,
                          starts, ends, weights, slots, slot_of, ks, *,
                          T: int, L: int, KV: int, PP: int, PW: int, M: int,
                          n_rec_iters: int, eps3: float, postings_tf=None,
                          avg32=None):
    """The semidense phrase route's packed (B, T+2, M) int32 output (raw:
    col the f32 scores, dense the f32 score rows, postings_tf; tc: col the
    tc lanes, dense the uint8 tf plane, avg32).

    On CUDA tensors the hand-written kernels (ops/phrase_route.
    semidense_phrase) run it, or raise; on CPU tensors the plain version,
    semidense_phrase_torch. Both check their arguments first
    (ValueError)."""
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_rec_iters=n_rec_iters,
              eps3=eps3, postings_tf=postings_tf, avg32=avg32)
    args = (postings_doc, col, dense, positions, pos_starts, starts, ends,
            weights, slots, slot_of, ks)
    if isinstance(postings_doc, torch.Tensor) and postings_doc.is_cuda:
        return _route_op.semidense_phrase(*args, **kw)
    _route_op.check_semidense_inputs(*args, **kw)
    return semidense_phrase_torch(*args, **kw)


def semidense_phrase_torch(postings_doc, col, dense, positions, pos_starts,
                           starts, ends, weights, slots, slot_of, ks, *,
                           T: int, L: int, KV: int, PP: int, PW: int, M: int,
                           n_rec_iters: int, eps3: float, postings_tf=None,
                           avg32=None):
    """semidense_phrase_body's plain torch version: the reference's
    operations one by one, (B, L) planes, the stable sort and the
    (B, T-1, KV) search planes included (on any device; the tests and the
    chip smoke hold the kernels against it)."""
    tc_mode = avg32 is not None
    B = starts.shape[0]
    cdocs, cval, cvalid, cs = _candidates(postings_doc, col, starts, ends, L)
    match = cvalid
    score = (tc_score(cval, weights[:, 0:1], avg32) if tc_mode
             else cval * weights[:, 0:1])
    lanes = [cval]  # tc lanes per slot (tc mode)
    for t in range(1, T):
        p = _dense_gather(dense, slots[:, t : t + 1], cdocs)
        if tc_mode:
            p = _compose_tc(p, cval & 0xFF00)
            lanes.append(p)
            score = score + tc_score(p, weights[:, t : t + 1], avg32)
        else:
            score = score + p * weights[:, t : t + 1]
        match = match & (p > 0)
    mscore = torch.where(match, score, NEG_INF)
    top_cs, top_cl = _top_stable(mscore, KV + 1)
    sel_cl = top_cl[:, :KV]
    sel_docs = torch.gather(cdocs, 1, sel_cl)
    # invalid lanes recover in-range garbage, masked by their score
    targets = sel_docs[:, None, :].expand(B, T - 1, KV)
    lo = _binary_search(postings_doc, targets, starts[:, 1:, None],
                        ends[:, 1:, None], n_rec_iters)
    sel_pidx = torch.cat([(cs[:, None] + sel_cl.to(torch.int32))[:, None, :],
                          lo], dim=1)
    top_docs, top_l, flags, _ = _verify_and_select(
        positions, pos_starts, top_cs[:, :KV], sel_docs, sel_pidx,
        slot_of, ks, top_cs[:, KV], T=T, KV=KV, PP=PP, PW=PW, M=M,
        eps3=eps3)
    kept = top_docs >= 0
    if tc_mode:
        top_cl_l = torch.gather(sel_cl, 1, top_l)
        top_tc = torch.stack([torch.gather(x, 1, top_cl_l) for x in lanes],
                             dim=1)
        flags = flags | (tc_saturated(top_tc, top_docs).to(torch.int32)
                         * FLAG_TF_SAT)
        top_tfs = torch.where(kept[:, None, :], top_tc & 0xFF, 0)
    else:
        top_tfs = torch.where(
            kept[:, None, :],
            _gather1d(postings_tf, _gather_slots(sel_pidx, top_l)), 0)
    return pack_with_flags(top_docs, top_tfs, flags)


def _pruned_phrase_body(lanes, blockmax, blockmax2, argpos, postings_doc,
                        positions, pos_starts, starts, ends, slots, weights,
                        anchor, ks, *, T: int, NB: int, C: int, KV: int,
                        PP: int, PW: int, M: int, n_bs_iters: int,
                        eps3: float):
    """Block-pruned mega phrase: the C highest-bound 128-doc blocks
    (_select_ub_blocks; weights are the bound's per-slot multipliers), their
    C*128 lanes scored in query-term order from zeros, compacted to the KV
    best AND scores (stable: score desc, lane asc, the canonical set),
    posting indices recovered by binary search (a matched doc is in every
    term's run: the dense rows are built from them), window verify, then
    a stable top-M over the (score desc, doc asc) ordered selection. The
    guard bound is the larger of the (C+1)-th block bound (every
    unexamined block) and the (KV+1)-th AND score (every unverified lane):
    phrase matches are a subset of AND matches.

    lanes(t, blk) -> ((B, C, 128) payload lanes, 0 = absent; their f32
    score contributions). Per-term arrays are in query-term order; anchor
    (B,) is the term whose bag gives the bases. Returns (top_docs (B, M)
    int32 or -1, cand_l (B, M) int64 kept lanes in the C*128 selection,
    payloads [(B, C*128)] per term, flags (B,) int32)."""
    B = slots.shape[0]
    CL = C * 128
    blk, next_ub = _select_ub_blocks(blockmax, slots, weights, T=T, NB=NB,
                                     C=C, blockmax2=blockmax2, argpos=argpos)
    lane = torch.arange(128, dtype=torch.int64, device=blk.device)
    cand_docs = (blk[:, :, None] * 128 + lane).reshape(B, CL)
    match = torch.ones((B, CL), dtype=torch.bool, device=blk.device)
    score = torch.zeros((B, CL), dtype=torch.float32, device=blk.device)
    payloads = []
    for t in range(T):
        p, contrib = lanes(t, blk)
        p = p.reshape(B, CL)
        payloads.append(p)
        match &= p > 0
        score = score + contrib.reshape(B, CL)
    score = torch.where(match, score, NEG_INF)
    del match
    top_cs, top_cl = _top_stable(score, KV + 1)
    unseen = top_cs[:, KV]
    sel_score = top_cs[:, :KV]
    sel_l = top_cl[:, :KV]
    sel_docs = torch.gather(cand_docs, 1, sel_l).to(torch.int32)
    # invalid lanes recover in-range garbage, masked by their score
    n_matches = _verify_docs(postings_doc, positions, pos_starts, sel_docs,
                             starts, ends, anchor, T=T, NL=KV, PP=PP, PW=PW,
                             n_iters=n_bs_iters)
    final_score = torch.where((sel_score > NEG_INF) & (n_matches > 0),
                              sel_score, NEG_INF)
    top_score, top_l = _top_stable(final_score, M)
    top_docs = torch.where(top_score > NEG_INF,
                           torch.gather(sel_docs, 1, top_l), -1)
    flags = (boundary_truncated(final_score, top_score, M).to(torch.int32)
             | prune_guard_flag(top_score, torch.maximum(next_ub, unseen), ks,
                                M=M, eps3=eps3))
    return top_docs, torch.gather(sel_l, 1, top_l), payloads, flags


def make_pruned_phrase_kernel(T: int, NB: int, C: int, KV: int, PP: int,
                              PW: int, M: int, n_bs_iters: int, eps3: float):
    """Raw-column block-pruned mega phrase (_pruned_phrase_body), the
    per-term tfs from the dense tf rows at the kept docs.

    fn(dense_sc (H, NB*128) f32, dense_tf (H, NB*128) i32, blockmax,
       blockmax2 (H, NB) f32, argpos (H, NB) u8, postings_doc, positions,
       pos_starts, starts (B, T), ends (B, T), slots (B, T), use_score
       (B, T) f32, anchor (B,) i32, ks (B,) i32), per-term arrays in query
       order -> packed (B, T+2, M) int32."""

    def kernel(dense_sc, dense_tf, blockmax, blockmax2, argpos, postings_doc,
               positions, pos_starts, starts, ends, slots, use_score, anchor,
               ks):
        sc_rows = dense_sc.view(dense_sc.shape[0] * NB, 128)
        rows = slots.to(torch.int64)

        def lanes(t, blk):
            p = sc_rows[rows[:, t : t + 1] * NB + blk]  # (B, C, 128)
            return p, p * use_score[:, t, None, None]

        top_docs, _, _, flags = _pruned_phrase_body(
            lanes, blockmax, blockmax2, argpos, postings_doc, positions,
            pos_starts, starts, ends, slots, use_score, anchor, ks, T=T,
            NB=NB, C=C, KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters,
            eps3=eps3)
        tfs = torch.stack([
            torch.where(top_docs >= 0,
                        _dense_gather(dense_tf, slots[:, t : t + 1], top_docs),
                        0)
            for t in range(T)], dim=1)
        return pack_with_flags(top_docs, tfs, flags)

    return kernel


def make_pruned_phrase_kernel_tc(T: int, NB: int, C: int, KV: int, PP: int,
                                 PW: int, M: int, n_bs_iters: int,
                                 eps3: float):
    """make_pruned_phrase_kernel over the uint8 tf plane and the shared
    len-code row, composed per selected block; scored by tc_score with
    idf32 (B, T) in query order (the block weights are idf32 > 0); tfs
    and saturation from the kept lanes.

    fn(dense_tf (H, NB*128) u8, len_code (NB*128,) u8, avg32, blockmax,
       blockmax2, argpos, postings_doc, positions, pos_starts, starts,
       ends, slots, idf32, anchor, ks) -> packed (B, T+2, M) int32."""

    def kernel(dense_tf, len_code, avg32, blockmax, blockmax2, argpos,
               postings_doc, positions, pos_starts, starts, ends, slots,
               idf32, anchor, ks):
        tf_rows = dense_tf.view(dense_tf.shape[0] * NB, 128)
        code_hi = len_code.to(torch.int32) << 8
        rows = slots.to(torch.int64)

        def lanes(t, blk):
            p = _compose_tc(tf_rows[rows[:, t : t + 1] * NB + blk],
                            code_hi.view(NB, 128)[blk])
            return p, tc_score(p, idf32[:, t, None, None], avg32)

        top_docs, cand_l, payloads, flags = _pruned_phrase_body(
            lanes, blockmax, blockmax2, argpos, postings_doc, positions,
            pos_starts, starts, ends, slots, (idf32 > 0).to(torch.float32),
            anchor, ks, T=T, NB=NB, C=C, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3)
        top_tc = torch.stack([torch.gather(p, 1, cand_l) for p in payloads],
                             dim=1)
        kept = top_docs >= 0
        flags = flags | tc_saturated(top_tc, top_docs).to(torch.int32) \
            * FLAG_TF_SAT
        return pack_with_flags(
            top_docs, torch.where(kept[:, None, :], top_tc & 0xFF, 0), flags)

    return kernel


def _phrase_score(rows_f32, T: int) -> torch.Tensor:
    """The full-scan phrase's (B, N_pad) f32 score plane: rows_f32(t)
    summed in query-term order from zeros, -inf where some term's
    contribution is not > 0."""
    p = rows_f32(0)
    score = torch.zeros_like(p) + p  # from zeros: -0 sums to +0
    match = p > 0
    for t in range(1, T):
        p = rows_f32(t)
        match &= p > 0
        score += p
    return torch.where(match, score, NEG_INF)


def _phrase_rows(plane, slots, weights, len_code=None, avg32=None):
    """(rows_f32, rows_payload) of the planes (_full_phrase_body's row
    functions): raw the score rows times use_score, tc the composed
    payload lanes (rows_payload) scored by tc_score with idf32; every
    array in query-term order."""
    rows = slots.to(torch.int64)
    if len_code is None:
        return (lambda t: plane[rows[:, t]] * weights[:, t : t + 1]), None
    code_hi = len_code.to(torch.int32) << 8

    def payload(t):
        return _compose_tc(plane[rows[:, t]], code_hi[None, :])

    return (lambda t: tc_score(payload(t), weights[:, t : t + 1], avg32),
            payload)


def full_phrase_select(plane, slots, weights, *, T: int, N_pad: int,
                       KV: int, len_code=None, avg32=None):
    """The full-scan phrase's selection (full_phrase_select_torch's
    outputs) of the planes: raw the (H, N_pad) f32 score plane with
    use_score, tc the uint8 tf plane with the len-code row, avg32 and
    idf32 as weights; slots and weights in query-term order. On CUDA
    tensors the kernel (ops/dense.phrase_select), or it raises; on CPU
    tensors the plain version. Both check their arguments first
    (ValueError). A third output: the kernels' (B, NB) block keys for
    the listed band (full_phrase_band's bkeys; None where the selection
    took one pass, and on CPU tensors)."""
    kw = dict(T=T, N_pad=N_pad, KV=KV, len_code=len_code, avg32=avg32)
    if isinstance(plane, torch.Tensor) and plane.is_cuda:
        return _dense_op.phrase_select(plane, slots, weights, **kw)
    _dense_op.check_phrase_inputs(plane, slots, weights, **kw)
    rows_f32, _ = _phrase_rows(plane, slots, weights, len_code, avg32)
    return full_phrase_select_torch(rows_f32, T=T, N_pad=N_pad,
                                    KV=KV) + (None,)


def full_phrase_select_torch(rows_f32, *, T: int, N_pad: int, KV: int):
    """The full-scan phrase's selection, plain: an exact top-(KV+1) of
    the score plane (_phrase_score), two-level (per-128-block maxima, the
    top KV + 1 blocks re-sorted ascending, then the top KV + 1 of their
    lanes, both by stable sort, lax.top_k's tie order), or one flat
    selection where the doc space has fewer blocks. Every lane strictly
    above the (KV+1)-th value is selected, so that value is exact.
    Returns (top_cs (B, KV+1) f32 in descending order, top_cl (B, KV+1)
    int32 lanes, -1 where the score is -inf)."""
    score = _phrase_score(rows_f32, T)
    B = score.shape[0]
    NB = N_pad // 128
    if NB >= KV + 1:
        s3 = score.view(B, NB, 128)
        _, blk = _top_stable(s3.amax(dim=2), KV + 1)
        blk, _ = torch.sort(blk, dim=1)  # ascending: lane order = doc order
        rows3 = torch.gather(s3, 1, blk[:, :, None].expand(B, KV + 1, 128))
        top_cs, fl = _top_stable(rows3.reshape(B, (KV + 1) * 128), KV + 1)
        top_cl = torch.gather(blk, 1, fl // 128) * 128 + fl % 128
    else:  # tiny doc spaces: one flat selection
        top_cs, top_cl = _top_stable(score, KV + 1)
    return (top_cs.contiguous(),
            torch.where(top_cs > NEG_INF, top_cl, -1).to(torch.int32))


def full_phrase_band(plane, slots, weights, top_cs, top_cl, thr, *, T: int,
                     N_pad: int, KV: int, kth_doc=None, len_code=None,
                     avg32=None, bkeys=None):
    """The full-scan phrase's band word (full_phrase_band_torch's output)
    of the planes (as full_phrase_select) and a selection of them: on
    CUDA tensors the kernel (ops/dense.phrase_band: tc with the
    selection's block keys bkeys, a query that needs the band streams only
    the blocks whose key reaches thr), or it raises; on CPU tensors the
    plain
    version, which reads every lane. Both check their arguments first
    (ValueError)."""
    kw = dict(T=T, N_pad=N_pad, KV=KV, len_code=len_code, avg32=avg32)
    if isinstance(plane, torch.Tensor) and plane.is_cuda:
        return _dense_op.phrase_band(plane, slots, weights, top_cs, top_cl,
                                     thr, kth_doc=kth_doc, bkeys=bkeys, **kw)
    _dense_op.check_phrase_inputs(plane, slots, weights,
                                  band=(top_cs, top_cl, thr, kth_doc),
                                  bkeys=bkeys, **kw)
    rows_f32, payload = _phrase_rows(plane, slots, weights, len_code, avg32)
    return full_phrase_band_torch(rows_f32, top_cl, thr, T=T, N_pad=N_pad,
                                  KV=KV, rows_payload=payload,
                                  kth_doc=kth_doc)


def full_phrase_band_torch(rows_f32, top_cl, thr, *, T: int, N_pad: int,
                           KV: int, rows_payload=None, kth_doc=None):
    """The full-scan phrase's band word, plain: 1 where some lane that is
    not among the selection's first KV lanes (a scatter of top_cl[:, :KV])
    has a score (_phrase_score) > -inf and >= thr, else 0. With
    rows_payload (tc columns), a lane whose integer payload (len_code <<
    8 | tf on every term) equals the kth_doc's has exactly its f64 score,
    so it can displace it only by the doc-asc canon: it counts only if
    its doc id is smaller. Returns (B,) int32."""
    score = _phrase_score(rows_f32, T)
    B = score.shape[0]
    dev = score.device
    # the empty places (-1) go to a spare last column
    sel = top_cl[:, :KV].to(torch.int64)
    selected = torch.zeros((B, N_pad + 1), dtype=torch.bool, device=dev)
    selected.scatter_(1, torch.where(sel >= 0, sel, N_pad), True)
    band = (~selected[:, :N_pad] & (score > NEG_INF)
            & (score >= thr[:, None]))
    if rows_payload is not None:
        kd = kth_doc.to(torch.int64).clamp(0, N_pad - 1)
        lane_id = torch.arange(N_pad, dtype=torch.int64, device=dev)
        bad = lane_id[None, :] < kd[:, None]  # (B, N_pad)
        for t in range(T):
            pay = rows_payload(t)
            bad |= pay != torch.gather(pay, 1, kd[:, None])
        band &= bad
    return band.any(dim=1).to(torch.int32)


def _full_phrase_run(select, band, postings_doc, positions, pos_starts,
                     starts, ends, anchor, ks, *, T: int, KV: int, PP: int,
                     PW: int, M: int, n_bs_iters: int, eps3: float):
    """Full-scan dense phrase: select the KV + 1 best lanes (select() ->
    (top_cs, top_cl)), verify the KV best candidates by position windows,
    bound the rest by the exact (KV+1)-th value: band(top_cs, top_cl,
    thr, kth_doc) -> (B,) int32 flags every row where an unselected lane
    scores within the eps3 band of the k-th kept score (thr), and
    FLAG_PRUNE_MISS is raised there and where no k-th doc was kept while
    the (KV+1)-th lane matched. The (KV+1)-th lane is not verified and
    stays in the band. Returns (top_docs (B, M) i32, flags (B,) i32)."""
    top_cs, top_cl = select()
    unseen = top_cs[:, KV]
    sel_score = top_cs[:, :KV]
    sel_docs = top_cl[:, :KV]
    # invalid lanes (-1) recover in-range garbage, masked by their score
    n_matches = _verify_docs(postings_doc, positions, pos_starts,
                             sel_docs.contiguous(), starts, ends, anchor,
                             T=T, NL=KV, PP=PP, PW=PW, n_iters=n_bs_iters)
    final_score = torch.where((sel_score > NEG_INF) & (n_matches > 0),
                              sel_score, NEG_INF)
    # the sel lanes are in (score desc, doc asc) order, so a stable top-M
    # puts the canonical doc at place k, which the payload-tie rule reads
    top_score, top_l = _top_stable(final_score, M)
    top_docs = torch.where(top_score > NEG_INF,
                           torch.gather(sel_docs, 1, top_l), -1)

    k_idx = (ks.to(torch.int64) - 1).clamp(0, M - 1)
    kth = torch.gather(top_score, 1, k_idx[:, None])[:, 0]
    no_k = kth <= NEG_INF
    safe_kth = torch.where(no_k, float("inf"), kth)
    thr = safe_kth * float(np.float32(1.0 - eps3))
    kth_doc = torch.gather(top_docs, 1, k_idx[:, None])[:, 0].clamp(min=0)
    hit = band(top_cs, top_cl, thr, kth_doc)
    miss = (no_k & (unseen > NEG_INF)) | (hit != 0)
    flags = (boundary_truncated(final_score, top_score, M).to(torch.int32)
             | miss.to(torch.int32) * FLAG_PRUNE_MISS)
    return top_docs, flags


def _full_phrase_body(rows_f32, postings_doc, positions, pos_starts, starts,
                      ends, anchor, ks, *, T: int, N_pad: int, KV: int,
                      PP: int, PW: int, M: int, n_bs_iters: int,
                      eps3: float, rows_payload=None):
    """_full_phrase_run over row functions, with the plain passes.

    Any unselected lane within the eps3 band of the k-th kept score
    raises FLAG_PRUNE_MISS, except, with rows_payload (tc columns), an
    exact payload tie (full_phrase_band_torch). rows_f32(t) -> (B, N_pad)
    f32 score contribution of query term t (0 where absent);
    rows_payload(t) -> (B, N_pad) int32 payload lanes or None. All
    per-term arrays are in query-term order. Returns (top_docs (B, M)
    i32, flags (B,) i32)."""
    kw = dict(T=T, N_pad=N_pad, KV=KV)
    return _full_phrase_run(
        lambda: full_phrase_select_torch(rows_f32, **kw),
        lambda top_cs, top_cl, thr, kth_doc: full_phrase_band_torch(
            rows_f32, top_cl, thr, rows_payload=rows_payload,
            kth_doc=kth_doc, **kw),
        postings_doc, positions, pos_starts, starts, ends, anchor, ks, T=T,
        KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters, eps3=eps3)


def _full_phrase_planes(plane, slots, weights, postings_doc, positions,
                        pos_starts, starts, ends, anchor, ks, *, T: int,
                        N_pad: int, KV: int, PP: int, PW: int, M: int,
                        n_bs_iters: int, eps3: float, len_code=None,
                        avg32=None):
    """_full_phrase_run over the planes, through the dispatching passes
    (full_phrase_select, full_phrase_band): on a card the kernels, which
    write no (B, N_pad) plane; the band reads the selection's block
    keys."""
    kw = dict(T=T, N_pad=N_pad, KV=KV, len_code=len_code, avg32=avg32)
    tc = len_code is not None
    bkeys = []

    def select():
        top_cs, top_cl, keys = full_phrase_select(plane, slots, weights,
                                                  **kw)
        bkeys.append(keys)
        return top_cs, top_cl

    return _full_phrase_run(
        select,
        lambda top_cs, top_cl, thr, kth_doc: full_phrase_band(
            plane, slots, weights, top_cs, top_cl, thr,
            kth_doc=kth_doc if tc else None, bkeys=bkeys[0], **kw),
        postings_doc, positions, pos_starts, starts, ends, anchor, ks, T=T,
        KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters, eps3=eps3)


def make_full_phrase_kernel(T: int, N_pad: int, KV: int, PP: int, PW: int,
                            M: int, n_bs_iters: int, eps3: float):
    """Raw-column full-scan mega phrase (_full_phrase_planes: on a card
    the phrase's select and band kernels) with the per-term tfs from the
    dense tf rows.

    fn(dense_sc (H, N_pad) f32, dense_tf (H, N_pad) i32, postings_doc,
       positions, pos_starts, starts (B, T), ends (B, T), slots (B, T),
       use_score (B, T) f32, anchor (B,) i32, ks (B,) i32), per-term arrays
       in query order -> packed (B, T+2, M) int32."""

    def kernel(dense_sc, dense_tf, postings_doc, positions, pos_starts,
               starts, ends, slots, use_score, anchor, ks):
        top_docs, flags = _full_phrase_planes(
            dense_sc, slots, use_score, postings_doc, positions, pos_starts,
            starts, ends, anchor, ks, T=T, N_pad=N_pad, KV=KV, PP=PP, PW=PW,
            M=M, n_bs_iters=n_bs_iters, eps3=eps3)
        tfs = torch.stack([
            torch.where(top_docs >= 0,
                        _dense_gather(dense_tf, slots[:, t : t + 1],
                                      top_docs.clamp(min=0)), 0)
            for t in range(T)], dim=1)
        return pack_with_flags(top_docs, tfs, flags)

    return kernel


def make_full_phrase_kernel_tc(T: int, N_pad: int, KV: int, PP: int,
                               PW: int, M: int, n_bs_iters: int,
                               eps3: float):
    """tc full-scan mega phrase: _full_phrase_planes over lanes composed
    from the uint8 tf plane and the shared len-code row (as
    make_dense_search_kernel_tc), with the exact payload-tie refinement;
    tfs and saturation from the kept lanes.

    fn(dense_tf (H, N_pad) u8, len_code (N_pad,) u8, avg32, postings_doc,
       positions, pos_starts, starts (B, T), ends (B, T), slots (B, T),
       idf32 (B, T) f32, anchor (B,) i32, ks (B,) i32), per-term arrays in
       query order -> packed (B, T+2, M) int32."""

    def kernel(dense_tf, len_code, avg32, postings_doc, positions,
               pos_starts, starts, ends, slots, idf32, anchor, ks):
        top_docs, flags = _full_phrase_planes(
            dense_tf, slots, idf32, postings_doc, positions, pos_starts,
            starts, ends, anchor, ks, T=T, N_pad=N_pad, KV=KV, PP=PP, PW=PW,
            M=M, n_bs_iters=n_bs_iters, eps3=eps3, len_code=len_code,
            avg32=avg32)
        code_hi = len_code.to(torch.int32) << 8
        return _pack_dense_tc(dense_tf, code_hi, slots, top_docs, flags, T)

    return kernel
