"""Three phrase routes as hand-written CUDA kernels (csrc/phrase_route.cu):
the semidense phrase route, the list chain and the compact route, each
from the candidate slice to the packed (B, T+2, M) output.

`semidense_phrase` computes engine/kernels.semidense_phrase_torch (the
body of make_semidense_phrase_kernel) in three launches: the selection
of the KV + 1 best AND keys a query (csrc/segsel.cuh: the query's lanes
in segments planned over the card's SMs, ops/semidense.segments, a CTA a
segment keeping its keys in shared memory, the segments of a query one
cluster merged through distributed shared memory: no (B, L) plane), the
recovery (the warp's 32-ary lower bound a slot) and window
verification of the KV kept lanes (a warp a lane), the top M with its
flags and tfs. `list_phrase` computes engine/kernels.list_phrase_torch
(the list chain: make_match_kernel with the bi-bloom gate,
make_phrase_verify_kernel, make_select_topk_kernel, or their tc forms)
in one launch: a query's L <= 1,024 lanes in segments of one cluster
planned over the card (`list_plan`), a thread a lane through the match
and the gate, a thread a (lane, term) and a (lane, base) through the
bags and the verification of the round's active lanes, the verified
lanes pushed through distributed shared memory into the cluster's first
CTA, which takes their top M; `gate=False` leaves the bloom gate out (a
compile-time switch of the kernel: engine/kernels.phrase_body, the mesh's
list route) and also returns the kept scores.
`compact_phrase` computes engine/kernels.compact_phrase_body_torch in
three launches: the semidense phrase route's with a selection that
searches every slot and tests the bi-bloom probes of each found slot
(segsel.cuh's gate; the probes' rows in shared memory, GATE_BYTES), then
that route's recovery, verification and output (tc tfs from the tc
lanes), with the (B, M) kept scores the mesh merges on. tc columns
score from dense.cu's device table (ops/dense.tc_table, launched first
and counted as dense_tc_table), so no lane divides.

engine/kernels dispatches them for CUDA tensors and runs the plain
versions for CPU tensors after the same argument checks
(`check_semidense_inputs`, `check_list_inputs`,
`check_compact_inputs`), which the wrappers run
before every launch, so a bad argument raises ValueError the same way on
either device. The packed output (and the kept scores) equal the plain
version's bit for bit: the keys order lanes by (score desc, lane asc),
lax.top_k's order, which the plain versions keep with stable sorts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from wiser_tpu_torch.ops import dense as _D
from wiser_tpu_torch.ops import phrase as _P
from wiser_tpu_torch.ops import semidense as _SD

# kernel launches by wrapper name, one a call (raw and tc columns; the
# list chain without its gate, the mesh's list route, counts apart)
launch_counts = {"semidense_phrase": 0, "semidense_phrase_tc": 0,
                 "list_phrase": 0, "list_phrase_tc": 0,
                 "list_phrase_nogate": 0, "list_phrase_nogate_tc": 0,
                 "compact_phrase": 0, "compact_phrase_tc": 0}
MAX_T = 8  # terms at most (phrase_route.cu kMaxT)
LIST_MAX_L = 1024  # the list chain's lanes at most (kListMaxL)
OUT_WARPS = 8  # the semidense phrase output kernel's queries a CTA
# the compact selection's probes' rows in shared memory ahead of its
# buffer (segsel.cuh GateSmem: an 8-byte offset, a slot and a mask a
# probe, kSegMaxT probes at most)
MAX_PROBES = _SD.MAX_T
GATE_BYTES = 16 * MAX_PROBES
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into
# the list chain (phrase_route.cu list_kernel): a CTA of LIST_THREADS, a
# round of that many lanes a thread each; a segment holds whole warps of
# lanes (LIST_ROUND); the query's (T,) rows in shared memory (ListQuery:
# 4 int32 or f32 words a slot)
LIST_THREADS = 256
LIST_ROUND = 32
LIST_QUERY_BYTES = 4 * 4 * MAX_T
# a group's segments: as many as bring each to LIST_SEG_LANES lanes (one
# round), within LIST_CTAS_PER_SM CTAs an SM over the group (PERF.md §6:
# the forced counts at the engines' groups)
LIST_SEG_LANES = 256
LIST_CTAS_PER_SM = 2


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _align16(n: int) -> int:
    return (n + 15) & ~15


class SdpPlan(NamedTuple):
    """How semidense_phrase runs one (B, T, KV, PW, M) group."""
    K: int  # keys kept a query: KV + 1
    KP: int  # the power of 2 >= K
    smem_select: int  # the selection's shared bytes a CTA
    W: int  # the verification's warps a CTA, one a (query, kept lane)
    smem_verify: int
    smem_output: int  # the output kernel's, OUT_WARPS queries a CTA
    scratch_bytes: int  # the keys, counts and posting indices


@functools.lru_cache(maxsize=1024)
def plan_semidense(B: int, T: int, KV: int, PW: int, M: int) -> SdpPlan:
    K = KV + 1
    KP = _pow2(K)
    per = _P.warp_bytes(T, PW)
    W = max(1, min(_P.MAX_WARPS, _P.VERIFY_SMEM // per))
    # the selection's buffer always in shared memory (segsel.cuh's)
    return SdpPlan(K, KP, _SD.HEAD_BYTES + 8 * _SD.layout(K)[1], W, W * per,
                   4 * OUT_WARPS * (M + 1), B * (8 * K + 4 * KV
                                                    + 4 * T * KV))


@functools.lru_cache(maxsize=1024)
def plan_compact(B: int, T: int, KV: int, PW: int, M: int) -> SdpPlan:
    """How compact_phrase runs one (B, T, KV, PW, M) group: the semidense
    phrase route's plan, the selection's shared bytes grown by the
    probes' rows (GATE_BYTES)."""
    p = plan_semidense(B, T, KV, PW, M)
    return p._replace(smem_select=p.smem_select + GATE_BYTES)


@functools.lru_cache(maxsize=1024)
def plan_list(T: int, L: int) -> int:
    """The list kernel's shared bytes a CTA (phrase_route.cu list_layout):
    2 counters (16 B), the query's rows (LIST_QUERY_BYTES), a round's
    active lanes (LIST_THREADS of: lane, score, count, saturation, T
    posting indices, T bag starts and ends, int32 each), the verified
    keys (the power of 2 >= L), their posting indices (T, L) int32, their
    saturation bytes (L) and a flush's scratch."""
    return (16 + LIST_QUERY_BYTES + 4 * LIST_THREADS * (4 + 3 * T)
            + 8 * _pow2(L) + _align16(4 * T * L) + _align16(L)
            + _align16(_D.FLUSH_BYTES))


class ListPlan(NamedTuple):
    """How list_phrase runs one (B, T, L) group."""
    nseg: int  # CTAs a query, one cluster
    seg_lanes: int  # lanes a CTA, whole warps of LIST_ROUND
    smem: int  # dynamic shared bytes a CTA (plan_list)


def segment_plan(L: int, nseg: int, T: int) -> ListPlan:
    """nseg segments of L lanes (as far as the lanes allow), whole warps
    of lanes each."""
    rounds = -(-L // LIST_ROUND)
    seg_lanes = -(-rounds // max(1, min(nseg, rounds))) * LIST_ROUND
    return ListPlan(-(-L // seg_lanes), seg_lanes, plan_list(T, L))


@functools.lru_cache(maxsize=4096)
def list_plan(B: int, T: int, L: int, sms: int) -> ListPlan:
    """The list chain's segments on a card of `sms` SMs: as many as bring
    each to LIST_SEG_LANES lanes (a thread a lane, one round), at most
    LIST_CTAS_PER_SM CTAs an SM over the group and a cluster's
    MAX_CLUSTER, at least one."""
    n = max(1, min(_SD.MAX_CLUSTER, -(-L // LIST_SEG_LANES),
                   LIST_CTAS_PER_SM * sms // max(B, 1)))
    return segment_plan(L, n, T)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_T = torch.Tensor


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _vec(name, t, dtypes, dev, n_min: int = 1) -> None:
    _need(isinstance(t, _T) and t.dtype in dtypes and t.dim() == 1
          and t.is_contiguous() and t.device == dev and t.shape[0] >= n_min,
          f"{name} must be a contiguous 1-D tensor of "
          f"{' or '.join(map(str, dtypes))} on {dev}, at least {n_min} long")


def _mat(name, t, dtype, shape, dev) -> None:
    _need(isinstance(t, _T) and t.dtype is dtype and tuple(t.shape) == shape
          and t.is_contiguous() and t.device == dev,
          f"{name} must be a contiguous {dtype} tensor of shape {shape} "
          f"on {dev}")


def _common(postings_doc, col, positions, pos_starts, starts, ends, weights,
            slot_of, T: int, L: int, postings_tf, avg32):
    """The checks both routes share; returns (dev, B)."""
    _need(isinstance(postings_doc, _T), "postings_doc must be a tensor")
    dev = postings_doc.device
    _need(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _need(2 <= T <= MAX_T and L >= 1,
          f"need 2 <= T <= {MAX_T} and L >= 1, got T={T} L={L}")
    _vec("postings_doc", postings_doc, (torch.int32,), dev, L)
    if avg32 is not None:
        _vec("tc", col, (torch.int16,), dev, L)
        _need(isinstance(avg32, _T) and avg32.dtype is torch.float32
              and avg32.numel() == 1 and avg32.is_contiguous()
              and avg32.device == dev,
              f"avg32 must be a contiguous one-element float32 tensor on {dev}")
    else:
        _vec("postings_score", col, (torch.float32,), dev, L)
        _vec("postings_tf", postings_tf, (torch.int32,), dev)
    _vec("positions", positions, (torch.int16, torch.int32), dev)
    _vec("pos_starts", pos_starts, (torch.int32,), dev)
    _need(isinstance(starts, _T) and starts.dim() == 2,
          "starts must be a (B, T) tensor")
    shape = (starts.shape[0], T)
    _mat("starts", starts, torch.int32, shape, dev)
    _mat("ends", ends, torch.int32, shape, dev)
    _mat("idf32" if avg32 is not None else "use_score", weights,
         torch.float32, shape, dev)
    _mat("slot_of", slot_of, torch.int32, shape, dev)
    return dev, shape[0]


def check_semidense_inputs(postings_doc, col, dense, positions, pos_starts,
                           starts, ends, weights, slots, slot_of, ks, *,
                           T: int, L: int, KV: int, PP: int, PW: int, M: int,
                           n_rec_iters: int, eps3: float, postings_tf=None,
                           avg32=None) -> None:
    """Raise ValueError unless the arguments are what the semidense phrase
    route takes: contiguous 1-D columns (doc int32 and the candidate's
    column, raw f32 score with an int32 tf column or tc int16 lanes, at
    least L long; positions int16 or int32; pos_starts int32); a
    contiguous 2-D dense plane (raw f32, tc uint8); contiguous (B, T)
    int32 starts, ends, slots and slot_of, f32 weights and (B,) int32 ks;
    a one-element f32 avg32 (tc); every tensor on postings_doc's device;
    2 <= T <= MAX_T, KV >= 1, 1 <= M <= KV, PP and PW >= 1, every
    kernel's shared bytes (plan_semidense) within the card's,
    n_rec_iters >= 0 and 0 <= eps3 < 1."""
    dev, B = _common(postings_doc, col, positions, pos_starts, starts, ends,
                     weights, slot_of, T, L, postings_tf, avg32)
    ok = KV >= 1 and 1 <= M <= KV and PP >= 1 and PW >= 1
    if ok:
        p = plan_semidense(B, T, KV, PW, M)
        ok = max(p.smem_select, p.smem_verify, p.smem_output) <= MAX_SMEM
    _need(ok and n_rec_iters >= 0 and 0.0 <= eps3 < 1.0,
          f"need KV >= 1, 1 <= M <= KV, PP, PW >= 1 (shared bytes within "
          f"{MAX_SMEM}), n_rec_iters >= 0 and 0 <= eps3 < 1, got KV={KV} "
          f"M={M} PP={PP} PW={PW} n_rec_iters={n_rec_iters} eps3={eps3}")
    dt = torch.uint8 if avg32 is not None else torch.float32
    _need(isinstance(dense, _T) and dense.dtype is dt and dense.dim() == 2
          and dense.is_contiguous() and dense.device == dev
          and dense.shape[1] >= 1,
          f"dense must be a contiguous (H, N_pad) {dt} tensor on {dev}")
    _mat("slots", slots, torch.int32, (B, T), dev)
    _mat("ks", ks, torch.int32, (B,), dev)


def _check_blooms(dev, B: int, bloom_rows, bloom_bitmap, bloom_rank,
                  probe_slot, probe_begins, probe_mask, probe_active,
                  max_probes: Optional[int] = None) -> None:
    """The bi-bloom columns and the (B, C) probes, as the gated routes
    take them."""
    _vec("bloom_rows", bloom_rows, (torch.int32,), dev)
    _vec("bloom_bitmap", bloom_bitmap, (torch.int32,), dev, 2)
    _need(bloom_bitmap.shape[0] % 2 == 0,
          "bloom_bitmap holds two sides of equal length")
    _vec("bloom_rank", bloom_rank, (torch.int32,), dev,
         bloom_bitmap.shape[0])
    _need(isinstance(probe_slot, _T) and probe_slot.dim() == 2,
          "probe_slot must be a (B, C) tensor")
    shape = (B, probe_slot.shape[1])
    _need(max_probes is None or shape[1] <= max_probes,
          f"at most {max_probes} probes a query, got {shape[1]}")
    _mat("probe_slot", probe_slot, torch.int32, shape, dev)
    _mat("probe_begins", probe_begins, torch.bool, shape, dev)
    _mat("probe_mask", probe_mask, torch.int32, shape, dev)
    _mat("probe_active", probe_active, torch.bool, shape, dev)


def check_compact_inputs(postings_doc, col, positions, pos_starts, starts,
                         ends, weights, slot_of, ks, bloom_rows, bloom_bitmap,
                         bloom_rank, probe_slot, probe_begins, probe_mask,
                         probe_active, *, T: int, L: int, KV: int, PP: int,
                         PW: int, M: int, n_bs_iters: int, eps3: float,
                         postings_tf=None, avg32=None) -> None:
    """Raise ValueError unless the arguments are what the compact phrase
    route takes: the columns and (B, T) planes as check_semidense_inputs
    says (no dense plane or slots), (B,) int32 ks, the bloom columns and
    (B, C) probes as check_list_inputs says with the gate (C <=
    MAX_PROBES); 2 <= T <= MAX_T, 1 <= KV < L, 1 <= M <= KV, PP and PW
    >= 1, the kernels' shared bytes (plan_compact) within the card's,
    n_bs_iters >= 0 and 0 <= eps3 < 1."""
    dev, B = _common(postings_doc, col, positions, pos_starts, starts, ends,
                     weights, slot_of, T, L, postings_tf, avg32)
    ok = 1 <= KV < L and 1 <= M <= KV and PP >= 1 and PW >= 1
    if ok:
        p = plan_compact(B, T, KV, PW, M)
        ok = max(p.smem_select, p.smem_verify, p.smem_output) <= MAX_SMEM
    _need(ok and n_bs_iters >= 0 and 0.0 <= eps3 < 1.0,
          f"need 1 <= KV < L, 1 <= M <= KV, PP, PW >= 1 (shared bytes "
          f"within {MAX_SMEM}), n_bs_iters >= 0 and 0 <= eps3 < 1, got "
          f"L={L} KV={KV} M={M} PP={PP} PW={PW} n_bs_iters={n_bs_iters} "
          f"eps3={eps3}")
    _mat("ks", ks, torch.int32, (B,), dev)
    _check_blooms(dev, B, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
                  probe_begins, probe_mask, probe_active, MAX_PROBES)


def check_list_inputs(postings_doc, col, positions, pos_starts, starts, ends,
                      weights, slot_of, bloom_rows, bloom_bitmap, bloom_rank,
                      probe_slot, probe_begins, probe_mask, probe_active, *,
                      T: int, L: int, PP: int, M: int, n_bs_iters: int,
                      n_pos_iters: int, postings_tf=None, avg32=None,
                      gate: bool = True) -> None:
    """Raise ValueError unless the arguments are what the list chain
    takes: the columns and (B, T) planes as check_semidense_inputs says
    (no dense plane, slots or ks); with the gate, contiguous 1-D int32
    bloom rows (at least one), bitmap (an even count, at least 2) and
    rank (the bitmap's length), and (B, C) probes (int32 slot and mask,
    bool begins and active); 2 <= T <= MAX_T, 1 <= L <= LIST_MAX_L,
    1 <= M <= L, PP >= 1, n_bs_iters and n_pos_iters >= 0."""
    dev, B = _common(postings_doc, col, positions, pos_starts, starts, ends,
                     weights, slot_of, T, L, postings_tf, avg32)
    _need(L <= LIST_MAX_L and 1 <= M <= L and PP >= 1 and n_bs_iters >= 0
          and n_pos_iters >= 0,
          f"need L <= {LIST_MAX_L}, 1 <= M <= L, PP >= 1 and iteration "
          f"counts >= 0, got L={L} M={M} PP={PP} n_bs_iters={n_bs_iters} "
          f"n_pos_iters={n_pos_iters}")
    if gate:
        _check_blooms(dev, B, bloom_rows, bloom_bitmap, bloom_rank,
                      probe_slot, probe_begins, probe_mask, probe_active)


class _SdpParams(ctypes.Structure):
    """phrase_route.cu's WiserSdpParams: every field 8 bytes."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "doc n_doc score n_score tf n_tf tc n_tc dense_sc dense_tf8 n_pad "
        "norm_g positions n_pos u16 pos_starts n_ps starts ends weights "
        "slots slot_of ks B T L KV K KP PP PW M n_iters keep_bits keys "
        "counts pidx out W smem_select smem_verify smem_output nseg "
        "seg_lanes top_score bloom_rows n_rows bloom_bitmap n_bitmap "
        "bloom_rank probe_slot probe_begins probe_mask probe_active "
        "C").split()]


class _ListParams(ctypes.Structure):
    """phrase_route.cu's WiserListParams: every field 8 bytes."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "doc n_doc score n_score tf n_tf tc n_tc norm_g positions n_pos u16 "
        "pos_starts n_ps bloom_rows n_rows bloom_bitmap n_bitmap bloom_rank "
        "probe_slot probe_begins probe_mask probe_active C gate starts ends "
        "weights slot_of B T L PP M n_iters n_pos_iters out smem nseg "
        "seg_lanes top_score").split()]


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.sdp = lib.wiser_semidense_phrase
        self.sdp.argtypes = [ctypes.POINTER(_SdpParams), ctypes.c_void_p]
        self.sdp.restype = ctypes.c_int
        self.compact = lib.wiser_compact_phrase
        self.compact.argtypes = [ctypes.POINTER(_SdpParams), ctypes.c_void_p]
        self.compact.restype = ctypes.c_int
        self.list = lib.wiser_list_phrase
        self.list.argtypes = [ctypes.POINTER(_ListParams), ctypes.c_void_p]
        self.list.restype = ctypes.c_int
        self.error = lib.wiser_phrase_route_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("phrase_route"))
    return _fns


def _run(fn, params, dev, what: str) -> None:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        rc = fn(ctypes.byref(params), torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _kernel_fns().error(rc).decode())


def _ptr(t) -> int:
    return t.data_ptr() if t is not None else 0


def semidense_phrase(postings_doc, col, dense, positions, pos_starts, starts,
                     ends, weights, slots, slot_of, ks, *, T: int, L: int,
                     KV: int, PP: int, PW: int, M: int, n_rec_iters: int,
                     eps3: float, postings_tf=None, avg32=None):
    """The semidense phrase route's packed (B, T+2, M) int32 output from
    the kernels, on CUDA tensors (raw: col the f32 scores, dense the f32
    score rows, postings_tf; tc: col the tc lanes, dense the uint8 tf
    rows, avg32). Checks the arguments (ValueError before any launch),
    allocates the output and the (B, KV + 1) keys, (B, KV) counts and
    (B, T, KV) posting indices, launches on the current stream (tc: the
    table kernel first) and does not synchronize."""
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_rec_iters=n_rec_iters,
              eps3=eps3, postings_tf=postings_tf, avg32=avg32)
    args = (postings_doc, col, dense, positions, pos_starts, starts, ends,
            weights, slots, slot_of, ks)
    check_semidense_inputs(*args, **kw)
    dev = postings_doc.device
    _need(dev.type == "cuda", f"semidense_phrase runs on CUDA tensors, got "
          f"{dev}")
    tc = avg32 is not None
    B = starts.shape[0]
    out = torch.empty((B, T + 2, M), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    p = plan_semidense(B, T, KV, PW, M)
    fns = _kernel_fns()
    seg = _SD.segments(B, L, p.K, _SD.sms_of(dev))
    keys = torch.empty((B, p.K), dtype=torch.int64, device=dev)
    counts = torch.empty((B, KV), dtype=torch.int32, device=dev)
    pidx = torch.empty((B, T, KV), dtype=torch.int32, device=dev)
    norm = _D.tc_table(avg32) if tc else None
    keep = int(np.float32(1.0 - eps3).view(np.uint32))
    params = _SdpParams(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc else col.data_ptr(), col.shape[0],
        0 if tc else postings_tf.data_ptr(),
        0 if tc else postings_tf.shape[0],
        col.data_ptr() if tc else 0, col.shape[0],
        0 if tc else dense.data_ptr(), dense.data_ptr() if tc else 0,
        dense.shape[1], _ptr(norm), positions.data_ptr(), positions.shape[0],
        int(positions.dtype is torch.int16), pos_starts.data_ptr(),
        pos_starts.shape[0], starts.data_ptr(), ends.data_ptr(),
        weights.data_ptr(), slots.data_ptr(), slot_of.data_ptr(),
        ks.data_ptr(), B, T, L, KV, p.K, p.KP, PP, PW, M, n_rec_iters, keep,
        keys.data_ptr(), counts.data_ptr(), pidx.data_ptr(), out.data_ptr(),
        p.W, p.smem_select, p.smem_verify, p.smem_output, seg.nseg,
        seg.seg_lanes, *(0,) * 11)
    _run(fns.sdp, params, dev, "semidense_phrase")
    launch_counts["semidense_phrase_tc" if tc else "semidense_phrase"] += 1
    return out


def compact_phrase(postings_doc, col, positions, pos_starts, starts, ends,
                   weights, slot_of, ks, bloom_rows, bloom_bitmap, bloom_rank,
                   probe_slot, probe_begins, probe_mask, probe_active, *,
                   T: int, L: int, KV: int, PP: int, PW: int, M: int,
                   n_bs_iters: int, eps3: float, postings_tf=None,
                   avg32=None):
    """The compact phrase route's (packed (B, T+2, M) int32, top_score
    (B, M) f32) from the kernels, on CUDA tensors (raw: col the f32
    scores and postings_tf; tc: col the tc lanes and avg32). Checks the
    arguments (ValueError before any launch), allocates the outputs and
    the (B, KV + 1) keys, (B, KV) counts and (B, T, KV) posting indices,
    launches on the current stream (tc: the table kernel first; the
    selection's segments by ops/semidense.segments) and does not
    synchronize."""
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M, n_bs_iters=n_bs_iters,
              eps3=eps3, postings_tf=postings_tf, avg32=avg32)
    args = (postings_doc, col, positions, pos_starts, starts, ends, weights,
            slot_of, ks, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
            probe_begins, probe_mask, probe_active)
    check_compact_inputs(*args, **kw)
    dev = postings_doc.device
    _need(dev.type == "cuda", f"compact_phrase runs on CUDA tensors, got "
          f"{dev}")
    tc = avg32 is not None
    B = starts.shape[0]
    out = torch.empty((B, T + 2, M), dtype=torch.int32, device=dev)
    top_score = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B == 0:
        return out, top_score
    p = plan_compact(B, T, KV, PW, M)
    fns = _kernel_fns()
    seg = _SD.segments(B, L, p.K, _SD.sms_of(dev))
    keys = torch.empty((B, p.K), dtype=torch.int64, device=dev)
    counts = torch.empty((B, KV), dtype=torch.int32, device=dev)
    pidx = torch.empty((B, T, KV), dtype=torch.int32, device=dev)
    norm = _D.tc_table(avg32) if tc else None
    keep = int(np.float32(1.0 - eps3).view(np.uint32))
    params = _SdpParams(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc else col.data_ptr(), col.shape[0],
        0 if tc else postings_tf.data_ptr(),
        0 if tc else postings_tf.shape[0],
        col.data_ptr() if tc else 0, col.shape[0], 0, 0, 1, _ptr(norm),
        positions.data_ptr(), positions.shape[0],
        int(positions.dtype is torch.int16), pos_starts.data_ptr(),
        pos_starts.shape[0], starts.data_ptr(), ends.data_ptr(),
        weights.data_ptr(), 0, slot_of.data_ptr(), ks.data_ptr(), B, T, L,
        KV, p.K, p.KP, PP, PW, M, n_bs_iters, keep, keys.data_ptr(),
        counts.data_ptr(), pidx.data_ptr(), out.data_ptr(), p.W,
        p.smem_select, p.smem_verify, p.smem_output, seg.nseg, seg.seg_lanes,
        top_score.data_ptr(), bloom_rows.data_ptr(), bloom_rows.shape[0],
        bloom_bitmap.data_ptr(), bloom_bitmap.shape[0], bloom_rank.data_ptr(),
        probe_slot.data_ptr(), probe_begins.data_ptr(), probe_mask.data_ptr(),
        probe_active.data_ptr(), probe_slot.shape[1])
    _run(fns.compact, params, dev, "compact_phrase")
    launch_counts["compact_phrase_tc" if tc else "compact_phrase"] += 1
    return out, top_score


def list_phrase(postings_doc, col, positions, pos_starts, starts, ends,
                weights, slot_of, bloom_rows, bloom_bitmap, bloom_rank,
                probe_slot, probe_begins, probe_mask, probe_active, *, T: int,
                L: int, PP: int, M: int, n_bs_iters: int, n_pos_iters: int,
                postings_tf=None, avg32=None, gate: bool = True):
    """The list chain's packed (B, T+2, M) int32 output from the kernel,
    on CUDA tensors (raw: col the f32 scores and postings_tf; tc: col the
    tc lanes and avg32). Checks the arguments (ValueError before any
    launch), allocates the outputs, launches on the current stream (tc:
    the table kernel first; the group's segments by list_plan) and does
    not synchronize. gate=False leaves the bloom gate out (the bloom and
    probe arguments are not read) and returns (packed, top_score (B, M)
    f32: the kept lanes' scores, -inf past them)."""
    kw = dict(T=T, L=L, PP=PP, M=M, n_bs_iters=n_bs_iters,
              n_pos_iters=n_pos_iters, postings_tf=postings_tf, avg32=avg32,
              gate=gate)
    args = (postings_doc, col, positions, pos_starts, starts, ends, weights,
            slot_of, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
            probe_begins, probe_mask, probe_active)
    check_list_inputs(*args, **kw)
    dev = postings_doc.device
    _need(dev.type == "cuda", f"list_phrase runs on CUDA tensors, got {dev}")
    tc = avg32 is not None
    B = starts.shape[0]
    out = torch.empty((B, T + 2, M), dtype=torch.int32, device=dev)
    top_score = (None if gate else
                 torch.empty((B, M), dtype=torch.float32, device=dev))
    if B == 0:
        return out if gate else (out, top_score)
    norm = _D.tc_table(avg32) if tc else None
    p = list_plan(B, T, L, _SD.sms_of(dev))
    g = (bloom_rows, bloom_bitmap, bloom_rank, probe_slot, probe_begins,
         probe_mask, probe_active) if gate else (None,) * 7
    params = _ListParams(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc else col.data_ptr(), col.shape[0],
        0 if tc else postings_tf.data_ptr(),
        0 if tc else postings_tf.shape[0],
        col.data_ptr() if tc else 0, col.shape[0], _ptr(norm),
        positions.data_ptr(), positions.shape[0],
        int(positions.dtype is torch.int16), pos_starts.data_ptr(),
        pos_starts.shape[0], _ptr(g[0]), g[0].shape[0] if gate else 0,
        _ptr(g[1]), g[1].shape[0] if gate else 0, _ptr(g[2]), _ptr(g[3]),
        _ptr(g[4]), _ptr(g[5]), _ptr(g[6]),
        g[3].shape[1] if gate else 0, int(gate), starts.data_ptr(),
        ends.data_ptr(), weights.data_ptr(), slot_of.data_ptr(), B, T, L, PP,
        M, n_bs_iters, n_pos_iters, out.data_ptr(), p.smem, p.nseg,
        p.seg_lanes, _ptr(top_score))
    _run(_kernel_fns().list, params, dev, "list_phrase")
    launch_counts["list_phrase" + ("" if gate else "_nogate")
                  + ("_tc" if tc else "")] += 1
    return out if gate else (out, top_score)
