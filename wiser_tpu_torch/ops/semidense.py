"""The semidense step as one hand-written CUDA kernel (csrc/semidense.cu).

`semidense` computes engine/kernels._semidense_step's outputs (top_docs,
top_score, tfs, flags) for raw and tc columns, on one card or a mesh
shard (doc_base): the tail candidate's run against short non-dense runs
(slots 1..n_bs, searched) and the head terms' dense rows (the later
slots, one gather a lane). `plan` lays a group out (csrc/segsel.cuh):
each query's lanes in nseg segments of whole 256-lane units, a CTA a
segment, as many as keep the group within two CTAs an SM (at most a
cluster's 8: `segments`); the CTAs of a query
form one thread-block cluster and merge their top K = min(M + 1, L)
keys through distributed shared memory, so one launch and no (B, L)
plane or device-memory scratch. A K past what two lists in shared memory
hold (a deep k) keeps a query in one CTA; past what shared memory holds
at all, the CTA's key buffer lies in a device-memory scratch. tc columns
score from dense.cu's device table (ops/dense.tc_table, launched first
and counted as dense_tc_table), so no lane divides.

engine/kernels._semidense_step calls `semidense` for CUDA tensors and
runs its plain torch version (_semidense_step_torch) for CPU tensors
after `check_inputs`; `semidense` checks the same conditions with the
cheap `args_ok` before every launch, so a bad argument raises ValueError
the same way on either device.

Where the plain version is exact the kernel equals it bit for bit: the
flags on every row; the kept docs, f32 scores and tfs, and the kept set,
wherever no boundary tie was cut (FLAG_TRUNC clear). Its order is (score
desc, doc asc), lax.top_k's on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from wiser_tpu_torch.ops import dense as _D
from wiser_tpu_torch.ops import search as _S

# kernel launches by wrapper name, one a call: raw and tc columns
launch_counts = {"semidense": 0, "semidense_tc": 0}
THREADS = 256  # a segment's CTA (segsel.cuh kThreads)
STEP = 1024  # lanes a step of a CTA (kStep)
UNIT = 256  # a segment holds whole units of lanes (kUnit)
MAX_CLUSTER = 8  # segments a query at most: a portable cluster
MAX_T = 16  # slots a query at most (segsel.cuh kSegMaxT)
# a CTA's shared bytes ahead of its buffer (segsel.cuh kHead): select.cuh
# FlushSmem, 16-aligned, 4 step counters, the query's (T,) rows
HEAD_BYTES = 1056 + 16 + 4 * 4 * MAX_T
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into
CTAS_PER_SM = 2  # a group's segments at most, over the card's SMs
MIN_SEG_UNITS = 2  # a segment's 256-lane units at least


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class Segments(NamedTuple):
    """How segsel.cuh lays a group's selection out (ops/phrase_route's
    selection shares it)."""
    K: int  # keys kept a query
    KP: int  # the power of 2 >= K
    XC: int  # keys a CTA's buffer holds
    global_x: bool  # the buffers in device memory (too large to share)
    smem: int  # dynamic shared bytes a CTA
    nmax: int  # the most segments the lanes and the buffer allow
    nseg: int  # CTAs a query, one cluster
    seg_lanes: int  # lanes a segment, whole units


def layout(K: int):
    """(KP, XC, global_x, smem) of a CTA keeping K keys: its buffer
    (segsel.cuh buffer_keys: KP + 2 steps' keys, or the split merge's 3
    lists of KP where more) in shared memory, or in device memory where
    the card's shared memory cannot hold it."""
    KP = _pow2(K)
    # two steps past KP; three lists of KP where a query may split
    XC = 3 * KP if KP <= 2 * STEP and 3 * KP > KP + 2 * STEP \
        else KP + 2 * STEP
    global_x = HEAD_BYTES + 8 * XC > MAX_SMEM
    return KP, XC, global_x, HEAD_BYTES + (0 if global_x else 8 * XC)


@functools.lru_cache(maxsize=4096)
def segments(B: int, L: int, K: int, sms: int) -> Segments:
    """The segments of a group of B queries of L lanes keeping K keys on a
    card of `sms` SMs: as many as keep the group within two CTAs an SM
    (more only add merge rounds where the queries' lanes already keep the
    card busy), each at least MIN_SEG_UNITS units long (shorter ones
    measured no faster), at most a cluster's 8. A split needs the merge's
    three lists (3 KP keys) in the buffer, so K <= 2,048; a buffer past the
    card's shared memory lies in device memory, one CTA a query. (A sweep
    of forced counts at the engines' group shapes, PERF.md §6, put this
    rule within 10% of each shape's best count, where planning to whole
    waves of resident CTAs was slower.)"""
    KP, XC, global_x, smem = layout(K)
    units = -(-L // UNIT)
    nmax = (min(MAX_CLUSTER, max(1, units // MIN_SEG_UNITS))
            if 3 * KP <= XC and not global_x else 1)
    n = max(1, min(nmax, CTAS_PER_SM * sms // max(B, 1)))
    seg_lanes = -(-units // n) * UNIT
    return Segments(K, KP, XC, global_x, smem, nmax, -(-L // seg_lanes),
                    seg_lanes)


class Plan(NamedTuple):
    """How semidense runs one (B, T, L, M) group."""
    seg: Segments
    out_words: int  # int32 words of the one output allocation
    scratch_bytes: int  # the device-memory key buffers (global_x only)


def plan(B: int, T: int, n_bs: int, L: int, M: int, sms: int) -> Plan:
    """The launch plan of a (B, T, L, M) semidense group with n_bs
    searched others on a card of `sms` SMs."""
    seg = segments(B, L, min(M + 1, L), sms)
    return Plan(seg, B * (2 * M + T * M + 1),
                8 * B * seg.nseg * seg.XC if seg.global_x else 0)


@functools.lru_cache(maxsize=16)
def _sms(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def sms_of(dev: torch.device) -> int:
    """The card's SM count (the segments' plan)."""
    return _sms(dev.index if dev.index is not None
                else torch.cuda.current_device())


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_T = torch.Tensor


def _matrix_ok(t, dtype, dev, shape=None) -> bool:
    return (isinstance(t, _T) and t.dtype is dtype and t.dim() == 2
            and t.is_contiguous() and t.device == dev and t.shape[1] >= 1
            and (shape is None or tuple(t.shape) == shape))


def check_inputs(postings_doc, col, dense, starts, ends, weights, slots, *,
                 T: int, L: int, M: int, n_bs: int, n_bs_iters: int,
                 postings_tf=None, dense_tf=None, avg32=None,
                 doc_base: int = 0) -> None:
    """Raise ValueError unless the arguments are what _semidense_step
    takes: contiguous 1-D columns at least L long (doc int32; raw score
    f32 and tf int32, or tc lanes as int16 bits of uint16); a contiguous
    2-D dense plane (raw f32 with an int32 dense_tf of its shape; tc
    uint8) at least one lane wide; contiguous (B, T) int32 starts, ends
    and slots and f32 weights (use_score raw, idf32 tc); a one-element
    f32 avg32 (tc); every tensor on postings_doc's device; 1 <= T <=
    MAX_T, 0 <= n_bs < T, 1 <= M <= L, n_bs_iters >= 0, doc_base >= 0."""
    if not isinstance(postings_doc, _T):
        raise ValueError("postings_doc must be a tensor")
    dev = postings_doc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (not 1 <= T <= MAX_T or not 0 <= n_bs < T or not 1 <= M <= L
            or n_bs_iters < 0 or doc_base < 0):
        raise ValueError(f"need 1 <= T <= {MAX_T}, 0 <= n_bs < T, "
                         f"1 <= M <= L, n_bs_iters >= 0 and doc_base >= 0, "
                         f"got T={T} "
                         f"n_bs={n_bs} L={L} M={M} n_bs_iters={n_bs_iters} "
                         f"doc_base={doc_base}")
    tc = avg32 is not None
    _S._column("postings_doc", postings_doc, (torch.int32,), dev)
    cols = [("postings_doc", postings_doc)]
    if tc:
        _S._column("tc", col, (torch.int16,), dev)
        if not (isinstance(avg32, _T) and avg32.dtype is torch.float32
                and avg32.numel() == 1 and avg32.device == dev):
            raise ValueError(f"avg32 must be a one-element float32 tensor "
                             f"on {dev}")
        if not _matrix_ok(dense, torch.uint8, dev):
            raise ValueError(f"dense must be a contiguous (H, N_pad) uint8 "
                             f"tensor on {dev}")
        cols.append(("tc", col))
    else:
        _S._column("postings_score", col, (torch.float32,), dev)
        _S._column("postings_tf", postings_tf, (torch.int32,), dev)
        if not _matrix_ok(dense, torch.float32, dev):
            raise ValueError(f"dense must be a contiguous (H, N_pad) float32 "
                             f"tensor on {dev}")
        if not _matrix_ok(dense_tf, torch.int32, dev, tuple(dense.shape)):
            raise ValueError(f"dense_tf must be a contiguous int32 tensor of "
                             f"the dense plane's shape {tuple(dense.shape)} "
                             f"on {dev}")
        cols += [("postings_score", col), ("postings_tf", postings_tf)]
    for name, t in cols:
        if t.shape[0] < L:
            raise ValueError(f"{name} holds {t.shape[0]} postings, fewer "
                             f"than the L = {L} lanes of a candidate load")
    if not isinstance(starts, _T) or starts.dim() != 2:
        raise ValueError("starts must be a (B, T) tensor")
    shape = (starts.shape[0], T)
    _S._plane("starts", starts, torch.int32, shape, dev)
    _S._plane("ends", ends, torch.int32, shape, dev)
    _S._plane("use_score" if not tc else "idf32", weights, torch.float32,
              shape, dev)
    _S._plane("slots", slots, torch.int32, shape, dev)


def args_ok(postings_doc, col, dense, starts, ends, weights, slots, *,
            T: int, L: int, M: int, n_bs: int, n_bs_iters: int,
            postings_tf=None, dense_tf=None, avg32=None,
            doc_base: int = 0) -> bool:
    """check_inputs's conditions as one cheap test (no message): True
    exactly where check_inputs raises nothing."""
    if not isinstance(postings_doc, _T) or not isinstance(starts, _T):
        return False
    dev = postings_doc.device
    if dev.type not in ("cpu", "cuda") or starts.dim() != 2:
        return False
    B = starts.shape[0]
    ok = (1 <= T <= MAX_T and 0 <= n_bs < T and 1 <= M <= L
          and n_bs_iters >= 0
          and doc_base >= 0
          and _S._col_ok(postings_doc, torch.int32, dev, L)
          and _S._bt_ok(starts, torch.int32, dev, B, T)
          and _S._bt_ok(ends, torch.int32, dev, B, T)
          and _S._bt_ok(weights, torch.float32, dev, B, T)
          and _S._bt_ok(slots, torch.int32, dev, B, T))
    if avg32 is not None:
        return (ok and _S._col_ok(col, torch.int16, dev, L)
                and _matrix_ok(dense, torch.uint8, dev)
                and isinstance(avg32, _T) and avg32.dtype is torch.float32
                and avg32.numel() == 1 and avg32.device == dev)
    return (ok and _S._col_ok(col, torch.float32, dev, L)
            and _S._col_ok(postings_tf, torch.int32, dev, L)
            and _matrix_ok(dense, torch.float32, dev)
            and _matrix_ok(dense_tf, torch.int32, dev, tuple(dense.shape)))


class _Params(ctypes.Structure):
    """semidense.cu's WiserSemiParams: every field 8 bytes, in its order."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "doc n_doc score n_score tf n_tf tc n_tc dense_sc dense_tf dense_tf8 "
        "n_pad doc_base norm_g starts ends weights slots B T L M nb n_iters "
        "K KP XC nseg seg_lanes xg smem top_docs top_score top_tfs "
        "flags").split()]


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.step = lib.wiser_semidense_step
        self.step.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        self.step.restype = ctypes.c_int
        self.error = lib.wiser_semidense_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("semidense"))
    return _fns


def semidense(postings_doc, col, dense, starts, ends, weights, slots, *,
              T: int, L: int, M: int, n_bs: int, n_bs_iters: int,
              postings_tf=None, dense_tf=None, avg32=None,
              doc_base: int = 0):
    """_semidense_step's outputs from the kernel, on CUDA tensors:
    (top_docs (B, M) int32 doc ids or -1, top_score (B, M) f32, tfs (B, T,
    M) int32, flags (B,) int32). Checks the arguments as check_inputs does
    (ValueError before any launch), allocates the outputs as views of one
    buffer (and, by `plan`, a deep k's device-memory key buffers); tc
    launches dense.cu's table kernel first; launches on the current
    stream and does not synchronize."""
    kw = dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_bs_iters,
              postings_tf=postings_tf, dense_tf=dense_tf, avg32=avg32,
              doc_base=doc_base)
    args = (postings_doc, col, dense, starts, ends, weights, slots)
    if not (args_ok(*args, **kw) and postings_doc.device.type == "cuda"):
        check_inputs(*args, **kw)
        raise ValueError(f"semidense runs on CUDA tensors, got "
                         f"{postings_doc.device}")
    tc = avg32 is not None
    dev = postings_doc.device
    B = starts.shape[0]
    fns = _kernel_fns()
    p = plan(B, T, n_bs, L, M, sms_of(dev))
    seg = p.seg
    out = torch.empty(p.out_words, dtype=torch.int32, device=dev)
    BM, BTM = B * M, B * T * M
    docs, score, tfs, flags = out.split((BM, BM, BTM, B))
    res = (docs.view(B, M), score.view(torch.float32).view(B, M),
           tfs.view(B, T, M), flags)
    if B == 0:
        return res
    norm = _D.tc_table(avg32) if tc else None
    xg = (torch.empty(p.scratch_bytes, dtype=torch.uint8, device=dev)
          if p.scratch_bytes else None)
    base = out.data_ptr()
    params = _Params(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc else col.data_ptr(), col.shape[0],
        0 if tc else postings_tf.data_ptr(),
        0 if tc else postings_tf.shape[0],
        col.data_ptr() if tc else 0, col.shape[0],
        0 if tc else dense.data_ptr(), 0 if tc else dense_tf.data_ptr(),
        dense.data_ptr() if tc else 0, dense.shape[1], doc_base,
        norm.data_ptr() if tc else 0, starts.data_ptr(), ends.data_ptr(),
        weights.data_ptr(), slots.data_ptr(), B, T, L, M, 1 + n_bs,
        n_bs_iters, seg.K, seg.KP, seg.XC, seg.nseg, seg.seg_lanes,
        xg.data_ptr() if xg is not None else 0, seg.smem,
        base, base + 4 * BM, base + 8 * BM, base + 4 * (2 * BM + BTM))
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = fns.step(ctypes.byref(params),
                      torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fns.step(ctypes.byref(params),
                          torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError("semidense launch failed: "
                           + fns.error(rc).decode())
    launch_counts["semidense_tc" if tc else "semidense"] += 1
    return res
