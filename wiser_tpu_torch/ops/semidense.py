"""The semidense step as one hand-written CUDA kernel (csrc/semidense.cu).

`semidense` computes engine/kernels._semidense_step's outputs (top_docs,
top_score, tfs, flags) for raw and tc columns, on one card or a mesh
shard (doc_base): the tail candidate's run against short non-dense runs
(slots 1..n_bs, searched) and the head terms' dense rows (the later
slots, one gather a lane). It is the bs step's tile path (csrc/tile.cuh)
with a dense phase, so `plan` is ops/search.plan at the slots searched
(1 + n_bs): no (B, L) plane on the tile path, which takes every group
whose K = min(M + 1, L) fits KEY_CAP; a deeper k takes the plane path.
tc columns score from dense.cu's device table (ops/dense.tc_table,
launched first and counted as dense_tc_table), so no lane divides.

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
from typing import Optional

import torch

from wiser_tpu_torch.ops import dense as _D
from wiser_tpu_torch.ops import search as _S

# kernel launches by wrapper name, one a call (either path; a split
# group's merge launch included): raw and tc columns
launch_counts = {"semidense": 0, "semidense_tc": 0}


def plan(B: int, T: int, n_bs: int, L: int, M: int) -> _S.Plan:
    """The launch plan of a (B, T, L, M) semidense group with n_bs
    searched others: ops/search.plan laid out for the 1 + n_bs slots
    searched, its one output allocation without posting indices."""
    return _S.plan(B, 1 + n_bs, L, M)._replace(
        out_words=B * (2 * M + T * M + 1))


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
    f32 avg32 (tc); every tensor on postings_doc's device; T >= 1, 0 <=
    n_bs < T, 1 <= M <= L, n_bs_iters >= 0, doc_base >= 0."""
    if not isinstance(postings_doc, _T):
        raise ValueError("postings_doc must be a tensor")
    dev = postings_doc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (T < 1 or not 0 <= n_bs < T or not 1 <= M <= L or n_bs_iters < 0
            or doc_base < 0):
        raise ValueError(f"need T >= 1, 0 <= n_bs < T, 1 <= M <= L, "
                         f"n_bs_iters >= 0 and doc_base >= 0, got T={T} "
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
    ok = (T >= 1 and 0 <= n_bs < T and 1 <= M <= L and n_bs_iters >= 0
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


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.step = lib.wiser_semidense_step
        self.step.argtypes = [ctypes.POINTER(_S._Params), ctypes.c_void_p]
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
    buffer and, by `plan`, the tile path's small scratch or the plane
    path's (B, L) plane; tc launches dense.cu's table kernel first;
    launches on the current stream and does not synchronize."""
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
    NS = 1 + n_bs
    p = plan(B, T, n_bs, L, M)
    if p.path == "plane" and B > _S.MAX_B:
        raise ValueError(f"B = {B} queries exceed the plane path's "
                         f"{_S.MAX_B}")
    out = torch.empty(p.out_words, dtype=torch.int32, device=dev)
    BM, BTM = B * M, B * T * M
    docs, score, tfs, flags = out.split((BM, BM, BTM, B))
    res = (docs.view(B, M), score.view(torch.float32).view(B, M),
           tfs.view(B, T, M), flags)
    if B == 0:
        return res
    norm = _D.tc_table(avg32) if tc else None
    scratch = plane = sort = None
    lo_ptr = keys_ptr = src_ptr = 0
    if p.scratch_words:
        # the parts' int64 keys first (8-byte aligned), then their
        # sources, then the tiles' lower bounds
        scratch = torch.empty(p.scratch_words, dtype=torch.int32, device=dev)
        base = scratch.data_ptr()
        n_part = B * p.nseg * p.K if p.nseg > 1 else 0
        keys_ptr = base if n_part else 0
        src_ptr = base + 8 * n_part if n_part else 0
        lo_ptr = base + 12 * n_part if p.ntiles > 1 and NS > 1 else 0
    if p.path == "plane":
        plane = torch.empty((B, L), dtype=torch.float32, device=dev)
        if p.P > _S.SMEM_KEYS:
            sort = torch.empty((B, p.P), dtype=torch.int64, device=dev)
    base = out.data_ptr()
    params = _S._Params(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc else col.data_ptr(), col.shape[0],
        0 if tc else postings_tf.data_ptr(),
        0 if tc else postings_tf.shape[0],
        col.data_ptr() if tc else 0, col.shape[0],
        starts.data_ptr(), ends.data_ptr(), weights.data_ptr(),
        avg32.data_ptr() if tc else 0,
        B, T, L, M, n_bs_iters, p.path == "plane", p.G, p.LPT, p.ntiles,
        p.nseg, p.tps, p.K, p.KP, p.smem, p.merge_smem,
        lo_ptr, keys_ptr, src_ptr,
        plane.data_ptr() if plane is not None else 0,
        sort.data_ptr() if sort is not None else 0, p.P,
        base, base + 4 * BM, base + 8 * BM, 0, base + 4 * (2 * BM + BTM),
        NS, 0 if tc else dense.data_ptr(), 0 if tc else dense_tf.data_ptr(),
        dense.data_ptr() if tc else 0, slots.data_ptr(),
        norm.data_ptr() if tc else 0, dense.shape[1], doc_base)
    fns = _kernel_fns()
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
