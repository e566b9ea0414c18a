"""The bs search step as one hand-written CUDA kernel (csrc/search.cu).

`bs_search` computes engine/kernels.search_body's outputs (top_docs,
top_score, top_tfs, top_pidx, flags) for raw and tc columns. `plan`
says how: on the tile path (K = min(M + 1, L) <= KEY_CAP, every engine
group) a worker (a warp where L <= 128, else a CTA) takes one query's
tiles of consecutive candidate lanes, intersects each tile with a window
of every other run in shared memory and keeps a running top K there, so
no (B, L) score plane is allocated; one launch a group, or two where the
tiles of a small group are split across CTAs and merged per query. Above
KEY_CAP the plane path runs the first form's two launches (a score
plane, then a per-query select). `search_body` calls `bs_search` for
CUDA tensors and runs its plain torch version (search_body_torch) for
CPU tensors; `check_inputs` runs first on the CPU, and `bs_search`
checks the same conditions (`args_ok`, cheap enough for every launch),
so a bad argument raises ValueError the same way on either device
before any launch.

Where the plain version is exact the kernel equals it bit for bit: the
flags on every row; the kept lanes' docs, f32 scores, posting indices
and tfs; the kept set itself wherever no boundary tie was cut (FLAG_TRUNC
clear). Its order is (score desc, doc asc), lax.top_k's on the CPU; on a
flagged row it keeps the lowest docs of the boundary class, which
torch.topk on a card does not promise. top_pidx is defined on kept lanes
only, as in the plain version (the tile path writes -1 past the matched
lanes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

# kernel launches by wrapper name and path, counted where the kernel is
# launched: one a call on the tile path (bs_search) or the plane path
launch_counts = {"bs_search": 0, "bs_search_plane": 0}
KEY_CAP = 1024  # the tile path's largest K = min(M + 1, L) (search.cu)
THREADS = 256  # every launch's CTA
WARP_WINDOW = 256  # window ids a chunk of a warp worker
MISC_BYTES = 512  # a worker's scalars
MAX_TILE = 1024  # lanes a tile of a CTA worker: 4 a thread
# a group narrower than this many CTAs splits each query's tiles across
# CTAs (at most one CTA a tile), merged by a second launch
TARGET_CTAS = 2048
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into
SMEM_KEYS = 4096  # plane path: sort keys held in shared memory, else a scratch
MAX_B = 65535  # the plane path's score launch grid.y


class Plan(NamedTuple):
    """How bs_search runs one (B, T, L, M) group."""
    path: str  # "tile" or "plane"
    G: int  # threads a worker: 32 (a warp) or 256 (a CTA); plane: 256
    LPT: int  # lanes a thread holds
    TL: int  # lanes a tile
    ntiles: int  # tiles a query
    nseg: int  # workers a query (> 1: the merge launch runs)
    tps: int  # tiles a worker
    K: int  # keys kept a query: min(M + 1, L)
    KP: int  # the power of 2 >= K
    smem: int  # dynamic shared bytes of the first launch
    merge_smem: int  # of the merge launch (0 without it)
    launches: int  # CUDA launches a call
    out_words: int  # int32 words of the one output allocation
    scratch_words: int  # int32 words of the tile path's scratch
    plane_bytes: int  # the plane path's (B, L) f32 plane
    P: int  # plane path: sorted keys a query


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _align8(n: int) -> int:
    return (n + 7) & ~7


def worker_bytes(G: int, T: int, TL: int, KP: int, multi: bool) -> int:
    """search.cu's worker_bytes: Misc | S (TL int32 staged docs) | X
    (TL u64 keys or three chunks of window ids) | R and R2 (each KP u64 + KP u32, several
    tiles only) | lo ((T-1, TL) int32)."""
    win = WARP_WINDOW if G == 32 else TL
    r = 2 * _align8(KP * 12) if multi else 0
    return (MISC_BYTES + _align8(TL * 4) + max(2 * TL, 3 * win) * 4 + r
            + _align8((T - 1) * TL * 4))


@functools.lru_cache(maxsize=4096)
def plan(B: int, T: int, L: int, M: int) -> Plan:
    """The launch plan of a (B, T, L, M) group (arguments already
    checked: T >= 1, 1 <= M <= L): the tile path, or the plane path where
    K = min(M + 1, L) passes KEY_CAP or a worker's shared bytes would pass
    the card's (a T far past the engine's buckets)."""
    K = min(M + 1, L)
    out_words = B * (2 * M + 2 * T * M + 1)
    KP = _pow2(K)
    if L <= 128:
        G, LPT = 32, 4
    else:
        G = THREADS
        LPT = min(MAX_TILE, max(THREADS, _pow2(L))) // THREADS
    TL = G * LPT
    ntiles = -(-L // TL)
    nseg = 1
    if ntiles > 1:
        nseg = min(ntiles, max(1, -(-TARGET_CTAS // max(B, 1))))
    tps = -(-ntiles // nseg)
    nseg = -(-ntiles // tps)
    multi = ntiles > 1
    smem = (THREADS // G) * worker_bytes(G, T, TL, KP, multi)
    merge_smem = MISC_BYTES + 3 * _align8(KP * 12) if nseg > 1 else 0
    if K > KEY_CAP or smem > MAX_SMEM:  # the first form's plane and select
        return Plan("plane", THREADS, 1, THREADS, -(-L // THREADS), 1, 1, K,
                    KP, 0 if KP > SMEM_KEYS else KP * 8, 0, 2, out_words, 0,
                    B * L * 4, KP)
    scratch = 0
    if multi:
        scratch += B * (T - 1) * ntiles * K
    if nseg > 1:
        scratch += 3 * B * nseg * K  # part keys (2 words) + sources
    return Plan("tile", G, LPT, TL, ntiles, nseg, tps, K, KP, smem,
                merge_smem, 1 + (nseg > 1), out_words, scratch, 0, 0)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _column(name: str, t, dtypes, dev) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if (not isinstance(t, torch.Tensor) or t.dtype not in dtypes
            or t.dim() != 1 or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f"{' or '.join(map(str, dtypes))} on {dev}")


def _plane(name: str, t, dtype, shape, dev) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}")


def check_inputs(postings_doc, postings_score, postings_tf, starts, ends,
                 use_score, *, T: int, L: int, M: int, n_bs_iters: int,
                 tc=None, idf32=None, avg32=None) -> None:
    """Raise ValueError unless the arguments are what search_body takes:
    contiguous 1-D columns (doc int32; raw score f32 and tf int32, or tc
    lanes as int16 bits of uint16) at least L long, contiguous (B, T) int32
    starts / ends and f32 use_score (raw) or idf32 (tc), a one-element f32
    avg32 (tc), every tensor on postings_doc's device, 1 <= M <= L."""
    if not isinstance(postings_doc, torch.Tensor):
        raise ValueError("postings_doc must be a tensor")
    dev = postings_doc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if T < 1 or not 1 <= M <= L or n_bs_iters < 0:
        raise ValueError(f"need T >= 1, 1 <= M <= L and n_bs_iters >= 0, "
                         f"got T={T} L={L} M={M} n_bs_iters={n_bs_iters}")
    _column("postings_doc", postings_doc, (torch.int32,), dev)
    if tc is None:
        cols = (("postings_score", postings_score, (torch.float32,)),
                ("postings_tf", postings_tf, (torch.int32,)))
        weights, wname = use_score, "use_score"
    else:
        cols = (("tc", tc, (torch.int16,)),)
        weights, wname = idf32, "idf32"
        if (not isinstance(avg32, torch.Tensor)
                or avg32.dtype != torch.float32 or avg32.numel() != 1
                or avg32.device != dev):
            raise ValueError(f"avg32 must be a one-element float32 tensor "
                             f"on {dev}")
    for name, t, dtypes in cols:
        _column(name, t, dtypes, dev)
    for name, t in (("postings_doc", postings_doc),) + tuple(
            (n, t) for n, t, _ in cols):
        if t.shape[0] < L:
            raise ValueError(f"{name} holds {t.shape[0]} postings, fewer "
                             f"than the L = {L} lanes of a candidate load")
    if not isinstance(starts, torch.Tensor) or starts.dim() != 2:
        raise ValueError("starts must be a (B, T) tensor")
    shape = (starts.shape[0], T)
    _plane("starts", starts, torch.int32, shape, dev)
    _plane("ends", ends, torch.int32, shape, dev)
    _plane(wname, weights, torch.float32, shape, dev)


_T = torch.Tensor


def _col_ok(t, dtype, dev, L: int) -> bool:
    return (isinstance(t, _T) and t.dtype is dtype and t.dim() == 1
            and t.is_contiguous() and t.device == dev and t.shape[0] >= L)


def _bt_ok(t, dtype, dev, B: int, T: int) -> bool:
    return (isinstance(t, _T) and t.dtype is dtype and t.dim() == 2
            and t.shape[0] == B and t.shape[1] == T and t.is_contiguous()
            and t.device == dev)


def args_ok(postings_doc, postings_score, postings_tf, starts, ends,
            use_score, *, T: int, L: int, M: int, n_bs_iters: int, tc=None,
            idf32=None, avg32=None) -> bool:
    """check_inputs's conditions as one cheap test (no message): True
    exactly where check_inputs raises nothing. It runs on every launch;
    bs_search calls check_inputs for the message where it is False."""
    if not isinstance(postings_doc, _T) or not isinstance(starts, _T):
        return False
    dev = postings_doc.device
    if dev.type not in ("cpu", "cuda") or starts.dim() != 2:
        return False
    B = starts.shape[0]
    ok = (T >= 1 and 1 <= M <= L and n_bs_iters >= 0
          and _col_ok(postings_doc, torch.int32, dev, L)
          and _bt_ok(starts, torch.int32, dev, B, T)
          and _bt_ok(ends, torch.int32, dev, B, T))
    if tc is not None:
        return (ok and _col_ok(tc, torch.int16, dev, L)
                and _bt_ok(idf32, torch.float32, dev, B, T)
                and isinstance(avg32, _T) and avg32.dtype is torch.float32
                and avg32.numel() == 1 and avg32.device == dev)
    return (ok and _col_ok(postings_score, torch.float32, dev, L)
            and _col_ok(postings_tf, torch.int32, dev, L)
            and _bt_ok(use_score, torch.float32, dev, B, T))


class _Params(ctypes.Structure):
    """tile.cuh's WiserStepParams: every field 8 bytes, in its order."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "doc n_doc score n_score tf n_tf tc n_tc starts ends weights avg32 "
        "B T L M n_iters path G LPT ntiles nseg tps K KP smem merge_smem "
        "lo_scratch part_keys part_src plane sort_scratch P "
        "top_docs top_score top_tfs top_pidx flags").split()]


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.search = lib.wiser_bs_search
        self.search.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        self.search.restype = ctypes.c_int
        self.error = lib.wiser_search_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("search"))
    return _fns


def bs_search(postings_doc, postings_score, postings_tf, starts, ends,
              use_score, *, T: int, L: int, M: int, n_bs_iters: int,
              tc=None, idf32=None, avg32=None):
    """search_body's outputs from the kernel, on CUDA tensors. Checks the
    arguments as check_inputs does (ValueError before any launch), then
    allocates the outputs as views of one buffer and, by `plan`, the tile
    path's small scratch or the plane path's (B, L) plane; launches on the
    current stream and does not synchronize."""
    tc_mode = tc is not None
    if not (args_ok(postings_doc, postings_score, postings_tf, starts, ends,
                    use_score, T=T, L=L, M=M, n_bs_iters=n_bs_iters, tc=tc,
                    idf32=idf32, avg32=avg32)
            and postings_doc.device.type == "cuda"):
        check_inputs(postings_doc, postings_score, postings_tf, starts,
                     ends, use_score, T=T, L=L, M=M, n_bs_iters=n_bs_iters,
                     tc=tc, idf32=idf32, avg32=avg32)
        raise ValueError(f"bs_search runs on CUDA tensors, got "
                         f"{postings_doc.device}")
    dev = postings_doc.device
    B = starts.shape[0]
    p = plan(B, T, L, M)
    if p.path == "plane" and B > MAX_B:
        raise ValueError(f"B = {B} queries exceed the plane path's {MAX_B}")
    out = torch.empty(p.out_words, dtype=torch.int32, device=dev)
    BM, BTM = B * M, B * T * M
    docs, score, tfs, pidx, flags = out.split((BM, BM, BTM, BTM, B))
    res = (docs.view(B, M), score.view(torch.float32).view(B, M),
           tfs.view(B, T, M), pidx.view(B, T, M), flags)
    if B == 0:
        return res
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
        lo_ptr = base + 12 * n_part if p.ntiles > 1 and T > 1 else 0
    if p.path == "plane":
        plane = torch.empty((B, L), dtype=torch.float32, device=dev)
        if p.P > SMEM_KEYS:
            sort = torch.empty((B, p.P), dtype=torch.int64, device=dev)
    col = tc if tc_mode else postings_score
    base = out.data_ptr()
    params = _Params(
        postings_doc.data_ptr(), postings_doc.shape[0],
        0 if tc_mode else col.data_ptr(), col.shape[0],
        0 if tc_mode else postings_tf.data_ptr(),
        0 if tc_mode else postings_tf.shape[0],
        tc.data_ptr() if tc_mode else 0, col.shape[0],
        starts.data_ptr(), ends.data_ptr(),
        (idf32 if tc_mode else use_score).data_ptr(),
        avg32.data_ptr() if tc_mode else 0,
        B, T, L, M, n_bs_iters, p.path == "plane", p.G, p.LPT, p.ntiles,
        p.nseg, p.tps, p.K, p.KP, p.smem, p.merge_smem,
        lo_ptr, keys_ptr, src_ptr,
        plane.data_ptr() if plane is not None else 0,
        sort.data_ptr() if sort is not None else 0, p.P,
        base, base + 4 * BM, base + 8 * BM, base + 4 * (2 * BM + BTM),
        base + 4 * (2 * BM + 2 * BTM))
    fns = _kernel_fns()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = fns.search(ctypes.byref(params),
                        torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fns.search(ctypes.byref(params),
                            torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError("bs_search launch failed: "
                           + fns.error(rc).decode())
    launch_counts["bs_search" if p.path == "tile" else "bs_search_plane"] += 1
    return res
