"""The phrase position verification as a hand-written CUDA kernel
(csrc/phrase.cu group_kernel).

It computes engine/kernels._verify_pos_windows_torch's counts: for each
(query, lane) of a (B, NL) group, the number of bases y (the anchor
term's first PP valid positions minus the anchor) at which every term t
holds y + t in its PW-wide position window, from what the phrase routes
hold instead of the bag bounds. `group_plan` says how it runs: a group of
G threads an item (8 where T <= 8 and PW <= 32, else 32), W warps a CTA,
each item's T windows (the valid entries only) in shared memory, so no
(B, NL, PP, PW) compare plane reaches device memory; the output is the
(B, NL) int32 counts.
`phrase_verify_docs` (engine/kernels._verify_docs, the mega routes) takes
the kept docs (B, NL) and the query terms' runs (B, T); each term's
posting index is recovered inside the kernel exactly as the plain
version's fixed-count search finds it, the bag bounds read from
pos_starts, the verification anchored on each query's anchor term. Its
plain version is engine/kernels._verify_docs_torch; `check_docs_inputs`
checks the arguments, so a bad argument raises ValueError the same way
on either device. The counts are integer work: the kernel equals the
plain version on every row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

# kernel launches by wrapper name, one a call
launch_counts = {"phrase_verify_docs": 0}
MAX_T = 32  # terms at most (phrase.cu kMaxT: a thread a term's bounds)
MAX_WARPS = 8  # warps a CTA
# a CTA's windows together at most, as far as one warp allows: 8 warps
# at T 8 and PW 128 (33 KB) take one CTA's whole share
VERIFY_SMEM = 48 * 1024
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into
# a group of GROUP_SMALL threads an item where T and PW allow it
# (phrase.cu kGroupMaxT, kGroupMaxPW), else a warp
GROUP_SMALL = 8
GROUP_MAX_T, GROUP_MAX_PW = 8, 32


def warp_bytes(T: int, PW: int) -> int:
    """A warp's shared bytes: T windows of PW int32, then T counts."""
    return (T * PW + T) * 4


class GroupPlan(NamedTuple):
    """How phrase_verify_docs runs one (B, T, NL, PW) group."""
    G: int  # threads an item
    W: int  # warps a CTA, 32 / G items each
    smem: int  # dynamic shared bytes a CTA
    ctas: int  # the grid


@functools.lru_cache(maxsize=1024)
def group_plan(B: int, T: int, NL: int, PW: int) -> GroupPlan:
    """The launch plan (arguments already checked): G =
    GROUP_SMALL where T <= GROUP_MAX_T and PW <= GROUP_MAX_PW, else 32;
    as many warps a CTA as fit VERIFY_SMEM, at least one."""
    G = GROUP_SMALL if T <= GROUP_MAX_T and PW <= GROUP_MAX_PW else 32
    per = warp_bytes(T, PW) * (32 // G)  # a warp's items' windows
    W = max(1, min(MAX_WARPS, VERIFY_SMEM // per))
    items = W * (32 // G)
    return GroupPlan(G, W, W * per, -(-(B * NL) // items))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_T = torch.Tensor


def _ok(t, dtype, shape, dev) -> bool:
    return (isinstance(t, _T) and t.dtype is dtype
            and tuple(t.shape) == shape and t.is_contiguous()
            and t.device == dev)


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.group = lib.wiser_phrase_verify_group
        self.group.argtypes = [ctypes.POINTER(_GroupParams), ctypes.c_void_p]
        self.group.restype = ctypes.c_int
        self.error = lib.wiser_phrase_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("phrase"))
    return _fns


def _check_common(positions, T: int, NL: int, PP: int, PW: int):
    """The conditions on the positions column and the shape
    arguments: a non-empty contiguous 1-D positions column (int16 bits of
    uint16, or int32) on the CPU or a card, 1 <= T <= MAX_T, NL >= 0,
    PP >= 1, PW >= 1 and a warp's windows within the card's shared
    memory. Returns the device."""
    if not isinstance(positions, _T):
        raise ValueError("positions must be a tensor")
    dev = positions.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (not 1 <= T <= MAX_T or NL < 0 or PP < 1 or PW < 1
            or warp_bytes(T, PW) > MAX_SMEM):
        raise ValueError(f"need 1 <= T <= {MAX_T}, NL >= 0, PP >= 1 and "
                         f"PW >= 1 (T * PW windows within {MAX_SMEM} "
                         f"shared bytes), got T={T} NL={NL} PP={PP} PW={PW}")
    if (positions.dtype not in (torch.int16, torch.int32)
            or positions.dim() != 1 or not positions.is_contiguous()
            or positions.shape[0] < 1):
        raise ValueError(f"positions must be a non-empty contiguous 1-D "
                         f"int16 or int32 tensor on {dev}")
    return dev


def _need_i32(name, t, shape, dev) -> None:
    if not _ok(t, torch.int32, shape, dev):
        raise ValueError(f"{name} must be a contiguous int32 tensor of "
                         f"shape {shape} on {dev}")


def _column(name, t, dev) -> None:
    if not (isinstance(t, _T) and t.dtype is torch.int32 and t.dim() == 1
            and t.is_contiguous() and t.shape[0] >= 1 and t.device == dev):
        raise ValueError(f"{name} must be a non-empty contiguous 1-D int32 "
                         f"tensor on {dev}")


def check_docs_inputs(postings_doc, positions, pos_starts, docs, starts,
                      ends, anchor, *, T: int, NL: int, PP: int, PW: int,
                      n_iters: int) -> None:
    """Raise ValueError unless the arguments are what _verify_docs takes:
    the positions column and shapes as _check_common says, non-empty
    contiguous 1-D int32 postings_doc and pos_starts, contiguous (B, NL)
    int32 docs, (B, T) int32 starts and ends, a (B,) int32 anchor, every
    tensor on one device, n_iters >= 0."""
    dev = _check_common(positions, T, NL, PP, PW)
    _column("postings_doc", postings_doc, dev)
    _column("pos_starts", pos_starts, dev)
    if not isinstance(docs, _T) or docs.dim() != 2:
        raise ValueError("docs must be a (B, NL) tensor")
    B = docs.shape[0]
    _need_i32("docs", docs, (B, NL), dev)
    _need_i32("starts", starts, (B, T), dev)
    _need_i32("ends", ends, (B, T), dev)
    _need_i32("anchor", anchor, (B,), dev)
    if n_iters < 0:
        raise ValueError(f"need n_iters >= 0, got {n_iters}")


class _GroupParams(ctypes.Structure):
    """phrase.cu's WiserVerifyGroupParams: every field 8 bytes."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "positions n u16 pos_starts n_ps doc n_doc docs starts ends "
        "anchor out B T NL PP PW n_iters G W smem").split()]


def _launch_group(params, dev, what: str) -> None:
    fns = _kernel_fns()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        rc = fns.group(ctypes.byref(params),
                       torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: " + fns.error(rc).decode())
    launch_counts[what] += 1


def _group_params(positions, pos_starts, out, B, T, NL, PP, PW, n_iters,
                  doc, docs, starts, ends, anchor) -> _GroupParams:
    g = group_plan(B, T, NL, PW)
    return _GroupParams(
        positions.data_ptr(), positions.shape[0],
        int(positions.dtype is torch.int16), pos_starts.data_ptr(),
        pos_starts.shape[0], doc.data_ptr(), doc.shape[0], docs.data_ptr(),
        starts.data_ptr(), ends.data_ptr(), anchor.data_ptr(),
        out.data_ptr(), B, T, NL, PP, PW, n_iters, g.G, g.W, g.smem)


def phrase_verify_docs(postings_doc, positions, pos_starts, docs, starts,
                       ends, anchor, *, T: int, NL: int, PP: int, PW: int,
                       n_iters: int):
    """_verify_docs's (B, NL) int32 counts from the kernel, on CUDA
    tensors: each kept doc's posting index in each query term's run
    recovered as the fixed-count search finds it, its bag bounds from
    pos_starts, the verification anchored on anchor[b]. Checks the
    arguments as check_docs_inputs does (ValueError before any launch),
    allocates the output, launches on the current stream and does not
    synchronize."""
    check_docs_inputs(postings_doc, positions, pos_starts, docs, starts,
                      ends, anchor, T=T, NL=NL, PP=PP, PW=PW,
                      n_iters=n_iters)
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"phrase_verify_docs runs on CUDA tensors, got "
                         f"{dev}")
    B = docs.shape[0]
    out = torch.empty((B, NL), dtype=torch.int32, device=dev)
    if B * NL == 0:
        return out
    _launch_group(_group_params(positions, pos_starts, out, B, T, NL, PP, PW,
                                n_iters, postings_doc, docs, starts, ends,
                                anchor), dev, "phrase_verify_docs")
    return out

