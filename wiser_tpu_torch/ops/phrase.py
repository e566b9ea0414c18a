"""The phrase steps as hand-written CUDA kernels (csrc/phrase.cu).

`phrase_verify` computes engine/kernels._verify_pos_windows: for each
(query, lane) of a (B, NL) group, the number of bases y (the anchor
term's first PP valid positions minus the anchor) at which every term t
holds y + t in its PW-wide position window. `plan` says how it runs: one
warp a (query, lane), W warps a CTA, each warp's T windows (the valid
entries only) in shared memory, so no (B, NL, PP, PW) compare plane
reaches device memory; the output is the (B, NL) int32 counts.

engine/kernels._verify_pos_windows calls `phrase_verify` for CUDA
tensors and runs its plain torch version (_verify_pos_windows_torch)
for CPU tensors after `check_verify_inputs`; `phrase_verify` checks the
same conditions with the cheap `verify_args_ok` before every launch, so
a bad argument raises ValueError the same way on either device. The
counts are integer work: the kernel equals the plain version on every
row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

# kernel launches by wrapper name, one a call
launch_counts = {"phrase_verify": 0}
MAX_T = 32  # terms at most (phrase.cu kMaxT: a thread a term's bounds)
MAX_WARPS = 8  # warps a CTA
# a CTA's windows together at most, as far as one warp allows: 8 warps
# at T 8 and PW 128 (33 KB) take one CTA's whole share
VERIFY_SMEM = 48 * 1024
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into


class Plan(NamedTuple):
    """How phrase_verify runs one (B, T, NL, PW) group."""
    W: int  # warps a CTA, one a (query, lane)
    smem: int  # dynamic shared bytes a CTA
    ctas: int  # the grid


def warp_bytes(T: int, PW: int) -> int:
    """A warp's shared bytes: T windows of PW int32, then T counts."""
    return (T * PW + T) * 4


@functools.lru_cache(maxsize=1024)
def plan(B: int, T: int, NL: int, PW: int) -> Plan:
    """The launch plan of a (B, T, NL, PW) group (arguments already
    checked): as many warps a CTA as fit VERIFY_SMEM, at least one."""
    per = warp_bytes(T, PW)
    W = max(1, min(MAX_WARPS, VERIFY_SMEM // per))
    return Plan(W, W * per, -(-(B * NL) // W))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_T = torch.Tensor


def _ok(t, dtype, shape, dev) -> bool:
    return (isinstance(t, _T) and t.dtype is dtype
            and tuple(t.shape) == shape and t.is_contiguous()
            and t.device == dev)


def check_verify_inputs(positions, ps, pe, anchor, *, T: int, NL: int,
                        PP: int, PW: int) -> None:
    """Raise ValueError unless the arguments are what _verify_pos_windows
    takes: a non-empty contiguous 1-D positions column (int16 bits of
    uint16, or int32), contiguous (B, T, NL) int32 ps and pe, a contiguous
    (B,) int32 anchor (values in [0, T)), every tensor on one device,
    1 <= T <= MAX_T, NL >= 0, PP >= 1, PW >= 1 and a warp's windows
    within the card's shared memory."""
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
    if not isinstance(ps, _T) or ps.dim() != 3:
        raise ValueError("ps must be a (B, T, NL) tensor")
    shape = (ps.shape[0], T, NL)
    for name, t in (("ps", ps), ("pe", pe)):
        if not _ok(t, torch.int32, shape, dev):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {shape} on {dev}")
    if not _ok(anchor, torch.int32, (shape[0],), dev):
        raise ValueError(f"anchor must be a contiguous int32 tensor of "
                         f"shape {(shape[0],)} on {dev}")


def verify_args_ok(positions, ps, pe, anchor, *, T: int, NL: int, PP: int,
                   PW: int) -> bool:
    """check_verify_inputs's conditions as one cheap test (no message):
    True exactly where it raises nothing."""
    if not isinstance(positions, _T) or not isinstance(ps, _T):
        return False
    dev = positions.device
    if dev.type not in ("cpu", "cuda") or ps.dim() != 3:
        return False
    shape = (ps.shape[0], T, NL)
    return (1 <= T <= MAX_T and NL >= 0 and PP >= 1 and PW >= 1
            and warp_bytes(T, PW) <= MAX_SMEM
            and positions.dtype in (torch.int16, torch.int32)
            and positions.dim() == 1 and positions.is_contiguous()
            and positions.shape[0] >= 1
            and _ok(ps, torch.int32, shape, dev)
            and _ok(pe, torch.int32, shape, dev)
            and _ok(anchor, torch.int32, (shape[0],), dev))


class _VerifyParams(ctypes.Structure):
    """phrase.cu's WiserVerifyParams: every field 8 bytes."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "positions n u16 ps pe anchor out B T NL PP PW W smem").split()]


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.verify = lib.wiser_phrase_verify
        self.verify.argtypes = [ctypes.POINTER(_VerifyParams),
                                ctypes.c_void_p]
        self.verify.restype = ctypes.c_int
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


def phrase_verify(positions, ps, pe, anchor, *, T: int, NL: int, PP: int,
                  PW: int):
    """_verify_pos_windows's (B, NL) int32 counts from the kernel, on CUDA
    tensors. Checks the arguments as check_verify_inputs does (ValueError
    before any launch), allocates the output, launches on the current
    stream and does not synchronize."""
    kw = dict(T=T, NL=NL, PP=PP, PW=PW)
    if not (verify_args_ok(positions, ps, pe, anchor, **kw)
            and positions.device.type == "cuda"):
        check_verify_inputs(positions, ps, pe, anchor, **kw)
        raise ValueError(f"phrase_verify runs on CUDA tensors, got "
                         f"{positions.device}")
    dev = positions.device
    B = ps.shape[0]
    out = torch.empty((B, NL), dtype=torch.int32, device=dev)
    if B * NL == 0:
        return out
    p = plan(B, T, NL, PW)
    params = _VerifyParams(
        positions.data_ptr(), positions.shape[0],
        int(positions.dtype is torch.int16), ps.data_ptr(), pe.data_ptr(),
        anchor.data_ptr(), out.data_ptr(), B, T, NL, PP, PW, p.W, p.smem)
    fns = _kernel_fns()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = fns.verify(ctypes.byref(params),
                        torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fns.verify(ctypes.byref(params),
                            torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError("phrase_verify launch failed: "
                           + fns.error(rc).decode())
    launch_counts["phrase_verify"] += 1
    return out
