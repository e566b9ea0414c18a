"""Decode of bit-packed posting blocks (port of wiser_tpu/ops/unpack.py).

Format (codecs.pack_block / native wiser_pack128): each 128-value block
is packed at a width w in 1..32; value i occupies bits [i*w, (i+1)*w) of
a little-endian stream of 4*w uint32 words. Doc-id blocks store delta-1
of ascending ids (lane 0 stores 0) against a per-block first id.

uint32 words and values travel as int32 tensors holding the same bits
(torch has no full uint32 arithmetic); `.numpy().view(np.uint32)` reads
them back.

- `unpack_blocks_torch` / `delta_decode_docs`: the plain torch version.
- `unpack_delta_blocks`: the wrapper of the hand-written CUDA kernel
  (csrc/unpack.cu), which fuses unpack, in-block prefix sum and the add
  of `first`. A CPU tensor takes the plain version; a CUDA tensor runs
  the kernel or raises.
- `combine_doc_column`: the staged engine's scratch doc column rebuilt on
  the device (port of staged._make_doc_combine).
- `pack_doc_blocks` / `unpack_doc_blocks`: a whole doc column packed on
  the host into width buckets, and decoded on the device by
  `unpack_delta_blocks` at every width present.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC
_MASK32 = 0xFFFFFFFF

# kernel launches by wrapper name, counted where the kernel is launched
launch_counts = {"unpack_delta_blocks": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _static_layout(width: int):
    """(word_idx[128], bit_off[128], needs_hi[128]) as numpy constants."""
    bitpos = np.arange(BLOCK, dtype=np.int64) * width
    word_idx = bitpos >> 5
    bit_off = bitpos & 31
    needs_hi = bit_off + width > 32
    return word_idx, bit_off, needs_hi


def unpack_blocks_torch(words: torch.Tensor, width: int) -> torch.Tensor:
    """(G, 4*width) int32 words -> (G, 128) int32 values (uint32 bits)."""
    if not 1 <= width <= 32:
        raise ValueError(f"width {width} outside 1..32")
    word_idx, bit_off, needs_hi = _static_layout(width)
    dev = words.device
    w64 = words.to(torch.int64) & _MASK32
    lo = w64[:, torch.from_numpy(word_idx).to(dev)] >> torch.from_numpy(
        bit_off).to(dev)
    hi_idx = np.minimum(word_idx + 1, 4 * width - 1)
    hi_shift = (32 - bit_off) % 32  # masked out below where it is 32
    hi = (w64[:, torch.from_numpy(hi_idx).to(dev)]
          << torch.from_numpy(hi_shift).to(dev)) & _MASK32
    hi = torch.where(torch.from_numpy(needs_hi).to(dev), hi, 0)
    mask = _MASK32 if width == 32 else (1 << width) - 1
    return _to_int32_bits((lo | hi) & mask)


def _to_int32_bits(x64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(x64 >= 2**31, x64 - 2**32, x64).to(torch.int32)


def delta_decode_docs(deltas: torch.Tensor, block_first: torch.Tensor) -> torch.Tensor:
    """(G, 128) int32 deltas (delta-1 of ascending ids, lane 0 stores 0)
    + (G,) int32 first ids -> (G, 128) int32 doc ids. int32 wraparound,
    as the reference's int32 cumsum."""
    d = deltas.to(torch.int64)
    inc = torch.cumsum(d + 1, dim=1) - (d[:, :1] + 1)
    return _to_int32_bits((block_first.to(torch.int64)[:, None] + inc) & _MASK32)


def unpack_delta_blocks(words: torch.Tensor, first: Optional[torch.Tensor],
                        width: int, out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decode G packed blocks: (G, 4*width) int32 words -> (G*128,) int32.

    With `first` ((G,) int32) the values are delta-decoded doc ids; with
    first=None the raw unpacked values (uint32 bits). `out`, if given, is
    a contiguous (G*128,) int32 tensor (e.g. a prefix of a scratch
    column) written in place and returned."""
    if words.dim() != 2 or words.shape[1] != 4 * width:
        raise ValueError(f"words must be (G, {4 * width}), got {tuple(words.shape)}")
    if not 1 <= width <= 32:
        raise ValueError(f"width {width} outside 1..32")
    G = words.shape[0]
    if first is not None and tuple(first.shape) != (G,):
        raise ValueError(f"first must be ({G},), got {tuple(first.shape)}")
    if out is not None and tuple(out.shape) != (G * BLOCK,):
        raise ValueError(f"out must be ({G * BLOCK},), got {tuple(out.shape)}")
    if words.device.type == "cpu":
        vals = unpack_blocks_torch(words, width)
        if first is not None:
            vals = delta_decode_docs(vals, first)
        if out is None:
            return vals.reshape(-1)
        out.copy_(vals.reshape(-1))
        return out
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    for name, t in (("words", words), ("first", first), ("out", out)):
        if t is None:
            continue
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
    if out is None:
        out = torch.empty(G * BLOCK, dtype=torch.int32, device=words.device)
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    if G == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.wiser_unpack_delta_blocks(
        words.data_ptr(), None if first is None else first.data_ptr(),
        out.data_ptr(), G, width, stream)
    if rc != 0:
        raise RuntimeError("unpack_delta_blocks launch failed: "
                           + lib.wiser_cuda_error_string(rc).decode())
    launch_counts["unpack_delta_blocks"] += 1
    return out


def _kernel_lib() -> ctypes.CDLL:
    from wiser_tpu_torch.build import load_library

    lib = load_library("unpack")
    fn = lib.wiser_unpack_delta_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wiser_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wiser_cuda_error_string.restype = ctypes.c_char_p
    return lib


def combine_doc_column(words: torch.Tensor, first: torch.Tensor,
                       raw_flat: torch.Tensor, off_raw: int, cap: int,
                       width: int, graw: int) -> torch.Tensor:
    """(cap,) int32 scratch doc column: the width-`width` delta blocks
    decoded into [0, G*128), then the raw segment (graw > 0: its first
    graw*128 ids) overlaid at off_raw. Padding junk past the last run is
    masked by every consumer's CSR ends, as in the reference.

    The reference's dynamic_update_slice clamps its start; a torch slice
    does not, so the caller's cap arithmetic must make both writes fit —
    checked here, never clamped."""
    G = words.shape[0]
    n_raw = graw * BLOCK
    if G * BLOCK > cap or (graw and off_raw + n_raw > cap) or off_raw < 0:
        raise ValueError(
            f"scratch cap {cap} too small for {G} packed blocks and "
            f"{n_raw} raw ids at {off_raw}")
    out = torch.zeros(cap, dtype=torch.int32, device=words.device)
    unpack_delta_blocks(words, first, width, out=out[: G * BLOCK])
    if graw:
        out[off_raw : off_raw + n_raw] = raw_flat[:n_raw]
    return out


# -- host-side packing of a 128-aligned doc column ---------------------------


def doc_block_deltas(postings_doc: np.ndarray):
    """(G, 128) uint32 block-local delta-1 values + (G,) int32 block-first
    ids of a 128-aligned, sentinel-padded doc column. Sentinel lanes carry
    the previous real id (delta 0)."""
    P = len(postings_doc)
    if P % BLOCK:
        raise ValueError(f"doc column length {P} is not 128-aligned")
    blocks = postings_doc.reshape(-1, BLOCK).astype(np.int64)
    carried = np.where(blocks != SENTINEL_DOC, blocks, 0)
    np.maximum.accumulate(carried, axis=1, out=carried)
    first = carried[:, 0]
    deltas = np.diff(carried, axis=1, prepend=carried[:, :1])
    deltas = np.where(deltas > 0, deltas - 1, 0).astype(np.uint32)
    return deltas, first.astype(np.int32)


def doc_block_widths(postings_doc: np.ndarray) -> np.ndarray:
    """(G,) uint8 per-128-block pack width (bits) of the delta stream."""
    return _delta_widths(doc_block_deltas(postings_doc)[0])


def _delta_widths(deltas: np.ndarray) -> np.ndarray:
    return np.maximum(
        1, np.ceil(np.log2(deltas.max(axis=1).astype(np.float64) + 1.0)),
    ).astype(np.uint8)


def pack_doc_blocks(postings_doc: np.ndarray) -> dict:
    """Pack a 128-aligned, sentinel-padded doc column into width-bucketed
    delta blocks: {"groups": {width: (block ids int32[gw], words
    uint32[gw, 4*width])}, "block_first": int32[G], "widths": uint8[G]}.
    Sentinel lanes pack as delta 0."""
    from wiser_tpu_torch.native import lib as native

    deltas, first = doc_block_deltas(postings_doc)
    widths = _delta_widths(deltas)
    out = {}
    for w in np.unique(widths):
        sel = np.nonzero(widths == w)[0].astype(np.int32)
        words = native.pack_blocks(deltas[sel].reshape(-1),
                                   np.full(len(sel), w, dtype=np.uint8))
        out[int(w)] = (sel, words.reshape(len(sel), 4 * int(w)))
    return {"groups": out, "block_first": first, "widths": widths}


def unpack_doc_blocks(packed: dict, device="cuda") -> np.ndarray:
    """Inverse of pack_doc_blocks -> int32[G*128] doc column (sentinel
    lanes hold the carried previous id, not the sentinel). Each width's
    blocks decode in one unpack_delta_blocks call on `device`: the CUDA
    kernel on a card, the plain torch version on the CPU."""
    from wiser_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    G = len(packed["block_first"])
    out = np.zeros((G, BLOCK), dtype=np.int32)
    for w, (sel, words) in packed["groups"].items():
        d_words = torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(dev)
        d_first = torch.from_numpy(packed["block_first"][sel]).to(dev)
        out[sel] = unpack_delta_blocks(d_words, d_first, w).cpu().numpy(
            ).reshape(len(sel), BLOCK)
    return out.reshape(-1)
