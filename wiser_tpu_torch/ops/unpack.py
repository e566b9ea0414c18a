"""Decode of bit-packed posting blocks (port of wiser_tpu/ops/unpack.py).

Format (codecs.pack_block / native wiser_pack128): each 128-value block
is packed at a width w in 1..32; value i occupies bits [i*w, (i+1)*w) of
a little-endian stream of 4*w uint32 words. Doc-id blocks store delta-1
of ascending ids (lane 0 stores 0) against a per-block first id.

uint32 words and values travel as int32 tensors holding the same bits
(torch has no full uint32 arithmetic); `.numpy().view(np.uint32)` reads
them back.

- `unpack_blocks_torch` / `delta_decode_docs`: the plain torch version;
  `unpack_mixed_blocks_torch`: the same per width over a block table.
- `unpack_delta_blocks` (one width) and `unpack_mixed_blocks` (a block
  table of mixed widths, each block written in place): the wrappers of
  the hand-written CUDA kernel (csrc/unpack.cu), which fuses unpack,
  in-block prefix sum and the add of `first`. A CPU tensor takes the
  plain version; a CUDA tensor runs the kernel or raises.
- `combine_doc_column`: the staged engine's scratch doc column rebuilt on
  the device (port of staged._make_doc_combine).
- `pack_doc_blocks` / `unpack_doc_blocks`: a whole doc column packed on
  the host into width buckets, and decoded on the device in one
  `unpack_mixed_blocks` launch over `doc_block_table`'s table.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC
_MASK32 = 0xFFFFFFFF

# kernel launches by wrapper name, counted where the kernel is launched
launch_counts = {"unpack_delta_blocks": 0, "unpack_mixed_blocks": 0}


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
    column) written in place and returned. On a card, words and out
    must be 16-byte aligned (the kernel copies 16 bytes a lane)."""
    G = words.shape[0]
    if words.dim() != 2 or words.shape[1] != 4 * width or not 1 <= width <= 32:
        raise ValueError(f"words must be (G, 4*width) at a width in 1..32, "
                         f"got {tuple(words.shape)} at width {width}")
    if first is not None and (first.dim() != 1 or first.shape[0] != G):
        raise ValueError(f"first must be ({G},), got {tuple(first.shape)}")
    if out is not None and (out.dim() != 1 or out.shape[0] != G * BLOCK):
        raise ValueError(f"out must be ({G * BLOCK},), got {tuple(out.shape)}")
    if not words.is_cuda:
        if words.device.type != "cpu":
            raise ValueError(f"unsupported device {words.device}")
        vals = unpack_blocks_torch(words, width)
        if first is not None:
            vals = delta_decode_docs(vals, first)
        if out is None:
            return vals.reshape(-1)
        out.copy_(vals.reshape(-1))
        return out
    # the checks stay cheap: they run on every launch
    dev = words.get_device()
    for name, t in (("words", words), ("first", first), ("out", out)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()
                              or t.get_device() != dev):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{words.device}")
    if out is None:
        out = torch.empty(G * BLOCK, dtype=torch.int32, device=words.device)
    if (out.data_ptr() | words.data_ptr()) & 15:
        raise ValueError("words and out must be 16-byte aligned")
    if G == 0:
        return out
    fns = _kernel_fns()
    _check_launch(fns, "unpack_delta_blocks", fns.delta(
        words.data_ptr(), None if first is None else first.data_ptr(),
        out.data_ptr(), G, width, torch._C._cuda_getCurrentRawStream(dev)))
    return out


def unpack_mixed_blocks(words: torch.Tensor, widths: torch.Tensor,
                        offsets: torch.Tensor, dest: torch.Tensor,
                        first: torch.Tensor, out: torch.Tensor
                        ) -> torch.Tensor:
    """Decode the delta blocks of a block table in one launch: entry k is
    the block of width widths[k] (uint8, 1..32) whose 4*width words start
    at offsets[k] (int64, a multiple of 4) in the flat int32 stream
    `words` (16-byte aligned), decoded against first[k] (int32) into
    block dest[k] (int32) of `out`, a contiguous (n*128,) int32 tensor
    written in place and returned; blocks no entry names keep their
    values. On a CUDA tensor an entry out of range traps the kernel (the
    fault surfaces at the next synchronize); the plain version raises."""
    G = widths.shape[0]
    dev = words.get_device()
    for name, t, dtype in (("words", words, torch.int32),
                           ("widths", widths, torch.uint8),
                           ("offsets", offsets, torch.int64),
                           ("dest", dest, torch.int32),
                           ("first", first, torch.int32),
                           ("out", out, torch.int32)):
        if (t.dtype != dtype or t.dim() != 1 or not t.is_contiguous()
                or t.get_device() != dev):
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor on {words.device}")
    if not offsets.shape[0] == dest.shape[0] == first.shape[0] == G:
        raise ValueError(
            f"table lengths differ: widths {G}, offsets {offsets.shape[0]}, "
            f"dest {dest.shape[0]}, first {first.shape[0]}")
    if out.shape[0] % BLOCK:
        raise ValueError(f"out length {out.shape[0]} is not 128-aligned")
    if (words.data_ptr() | out.data_ptr()) & 15:
        raise ValueError("words and out must be 16-byte aligned")
    if not words.is_cuda:
        if words.device.type != "cpu":
            raise ValueError(f"unsupported device {words.device}")
        return unpack_mixed_blocks_torch(words, widths, offsets, dest, first,
                                         out)
    if G == 0:
        return out
    fns = _kernel_fns()
    _check_launch(fns, "unpack_mixed_blocks", fns.mixed(
        words.data_ptr(), words.shape[0], widths.data_ptr(),
        offsets.data_ptr(), dest.data_ptr(), first.data_ptr(),
        out.data_ptr(), G, out.shape[0] // BLOCK,
        torch._C._cuda_getCurrentRawStream(dev)))
    return out


def unpack_mixed_blocks_torch(words, widths, offsets, dest, first, out):
    """The plain version of unpack_mixed_blocks: each width's entries
    gathered from the stream, unpacked and delta-decoded by
    unpack_blocks_torch / delta_decode_docs, scattered into `out`."""
    n_out = out.shape[0] // BLOCK
    if widths.numel():
        w = widths.to(torch.int64)
        if int(w.min()) < 1 or int(w.max()) > 32:
            raise ValueError("a width outside 1..32")
        if (int((offsets % 4).max()) or int(offsets.min()) < 0
                or int((offsets + 4 * w).max()) > words.shape[0]):
            raise ValueError("an offset misaligned or past the word stream")
        if int(dest.min()) < 0 or int(dest.max()) >= n_out:
            raise ValueError(f"a destination outside 0..{n_out - 1}")
    blocks = out.view(n_out, BLOCK)
    for width in torch.unique(widths).tolist():
        k = torch.nonzero(widths == width).flatten()
        idx = offsets[k][:, None] + torch.arange(
            4 * width, dtype=torch.int64, device=words.device)
        vals = unpack_blocks_torch(words[idx], width)
        blocks[dest[k].to(torch.int64)] = delta_decode_docs(vals, first[k])
    return out


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        self.delta = lib.wiser_unpack_delta_blocks
        self.delta.argtypes = [p, p, p, ll, ctypes.c_int, p]
        self.mixed = lib.wiser_unpack_mixed_blocks
        self.mixed.argtypes = [p, ll, p, p, p, p, p, ll, ll, p]
        self.error = lib.wiser_cuda_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p
        for fn in (self.delta, self.mixed):
            fn.restype = ctypes.c_int


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("unpack"))
    return _fns


def _check_launch(fns: _Fns, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: " + fns.error(rc).decode())
    launch_counts[name] += 1


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


def doc_block_table(packed: dict):
    """pack_doc_blocks's dict as the block table of one unpack_mixed_blocks
    launch: (stream uint32[n_words], widths uint8[G], offsets int64[G],
    dest int32[G], first int32[G]). The stream is the groups' words
    concatenated in the dict's order; entry k is the k-th block of the
    stream, at a word offset that is the running sum of 4*width (so every
    block starts 16-byte aligned), decoded into block dest[k] = its `sel`
    with its block_first."""
    groups = list(packed["groups"].items())
    G = len(packed["block_first"])
    widths = np.concatenate([np.full(len(sel), w, dtype=np.uint8)
                             for w, (sel, _) in groups] or
                            [np.zeros(0, np.uint8)])
    dest = np.concatenate([sel for _, (sel, _) in groups] or
                          [np.zeros(0, np.int32)]).astype(np.int32)
    if len(dest) != G or not np.array_equal(
            np.bincount(dest, minlength=G), np.ones(G, dtype=np.int64)):
        raise ValueError("the groups must name every block exactly once")
    if widths.size and (widths.min() < 1 or widths.max() > 32):
        raise ValueError("a width outside 1..32")
    offsets = np.zeros(G, dtype=np.int64)
    np.cumsum(4 * widths[:-1].astype(np.int64), out=offsets[1:])
    stream = np.concatenate(
        [np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
         for _, (_, words) in groups] or [np.zeros(0, np.uint32)])
    if len(stream) != (offsets[-1] + 4 * int(widths[-1]) if G else 0):
        raise ValueError("a group's words do not match its width")
    first = np.asarray(packed["block_first"], dtype=np.int32)[dest]
    return stream, widths, offsets, dest, first


def upload_table(table, device):
    """doc_block_table's arrays as tensors on `device`, in one host to
    device copy: one 16-byte aligned byte buffer, each array at a
    16-byte aligned offset, viewed back as (words int32, widths uint8,
    offsets int64, dest int32, first int32) — unpack_mixed_blocks's
    arguments before `out`."""
    stream, widths, offsets, dest, first = table
    parts = [(stream.view(np.int32), torch.int32), (widths, torch.uint8),
             (offsets, torch.int64), (dest, torch.int32),
             (first, torch.int32)]
    starts, total = [], 0
    for a, _ in parts:
        starts.append(total)
        total += -(-a.nbytes // 16) * 16
    raw = np.empty(total + 16, dtype=np.uint8)
    pad = -raw.ctypes.data % 16
    buf = raw[pad : pad + total]
    for (a, _), s in zip(parts, starts):
        buf[s : s + a.nbytes] = a.view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    return tuple(dev_buf[s : s + a.nbytes].view(dtype)
                 for (a, dtype), s in zip(parts, starts))


def unpack_doc_blocks(packed: dict, device="cuda") -> np.ndarray:
    """Inverse of pack_doc_blocks -> int32[G*128] doc column (sentinel
    lanes hold the carried previous id, not the sentinel): one host to
    device copy of doc_block_table's table, one unpack_mixed_blocks call
    on `device` (the CUDA kernel on a card, the plain torch version on
    the CPU) writing every block in place, one copy back."""
    from wiser_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    G = len(packed["block_first"])
    table = upload_table(doc_block_table(packed), dev)
    out = torch.empty(G * BLOCK, dtype=torch.int32, device=dev)
    return unpack_mixed_blocks(*table, out=out).cpu().numpy()
