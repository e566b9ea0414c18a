"""Host codecs (the port's copy of wiser_tpu/codecs.py): the lossy 1-byte
doc-length code (the reference's UintToChar4 / Char4ToUint,
utils.h:301-330: a 3-bit mantissa and a 5-bit shift), LEB128 varints
(compression.h:6-131) and the delta + fixed-width bit packing of 128-value
posting blocks (packed_value.h:87-274's LittleIntPacker, in the layout
native/wiser_native.cpp and csrc/unpack.cu share). The native library
packs whole columns; these numpy forms are the specification the tests
and tools/micro_bench hold it to."""

from __future__ import annotations

import numpy as np


def uint_to_char4(val: int) -> int:
    """Encode a non-negative int (< 2^31) into the lossy 1-byte code
    (reference: utils.h:301-315)."""
    v = int(val)
    if v < 0x08:
        return v & 0xFF
    shift = v.bit_length() - 4
    return ((v >> shift) & 0x07) | ((shift + 1) << 3)


def char4_to_uint(code: int) -> int:
    """Decode the lossy 1-byte code (reference: utils.h:317-330)."""
    c = int(code) & 0xFF
    bits = c & 0x07
    shift = (c >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


# decode table for all 256 codes (the decode half of the reference's
# Bm25Similarity::BuildCache, scoring.h:85-90)
CHAR4_DECODE_TABLE = np.array([char4_to_uint(c) for c in range(256)],
                              dtype=np.int64)


def uint_to_char4_np(vals: np.ndarray) -> np.ndarray:
    """Encode non-negative ints (< 2^31) into uint8 codes
    (reference: utils.h:301-315)."""
    v = np.asarray(vals, dtype=np.int64)
    nbits = np.zeros_like(v)
    tmp = v.copy()
    for _ in range(31):  # bit_length by repeated shifts
        nz = tmp > 0
        if not nz.any():
            break
        nbits[nz] += 1
        tmp[nz] >>= 1
    shift = nbits - 4
    big = v >= 0x08
    enc_big = ((v >> np.maximum(shift, 0)) & 0x07) | ((shift + 1) << 3)
    out = np.where(big, enc_big, v & 0x07)
    return out.astype(np.uint8)


# -- varint (LEB128): host-side serialization, never on the device ----------


def varint_encode(value: int, out: bytearray) -> None:
    """Append the LEB128 bytes of a non-negative int to out."""
    v = int(value)
    if v < 0:
        raise ValueError("varint requires non-negative values")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def varint_decode(buf: bytes, offset: int) -> tuple[int, int]:
    """(value, bytes consumed) of the varint starting at offset."""
    result = 0
    shift = 0
    pos = offset
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not (b & 0x80):
            return result, pos - offset
        shift += 7


# -- delta + fixed-width bit packing of 128-value posting blocks -------------

BLOCK = 128


def bits_needed(vals: np.ndarray) -> int:
    """The narrowest width (>= 1) that holds every value."""
    return max(1, int(vals.max(initial=0)).bit_length())


def pack_block(vals: np.ndarray, width: int) -> np.ndarray:
    """128 values at `width` bits -> 4*width uint32 words: value i
    occupies bits [i*width, (i+1)*width) of the block's little-endian
    bit stream."""
    if len(vals) != BLOCK:
        raise ValueError(f"a block holds {BLOCK} values, got {len(vals)}")
    v = np.asarray(vals, dtype=np.uint64)
    if not 1 <= width <= 32 or int(v.max(initial=0)) >= (1 << width):
        raise ValueError(f"values do not fit width {width}")
    nwords = 4 * width
    words = np.zeros(nwords, dtype=np.uint64)
    bitpos = np.arange(BLOCK, dtype=np.uint64) * np.uint64(width)
    word_idx = (bitpos >> np.uint64(5)).astype(np.int64)
    bit_off = bitpos & np.uint64(31)
    lo = (v << bit_off) & np.uint64(0xFFFFFFFF)
    # a shift by 32 where bit_off == 0: those lanes spill nothing
    hi = np.where(bit_off == 0, np.uint64(0), v >> (np.uint64(32) - bit_off))
    np.bitwise_or.at(words, word_idx, lo)
    spill = word_idx + 1 < nwords
    np.bitwise_or.at(words, word_idx[spill] + 1, hi[spill])
    return words.astype(np.uint32)


def unpack_block(words: np.ndarray, width: int) -> np.ndarray:
    """Inverse of pack_block -> 128 uint32 values."""
    w = np.asarray(words, dtype=np.uint64)
    bitpos = np.arange(BLOCK, dtype=np.uint64) * np.uint64(width)
    word_idx = (bitpos >> np.uint64(5)).astype(np.int64)
    bit_off = bitpos & np.uint64(31)
    lo = w[word_idx] >> bit_off
    nxt = np.where(word_idx + 1 < len(w),
                   w[np.minimum(word_idx + 1, len(w) - 1)], 0)
    hi = np.where(bit_off == 0, np.uint64(0),
                  nxt << (np.uint64(32) - bit_off))
    vals = (lo | hi) & ((np.uint64(1) << np.uint64(width)) - np.uint64(1))
    return vals.astype(np.uint32)


def delta_encode(sorted_vals: np.ndarray, first_delta_from: int = 0) -> np.ndarray:
    """d[0] = v[0] - first_delta_from, d[i] = v[i] - v[i-1] (int64)."""
    v = np.asarray(sorted_vals, dtype=np.int64)
    d = np.empty_like(v)
    if len(v):
        d[0] = v[0] - first_delta_from
        d[1:] = v[1:] - v[:-1]
    return d


def delta_decode(deltas: np.ndarray, first_delta_from: int = 0) -> np.ndarray:
    """Inverse of delta_encode."""
    d = np.asarray(deltas, dtype=np.int64)
    return np.cumsum(d) + first_delta_from
