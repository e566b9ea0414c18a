"""The lossy 1-byte doc-length code (the port's copy of the CHAR4 part of
wiser_tpu/codecs.py; the reference's UintToChar4 / Char4ToUint,
utils.h:301-330: a 3-bit mantissa and a 5-bit shift)."""

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
