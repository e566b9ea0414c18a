"""ctypes bindings of the port's native host codecs (the port's copy of the
parts of wiser_tpu/native/lib.py it calls, plus the bloom-column key
hashing of the index builder): murmur2, block bit packing, the varint
codec of the oracle dump, the LZ4 block codec of the doc store and the
linedoc chunk assembler. The library is built from
native/wiser_native.cpp with g++ at first use into `.kernel_build/`
(build.py); without a C++ compiler these functions raise."""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "wiser_native.cpp")


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    from wiser_tpu_torch.build import load_host_library

    lib = load_host_library("wiser_native", _SRC)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.wiser_murmur2_batch.restype = None
    lib.wiser_murmur2_batch.argtypes = [u8p, i64p, i64p, ctypes.c_int64,
                                        ctypes.c_uint32, u32p]
    lib.wiser_murmur2_batch_seeded.restype = None
    lib.wiser_murmur2_batch_seeded.argtypes = [u8p, i64p, i64p,
                                               ctypes.c_int64, u32p, u32p]
    lib.wiser_bloom_col_hash.restype = ctypes.c_int64
    lib.wiser_bloom_col_hash.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_uint32,
                                         ctypes.c_int64, u32p, u32p, i32p]
    lib.wiser_bloom_set_bits.restype = None
    lib.wiser_bloom_set_bits.argtypes = [u32p, u32p, i64p, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_uint32,
                                         ctypes.c_int, u32p]
    lib.wiser_pack_blocks.restype = ctypes.c_int64
    lib.wiser_pack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
    lib.wiser_unpack_blocks.restype = ctypes.c_int64
    lib.wiser_unpack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
    lib.wiser_linedoc_chunk.restype = ctypes.c_int64
    lib.wiser_linedoc_chunk.argtypes = [u8p, i64p, ctypes.c_int64, i64p,
                                        i64p, ctypes.c_int64, ctypes.c_int,
                                        u8p, ctypes.c_int64]
    lib.wiser_varint_encode.restype = ctypes.c_int64
    lib.wiser_varint_encode.argtypes = [u32p, ctypes.c_int64, u8p]
    lib.wiser_varint_decode.restype = ctypes.c_int64
    lib.wiser_varint_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                        u32p]
    lib.wiser_lz4_compress.restype = ctypes.c_int64
    lib.wiser_lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64]
    lib.wiser_lz4_decompress.restype = ctypes.c_int64
    lib.wiser_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64]
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def murmur2_batch_seeded(blob: bytes, starts: np.ndarray, ends: np.ndarray,
                         seeds) -> np.ndarray:
    """murmur2 of the keys blob[starts[i]:ends[i]]. seeds: None (libbloom's
    MURMUR_SEED for every key) or uint32[n] per-key seeds (the double
    hash's second pass)."""
    from wiser_tpu_torch.index.bloom import MURMUR_SEED

    lib = get_lib()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(n, dtype=np.uint32)
    src = np.frombuffer(blob, dtype=np.uint8)
    if seeds is None:
        lib.wiser_murmur2_batch(_u8(src), _i64(starts), _i64(ends), n,
                                ctypes.c_uint32(MURMUR_SEED), _u32(out))
    else:
        seeds = np.ascontiguousarray(seeds, dtype=np.uint32)
        lib.wiser_murmur2_batch_seeded(_u8(src), _i64(starts), _i64(ends), n,
                                       _u32(seeds), _u32(out))
    return out


def bloom_col_hash(col: bytes, n_entries: int, entry_base: int = 0):
    """Parse one chunk's phrase-neighbor column (per-entry groups ending
    in '!', keys separated by ' ') and double-hash every key as libbloom
    does. Returns (a uint32, b uint32, entry_of int32) per key, where
    entry_of is entry_base + the key's group index."""
    from wiser_tpu_torch.index.bloom import MURMUR_SEED

    src = np.frombuffer(col, dtype=np.uint8)
    cap = col.count(b" ") + col.count(b"!") + 1
    a = np.empty(cap, dtype=np.uint32)
    b = np.empty(cap, dtype=np.uint32)
    e = np.empty(cap, dtype=np.int32)
    n = get_lib().wiser_bloom_col_hash(
        _u8(src), len(col), n_entries, entry_base, MURMUR_SEED, cap,
        _u32(a), _u32(b), _i32(e))
    if n < 0:
        raise ValueError(
            f"non-canonical bloom column (not {n_entries} '!' groups)")
    return a[:n], b[:n], e[:n]


def bloom_set_bits(a: np.ndarray, b: np.ndarray, row: np.ndarray,
                   n_hashes: int, bits: int, rows: np.ndarray) -> None:
    """OR key k's n_hashes bloom bits ((a[k] + i*b[k]) mod 2^32 mod bits)
    into rows[row[k]], a C-contiguous (P, n_words) uint32 array."""
    if rows.dtype != np.uint32 or not rows.flags.c_contiguous:
        raise ValueError("bloom_set_bits: rows must be C-contiguous uint32")
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    row = np.ascontiguousarray(row, dtype=np.int64)
    if len(row) and not 0 <= int(row.min()) <= int(row.max()) < len(rows):
        raise ValueError("bloom_set_bits: row index out of range")
    get_lib().wiser_bloom_set_bits(_u32(a), _u32(b), _i64(row), len(a),
                                   n_hashes, bits, rows.shape[1], _u32(rows))


def pack_blocks(vals: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """vals: uint32[n_blocks*128]; widths: uint8[n_blocks] -> the packed
    words, 4*width per block."""
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    nb = len(widths)
    if len(vals) != nb * 128 or (nb and not 1 <= int(widths.min())
                                 <= int(widths.max()) <= 32):
        raise ValueError("pack_blocks: 128 values per block, widths 1..32")
    out = np.empty(int(4 * widths.astype(np.int64).sum()), dtype=np.uint32)
    get_lib().wiser_pack_blocks(_u32(vals), _u8(widths), nb, _u32(out))
    return out


def unpack_blocks(words: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Inverse of pack_blocks -> uint32[n_blocks*128]."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    nb = len(widths)
    if len(words) != int(4 * widths.astype(np.int64).sum()):
        raise ValueError("unpack_blocks: words do not match the widths")
    out = np.empty(nb * 128, dtype=np.uint32)
    get_lib().wiser_unpack_blocks(_u32(words), _u8(widths), nb, _u32(out))
    return out


def varint_encode_array(vals: np.ndarray) -> bytes:
    """LEB128 bytes of uint32 values."""
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    out = np.empty(5 * len(vals) + 8, dtype=np.uint8)
    n = get_lib().wiser_varint_encode(_u32(vals), len(vals), _u8(out))
    return out[:n].tobytes()


def varint_decode_array(buf: bytes, n: int) -> np.ndarray:
    """The first n LEB128 values of buf as uint32."""
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint32)
    if get_lib().wiser_varint_decode(_u8(src), len(buf), n, _u32(out)) < 0:
        raise ValueError("truncated varint stream")
    return out


def lz4_compress(data: bytes) -> bytes:
    """One LZ4 block (no frame) of data."""
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 255 + 64
    dst = np.empty(cap, dtype=np.uint8)
    n = get_lib().wiser_lz4_compress(_u8(src), len(data), _u8(dst), cap)
    if n < 0:
        raise RuntimeError("lz4 compress failed")
    return dst[:n].tobytes()


def lz4_decompress(data: bytes, out_len: int) -> bytes:
    """Inverse of lz4_compress; out_len is the raw length."""
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max(out_len, 1), dtype=np.uint8)
    n = get_lib().wiser_lz4_decompress(_u8(src), len(data), _u8(dst), out_len)
    if n != out_len:
        raise RuntimeError("lz4 decompress failed")
    return dst[:out_len].tobytes()


def linedoc_chunk(vocab_blob: np.ndarray, vocab_offs: np.ndarray,
                  ids: np.ndarray, bounds: np.ndarray,
                  with_blooms: bool = False) -> bytes:
    """One chunk of canonical linedoc rows (each newline-terminated) from
    flat token ids and doc bounds: WITH_POSITIONS, plus the two
    WITH_BI_BLOOM neighbor columns when with_blooms."""
    lib = get_lib()
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    vocab_offs = np.ascontiguousarray(vocab_offs, dtype=np.int64)
    n_vocab = len(vocab_offs) - 1
    if len(ids) and not 0 <= int(ids.min()) <= int(ids.max()) < n_vocab:
        raise ValueError("linedoc_chunk: token id outside the vocabulary")
    cap = int(len(ids)) * 140 + int(len(bounds)) * 64 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.wiser_linedoc_chunk(
            _u8(vocab_blob), _i64(vocab_offs), n_vocab, _i64(ids),
            _i64(bounds), len(bounds) - 1, 1 if with_blooms else 0,
            _u8(out), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
