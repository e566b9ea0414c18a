"""ctypes bindings of the port's native host codecs (the port's copy of the
parts of wiser_tpu/native/lib.py it calls). The library is built from
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
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.wiser_pack_blocks.restype = ctypes.c_int64
    lib.wiser_pack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
    lib.wiser_unpack_blocks.restype = ctypes.c_int64
    lib.wiser_unpack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
    lib.wiser_linedoc_chunk.restype = ctypes.c_int64
    lib.wiser_linedoc_chunk.argtypes = [u8p, i64p, ctypes.c_int64, i64p,
                                        i64p, ctypes.c_int64, u8p,
                                        ctypes.c_int64]
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


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


def linedoc_chunk(vocab_blob: np.ndarray, vocab_offs: np.ndarray,
                  ids: np.ndarray, bounds: np.ndarray) -> bytes:
    """One chunk of canonical WITH_POSITIONS linedoc rows (each
    newline-terminated) from flat token ids and doc bounds."""
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
            _i64(bounds), len(bounds) - 1, _u8(out), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
