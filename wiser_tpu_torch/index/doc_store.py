"""Compressed document stores (the port's copy of wiser_tpu/index/
doc_store.py; the reference's doc_store.h). The files are the JAX
package's, so each package reads the other's stores.

- CompressedDocStore (doc_store.h:157): in memory, doc id -> one
  compressed blob.
- ChunkedDocStoreWriter / Reader (doc_store.h:277, :365): on disk. Bodies
  are concatenated into ~16 KB raw chunks, each compressed into
  `docs.fdt` (a chunk of more than 3 KB compressed starts 4 KB-aligned,
  ShouldAlign, doc_store.h:73-78), with the per-doc index and the chunk
  table in `docs.fdx.npz` and the codec in `docs.meta.json`. The reader
  keeps a small LRU of decompressed chunks (the BufferPool,
  simple_buffer_pool.h).

Chunks are LZ4 blocks from the native library (native/wiser_native.cpp);
where it cannot be built, zlib.
"""

from __future__ import annotations

import json
import os
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from wiser_tpu_torch.native import lib as native

CHUNK_RAW_TARGET = 16 * 1024
ALIGN = 4096
ALIGN_THRESHOLD = 3 * 1024  # align chunks of more than 3 KB compressed


def _compress(data: bytes) -> tuple:
    try:
        return native.lz4_compress(data), "lz4"
    except (OSError, RuntimeError):  # no C++ compiler: the build failed
        return zlib.compress(data, 1), "zlib"


def _decompress(blob: bytes, raw_len: int, codec: str) -> bytes:
    if codec == "lz4":
        return native.lz4_decompress(blob, raw_len)
    return zlib.decompress(blob)


class CompressedDocStore:
    """In-memory store (CompressedDocStore, doc_store.h:157)."""

    def __init__(self):
        self._blobs: Dict[int, tuple] = {}

    def add(self, doc_id: int, body: str) -> None:
        raw = body.encode("utf-8")
        blob, codec = _compress(raw)
        self._blobs[doc_id] = (blob, len(raw), codec)

    def get(self, doc_id: int) -> str:
        blob, raw_len, codec = self._blobs[doc_id]
        return _decompress(blob, raw_len, codec).decode("utf-8")

    def remove(self, doc_id: int) -> None:
        self._blobs.pop(doc_id, None)

    def has(self, doc_id: int) -> bool:
        return doc_id in self._blobs

    def size(self) -> int:
        return len(self._blobs)


class ChunkedDocStoreWriter:
    """ChunkedDocStoreDumper (doc_store.h:277)."""

    def __init__(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        self.dirpath = dirpath
        self._fdt = open(os.path.join(dirpath, "docs.fdt"), "wb")
        self._doc_chunk: List[int] = []
        self._doc_off: List[int] = []
        self._doc_len: List[int] = []
        self._chunk_file_off: List[int] = []
        self._chunk_comp_len: List[int] = []
        self._chunk_raw_len: List[int] = []
        self._buf = bytearray()
        self._codec: Optional[str] = None
        self._n_docs = 0

    def add(self, body: str) -> int:
        """Add the next document (doc-id order); returns its doc id."""
        raw = body.encode("utf-8")
        self._doc_chunk.append(len(self._chunk_file_off))
        self._doc_off.append(len(self._buf))
        self._doc_len.append(len(raw))
        self._buf.extend(raw)
        doc_id = self._n_docs
        self._n_docs += 1
        if len(self._buf) >= CHUNK_RAW_TARGET:
            self._flush_chunk()
        return doc_id

    def _flush_chunk(self) -> None:
        if not self._buf:
            return
        blob, codec = _compress(bytes(self._buf))
        self._codec = codec
        pos = self._fdt.tell()
        if len(blob) > ALIGN_THRESHOLD and pos % ALIGN:
            self._fdt.write(b"\0" * (ALIGN - pos % ALIGN))
            pos = self._fdt.tell()
        self._chunk_file_off.append(pos)
        self._chunk_comp_len.append(len(blob))
        self._chunk_raw_len.append(len(self._buf))
        self._fdt.write(blob)
        self._buf = bytearray()

    def close(self) -> None:
        self._flush_chunk()
        self._fdt.close()
        np.savez(
            os.path.join(self.dirpath, "docs.fdx"),
            doc_chunk=np.array(self._doc_chunk, dtype=np.int64),
            doc_off=np.array(self._doc_off, dtype=np.int64),
            doc_len=np.array(self._doc_len, dtype=np.int64),
            chunk_file_off=np.array(self._chunk_file_off, dtype=np.int64),
            chunk_comp_len=np.array(self._chunk_comp_len, dtype=np.int64),
            chunk_raw_len=np.array(self._chunk_raw_len, dtype=np.int64),
        )
        with open(os.path.join(self.dirpath, "docs.meta.json"), "w") as f:
            json.dump({"codec": self._codec or "lz4", "n_docs": self._n_docs}, f)


class ChunkedDocStoreReader:
    """ChunkedDocStoreReader (doc_store.h:365): the per-doc index in RAM,
    chunks read and decompressed on demand through an LRU pool."""

    def __init__(self, dirpath: str, pool_size: int = 8):
        z = np.load(os.path.join(dirpath, "docs.fdx.npz"))
        self.doc_chunk = z["doc_chunk"]
        self.doc_off = z["doc_off"]
        self.doc_len = z["doc_len"]
        self.chunk_file_off = z["chunk_file_off"]
        self.chunk_comp_len = z["chunk_comp_len"]
        self.chunk_raw_len = z["chunk_raw_len"]
        with open(os.path.join(dirpath, "docs.meta.json")) as f:
            meta = json.load(f)
        self.codec = meta["codec"]
        self.n_docs = meta["n_docs"]
        self._f = open(os.path.join(dirpath, "docs.fdt"), "rb")
        self._pool: OrderedDict = OrderedDict()
        self._pool_size = pool_size

    def _chunk(self, cid: int) -> bytes:
        hit = self._pool.get(cid)
        if hit is not None:
            self._pool.move_to_end(cid)
            return hit
        self._f.seek(int(self.chunk_file_off[cid]))
        blob = self._f.read(int(self.chunk_comp_len[cid]))
        raw = _decompress(blob, int(self.chunk_raw_len[cid]), self.codec)
        self._pool[cid] = raw
        if len(self._pool) > self._pool_size:
            self._pool.popitem(last=False)
        return raw

    def get(self, doc_id: int) -> str:
        cid = int(self.doc_chunk[doc_id])
        off = int(self.doc_off[doc_id])
        return self._chunk(cid)[off : off + int(self.doc_len[doc_id])
                                ].decode("utf-8")

    def close(self) -> None:
        self._f.close()


class LazyDocBodies:
    """A sequence view of a ChunkedDocStoreReader: `bodies[doc_id]`
    decompresses on demand through the reader's chunk pool, so snippets
    hold O(pool) bodies in memory, not the corpus."""

    def __init__(self, reader: ChunkedDocStoreReader):
        self._r = reader

    def __len__(self) -> int:
        return self._r.n_docs

    def __getitem__(self, doc_id: int) -> str:
        return self._r.get(int(doc_id))
