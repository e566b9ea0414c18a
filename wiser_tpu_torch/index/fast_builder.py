"""Vectorized linedoc -> PackedIndex builder (the port's copy of
wiser_tpu/index/fast_builder.py).

The linedoc stream is parsed in chunks with column-level string ops (one
`str.split` / `fromstring` per chunk, not per value), term ids are
assigned through one dict pass, and the packed CSR columns are assembled
with numpy prefix sums and ragged gathers. The columns are identical to
those of the JAX package's builders.

Input is the canonical WITH_POSITIONS linedoc shape written by
data/scale_corpus.py: tokens = unique terms, single-space separated;
positions groups "p1;p2;." per term; offsets groups "a,b;c,d;." per
term. With with_blooms the rows must be WITH_BI_BLOOM: two more columns
of per-term neighbor words ("w1 w2!" per term, following then
preceding), from which each posting gets a pair of bloom filter rows
(bloom_ends / bloom_begins), bit-equal to the JAX builder's. The native
library parses and hashes the neighbor keys (libbloom's double murmur2).
Non-canonical rows raise ValueError.

With spill_dir, the parsed columns stream through flat files on disk
and are read back once at pack time, so the parse phase holds only the
vocabulary and the doc lengths in RAM: the way to build a corpus whose
columns outgrow the host's memory.
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from itertools import repeat
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from wiser_tpu_torch.codecs import uint_to_char4_np
from wiser_tpu_torch.index.bloom import BloomConfig
from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.native import lib as native
from wiser_tpu_torch.scoring import RunningAvgLength


def _fromstring(s: str, seps: str) -> np.ndarray:
    for ch in seps:
        s = s.replace(ch, " ")
    if not s.strip():
        return np.empty(0, dtype=np.int64)
    with warnings.catch_warnings():
        # np.fromstring's text mode is deprecated but is numpy's only
        # C-speed bulk number parser; the callers check the counts
        warnings.simplefilter("ignore", DeprecationWarning)
        return np.fromstring(s, dtype=np.int64, sep=" ")


class _Spill:
    """Append-only flat binary files, one per parsed column, under a
    directory; each is read back once (np.fromfile) and deleted as soon
    as its column is consumed."""

    def __init__(self, spill_dir: str):
        os.makedirs(spill_dir, exist_ok=True)
        self.dir = spill_dir
        self._files: Dict[str, object] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".bin")

    def append(self, name: str, arr: np.ndarray) -> None:
        f = self._files.get(name)
        if f is None:
            f = self._files[name] = open(self._path(name), "wb")
        f.write(memoryview(np.ascontiguousarray(arr)))

    def load(self, name: str, dtype) -> np.ndarray:
        f = self._files.pop(name, None)
        if f is not None:
            f.close()
        if not os.path.exists(self._path(name)):
            return np.empty(0, dtype=dtype)
        return np.fromfile(self._path(name), dtype=dtype)

    def drop(self, name: str) -> None:
        if os.path.exists(self._path(name)):
            os.remove(self._path(name))

    def cleanup(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        shutil.rmtree(self.dir, ignore_errors=True)


class _ChunkAccum:
    """The parsed columns, chunk by chunk: in lists, or with a _Spill in
    its files (then only the vocabulary and doc lengths stay in RAM)."""

    def __init__(self, spill: Optional[_Spill] = None):
        self.spill = spill
        self.vocab: Dict[str, int] = {}
        self.term_ids: List[np.ndarray] = []
        self.doc_ids: List[np.ndarray] = []
        self.tf: List[np.ndarray] = []
        self.positions: List[np.ndarray] = []
        self.off_b: List[np.ndarray] = []
        self.off_e: List[np.ndarray] = []
        self.doc_lengths: List[np.ndarray] = []
        # per chunk, per bloom side: (a u32, b u32, entry id i32) of every
        # neighbor key, hashed at parse time (the key strings are not kept)
        self.bloom_ends_keys: List[tuple] = []
        self.bloom_begins_keys: List[tuple] = []
        self.n_docs = 0
        self.n_entries = 0
        self.bloom_s = 0.0  # seconds spent parsing and hashing bloom keys


def _map_term_ids(vocab: Dict[str, int], flat_tokens: List[str]) -> np.ndarray:
    """Dict-map tokens to int32 ids in discovery order, inserting new
    terms."""
    ids = np.fromiter(map(vocab.get, flat_tokens, repeat(-1)),
                      dtype=np.int32, count=len(flat_tokens))
    for i in np.nonzero(ids < 0)[0].tolist():
        ids[i] = vocab.setdefault(flat_tokens[i], len(vocab))
    return ids


def _parse_group_col(cols: List[str], n_entries: int, seps: str,
                     what: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a '.'-separated per-term group column over a whole chunk.
    Returns (counts int64[n_entries], flat numbers int64[total])."""
    joined = "".join(cols)
    groups = joined.split(".")
    if groups and groups[-1] == "":
        groups.pop()
    if len(groups) != n_entries:
        raise ValueError(
            f"non-canonical {what} column: {len(groups)} groups for "
            f"{n_entries} token entries (empty groups / missing dots?)")
    counts = np.fromiter((g.count(";") for g in groups),
                         dtype=np.int64, count=n_entries)
    return counts, _fromstring(joined, ";,.")


POSITIONAL_FORMATS = ("WITH_POSITIONS", "WITH_PHRASE_END", "WITH_BI_BLOOM")


def _parse_linedoc_chunks(path: str, chunk_docs: int, with_blooms: bool,
                          n_rows: Optional[int] = None) -> Iterator[tuple]:
    """Yield per-chunk column lists (tokens, positions, offsets, bodies,
    following-word groups, preceding-word groups; the last two empty
    unless with_blooms) of the first n_rows rows (all if None)."""
    cols: List[List[str]] = [[], [], [], [], [], []]
    count = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        f.readline()  # header
        for line in f:
            if n_rows is not None and count >= n_rows:
                break
            line = line.rstrip("\n")
            if not line:
                continue
            items = line.split("\t")
            cols[0].append(items[2])  # tokens
            cols[1].append(items[4])  # positions
            cols[2].append(items[3])  # offsets
            cols[3].append(items[1])  # body
            if with_blooms:
                if len(items) < 7:
                    raise ValueError("with_blooms needs WITH_BI_BLOOM rows "
                                     "(7 columns)")
                cols[4].append(items[5])  # bloom (following words)
                cols[5].append(items[6])  # bloom_before (preceding words)
            count += 1
            if len(cols[0]) >= chunk_docs:
                yield tuple(cols)
                cols = [[], [], [], [], [], []]
    if cols[0]:
        yield tuple(cols)


def _accumulate_chunk(acc: _ChunkAccum, chunk: tuple,
                      with_blooms: bool) -> None:
    tok_cols, pos_cols, off_cols, body_cols, ends_cols, begins_cols = chunk
    n_docs = len(tok_cols)
    flat_tokens: List[str] = []
    n_tok = np.empty(n_docs, dtype=np.int64)
    for i, tc in enumerate(tok_cols):
        ts = tc.split(" ")
        if ts and ts[-1] == "":
            ts.pop()
        flat_tokens.extend(ts)
        n_tok[i] = len(ts)
    if any(t == "" for t in flat_tokens):
        raise ValueError("non-canonical tokens column (empty tokens)")
    E = len(flat_tokens)

    term_ids = _map_term_ids(acc.vocab, flat_tokens)
    doc_ids = np.repeat(
        np.arange(acc.n_docs, acc.n_docs + n_docs, dtype=np.int32), n_tok)
    pos_counts, pos_nums = _parse_group_col(pos_cols, E, ";.", "positions")
    if int(pos_counts.sum()) != len(pos_nums):
        raise ValueError("non-canonical positions column (count mismatch)")
    off_counts, off_nums = _parse_group_col(off_cols, E, ";,.", "offsets")
    if 2 * int(off_counts.sum()) != len(off_nums):
        raise ValueError("non-canonical offsets column (pair mismatch)")
    if not np.array_equal(off_counts, pos_counts):
        raise ValueError("offsets/positions group size mismatch")

    # body length: count of non-empty space-separated terms
    blen = np.empty(n_docs, dtype=np.int64)
    for i, b in enumerate(body_cols):
        if not b:
            blen[i] = 0
        elif "  " not in b and b[0] != " " and b[-1] != " ":
            blen[i] = b.count(" ") + 1
        else:
            blen[i] = len([t for t in b.split(" ") if t])

    parsed = {"term_ids": term_ids, "doc_ids": doc_ids,
              "tf": pos_counts.astype(np.int32),
              "positions": pos_nums.astype(np.int32),
              "off_b": off_nums[0::2].astype(np.int32),
              "off_e": off_nums[1::2].astype(np.int32)}
    for name, arr in parsed.items():
        if acc.spill is not None:
            acc.spill.append(name, arr)
        else:
            getattr(acc, name).append(arr)
    acc.doc_lengths.append(blen)
    if with_blooms:
        t0 = time.perf_counter()
        for cols, side, store in ((ends_cols, "ends", acc.bloom_ends_keys),
                                  (begins_cols, "begins",
                                   acc.bloom_begins_keys)):
            keys = native.bloom_col_hash("".join(cols).encode("utf-8"), E,
                                         acc.n_entries)
            if acc.spill is not None:
                for suffix, arr in zip(("_a", "_b", "_e"), keys):
                    acc.spill.append(side + suffix, arr)
            else:
                store.append(keys)
        acc.bloom_s += time.perf_counter() - t0
    acc.n_docs += n_docs
    acc.n_entries += E


def _bloom_rows(key_chunks, order_inv: np.ndarray, pidx: np.ndarray, P: int,
                cfg: BloomConfig) -> np.ndarray:
    """(P, n_words) uint32 bloom rows from hashed (a, b, entry id)
    chunks: key bit x_i = ((a + i*b) mod 2^32) mod bits, i < n_hashes, is
    set in the row of the key's posting (native). Entry ids are pre-sort;
    order_inv maps them to sorted entries, pidx sorted entries to padded
    posting indices. key_chunks may also be a zero-argument callable that
    returns an iterator of them (the spill path streams slices)."""
    if callable(key_chunks):
        key_chunks = key_chunks()
    rows = np.zeros((P, cfg.n_words), dtype=np.uint32)
    for a, b, entry_of in key_chunks:
        native.bloom_set_bits(a, b, pidx[order_inv[entry_of]], cfg.n_hashes,
                              cfg.bits, rows)
    return rows


def pack_from_arrays(term_ids: np.ndarray, doc_ids: np.ndarray,
                     tf: np.ndarray, positions: np.ndarray,
                     off_b: np.ndarray, off_e: np.ndarray,
                     doc_lengths: np.ndarray,
                     vocab: Dict[str, int],
                     bloom_cfg: Optional[BloomConfig] = None,
                     bloom_key_chunks: Optional[tuple] = None,
                     stats: Optional[dict] = None) -> PackedIndex:
    """Assemble the packed CSR columns from flat occurrence arrays
    (per-entry term ids in discovery order, doc ids, tfs, and the
    per-entry groups of positions and offsets) and, given
    bloom_key_chunks = (following-side chunks, preceding-side chunks) of
    hashed keys, the bloom rows. Temporaries are int32 and freed as they
    are consumed; the inputs are consumed too."""
    terms = sorted(vocab)
    T = len(terms)
    remap = np.empty(T, dtype=np.int32)
    remap[np.fromiter((vocab[t] for t in terms), dtype=np.int64, count=T)] = \
        np.arange(T, dtype=np.int32)
    tid = remap[term_ids]
    del term_ids

    E = len(tid)
    if E >= 2**31 or len(positions) >= 2**31:
        raise ValueError("corpus exceeds int32 entry addressing "
                         f"(E={E}, positions={len(positions)})")
    order = np.lexsort((doc_ids, tid)).astype(np.int32)
    df = np.bincount(tid[order], minlength=T)
    del tid
    padded = (df + BLOCK - 1) // BLOCK * BLOCK
    term_starts = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(padded, out=term_starts[1:])
    P = int(term_starts[-1])
    if P >= 2**31:
        raise ValueError(f"padded postings exceed int32 addressing (P={P})")

    seg = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(df, out=seg[1:])
    # sorted entry -> padded posting index, built in int32 pieces
    pidx = np.repeat(term_starts[:-1].astype(np.int32), df)
    pidx += np.arange(E, dtype=np.int32)
    pidx -= np.repeat(seg[:-1].astype(np.int32), df)
    del seg

    postings_doc = np.full(P, SENTINEL_DOC, dtype=np.int32)
    postings_doc[pidx] = doc_ids[order]
    del doc_ids
    tf_s = tf[order]
    postings_tf = np.zeros(P, dtype=np.int32)
    postings_tf[pidx] = tf_s

    # second-level CSRs: ragged reorder of the per-entry bags,
    # gather = repeat(src_starts[order] - new_starts, tf_s) + arange(total)
    src_starts = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(tf, out=src_starts[1:])
    del tf
    new_starts = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(tf_s, out=new_starts[1:])
    total = int(new_starts[-1])
    base = src_starts[:-1].astype(np.int32)[order]
    base -= new_starts[:-1].astype(np.int32)
    del src_starts, new_starts
    gather = np.repeat(base, tf_s)
    del base
    gather += np.arange(total, dtype=np.int32)

    pos_counts_padded = np.zeros(P, dtype=np.int64)
    pos_counts_padded[pidx] = tf_s
    del tf_s
    pos_starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(pos_counts_padded, out=pos_starts[1:])
    del pos_counts_padded

    positions_f = positions[gather]
    del positions
    off_b_f = off_b[gather]
    del off_b
    off_e_f = off_e[gather]
    del off_e, gather

    cfg = bloom_cfg or BloomConfig()
    bloom_ends = bloom_begins = None
    if bloom_key_chunks is not None:
        t0 = time.perf_counter()
        order_inv = np.empty(E, dtype=np.int32)
        order_inv[order] = np.arange(E, dtype=np.int32)
        bloom_ends = _bloom_rows(bloom_key_chunks[0], order_inv, pidx, P, cfg)
        bloom_begins = _bloom_rows(bloom_key_chunks[1], order_inv, pidx, P,
                                   cfg)
        del order_inv
        if stats is not None:
            stats["bloom_s"] = stats.get("bloom_s", 0.0) + (
                time.perf_counter() - t0)
    del order, pidx

    avg = RunningAvgLength()  # running mean in insertion order
    for v in doc_lengths.tolist():
        avg.add(int(v))

    return PackedIndex(
        terms=terms,
        term_starts=term_starts,
        df=df.astype(np.int64),
        postings_doc=postings_doc,
        postings_tf=postings_tf,
        n_docs=len(doc_lengths),
        avg_len=float(avg.avg),
        doc_len_code=uint_to_char4_np(doc_lengths),
        pos_starts=pos_starts,
        positions=positions_f,
        off_starts=pos_starts.copy(),  # one offset pair per position
        off_begin=off_b_f,
        off_end=off_e_f,
        bloom_cfg=cfg,
        bloom_ends=bloom_ends,
        bloom_begins=bloom_begins,
    )


def _consume_concat(chunks: List[np.ndarray]) -> np.ndarray:
    """Concatenate chunk arrays, freeing each chunk as it is copied."""
    if not chunks:
        return np.empty(0, dtype=np.int32)
    out = np.empty(sum(len(c) for c in chunks), dtype=chunks[0].dtype)
    o = 0
    while chunks:
        c = chunks.pop(0)
        out[o : o + len(c)] = c
        o += len(c)
    return out


def _spill_side_loader(spill: _Spill, side: str,
                       slice_keys: int = 4_000_000):
    """A zero-argument callable for _bloom_rows: loads one bloom side's
    hashed keys from the spill, deletes their files, and yields bounded
    slices (the bit-setting temporaries stay small)."""

    def gen():
        a = spill.load(side + "_a", np.uint32)
        b = spill.load(side + "_b", np.uint32)
        e = spill.load(side + "_e", np.int32)
        for suffix in ("_a", "_b", "_e"):
            spill.drop(side + suffix)
        for i in range(0, len(a), slice_keys):
            yield (a[i : i + slice_keys], b[i : i + slice_keys],
                   e[i : i + slice_keys])

    return gen


_COLUMNS = ("term_ids", "doc_ids", "tf", "positions", "off_b", "off_e")


def build_packed_fast(path: str, fmt: str = "WITH_POSITIONS",
                      n_rows: Optional[int] = None,
                      chunk_docs: int = 20_000,
                      with_blooms: bool = False,
                      bloom_cfg: Optional[BloomConfig] = None,
                      verbose: bool = False,
                      spill_dir: Optional[str] = None,
                      stats: Optional[dict] = None) -> PackedIndex:
    """Stream the first n_rows rows (all if None) of a linedoc file into a
    PackedIndex: a positional file (fmt WITH_POSITIONS, WITH_PHRASE_END or
    WITH_BI_BLOOM), or with with_blooms a WITH_BI_BLOOM file, whose bloom
    rows are built with bloom_cfg (default BloomConfig(), the reference
    indexer's). spill_dir: stream the parsed columns through this
    directory instead of RAM (it is removed afterwards); the index is the
    same. verbose: progress on stdout. stats, if given, receives bloom_s:
    the seconds spent on the bloom rows (key parsing and hashing, bit
    setting)."""
    if fmt not in POSITIONAL_FORMATS:
        raise ValueError(f"fast builder supports positional formats, "
                         f"not {fmt}")
    spill = _Spill(spill_dir) if spill_dir else None
    try:
        acc = _ChunkAccum(spill)
        t0 = time.time()
        for chunk in _parse_linedoc_chunks(path, chunk_docs, with_blooms,
                                           n_rows):
            _accumulate_chunk(acc, chunk, with_blooms)
            if verbose:
                print(f"  parsed {acc.n_docs} docs ({time.time() - t0:.1f}s)",
                      flush=True)
        if acc.n_docs == 0:
            raise ValueError(f"no docs parsed from {path}")
        if spill is not None:
            cols = []
            for name in _COLUMNS:
                cols.append(spill.load(name, np.int32))
                spill.drop(name)
            blooms = ((_spill_side_loader(spill, "ends"),
                       _spill_side_loader(spill, "begins"))
                      if with_blooms else None)
        else:
            cols = [_consume_concat(getattr(acc, name)) for name in _COLUMNS]
            blooms = ((acc.bloom_ends_keys, acc.bloom_begins_keys)
                      if with_blooms else None)
        doc_lengths = _consume_concat(acc.doc_lengths)
        vocab = acc.vocab
        if stats is not None and with_blooms:
            stats["bloom_s"] = stats.get("bloom_s", 0.0) + acc.bloom_s
        del acc
        packed = pack_from_arrays(*cols, doc_lengths, vocab,
                                  bloom_cfg=bloom_cfg,
                                  bloom_key_chunks=blooms, stats=stats)
        if verbose:
            print(f"  packed {packed.n_postings} postings / "
                  f"{packed.n_terms} terms in {time.time() - t0:.1f}s",
                  flush=True)
        return packed
    finally:
        if spill is not None:
            spill.cleanup()
