"""Index builder from DocInfos (the port's copy of wiser_tpu/index/
builder.py): the reference's two-stage pipeline (tools/indexer.py:
139-151). Stage 1 is the in-memory OracleEngine (create_qq_mem_dump.cc),
stage 2 `pack_oracle`, which turns it into the PackedIndex the engines
serve (convert_qq_to_vacuum.cc); `build_index` runs both. The packed
arrays equal the JAX package's for the same documents.

Offsets come from prefix sums in one pass, so the reference's two-pass
skip-list sizing dump (FakeFileDumper, file_dumper.h:151-234) is not
needed. For large linedoc files, index/fast_builder.py builds the same
index without the per-posting objects.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from wiser_tpu_torch.index.bloom import BloomConfig
from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu_torch.linedoc import parse_linedoc
from wiser_tpu_torch.oracle import OracleEngine
from wiser_tpu_torch.types import DocInfo


def pack_oracle(eng: OracleEngine, bloom_cfg: Optional[BloomConfig] = None,
                with_blooms: bool = False) -> PackedIndex:
    """Stage 2: the in-memory engine -> the packed columnar index. Every
    term's run is padded to a BLOCK (128) multiple with the sentinel doc,
    tf 0 and empty position / offset bags, so posting memory reads as
    (P/128, 128) rows."""
    terms = sorted(eng.index.keys())
    T = len(terms)
    df = np.array([len(eng.index[t]) for t in terms], dtype=np.int64)
    padded = (df + BLOCK - 1) // BLOCK * BLOCK
    term_starts = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(padded, out=term_starts[1:])
    P = int(term_starts[-1])

    postings_doc = np.full(P, SENTINEL_DOC, dtype=np.int32)
    postings_tf = np.zeros(P, dtype=np.int32)
    pos_counts = np.zeros(P, dtype=np.int64)
    off_counts = np.zeros(P, dtype=np.int64)
    for ti, t in enumerate(terms):
        p = int(term_starts[ti])
        for post in eng.index[t]:
            postings_doc[p] = post.doc_id
            postings_tf[p] = post.term_freq
            pos_counts[p] = len(post.positions)
            off_counts[p] = len(post.offsets)
            p += 1

    pos_starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(pos_counts, out=pos_starts[1:])
    off_starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(off_counts, out=off_starts[1:])

    # the bags in global posting order (pads hold none): one concatenation
    # each, no per-posting stores
    flat_pos, flat_off = [], []
    for t in terms:
        for post in eng.index[t]:
            flat_pos += post.positions
            flat_off += post.offsets
    positions = np.array(flat_pos, dtype=np.int32)
    offs = np.array(flat_off, dtype=np.int32).reshape(-1, 2)
    off_begin = np.ascontiguousarray(offs[:, 0])
    off_end = np.ascontiguousarray(offs[:, 1])

    bloom_cfg = bloom_cfg or BloomConfig()
    bloom_ends = bloom_begins = None
    if with_blooms:
        W = bloom_cfg.n_words
        bloom_ends = np.zeros((P, W), dtype=np.uint32)
        bloom_begins = np.zeros((P, W), dtype=np.uint32)
        for ti, t in enumerate(terms):
            p = int(term_starts[ti])
            for post in eng.index[t]:
                ends = eng.phrase_ends.get((t, post.doc_id))
                if ends:
                    bloom_ends[p] = bloom_cfg.build_filter_words(ends)
                begins = eng.phrase_begins.get((t, post.doc_id))
                if begins:
                    bloom_begins[p] = bloom_cfg.build_filter_words(begins)
                p += 1

    return PackedIndex(
        terms=terms, term_starts=term_starts, df=df,
        postings_doc=postings_doc, postings_tf=postings_tf,
        n_docs=eng.n_docs, avg_len=eng.avg_length,
        doc_len_code=np.array(eng.doc_len_codes, dtype=np.uint8),
        pos_starts=pos_starts, positions=positions,
        off_starts=off_starts, off_begin=off_begin, off_end=off_end,
        bloom_cfg=bloom_cfg, bloom_ends=bloom_ends, bloom_begins=bloom_begins,
    )


def build_index(docs: Iterable[DocInfo], bloom_cfg: Optional[BloomConfig] = None,
                with_blooms: bool = False) -> tuple:
    """DocInfos -> (PackedIndex, the stage-1 OracleEngine)."""
    eng = OracleEngine()
    eng.load_linedocs(docs)
    return pack_oracle(eng, bloom_cfg, with_blooms), eng


def build_index_from_linedoc(path: str, fmt: str, n_rows: Optional[int] = None,
                             bloom_cfg: Optional[BloomConfig] = None,
                             with_blooms: bool = False) -> tuple:
    return build_index(parse_linedoc(path, fmt, n_rows), bloom_cfg, with_blooms)
