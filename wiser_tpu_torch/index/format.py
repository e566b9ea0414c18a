"""PackedIndex — the columnar index the engines serve (the port's copy of
wiser_tpu/index/format.py; it reads and writes the same directory).

- postings are one global CSR: `term_starts[t] .. term_starts[t+1]`
  slices `postings_doc` / `postings_tf` (ascending doc ids within a
  term), each run padded to a multiple of BLOCK postings with the
  sentinel doc INT32_MAX and tf 0;
- positions and offsets are a second-level CSR addressed by global
  posting index;
- bi-bloom filters are fixed-width uint32 rows per posting;
- the term dictionary is the sorted term list.

Persisted as a directory: `meta.json`, `columns.npz`, `terms.txt`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from wiser_tpu_torch.index.bloom import BloomConfig
from wiser_tpu_torch.scoring import calc_es_idf

FORMAT_VERSION = 2
BLOCK = 128
SENTINEL_DOC = np.int32(2**31 - 1)
# the per-term / per-posting arrays of columns.npz (blooms are optional)
COLUMNS = ("term_starts", "df", "postings_doc", "postings_tf",
           "doc_len_code", "pos_starts", "positions", "off_starts",
           "off_begin", "off_end")


@dataclass
class PackedIndex:
    terms: List[str]  # sorted unicode order
    term_starts: np.ndarray  # int64[T+1] padded CSR offsets (128-aligned)
    df: np.ndarray  # int64[T] real posting counts (<= padded run length)
    postings_doc: np.ndarray  # int32[P_pad], ascending within term
    postings_tf: np.ndarray  # int32[P_pad], pad 0

    n_docs: int
    avg_len: float  # float64 running mean (insertion order)
    doc_len_code: np.ndarray  # uint8[N]

    pos_starts: np.ndarray  # int64[P+1]
    positions: np.ndarray  # int32[sum tf]

    off_starts: np.ndarray  # int64[P+1]
    off_begin: np.ndarray  # int32
    off_end: np.ndarray  # int32

    bloom_cfg: BloomConfig = field(default_factory=BloomConfig)
    bloom_ends: Optional[np.ndarray] = None  # (P, W) uint32, 0 = absent
    bloom_begins: Optional[np.ndarray] = None

    # derived (built in __post_init__)
    term_to_row: Dict[str, int] = field(default_factory=dict, repr=False)
    idf64: np.ndarray = None  # float64[T]
    max_tf: np.ndarray = None  # int32[T]

    def __post_init__(self):
        if not self.term_to_row:
            self.term_to_row = {t: i for i, t in enumerate(self.terms)}
        if self.idf64 is None:
            self.idf64 = np.asarray(calc_es_idf(self.n_docs, self.df),
                                    dtype=np.float64)
        if self.max_tf is None:
            if len(self.postings_tf) and len(self.terms):
                # runs are never empty (padded to >= 1 block)
                self.max_tf = np.maximum.reduceat(
                    self.postings_tf, self.term_starts[:-1].astype(np.int64)
                ).astype(np.int32)
            else:
                self.max_tf = np.zeros(len(self.terms), dtype=np.int32)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_postings(self) -> int:
        """Padded posting count (block-aligned)."""
        return int(self.term_starts[-1])

    def lookup(self, term: str) -> int:
        """term -> row, or -1 (the TermTrieIndex::Find analog)."""
        return self.term_to_row.get(term, -1)

    def postinglist_size(self, term: str) -> int:
        r = self.lookup(term)
        return int(self.df[r]) if r >= 0 else 0

    def partial_scores(self, cache64: np.ndarray) -> np.ndarray:
        """Per-posting f64 partial BM25 score idf_term * lossy_tfnorm (the
        device's selection-phase score column). Sentinel postings score
        0."""
        lens = np.diff(self.term_starts)
        term_of = np.repeat(np.arange(self.n_terms, dtype=np.int64), lens)
        valid = self.postings_doc != SENTINEL_DOC
        code = self.doc_len_code[
            np.where(valid, self.postings_doc, 0).astype(np.int64)] & 0xFF
        cache_val = cache64[code]
        tf = self.postings_tf.astype(np.float64)
        score = self.idf64[term_of] * ((tf * 2.2) / (tf + cache_val))
        return np.where(valid, score, 0.0)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "format_version": FORMAT_VERSION,
            "n_docs": self.n_docs,
            "avg_len": self.avg_len,
            "n_terms": self.n_terms,
            "bloom": {
                "expected_entries": self.bloom_cfg.expected_entries,
                "error_ratio": self.bloom_cfg.error_ratio,
            },
            "has_blooms": self.bloom_ends is not None,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(path, "terms.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(self.terms))
        cols = {name: getattr(self, name) for name in COLUMNS}
        if self.bloom_ends is not None:
            cols["bloom_ends"] = self.bloom_ends
            cols["bloom_begins"] = self.bloom_begins
        np.savez(os.path.join(path, "columns.npz"), **cols)

    @classmethod
    def load(cls, path: str, skip_offsets: bool = False) -> "PackedIndex":
        """Load a saved index. skip_offsets=True leaves the char-offset
        bags empty (a zero-length CSR): only the highlighter reads them,
        and they hold two int32 values per position."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported index format {meta['format_version']}")
        with open(os.path.join(path, "terms.txt"), encoding="utf-8") as f:
            raw = f.read()
        z = np.load(os.path.join(path, "columns.npz"))
        blooms = meta["has_blooms"]
        cols = {name: z[name] for name in COLUMNS
                if not (skip_offsets and name.startswith("off_"))}
        if skip_offsets:
            cols.update(
                off_starts=np.zeros(int(cols["term_starts"][-1]) + 1,
                                    dtype=np.int64),
                off_begin=np.zeros(0, dtype=np.int32),
                off_end=np.zeros(0, dtype=np.int32))
        return cls(
            terms=raw.split("\n") if raw else [],
            n_docs=meta["n_docs"],
            avg_len=meta["avg_len"],
            bloom_cfg=BloomConfig(meta["bloom"]["expected_entries"],
                                  meta["bloom"]["error_ratio"]),
            bloom_ends=z["bloom_ends"] if blooms else None,
            bloom_begins=z["bloom_begins"] if blooms else None,
            **cols,
        )
