"""The exact in-memory engine, QQ-Mem's analog (the port's copy of
wiser_tpu/oracle.py; the reference's qq_mem_engine.h:46-447).

A simple, obviously correct engine over parsed DocInfos: the ground
truth the packed engines are held to, and stage 1 of the index builder
(index/builder.py packs it). Scores are f64 in the reference's operation
order; the top-k is (score desc, doc asc), the set the reference's
min-heap keeps (query_processing.h:897-945: strict-greater insertion over
ascending doc ids keeps the lowest ids among ties).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from wiser_tpu_torch.codecs import uint_to_char4
from wiser_tpu_torch.highlighter import SimpleHighlighter
from wiser_tpu_torch.scoring import K1, Bm25Similarity, RunningAvgLength, calc_es_idf
from wiser_tpu_torch.types import DocInfo, SearchQuery, SearchResult, SearchResultEntry


@dataclass
class Posting:
    """The reference's StandardPosting (posting.h:130-151)."""

    doc_id: int
    term_freq: int
    offsets: List[Tuple[int, int]] = field(default_factory=list)
    positions: List[int] = field(default_factory=list)


class OracleEngine:
    """Exact engine over parsed DocInfos (QqMemEngineDelta +
    InvertedIndexQqMemDelta)."""

    def __init__(self):
        self.index: Dict[str, List[Posting]] = {}
        self.doc_bodies: List[str] = []
        self.doc_len_codes: List[int] = []  # lossy 1-byte codes
        self._avg = RunningAvgLength()
        self.similarity = Bm25Similarity(1.0)
        # per (term, doc): the exact sets of following / preceding words,
        # the source of the bi-bloom filters (bloom_filter.h:277-322)
        self.phrase_ends: Dict[Tuple[str, int], set] = {}
        self.phrase_begins: Dict[Tuple[str, int], set] = {}

    # -- indexing ----------------------------------------------------------

    def add_document(self, doc: DocInfo) -> int:
        """QqMemEngineDelta::AddDocument (qq_mem_engine.h:298-305)."""
        doc_id = len(self.doc_bodies)
        self.doc_bodies.append(doc.body)

        tokens = doc.get_tokens()
        offsets = doc.get_offset_pairs_vec()
        positions = doc.get_positions()
        ends = doc.get_phrase_ends()
        begins = doc.get_phrase_begins()

        for i, term in enumerate(tokens):
            offs = offsets[i] if i < len(offsets) else []
            poss = positions[i] if i < len(positions) else []
            # tf: the position count where there are positions, else the
            # offset count, else 1 (TOKEN_ONLY)
            tf = len(poss) or len(offs) or 1
            self.index.setdefault(term, []).append(
                Posting(doc_id, tf, offs, poss))
            if i < len(ends) and ends[i]:
                self.phrase_ends[(term, doc_id)] = set(ends[i].split(" "))
            if i < len(begins) and begins[i]:
                self.phrase_begins[(term, doc_id)] = set(begins[i].split(" "))

        self._avg.add(doc.body_length())
        self.doc_len_codes.append(uint_to_char4(doc.body_length()))
        self.similarity.reset(float(self._avg.avg))
        return doc_id

    def load_linedocs(self, docs) -> int:
        n = 0
        for d in docs:
            self.add_document(d)
            n += 1
        return n

    # -- introspection -----------------------------------------------------

    @property
    def n_docs(self) -> int:
        return len(self.doc_bodies)

    @property
    def avg_length(self) -> float:
        return float(self._avg.avg)

    def term_count(self) -> int:
        return len(self.index)

    def postinglist_size(self, term: str) -> int:
        return len(self.index.get(term, []))

    def get_document(self, doc_id: int) -> str:
        return self.doc_bodies[doc_id]

    # -- search ------------------------------------------------------------

    @staticmethod
    def _intersect(lists: List[List[Posting]]) -> List[List[Posting]]:
        """Per-doc posting tuples of the docs in every list, ascending doc
        id (the zigzag join, query_processing.h:644-678)."""
        if not lists or any(len(l) == 0 for l in lists):
            return []
        maps = [{p.doc_id: p for p in l} for l in lists[1:]]
        out = []
        for p0 in lists[0]:
            row = [p0]
            for m in maps:
                q = m.get(p0.doc_id)
                if q is None:
                    break
                row.append(q)
            else:
                out.append(row)
        return out

    @staticmethod
    def _common_bases(postings_row: List[Posting]) -> set:
        """Phrase starts: the positions p_i - i common to every term (the
        adjusted-position rule, query_processing.h:266-362)."""
        adjusted = [set(np.asarray(p.positions, dtype=np.int64) - i)
                    for i, p in enumerate(postings_row)]
        return set.intersection(*adjusted) if adjusted else set()

    @classmethod
    def phrase_match_count(cls, postings_row: List[Posting]) -> int:
        return len(cls._common_bases(postings_row))

    @classmethod
    def phrase_match_table(cls, postings_row: List[Posting]) -> List[List[int]]:
        """Each term's position at every phrase match, match by match (the
        PositionInfoTable2 analog), for highlighting."""
        return [[int(base + i) for i in range(len(postings_row))]
                for base in sorted(cls._common_bases(postings_row))]

    def search(self, query: SearchQuery) -> SearchResult:
        """Search -> ProcessQueryDelta (qq_mem_engine.h:335-368,
        query_processing.h:956-979)."""
        result = SearchResult()
        if query.n_results == 0:
            return result
        lists = [self.index.get(t, []) for t in query.terms]
        if any(len(l) == 0 for l in lists):
            return result
        idfs = [float(calc_es_idf(self.n_docs, len(l))) for l in lists]

        rows = self._intersect(lists)
        if query.is_phrase and len(query.terms) > 1:
            rows = [r for r in rows if self.phrase_match_count(r) > 0]
        if not rows:
            return result

        # exact f64 scores, accumulated in query-term order
        scored = []
        for row in rows:
            cache_val = self.similarity.cache[
                self.doc_len_codes[row[0].doc_id] & 0xFF]
            s = np.float64(0.0)
            for idf, p in zip(idfs, row):
                tf = np.float64(p.term_freq)
                s = s + np.float64(idf) * ((tf * (K1 + 1)) / (tf + cache_val))
            scored.append((float(s), row[0].doc_id, row))
        scored.sort(key=lambda x: (-x[0], x[1]))

        for s, doc_id, row in scored[: query.n_results]:
            snippet = ""
            if query.return_snippets:
                offset_table = [p.offsets for p in row]
                if query.is_phrase:
                    offset_table = _filter_offsets_by_positions(
                        row, self.phrase_match_table(row))
                snippet = SimpleHighlighter().highlight(
                    offset_table, query.n_snippet_passages,
                    self.doc_bodies[doc_id])
            result.entries.append(SearchResultEntry(doc_id, s, snippet))
        return result


def _filter_offsets_by_positions(row: List[Posting],
                                 table: List[List[int]]) -> list:
    """Only the offset pairs at phrase-match positions
    (ResultDocEntry::FilterOffsetByPosition, query_processing.h:469-492);
    offsets are parallel to positions."""
    out = []
    for i, p in enumerate(row):
        pos_to_idx = {pos: j for j, pos in enumerate(p.positions)}
        pairs = []
        for match in table:
            j = pos_to_idx.get(match[i])
            if j is not None and j < len(p.offsets):
                pairs.append(p.offsets[j])
        out.append(pairs)
    return out
