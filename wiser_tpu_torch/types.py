"""Query and result types (the port's copy of wiser_tpu/types.py's
SearchQuery / SearchResult; the reference's types.h:233-291)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class SearchQuery:
    terms: List[str]
    n_results: int = 5
    return_snippets: bool = False
    n_snippet_passages: int = 3
    is_phrase: bool = False


@dataclass
class SearchResultEntry:
    doc_id: int
    doc_score: float
    snippet: str = ""


class SearchResult:
    """Top-k result. Backed either by an eager entry list or lazily by
    (doc_ids, scores) arrays — the batched engine fills arrays to avoid
    per-entry Python object churn on large batches; `.entries`
    materializes on first access."""

    __slots__ = ("_entries", "_docs", "_scores")

    def __init__(self, entries: list = None):
        self._entries = entries if entries is not None else []
        self._docs = None
        self._scores = None

    def set_arrays(self, docs, scores) -> None:
        self._docs = docs
        self._scores = scores

    @property
    def entries(self) -> List[SearchResultEntry]:
        if self._docs is not None:
            self._entries = [
                SearchResultEntry(int(d), float(s))
                for d, s in zip(self._docs, self._scores)
            ] + self._entries
            self._docs = None
            self._scores = None
        return self._entries

    def size(self) -> int:
        if self._docs is not None:
            return len(self._docs) + len(self._entries)
        return len(self._entries)
