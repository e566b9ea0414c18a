"""Document, query and result types (the port's copy of
wiser_tpu/types.py; the reference's types.h: DocInfo at :96-202,
SearchQuery at :233-291)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

# a (start, end) character-offset pair into a document body
OffsetPair = Tuple[int, int]


@dataclass
class DocInfo:
    """One parsed linedoc row. `tokens` holds the document's unique terms;
    offsets and positions are per-unique-term groups ("0,1;2,3;.4,5;."
    and "0;1;.2;.": '.' ends a group, ';' ends an entry)."""

    body: str = ""
    tokens: str = ""
    token_offsets: str = ""
    token_positions: str = ""
    phrase_begins: str = ""
    phrase_ends: str = ""
    format: str = "TOKEN_ONLY"

    def get_tokens(self) -> List[str]:
        # explode on ' ', empty fields skipped (types.cc:5-7)
        return [t for t in self.tokens.split(" ") if t]

    def get_offset_pairs_vec(self) -> List[List[OffsetPair]]:
        table: List[List[OffsetPair]] = []
        for group in (g for g in self.token_offsets.split(".") if g != ""):
            row: List[OffsetPair] = []
            for pair in group.split(";"):
                if pair == "":
                    continue
                a, b = pair.split(",")
                row.append((int(a), int(b)))
            table.append(row)
        return table

    def get_positions(self) -> List[List[int]]:
        return [[int(p) for p in group.split(";") if p != ""]
                for group in self.token_positions.split(".") if group != ""]

    @staticmethod
    def _parse_phrase_elems(s: str) -> List[str]:
        # split strictly on '!', then drop the trailing empty element
        # (ParsePhraseElems, types.cc:42-50)
        ret = s.split("!")
        if ret:
            ret.pop()
        return ret

    def get_phrase_ends(self) -> List[str]:
        return self._parse_phrase_elems(self.phrase_ends)

    def get_phrase_begins(self) -> List[str]:
        return self._parse_phrase_elems(self.phrase_begins)

    def body_length(self) -> int:
        # the number of non-empty space-separated terms (utils.cc:163-165)
        return len([t for t in self.body.split(" ") if t])


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
