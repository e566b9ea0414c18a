"""Snippets: passage highlighting on the host (the port's copy of
wiser_tpu/highlighter.py; the reference's highlighter.h). Snippets are
made after the top-k from the document bodies, as the reference does
(vacuum_engine.h:243-255), and are byte-identical to the JAX package's.

- A passage around offset o ends at the first '.' at or after o (or the
  end of the document) and starts just after the last '.' before o
  (SentenceBreakIteratorNew::next(offset), highlighter.h:170-186).
- highlightOffsetsEnums (highlighter.h:303-421): per-term offset lists
  are merged in start-offset order; each passage scores
  sum(tf / (tf + k1 * ((1 - b) + b * passage_len / pivot))), times
  passage_norm = 1 + 1 / log(pivot + start) at wrap-up; the best
  `max_passages` are kept and emitted in document order with "<b>" and
  the reference's literal closing tag "<\\b>" around each match
  (Passage::to_string, highlighter.h:99-116).
"""

from __future__ import annotations

import heapq
import math
from typing import List

from wiser_tpu_torch.types import OffsetPair

PIVOT = 87.0  # the hard-coded average passage length (highlighter.h:433)
K1 = 1.2
B = 0.75


def passage_norm(start_offset: int) -> float:
    return 1.0 + 1.0 / math.log(PIVOT + start_offset)


def tf_norm(freq: int, passage_len: int) -> float:
    norm = K1 * ((1.0 - B) + B * (passage_len / PIVOT))
    return freq / (freq + norm)


class _BreakIterator:
    """SentenceBreakIteratorNew, the variant highlightOffsetsEnums uses."""

    def __init__(self, content: str):
        self.content = content
        self.last_offset = len(content) - 1
        self.startoffset = -1
        self.endoffset = -1

    def next_containing(self, offset: int) -> bool:
        if offset > self.last_offset:
            return False
        c = self.content
        end = offset
        while end < self.last_offset:
            if c[end] == ".":
                break
            end += 1
        self.endoffset = end
        start = max(0, offset - 1)
        while start > 0:
            if c[start] == ".":
                start += 1
                break
            start -= 1
        self.startoffset = start
        return True


class _Passage:
    __slots__ = ("startoffset", "endoffset", "score", "matches")

    def __init__(self):
        self.reset()

    def reset(self):
        self.startoffset = -1
        self.endoffset = -1
        self.score = 0.0
        self.matches: List[OffsetPair] = []

    def to_string(self, doc: str) -> str:
        res = doc[self.startoffset : self.endoffset + 1] + "\n"
        # matches by start, last first: insert the closing, then the
        # opening tag
        for s, e in sorted(self.matches, key=lambda m: -m[0]):
            pos_end = max(0, min(e - self.startoffset + 1, len(res)))
            res = res[:pos_end] + "<\\b>" + res[pos_end:]
            pos_start = max(0, s - self.startoffset)
            res = res[:pos_start] + "<b>" + res[pos_start:]
        return res


class SimpleHighlighter:
    def highlight(self, offset_table: List[List[OffsetPair]],
                  max_passages: int, doc: str) -> str:
        """offset_table: per query term, its offset pairs in this doc."""
        if not offset_table:
            return ""
        breaker = _BreakIterator(doc)

        # min-heap of (start offset, seq, offsets, index) over the terms
        heap: List[tuple] = []
        seq = 0
        for offsets in offset_table:
            if offsets:
                heapq.heappush(heap, (offsets[0][0], seq, offsets, 0))
                seq += 1

        passages: List[tuple] = []  # min-heap of (score, order, passage)
        porder = 0
        min_score = -1.0
        passage = _Passage()

        def wrap_up(p: _Passage) -> _Passage:
            nonlocal min_score, porder
            p.score = p.score * passage_norm(p.startoffset)
            if len(passages) == max_passages and p.score <= min_score:
                p.reset()
                return p
            heapq.heappush(passages, (p.score, porder, p))
            porder += 1
            if len(passages) > max_passages:
                _, _, evicted = heapq.heappop(passages)
                evicted.reset()
                min_score = passages[0][0]
                return evicted
            min_score = passages[0][0]
            return _Passage()

        while heap:
            _, _, offsets, idx = heapq.heappop(heap)
            cur_start, cur_end = offsets[idx]

            if cur_end > passage.endoffset:
                if passage.startoffset >= 0:
                    passage = wrap_up(passage)
                if not breaker.next_containing(cur_end):
                    break
                passage.startoffset = breaker.startoffset
                passage.endoffset = breaker.endoffset

            tf = 0
            while True:
                tf += 1
                passage.matches.append((cur_start, cur_end))
                idx += 1
                if idx >= len(offsets):
                    break
                cur_start, cur_end = offsets[idx]
                if cur_end > passage.endoffset:
                    heapq.heappush(heap, (cur_start, seq, offsets, idx))
                    seq += 1
                    break
            passage.score += tf_norm(tf, passage.endoffset
                                     - passage.startoffset + 1)

        # the last passage (highlighter.h:392-409)
        passage.score = passage.score * passage_norm(passage.startoffset)
        if passage.score > 0:
            if len(passages) < max_passages:
                heapq.heappush(passages, (passage.score, porder, passage))
                porder += 1
            elif passage.score > min_score:
                heapq.heappop(passages)
                heapq.heappush(passages, (passage.score, porder, passage))
                porder += 1

        final = sorted((p for _, _, p in passages), key=lambda p: p.startoffset)
        return "".join(p.to_string(doc) for p in final)
