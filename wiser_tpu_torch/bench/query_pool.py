"""Query logs, pools and producers (the port's copy of wiser_tpu/bench/
query_pool.py) — reference: query_pool.h/.cc.

- QueryLogReader: one query per line; a line wrapped in double quotes is a
  phrase query (query_pool.h:308-311), terms are space-separated.
- TermPool / TermPoolArray: looping per-thread pools (query_pool.h:52,81).
- QueryProducer: per-thread looping producer (query_pool.h:139).
- QueryProducerNoLoop: mutex-guarded run-to-exhaustion pool
  (query_pool.h:251,274).
- QueryProducerByLog: replay a log file (query_pool.h:319).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from wiser_tpu_torch.types import SearchQuery


def parse_query_line(line: str, n_results: int = 5,
                     return_snippets: bool = False) -> Optional[SearchQuery]:
    """'a b' -> AND query; '"a b"' -> phrase query (query_pool.h:308-311)."""
    line = line.strip()
    if not line:
        return None
    is_phrase = False
    if line.startswith('"') and line.endswith('"') and len(line) >= 2:
        is_phrase = True
        line = line[1:-1]
    terms = [t for t in line.split(" ") if t]
    if not terms:
        return None
    return SearchQuery(terms, n_results=n_results,
                       return_snippets=return_snippets, is_phrase=is_phrase)


class QueryLogReader:
    """reference: QueryLogReader (query_pool.h:16)."""

    def __init__(self, path: str):
        self.path = path

    def read_all(self, n_results: int = 5) -> List[SearchQuery]:
        out = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                q = parse_query_line(line, n_results=n_results)
                if q is not None:
                    out.append(q)
        return out


def write_query_log(path: str, queries: List[SearchQuery]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for q in queries:
            line = " ".join(q.terms)
            if q.is_phrase:
                line = f'"{line}"'
            f.write(line + "\n")


class TermPool:
    """Looping pool of queries for one thread (query_pool.h:52)."""

    def __init__(self, queries: List[SearchQuery]):
        if not queries:
            raise ValueError("empty query pool")
        self.queries = queries
        self._i = 0

    def next(self) -> SearchQuery:
        q = self.queries[self._i]
        self._i = (self._i + 1) % len(self.queries)
        return q


class TermPoolArray:
    """Per-thread pools partitioned round-robin (query_pool.h:81)."""

    def __init__(self, queries: List[SearchQuery], n_pools: int):
        chunks: List[List[SearchQuery]] = [[] for _ in range(n_pools)]
        for i, q in enumerate(queries):
            chunks[i % n_pools].append(q)
        self.pools = [TermPool(c if c else queries[:1]) for c in chunks]

    def next(self, pool_id: int) -> SearchQuery:
        return self.pools[pool_id % len(self.pools)].next()


class QueryProducer:
    """Looping per-thread producer (query_pool.h:139)."""

    def __init__(self, queries: List[SearchQuery], n_threads: int):
        self.array = TermPoolArray(queries, n_threads)

    def next_query(self, thread_id: int) -> SearchQuery:
        return self.array.next(thread_id)


class QueryProducerNoLoop:
    """Run-to-exhaustion, thread-safe (query_pool.h:251; mutex at :274)."""

    def __init__(self, queries: List[SearchQuery]):
        self.queries = queries
        self._i = 0
        self._lock = threading.Lock()

    def next_query(self) -> Optional[SearchQuery]:
        with self._lock:
            if self._i >= len(self.queries):
                return None
            q = self.queries[self._i]
            self._i += 1
            return q

    def is_empty(self) -> bool:
        with self._lock:
            return self._i >= len(self.queries)


class QueryProducerByLog(QueryProducerNoLoop):
    """Replay a query-log file once (query_pool.h:319)."""

    def __init__(self, log_path: str, n_results: int = 5):
        super().__init__(QueryLogReader(log_path).read_all(n_results=n_results))
