"""Synthetic query-log generation (the port's copy of
wiser_tpu/data/synth_log.py; the same seeds give the same query lists) —
reference: tools/gen_synthetic_log.py and data/generate_synthetic_log.py.

Mirrors the reference's workload construction:
- terms bucketed by df into a LOW group (df < 10^4) and HIGH group
  (df >= 10^4) (gen_synthetic_log.py:22-36),
- single-term logs sampled from a working set of each group (:60-118),
- two-term logs from random group pairs, per-query terms sorted and
  deduplicated (:190-215),
- phrase logs from adjacent term pairs with no repeated terms (:217-262),
- locality-windowed logs replaying a base log through a sliding window
  (data/generate_synthetic_log.py, data/README.md:7-14).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from wiser_tpu_torch.types import SearchQuery

HIGH_DF_THRESHOLD = 10_000  # gen_synthetic_log.py:22-36


def split_df_groups(terms: Sequence[str], dfs: Sequence[int],
                    threshold: int = HIGH_DF_THRESHOLD
                    ) -> Tuple[List[str], List[str]]:
    low = [t for t, d in zip(terms, dfs) if d < threshold]
    high = [t for t, d in zip(terms, dfs) if d >= threshold]
    return low, high


def gen_single_term_log(terms: Sequence[str], n_queries: int,
                        working_set: Optional[int] = None,
                        seed: int = 0) -> List[SearchQuery]:
    """Sample a working set then draw queries from it
    (gen_synthetic_log.py:60-118)."""
    rng = np.random.default_rng(seed)
    terms = list(terms)
    if working_set is not None and working_set < len(terms):
        idx = rng.choice(len(terms), size=working_set, replace=False)
        terms = [terms[i] for i in idx]
    picks = rng.integers(0, len(terms), size=n_queries)
    return [SearchQuery([terms[i]]) for i in picks]


def gen_two_term_log(group_a: Sequence[str], group_b: Sequence[str],
                     n_queries: int, seed: int = 1) -> List[SearchQuery]:
    """Random pairs across groups; sorted, deduped
    (gen_synthetic_log.py:190-215)."""
    rng = np.random.default_rng(seed)
    out: List[SearchQuery] = []
    while len(out) < n_queries:
        a = group_a[rng.integers(0, len(group_a))]
        b = group_b[rng.integers(0, len(group_b))]
        if a == b:
            continue
        out.append(SearchQuery(sorted([a, b])))
    return out


def gen_phrase_log(phrases: Sequence[Sequence[str]], n_queries: int,
                   seed: int = 2) -> List[SearchQuery]:
    """Phrases with no repeated terms (gen_synthetic_log.py:217-262)."""
    rng = np.random.default_rng(seed)
    usable = [p for p in phrases if len(set(p)) == len(p) and len(p) >= 2]
    if not usable:
        return []
    picks = rng.integers(0, len(usable), size=n_queries)
    return [SearchQuery(list(usable[i]), is_phrase=True) for i in picks]


def mine_phrases_from_index(oracle, max_phrases: int = 1000,
                            seed: int = 3) -> List[Tuple[str, str]]:
    """Adjacent-term pairs that actually occur (phrase-ends sets)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for (term, _doc), ends in oracle.phrase_ends.items():
        for nxt in ends:
            if nxt != term:
                pairs.append((term, nxt))
            if len(pairs) >= max_phrases * 4:
                break
        if len(pairs) >= max_phrases * 4:
            break
    if not pairs:
        return []
    idx = rng.choice(len(pairs), size=min(max_phrases, len(pairs)), replace=False)
    return [pairs[i] for i in idx]


def gen_locality_log(base: List[SearchQuery], n_queries: int,
                     window: int = 1000, seed: int = 4) -> List[SearchQuery]:
    """Locality-windowed replay: draw each query from a sliding window of
    the base log (data/generate_synthetic_log.py semantics)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_queries):
        center = int(i / max(1, n_queries - 1) * max(0, len(base) - 1))
        lo = max(0, center - window // 2)
        hi = min(len(base), center + window // 2 + 1)
        out.append(base[rng.integers(lo, hi)])
    return out


def aol_shape_mixed_log(terms: Sequence[str], dfs: Sequence[int],
                        n_queries: int, zipf_a: float = 1.25,
                        seed: int = 7, n_results: int = 10
                        ) -> List[SearchQuery]:
    """1-4 term conjunctive mix matching the AOL trace shape
    (36.8%/25.2%/17.3% 1/2/3-term, data/AOL_QueryLog_analysis/stat.txt),
    term popularity ~ df rank."""
    rng = np.random.default_rng(seed)
    order = np.argsort(np.asarray(dfs))[::-1]  # popular first
    ranked = [terms[i] for i in order]
    n_terms = rng.choice([1, 2, 3, 4], size=n_queries, p=[0.43, 0.29, 0.20, 0.08])
    out = []
    for nt in n_terms:
        ranks = np.minimum(rng.zipf(zipf_a, size=int(nt)) - 1, len(ranked) - 1)
        out.append(SearchQuery([ranked[r] for r in ranks], n_results=n_results))
    return out
