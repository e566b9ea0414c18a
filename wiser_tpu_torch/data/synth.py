"""Synthetic corpora as DocInfos (the port's copy of wiser_tpu/data/
synth.py): Zipf-distributed tokens over the vocabulary t0..t{V-1}, each
document with every linedoc column (unique terms, per-term offsets and
positions and, with_blooms, the WITH_BI_BLOOM phrase-end / phrase-begin
columns). The numpy draws are the JAX package's, call for call, so a seed
gives the same documents in both packages.
"""

from __future__ import annotations

from typing import List

import numpy as np

from wiser_tpu_torch.types import DocInfo


def zipf_vocab(n_terms: int) -> List[str]:
    return [f"t{i}" for i in range(n_terms)]


def synth_docinfos(
    n_docs: int,
    vocab_size: int = 1000,
    mean_len: int = 60,
    zipf_a: float = 1.3,
    seed: int = 0,
    with_blooms: bool = True,
) -> List[DocInfo]:
    """n_docs documents of Poisson(mean_len) tokens (at least one)."""
    rng = np.random.default_rng(seed)
    vocab = zipf_vocab(vocab_size)
    docs = []
    for _ in range(n_docs):
        n_tok = max(1, int(rng.poisson(mean_len)))
        ranks = np.minimum(rng.zipf(zipf_a, size=n_tok) - 1, vocab_size - 1)
        docs.append(make_docinfo([vocab[r] for r in ranks],
                                 with_blooms=with_blooms))
    return docs


def make_docinfo(body_tokens: List[str], with_blooms: bool = True) -> DocInfo:
    """A DocInfo with every derived column from a token sequence: offsets
    are character offsets into the space-joined body, positions token
    positions, and the phrase ends / begins the sets of words that
    immediately follow / precede each unique term (the pre-tokenized
    linedoc columns, bloom_filter.h:277-322)."""
    body = " ".join(body_tokens)
    uniq: List[str] = []
    positions: dict = {}
    offsets: dict = {}
    ends: dict = {}
    begins: dict = {}
    off = 0
    for i, tok in enumerate(body_tokens):
        if tok not in positions:
            uniq.append(tok)
            positions[tok] = []
            offsets[tok] = []
            ends[tok] = set()
            begins[tok] = set()
        positions[tok].append(i)
        offsets[tok].append((off, off + len(tok) - 1))
        if i + 1 < len(body_tokens):
            ends[tok].add(body_tokens[i + 1])
        if i > 0:
            begins[tok].add(body_tokens[i - 1])
        off += len(tok) + 1

    tok_col = " ".join(uniq)
    off_col = "".join(
        ";".join(f"{a},{b}" for a, b in offsets[t]) + ";." for t in uniq)
    pos_col = "".join(";".join(str(p) for p in positions[t]) + ";."
                      for t in uniq)
    fmt = "WITH_POSITIONS"
    ends_col = begins_col = ""
    if with_blooms:
        ends_col = "".join(" ".join(sorted(ends[t])) + "!" for t in uniq)
        begins_col = "".join(" ".join(sorted(begins[t])) + "!" for t in uniq)
        fmt = "WITH_BI_BLOOM"
    return DocInfo(
        body=body, tokens=tok_col, token_offsets=off_col,
        token_positions=pos_col, phrase_begins=begins_col,
        phrase_ends=ends_col, format=fmt,
    )


def synth_query_terms(
    n_queries: int,
    vocab_size: int,
    n_terms: int = 1,
    zipf_a: float = 1.3,
    seed: int = 1,
) -> List[List[str]]:
    """n_queries term lists of n_terms Zipf draws each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_queries):
        ranks = np.minimum(rng.zipf(zipf_a, size=n_terms) - 1, vocab_size - 1)
        out.append([f"t{r}" for r in ranks])
    return out
