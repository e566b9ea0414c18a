"""Wiki-shaped linedoc generation at scale (the port's copy of
wiser_tpu/data/scale_corpus.py, WITH_POSITIONS rows only): a
pseudo-English vocabulary with Zipf term frequencies and Poisson document
lengths. Python draws every random number; the native assembler
(native/wiser_native.cpp) turns each chunk's token ids into rows, and the
file is byte-identical to the JAX package's for the same arguments.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np

from wiser_tpu_torch.native import lib as native

_CONS = "bcdfghjklmnpqrstvwz"
_VOW = "aeiou"


def pseudo_vocab(n: int, seed: int = 1234) -> List[str]:
    """Deterministic pseudo-English words, unique, 2-14 chars."""
    rng = np.random.default_rng(seed)
    words = []
    seen = set()
    while len(words) < n:
        need = n - len(words)
        syls = rng.integers(1, 5, size=need)
        for k in syls:
            w = "".join(
                _CONS[rng.integers(len(_CONS))] + _VOW[rng.integers(len(_VOW))]
                + (_CONS[rng.integers(len(_CONS))] if rng.random() < 0.35 else "")
                for _ in range(int(k)))
            if w not in seen:
                seen.add(w)
                words.append(w)
    return words


def generate_linedoc(out_path: str, n_docs: int, vocab_size: int = 200_000,
                     mean_len: int = 120, zipf_a: float = 1.25,
                     seed: int = 42, chunk_docs: int = 20_000,
                     verbose: bool = True) -> int:
    """Write a wiki-shaped WITH_POSITIONS linedoc corpus; returns the
    number of docs written. Needs the native library (g++)."""
    rng = np.random.default_rng(seed)
    vocab = pseudo_vocab(vocab_size, seed=seed + 1)
    wlen = np.fromiter((len(w) for w in vocab), dtype=np.int64,
                       count=vocab_size)
    vocab_blob = np.frombuffer("".join(vocab).encode("ascii"), dtype=np.uint8)
    vocab_offs = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(wlen, out=vocab_offs[1:])

    header = ["doctitle", "body", "tokenized", "offsets", "positions"]
    t0 = time.time()
    written = 0
    with open(out_path, "wb") as f:
        f.write(("FIELDS_HEADER_INDICATOR###\t"
                 + "\t".join(header) + "\n").encode("utf-8"))
        while written < n_docs:
            nd = min(chunk_docs, n_docs - written)
            lens = np.maximum(1, rng.poisson(mean_len, size=nd))
            total = int(lens.sum())
            ids_flat = np.minimum(rng.zipf(zipf_a, size=total) - 1,
                                  vocab_size - 1).astype(np.int64)
            bounds = np.zeros(nd + 1, dtype=np.int64)
            np.cumsum(lens, out=bounds[1:])
            f.write(native.linedoc_chunk(vocab_blob, vocab_offs, ids_flat,
                                         bounds))
            written += nd
            if verbose:
                print(f"  wrote {written}/{n_docs} docs "
                      f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
    return written
