"""Wiki-shaped linedoc generation at scale (the port's copy of
wiser_tpu/data/scale_corpus.py): a pseudo-English vocabulary with Zipf
term frequencies and Poisson document lengths, written as WITH_POSITIONS
rows or, with_blooms, WITH_BI_BLOOM rows (plus the per-term following /
preceding word columns the bi-bloom filters are built from). Python
draws every random number; the native assembler (native/wiser_native.cpp)
turns each chunk's token ids into rows, and the file is byte-identical
to the JAX package's for the same arguments.

mine_phrases_from_linedoc (the port's copy of wiser_tpu/tools/
scale_bench.py's) takes phrase queries from such a file.

Run: python -m wiser_tpu_torch.data.scale_corpus --out c.linedoc \
         --n-docs 1000000 [--with-blooms]
"""

from __future__ import annotations

import sys
import time
from typing import List, Tuple

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
                     seed: int = 42, with_blooms: bool = False,
                     chunk_docs: int = 20_000, verbose: bool = True) -> int:
    """Write a wiki-shaped linedoc corpus (WITH_BI_BLOOM columns when
    with_blooms); returns the number of docs written. Needs the native
    library (g++)."""
    rng = np.random.default_rng(seed)
    vocab = pseudo_vocab(vocab_size, seed=seed + 1)
    wlen = np.fromiter((len(w) for w in vocab), dtype=np.int64,
                       count=vocab_size)
    vocab_blob = np.frombuffer("".join(vocab).encode("ascii"), dtype=np.uint8)
    vocab_offs = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(wlen, out=vocab_offs[1:])

    header = ["doctitle", "body", "tokenized", "offsets", "positions"]
    if with_blooms:
        header += ["bloom", "bloom_before"]
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
                                         bounds, with_blooms))
            written += nd
            if verbose:
                print(f"  wrote {written}/{n_docs} docs "
                      f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
    return written


def mine_phrases_from_linedoc(path: str, term_to_row: dict,
                              max_pairs: int = 2000,
                              max_rows: int = 2000) -> List[Tuple[str, str]]:
    """Distinct adjacent-token pairs (a != b) of the first max_rows
    document bodies whose terms are both indexed (term_to_row: the
    index's term dictionary), in order of first appearance."""
    pairs: List[Tuple[str, str]] = []
    seen = set()
    with open(path, encoding="utf-8", errors="replace") as f:
        f.readline()
        for i, line in enumerate(f):
            if i >= max_rows or len(pairs) >= max_pairs:
                break
            toks = line.split("\t")[1].split(" ")
            for a, b in zip(toks, toks[1:]):
                if (a != b and (a, b) not in seen and a in term_to_row
                        and b in term_to_row):
                    seen.add((a, b))
                    pairs.append((a, b))
                    if len(pairs) >= max_pairs:
                        break
    return pairs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="generate a wiki-shaped linedoc corpus at scale")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-docs", type=int, required=True)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--mean-len", type=int, default=120)
    ap.add_argument("--zipf-a", type=float, default=1.25)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--with-blooms", action="store_true")
    args = ap.parse_args(argv)
    n = generate_linedoc(args.out, args.n_docs, args.vocab, args.mean_len,
                         args.zipf_a, args.seed, args.with_blooms)
    print(f"wrote {n} docs -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
