"""Index integrity checker (the port's copy of
wiser_tpu/tools/check_posting_list.py) — reference: check_posting_list.cc
(every term's doc freq against counts taken from the source linedoc),
extended to per-posting tfs and the block-padding invariants.

Run: python -m wiser_tpu_torch.tools.check_posting_list --index <dir> \
       --linedoc corpus.linedoc [--format WITH_POSITIONS]
Exits 1 when any check fails.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np


def check(index_dir: str, linedoc: str, fmt: str, n_rows=None) -> int:
    """The number of failed checks (each printed)."""
    from wiser_tpu_torch.index.format import BLOCK, SENTINEL_DOC, PackedIndex
    from wiser_tpu_torch.linedoc import parse_linedoc

    packed = PackedIndex.load(index_dir, skip_offsets=True)
    errors = 0

    # df and tf recomputed from the source
    df_truth: Counter = Counter()
    tf_truth = {}
    n_docs = 0
    for doc_id, doc in enumerate(parse_linedoc(linedoc, fmt, n_rows)):
        n_docs += 1
        toks = doc.get_tokens()
        poss = doc.get_positions()
        offs = doc.get_offset_pairs_vec()
        for i, t in enumerate(toks):
            df_truth[t] += 1
            p = poss[i] if i < len(poss) else []
            o = offs[i] if i < len(offs) else []
            tf_truth[(t, doc_id)] = len(p) or len(o) or 1

    if n_docs != packed.n_docs:
        print(f"ERROR: n_docs {packed.n_docs} != linedoc rows {n_docs}")
        errors += 1

    if set(df_truth) != set(packed.terms):
        missing = set(df_truth) - set(packed.terms)
        extra = set(packed.terms) - set(df_truth)
        print(f"ERROR: term set mismatch (missing={len(missing)}, "
              f"extra={len(extra)})")
        errors += 1

    for r, term in enumerate(packed.terms):
        df = int(packed.df[r])
        if df != df_truth.get(term, -1):
            print(f"ERROR: term {term!r} df {df} != truth {df_truth.get(term)}")
            errors += 1
            continue
        s = int(packed.term_starts[r])
        docs = packed.postings_doc[s : s + df]
        if not np.all(np.diff(docs) > 0):
            print(f"ERROR: term {term!r} doc ids not strictly ascending")
            errors += 1
        for j in range(df):
            key = (term, int(docs[j]))
            if packed.postings_tf[s + j] != tf_truth.get(key, -1):
                print(f"ERROR: tf mismatch at {key}")
                errors += 1
                break
        # padding invariants
        e = int(packed.term_starts[r + 1])
        if s % BLOCK or e % BLOCK:
            print(f"ERROR: term {term!r} run not block-aligned")
            errors += 1
        if not np.all(packed.postings_doc[s + df : e] == SENTINEL_DOC):
            print(f"ERROR: term {term!r} padding not sentinel")
            errors += 1

    if errors == 0:
        print(f"OK: {packed.n_terms} terms, {int(packed.df.sum())} postings "
              f"verified")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", required=True)
    ap.add_argument("--format", default="WITH_POSITIONS")
    ap.add_argument("--n-rows", type=int, default=None)
    args = ap.parse_args(argv)
    sys.exit(1 if check(args.index, args.linedoc, args.format, args.n_rows)
             else 0)


if __name__ == "__main__":
    main()
