"""Offline indexer CLI (the port's copy of wiser_tpu/tools/indexer.py) —
reference: tools/indexer.py:139-151 (create_qq_mem_dump, then
convert_qq_to_vacuum). Here: OracleEngine build + pack_oracle, or with
--fast the vectorized chunked builder (index/fast_builder.py; with
--spill-dir its parsed columns stream through disk), producing the
PackedIndex directory and a chunked LZ4 doc store in <out>/docs.

Run: python -m wiser_tpu_torch.tools.indexer --linedoc corpus.linedoc \
       --format WITH_BI_BLOOM --out /path/to/index [--with-blooms]
       [--n-rows N] [--bloom-entries 5 --bloom-ratio 0.0009]
       [--fast [--spill-dir DIR]] [--no-doc-store]
"""

from __future__ import annotations

import argparse
import sys
import time


def build(linedoc: str, fmt: str, out: str, n_rows=None, with_blooms=False,
          bloom_entries=5, bloom_ratio=0.0009, store_docs=True, fast=False,
          spill_dir=None):
    """Build, save to `out` (and the doc store to out/docs); returns
    (packed, oracle), oracle None with fast."""
    from wiser_tpu_torch.index.bloom import BloomConfig
    from wiser_tpu_torch.index.doc_store import ChunkedDocStoreWriter

    t0 = time.time()
    oracle = None
    if fast:
        from wiser_tpu_torch.index.fast_builder import build_packed_fast

        packed = build_packed_fast(
            linedoc, fmt, n_rows=n_rows, with_blooms=with_blooms,
            bloom_cfg=BloomConfig(bloom_entries, bloom_ratio), verbose=True,
            spill_dir=spill_dir)
    else:
        from wiser_tpu_torch.index.builder import build_index_from_linedoc

        packed, oracle = build_index_from_linedoc(
            linedoc, fmt, n_rows=n_rows,
            bloom_cfg=BloomConfig(bloom_entries, bloom_ratio),
            with_blooms=with_blooms)
    t1 = time.time()
    packed.save(out)
    if store_docs:
        w = ChunkedDocStoreWriter(out + "/docs")
        if oracle is not None:
            bodies = oracle.doc_bodies
        else:
            from wiser_tpu_torch.linedoc import parse_linedoc

            bodies = (d.body for d in parse_linedoc(linedoc, fmt, n_rows))
        for body in bodies:
            w.add(body)
        w.close()
    t2 = time.time()
    print(f"indexed {packed.n_docs} docs, {packed.n_terms} terms, "
          f"{int(packed.df.sum())} postings (padded {packed.n_postings}) "
          f"in {t1-t0:.1f}s; dumped in {t2-t1:.1f}s -> {out}",
          file=sys.stderr)
    return packed, oracle


def main(argv=None):
    ap = argparse.ArgumentParser(description="wiser_tpu_torch offline indexer")
    ap.add_argument("--linedoc", required=True)
    ap.add_argument("--format", default="WITH_POSITIONS")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-rows", type=int, default=None)
    ap.add_argument("--with-blooms", action="store_true")
    ap.add_argument("--bloom-entries", type=int, default=5)
    ap.add_argument("--bloom-ratio", type=float, default=0.0009)
    ap.add_argument("--no-doc-store", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="vectorized chunked builder (reference-scale path)")
    ap.add_argument("--spill-dir", default=None,
                    help="with --fast: stream parsed columns through this "
                         "directory instead of RAM")
    args = ap.parse_args(argv)
    build(args.linedoc, args.format, args.out, args.n_rows, args.with_blooms,
          args.bloom_entries, args.bloom_ratio,
          store_docs=not args.no_doc_store, fast=args.fast,
          spill_dir=args.spill_dir)


if __name__ == "__main__":
    main()
