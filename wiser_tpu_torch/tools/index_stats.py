"""Index statistics (the port's copy of wiser_tpu/tools/index_stats.py) —
reference: show_bloom_store_stats.cc and
SearchEngineServiceNew::PostinglistSizes (engine_services.h:14-27).

Run: python -m wiser_tpu_torch.tools.index_stats --index <dir> [--terms a b]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def stats(index_dir: str, terms=None) -> dict:
    from wiser_tpu_torch.index.format import PackedIndex

    p = PackedIndex.load(index_dir, skip_offsets=True)
    df = p.df
    out = {
        "n_docs": p.n_docs,
        "n_terms": p.n_terms,
        "n_postings": int(df.sum()),
        "n_postings_padded": p.n_postings,
        "padding_overhead": round(p.n_postings / max(1, int(df.sum())), 3),
        "avg_doc_len": round(p.avg_len, 3),
        "total_positions": int(len(p.positions)),
        "df_percentiles": {
            f"p{q}": int(np.percentile(df, q)) for q in (50, 90, 99, 100)
        },
        "has_blooms": p.bloom_ends is not None,
    }
    if p.bloom_ends is not None:
        nonzero = int(np.any(p.bloom_ends != 0, axis=1).sum())
        out["bloom"] = {
            "bits": p.bloom_cfg.bits,
            "hashes": p.bloom_cfg.n_hashes,
            "bytes_per_filter": p.bloom_cfg.n_bytes,
            "nonempty_end_filters": nonzero,
            "fill_ratio": round(nonzero / max(1, p.n_postings), 4),
        }
    if terms:
        rows = {t: p.term_to_row.get(t, -1) for t in terms}
        out["postinglist_sizes"] = {t: int(p.df[r]) if r >= 0 else 0
                                    for t, r in rows.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--terms", nargs="*")
    args = ap.parse_args(argv)
    print(json.dumps(stats(args.index, args.terms), indent=1))


if __name__ == "__main__":
    main()
