"""Write an AOL-shaped mixed query log for a PackedIndex to a text file
(the port's copy of wiser_tpu/tools/make_query_log.py): one query per
line, quoted = phrase (query_pool.h:308-311 syntax), so the closed-loop
serving benches (tools/run_client_server.py) replay the same workload
shape as the headline and the scale ladder.

Run: python -m wiser_tpu_torch.tools.make_query_log --index <dir> \
         --out queries.txt [--n 65536] [--seed 7]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    from wiser_tpu_torch.data.synth_log import aol_shape_mixed_log
    from wiser_tpu_torch.index.format import PackedIndex

    packed = PackedIndex.load(args.index, skip_offsets=True)
    queries = aol_shape_mixed_log(packed.terms, packed.df, args.n,
                                  seed=args.seed)
    with open(args.out, "w", encoding="utf-8") as f:
        for q in queries:
            line = " ".join(q.terms)
            f.write(f'"{line}"\n' if q.is_phrase else line + "\n")
    print(f"wrote {len(queries)} queries to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
