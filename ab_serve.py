#!/usr/bin/env python3
"""Same-card A/B of wiser_tpu_torch's conjunctive serving: two source
trees (for example a parent commit unpacked with `git archive` into a
git-ignored directory, and this checkout) serve the chip smoke's AOL-mix
query sets on one CUDA card, alternating processes (base, this, this,
base), over one shared index.

    python3 ab_serve.py BASE_TREE [--docs 1000000] [--passes 5]

The index is chip_smoke.py's bi-bloom index (built into .smoke_cache/ on
first use). Each process loads it, builds TorchEngine at budget 0
(`resident`, mix `aol`) and at the default dense budget (`dense`, mixes
`aol` and `aol_df`), runs a warm pass and then `--passes` timed passes
with the result memos cleared, and prints one JSON line of QPS per pass.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

CHILD = r'''
import json, sys, time
sys.path.insert(0, TREE)
import torch
import chip_smoke as cs
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.index.format import PackedIndex

packed = PackedIndex.load(IDX)
out = {"tree": TREE}
for name, budget in (("resident", 0), ("dense", 7 << 29)):
    eng = TorchEngine(packed, device="cuda", dense_budget_bytes=budget)
    for mix, by_df in (("aol", False), ("aol_df", True)):
        if name == "resident" and by_df:
            continue
        qs = cs.aol_mixed_queries(packed, 4096, by_df=by_df)
        eng.search_batch(qs)
        walls = []
        for _ in range(PASSES):
            eng.clear_result_memos()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.search_batch(qs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{name}_{mix}_qps"] = [len(qs) / w for w in walls]
    del eng
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", help="the other source tree (its root)")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--passes", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    report: dict = {}
    cs.get_index(args.docs, report)
    print(json.dumps({"card": cs.card_line(), "index": report["index"]}),
          flush=True)
    idx = os.path.join(cs.CACHE, f"idx_{args.docs}_bibloom")
    base = os.path.abspath(args.base)
    for tree in (base, ROOT, ROOT, base):
        src = (f"TREE = {tree!r}\nIDX = {idx!r}\nPASSES = {args.passes}\n"
               + CHILD)
        r = subprocess.run([sys.executable, "-c", src], capture_output=True,
                           text=True, timeout=900)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
