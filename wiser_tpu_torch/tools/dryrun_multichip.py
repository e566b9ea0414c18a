"""One full sharded search over n shards, every mesh route, raw and tc
columns, each answer checked against the exact host search (the port's
counterpart of __graft_entry__.dryrun_multichip).

The corpus is tiny (384 docs per shard, 3 blocks of 128 per shard, with
bi-blooms) and the tiers are shrunk on subclasses so it takes every
route: the impact table, bs (single-term past the table and AND), the
dense scan, the block-max pruned scan, semidense (with and without bs
others), the compact phrase pipeline, phrase_body and coalescing. Shards
go one per card on a machine with n cards, else all on cuda:0;
device="cpu" puts them on the CPU.

Run: python -m wiser_tpu_torch.tools.dryrun_multichip [--n 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

ROUTES = ("route_single_table", "route_bs", "route_dense", "route_pruned",
          "route_semidense", "route_phrase_compact", "route_phrase_list",
          "q_coalesced")


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """Raises AssertionError on any answer that differs from the exact
    host search, or a route that no query took; returns a summary."""
    from wiser_tpu_torch.data.synth import synth_docinfos
    from wiser_tpu_torch.engine.host import host_exact_search
    from wiser_tpu_torch.engine.shard import (ShardedEngine, ShardedIndex,
                                              default_placement)
    from wiser_tpu_torch.index.builder import build_index
    from wiser_tpu_torch.types import SearchQuery

    devices = (default_placement(n) if device == "cuda" else [device] * n)
    docs = synth_docinfos(n_docs=384 * n, vocab_size=400, mean_len=24,
                          seed=1, with_blooms=True)
    packed, oracle = build_index(docs, with_blooms=True)
    sharded = ShardedIndex.from_packed(packed, n)

    # shrunk tiers: a dense tier on the tiny corpus; the pruned scan over
    # C = 2 of each shard's 3 blocks; the compact phrase pipeline past 8
    # lanes (class _Full keeps the full scan and phrase_body)
    class _Pruned(ShardedEngine):
        DENSE_MIN_DF_FLOOR = 4
        PRUNED_DENSE_MIN_NB = 1
        PRUNED_DENSE_C = 2
        PHRASE_COMPACT_KV = 8

    class _Full(ShardedEngine):
        DENSE_MIN_DF_FLOOR = 4

    probe = _Pruned(sharded, devices=devices)
    if probe._dense_H == 0:
        raise AssertionError("the dryrun corpus produced no dense tier")
    df = packed.df
    head = [packed.terms[r] for r in np.nonzero(probe._dense_slot >= 0)[0]]
    tail = {packed.terms[r]
            for r in np.nonzero((probe._dense_slot < 0) & (df >= 2))[0]}
    # a document holding two tail terms and a head term, so that every
    # conjunction below has matches
    for body in oracle.doc_bodies:
        words = body.split(" ")
        t2 = sorted({w for w in words if w in tail},
                    key=lambda w: df[packed.term_to_row[w]])
        h1 = [w for w in words if w in head]
        if len(t2) >= 2 and h1 and len(words) >= 4:
            break
    else:
        raise AssertionError("the dryrun corpus has no tail x head document")
    deep = packed.terms[int(np.argmax(df))]
    queries = [
        SearchQuery([t2[0]], n_results=5),  # impact table
        SearchQuery([deep], n_results=100),  # past the table: bs
        SearchQuery(t2[:2], n_results=5),  # bs
        SearchQuery(head[:2], n_results=5),  # dense / pruned scan
        SearchQuery([t2[0], h1[0]], n_results=5),  # semidense
        SearchQuery([t2[0], t2[1], h1[0]], n_results=5),  # + bs
        SearchQuery(words[:2], n_results=5, is_phrase=True),  # phrases
        SearchQuery(words[1:4], n_results=5, is_phrase=True),
        SearchQuery(head[:2], n_results=5),  # coalesced with the above
    ]
    summary = {"n": n, "placement": [str(d) for d in probe.placement],
               "dense_H": int(probe._dense_H), "runs": {}}
    seen = dict.fromkeys(ROUTES, 0)
    for columns in ("raw", "tc"):
        for cls in (_Pruned, _Full):
            engine = probe if (cls, columns) == (_Pruned, "raw") else cls(
                sharded, devices=devices, columns=columns)
            results = engine.search_batch(queries)
            for q, r in zip(queries, results):
                rows = [engine.lookup(t) for t in q.terms]
                d, s = host_exact_search(packed, engine.cache64, rows,
                                         q.n_results, is_phrase=q.is_phrase)
                got = [(e.doc_id, e.doc_score) for e in r.entries]
                want = list(zip(d.tolist(), s.tolist()))
                if got != want or not want:
                    raise AssertionError(
                        f"dryrun_multichip({n}) {columns} {cls.__name__}: "
                        f"{q.terms} phrase={q.is_phrase} got {got[:3]} "
                        f"want {want[:3]}")
            stats = engine.stats_take()
            for k in ROUTES:
                seen[k] += stats.get(k, 0)
            summary["runs"][f"{columns}_{cls.__name__[1:].lower()}"] = {
                k: stats[k] for k in ROUTES if stats.get(k)}
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise AssertionError(f"dryrun_multichip({n}): no query took "
                             f"{missing}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4, help="the number of shards")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device)))


if __name__ == "__main__":
    main()
