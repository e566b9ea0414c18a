"""Per-route microbench over a saved PackedIndex (the port's copy of
wiser_tpu/tools/route_bench.py): query sets that pin each execution tier
are timed separately, so a ladder regression is attributed to a route
and not to an aggregate. With --trace DIR the zipf_t3 set (the ladder's
T=3 traffic) runs a second time under torch.profiler (utils.trace): its
row gains the top device kernels and the device busy share, beside the
untraced pass's wall.

Run: python -m wiser_tpu_torch.tools.route_bench --index <dir> \
         [--columns tc] [--n-queries 8192] [--batch 4096] \
         [--linedoc <corpus.linedoc>] [--trace DIR] \
         [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# df fraction below which route_bench calls a term "tail" (n_docs // this,
# floored at 1,024): the JAX engine's retained DENSE_MIN_DF_FRACTION, read
# only by this tool
DENSE_MIN_DF_FRACTION = 96

# the engine routes a set is named for; its queries take these for the
# most part. The all-head sets name the dense tier: the (pruned) dense
# scan, or semidense where the planner finds a conjunction sparse (fewer
# than 4k expected matches and a candidate df of at most
# SEMI_FROM_DENSE_MAX_CAND_L). phrase_mega names the all-dense phrase
# routes: the mega scan, or the semidense phrase route for candidates of
# df at most PHRASE_MAX_L. The zipf_t* sets (the ladder's mix) and
# phrase_mixed (one dense term: the semidense phrase route when the
# other's df passes PRUNED_PHRASE_KV, else the list chain) name none.
_DENSE_TIER = ("route_pruned", "route_dense", "route_semidense")
NAMED_ROUTES = {
    "dense_all_head_pair": _DENSE_TIER,
    "semidense_tail_x_head": ("route_semidense",),
    "windowed_mid_pair": ("route_windowed",),
    "bsearch_tail_pair": ("route_bs",),
    "single_term_table": ("route_single_table",),
    "dense_t3": _DENSE_TIER,
    "semidense_t3": ("route_semidense",),
    "midcand_x_2head_t3": ("route_semidense",),
    "phrase_list": ("route_phrase_compact", "route_phrase_list"),
    "phrase_mega": ("route_phrase_full", "route_phrase_pruned",
                    "route_phrase_semidense"),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def route_share(name: str, stats: dict):
    """(named route count, all routed queries) of a set's stats, or None
    for a set named for no route. Routed queries are the distinct
    queries the planner sent somewhere (route_* counters)."""
    if name not in NAMED_ROUTES:
        return None
    routed = sum(v for k, v in stats.items() if k.startswith("route_"))
    return sum(stats.get(k, 0) for k in NAMED_ROUTES[name]), routed


def build_phrase_route_sets(packed, engine, linedoc, n: int, k: int, seed=3,
                            pairs=None):
    """Phrase sets from adjacent pairs mined from the linedoc (or given as
    `pairs`), split by the tier that runs them: list (compact kernel or
    list chain: neither term dense), mega (both dense), mixed (one
    dense)."""
    from wiser_tpu_torch.data.scale_corpus import mine_phrases_from_linedoc
    from wiser_tpu_torch.types import SearchQuery

    rng = np.random.default_rng(seed)
    if pairs is None:
        pairs = mine_phrases_from_linedoc(linedoc, packed.term_to_row,
                                          max_pairs=4000)
    if not pairs:
        return {}
    dense = lambda t: engine._dense_slot[packed.term_to_row[t]] >= 0
    classes = {"phrase_list": [], "phrase_mega": [], "phrase_mixed": []}
    for a, b in pairs:
        da, db = dense(a), dense(b)
        key = ("phrase_mega" if (da and db)
               else "phrase_list" if not (da or db) else "phrase_mixed")
        classes[key].append((a, b))
    sets = {}
    for name, cls in classes.items():
        if not cls:
            continue
        idx = rng.integers(0, len(cls), size=n)
        sets[name] = [SearchQuery(list(cls[i]), n_results=k, is_phrase=True)
                      for i in idx]
    return sets


def build_route_sets(packed, engine, n: int, k: int, seed=3):
    """Query sets keyed by the route they exercise, from the df and tier
    boundaries the planner routes by."""
    from wiser_tpu_torch.types import SearchQuery

    rng = np.random.default_rng(seed)
    df = packed.df
    dense_min = max(1024, packed.n_docs // DENSE_MIN_DF_FRACTION)
    head = (np.nonzero(engine._dense_slot >= 0)[0]
            if engine._dense_H else np.zeros(0, np.int64))
    # windowed: WINDOWED_MIN_L <= df <= WINDOWED_MAX_L, not dense
    wlo, whi = engine.WINDOWED_MIN_L, engine.WINDOWED_MAX_L
    windowed_rows = np.nonzero((df >= wlo) & (df <= whi)
                               & (engine._dense_slot < 0))[0]
    tail_rows = np.nonzero((df >= 8) & (df < min(wlo, dense_min)))[0]

    def pick(rows, m):
        if len(rows) == 0:
            return None
        return rows[rng.integers(0, len(rows), size=m)]

    def q(*rows):
        return SearchQuery([packed.terms[r] for r in rows], n_results=k)

    sets = {}
    if len(head) >= 2:
        a, b = pick(head, n), pick(head, n)
        sets["dense_all_head_pair"] = [q(x, y) for x, y in zip(a, b) if x != y]
    if len(head) >= 1 and len(tail_rows) >= 1:
        a, b = pick(tail_rows, n), pick(head, n)
        sets["semidense_tail_x_head"] = [q(x, y) for x, y in zip(a, b)]
    if len(windowed_rows) >= 2:
        a, b = pick(windowed_rows, n), pick(windowed_rows, n)
        sets["windowed_mid_pair"] = [q(x, y) for x, y in zip(a, b) if x != y]
    if len(tail_rows) >= 2:
        a, b = pick(tail_rows, n), pick(tail_rows, n)
        sets["bsearch_tail_pair"] = [q(x, y) for x, y in zip(a, b) if x != y]
    if len(tail_rows) >= 1:
        sets["single_term_table"] = [q(x) for x in pick(tail_rows, n)]
    # the ladder's config-3 device traffic: Zipf-drawn 2-4 term
    # conjunctions
    order = np.argsort(df)[::-1].astype(np.int64)
    for nt in (2, 3, 4):
        ranks = np.minimum(rng.zipf(1.25, size=(n, nt)) - 1,
                           packed.n_terms - 1)
        sets[f"zipf_t{nt}"] = [q(*rr) for rr in order[ranks]]
    # T=3 decomposition: which tier makes multi-term queries slow?
    if len(head) >= 3:
        picks = [pick(head, n) for _ in range(3)]
        sets["dense_t3"] = [q(x, y, z) for x, y, z in zip(*picks)
                            if len({x, y, z}) == 3]
    if len(head) >= 2 and len(tail_rows) >= 1:
        a = pick(tail_rows, n)
        b, c = pick(head, n), pick(head, n)
        sets["semidense_t3"] = [q(x, y, z) for x, y, z in zip(a, b, c)
                                if y != z]
    if len(windowed_rows) >= 1 and len(head) >= 2:
        a = pick(windowed_rows, n)
        b, c = pick(head, n), pick(head, n)
        sets["midcand_x_2head_t3"] = [q(x, y, z) for x, y, z in zip(a, b, c)
                                      if y != z]
    return sets


def _timed_pass(engine, queries, batch):
    done = n_dispatch = 0
    submit_s = final_s = 0.0
    t0 = time.time()
    for i in range(0, len(queries), batch):
        ts = time.time()
        res, pending = engine.submit_batch(queries[i : i + batch])
        submit_s += time.time() - ts
        n_dispatch += len(pending)
        ts = time.time()
        engine.run_pending(res, pending)
        final_s += time.time() - ts
        done += len(res)
    return done, n_dispatch, submit_s, final_s, time.time() - t0


def run_set(engine, queries, batch, trace_dir=None):
    """A warm pass, then a timed pass (counters reset and memos cleared
    first). submit_s is host planning and dispatch, finalize_s the fetch
    waits and the host re-rank; stats are the timed pass's stats_take().
    With trace_dir the timed pass runs once more under utils.trace, and
    "traced" holds that pass's wall and the summarize() of its trace."""
    for i in range(0, len(queries), batch):  # warm pass
        engine.search_batch(queries[i : i + batch])
    engine.stats_take()
    engine.clear_result_memos()
    done, n_dispatch, submit_s, final_s, wall = _timed_pass(
        engine, queries, batch)
    out = {"qps": done / wall, "wall_s": wall, "n": done,
           "per_query_us": 1e6 * wall / max(done, 1),
           "dispatch_groups": n_dispatch, "submit_s": submit_s,
           "finalize_s": final_s,
           "stats": dict(sorted(engine.stats_take().items()))}
    if trace_dir:
        from wiser_tpu_torch.utils import summarize, trace

        engine.clear_result_memos()
        with trace(trace_dir, engine.device) as prof:
            _timed_pass(engine, queries, batch)
        engine.stats_take()
        out["traced"] = summarize(prof)
        out["traced"]["untraced_wall_s"] = wall
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--n-queries", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--routes", default=None, help="comma-separated subset")
    ap.add_argument("--linedoc", default=None,
                    help="mine adjacent pairs for the phrase routes")
    ap.add_argument("--pruned-c", type=int, default=None,
                    help="override PRUNED_DENSE_C (block budget A/B)")
    ap.add_argument("--phrase-kv", type=int, default=None,
                    help="override PRUNED_PHRASE_KV (compaction width A/B)")
    ap.add_argument("--phrase-c", type=int, default=None,
                    help="override PRUNED_PHRASE_C")
    ap.add_argument("--no-full-phrase", action="store_true",
                    help="A/B: block-pruned mega phrases instead of the "
                         "full scan")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="run the zipf_t3 set once more under "
                         "torch.profiler, writing DIR/trace.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex

    packed = PackedIndex.load(args.index, skip_offsets=True)
    engine = TorchEngine(packed, device=args.device, columns=args.columns)
    if args.pruned_c:
        engine.PRUNED_DENSE_C = args.pruned_c
    if args.phrase_kv:
        engine.PRUNED_PHRASE_KV = args.phrase_kv
    if args.phrase_c:
        engine.PRUNED_PHRASE_C = args.phrase_c
    if args.no_full_phrase:
        engine.FULL_PHRASE_SCAN = False
    log(f"engine up on {engine.device}; columns={args.columns}; "
        f"dense_H={engine._dense_H}")
    sets = build_route_sets(packed, engine, args.n_queries, args.k)
    if args.linedoc:
        sets.update(build_phrase_route_sets(
            packed, engine, args.linedoc, min(args.n_queries, 4096), args.k))
    if args.routes:
        keep = set(args.routes.split(","))
        sets = {k: v for k, v in sets.items() if k in keep}
    results = {}
    for name, queries in sets.items():
        log(f"== {name}: {len(queries)} queries")
        results[name] = run_set(
            engine, queries, args.batch,
            trace_dir=args.trace if name == "zipf_t3" else None)
        log(json.dumps({name: results[name]}))
    out = {"index": args.index, "columns": args.columns,
           "device": str(engine.device), "routes": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
