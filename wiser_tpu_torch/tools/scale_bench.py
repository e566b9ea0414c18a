"""The config ladder at reference scale (the port's copy of
wiser_tpu/tools/scale_bench.py): QPS and batch p50 / p99 latency per
query type over a saved PackedIndex, on the card.

Configs (BASELINE.md): (1) single-term, (2) two-term AND, (3) AOL-shaped
1-4-term mix, (4) two-term phrase. Each reports aggregate QPS, batch p50 /
p99, amortized per-query latency, and a sampled parity check against the
exact host search (mismatch count).

Run: python -m wiser_tpu_torch.tools.scale_bench --index <dir> \
         [--linedoc <corpus.linedoc>] [--n-queries 65536] [--columns tc] \
         [--engine staged --budget-bytes N] [--device cpu] [--out X.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import weakref

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# id(packed) -> (a weak reference to it, its df order): an id is reused
# once its index is freed, so a hit counts only while the reference
# still names the same object
_DF_ORDER = {}


def zipf_rows(packed, rng, n, nt):
    """Zipf draw over df rank (frequent terms queried most — the AOL
    shape): rank 0 = the highest-df term."""
    key = id(packed)
    got = _DF_ORDER.get(key)
    if got is None or got[0]() is not packed:
        got = _DF_ORDER[key] = (weakref.ref(packed),
                                np.argsort(packed.df)[::-1].astype(np.int64))
    order = got[1]
    ranks = np.minimum(rng.zipf(1.25, size=(n, nt)) - 1, packed.n_terms - 1)
    return order[ranks]


def build_configs(packed, linedoc, n_queries: int, k: int, seed=7,
                  pairs=None):
    """The four configs' query lists. Phrase pairs are mined from the
    linedoc (data/scale_corpus.mine_phrases_from_linedoc, up to 2,000), or
    given as `pairs`; without either there is no phrase config. The rng
    draws in the JAX harness's order: rows1, rows2, the term counts, the
    per-query rows, the pair indices."""
    from wiser_tpu_torch.data.scale_corpus import mine_phrases_from_linedoc
    from wiser_tpu_torch.types import SearchQuery

    rng = np.random.default_rng(seed)
    configs = {}
    rows1 = zipf_rows(packed, rng, n_queries, 1)
    configs["1_single_term"] = [
        SearchQuery([packed.terms[r]], n_results=k) for (r,) in rows1]
    rows2 = zipf_rows(packed, rng, n_queries, 2)
    configs["2_two_term_and"] = [
        SearchQuery([packed.terms[a], packed.terms[b]], n_results=k)
        for a, b in rows2]
    nt = rng.choice([1, 2, 3, 4], size=n_queries, p=[0.43, 0.29, 0.20, 0.08])
    mix = []
    for t in nt:
        rr = zipf_rows(packed, rng, 1, int(t))[0]
        mix.append(SearchQuery([packed.terms[r] for r in rr], n_results=k))
    configs["3_aol_mix"] = mix

    if pairs is None and linedoc:
        pairs = mine_phrases_from_linedoc(linedoc, packed.term_to_row,
                                          max_pairs=2000)
    if pairs:
        idx = rng.integers(0, len(pairs), size=n_queries)
        configs["4_phrase"] = [
            SearchQuery(list(pairs[i]), n_results=k, is_phrase=True)
            for i in idx]
    else:
        log("no linedoc or pairs given; skipping the phrase config")
    return configs


def run_config(engine, queries, batch: int, pipeline: int = 2):
    """A warm pass, then a timed pass with `pipeline` batches in flight
    (memos cleared first, so every timed query pays its real cost).
    Finalizers run through engine.run_pending (barrier finalizers last)."""
    t0 = time.time()
    for i in range(0, len(queries), batch):
        engine.search_batch(queries[i : i + batch])
    warm = time.time() - t0
    engine.clear_result_memos()

    lat = []
    done = 0
    in_flight = []

    def finish():
        nonlocal done
        bt0, (res, pending) = in_flight.pop(0)
        engine.run_pending(res, pending)
        lat.append(time.time() - bt0)
        done += len(res)

    t0 = time.time()
    for i in range(0, len(queries), batch):
        bt = time.time()
        in_flight.append((bt, engine.submit_batch(queries[i : i + batch])))
        while len(in_flight) > pipeline:
            finish()
    while in_flight:
        finish()
    wall = time.time() - t0
    lat = np.array(lat)
    return {
        "qps": round(done / wall, 1),
        "wall_s": round(wall, 2),
        "warmup_s": round(warm, 2),
        "n_queries": done,
        "batch": batch,
        "batch_p50_s": round(float(np.median(lat)), 3),
        "batch_p99_s": round(float(np.percentile(lat, 99)), 3),
        "per_query_us": round(1e6 * wall / max(done, 1), 1),
    }


def parity_sample(engine, packed, queries, n_sample: int, seed=11) -> int:
    """Exact host re-search of a sample; returns the mismatch count."""
    from wiser_tpu_torch.engine.host import host_exact_search

    rng = np.random.default_rng(seed)
    idx = rng.choice(len(queries), size=min(n_sample, len(queries)),
                     replace=False)
    bad = 0
    for i in idx:
        q = queries[int(i)]
        rows = [packed.term_to_row.get(t, -1) for t in q.terms]
        if min(rows) < 0:
            continue
        got = engine.search(q)
        d, s = host_exact_search(packed, engine.cache64, rows, q.n_results,
                                 is_phrase=q.is_phrase and len(rows) >= 2)
        want = list(zip(d.tolist(), s.tolist()))
        have = [(e.doc_id, e.doc_score) for e in got.entries]
        if want != have:
            bad += 1
            log(f"PARITY MISMATCH {q.terms} phrase={q.is_phrase}\n"
                f"  want={want[:3]}...\n  have={have[:3]}...")
    return bad


def ladder(engine, packed, configs, batch: int, n_parity: int,
           on_config=None) -> dict:
    """run_config (2 batches in flight) + parity_sample for each config;
    returns {name: row}, passed to on_config after each config."""
    results = {}
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries ==")
        r = run_config(engine, queries, batch)
        r["unique_queries"] = len({(tuple(q.terms), q.n_results, q.is_phrase)
                                   for q in queries})
        r["parity_mismatches"] = parity_sample(engine, packed, queries,
                                               n_parity)
        r["parity_sample"] = n_parity
        results[name] = r
        log(json.dumps({name: r}))
        if on_config is not None:
            on_config(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-queries", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--parity-sample", type=int, default=50)
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset, e.g. 1_single_term,3_aol_mix")
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--engine", default="torch", choices=["torch", "staged"],
                    help="staged: hot tier + dense rows within "
                         "--budget-bytes, cold terms staged from the host")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="the staged engine's device budget (required with "
                         "--engine staged)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.engine == "staged" and args.budget_bytes is None:
        ap.error("--engine staged needs --budget-bytes")

    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    # the char-offset bags feed only the highlighter, never benched here
    packed = PackedIndex.load(args.index, skip_offsets=True)
    log(f"index loaded in {time.time()-t0:.1f}s: {packed.n_docs} docs, "
        f"{packed.n_terms} terms, {packed.n_postings} padded postings")
    t0 = time.time()
    if args.engine == "staged":
        from wiser_tpu_torch.engine.staged import StagedEngine

        engine = StagedEngine(packed, args.budget_bytes, device=device,
                              columns=args.columns)
        log(f"staged engine up in {time.time()-t0:.1f}s; budget "
            f"{args.budget_bytes}; hot {engine.hot_fraction:.4f} "
            f"phrase_hot {engine.phrase_hot_fraction:.4f} "
            f"dense {float(engine.dense_mask.mean()):.4f}; device bytes: "
            f"{json.dumps(engine.device_bytes())}")
    else:
        engine = TorchEngine(packed, device=device, columns=args.columns)
        log(f"engine up in {time.time()-t0:.1f}s; device bytes: "
            f"{json.dumps(engine.device_bytes())}")

    configs = build_configs(packed, args.linedoc, args.n_queries, args.k)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}

    summary = {
        "index": args.index,
        "n_docs": packed.n_docs,
        "n_terms": packed.n_terms,
        "postings_padded": packed.n_postings,
        "columns": args.columns,
        "engine": args.engine,
        "device": str(device),
        "device_bytes": engine.device_bytes(),
    }

    def write(results):  # incremental: finished configs survive a crash
        summary["configs"] = results
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)

    write(ladder(engine, packed, configs, args.batch, args.parity_sample,
                 on_config=write))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
