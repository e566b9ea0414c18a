"""Experiment harness (the port's copy of wiser_tpu/bench/run_exp.py) —
reference: tools/run_exp.py (the config matrix: engine x memory cap x
query type x readahead x bloom factor, result-table parsing).

It sweeps corpus scale, batch size, workload mix, bloom factor and engine
kind, runs each treatment through a local engine on the card (or the CPU
when asked), and writes one JSON row per treatment. The reference's
memory-cap axis (cgroup limits, run_exp.py:628-696) maps to the staged
engine's device budget; each row records the peak device memory of its
timed pass (torch.cuda.max_memory_allocated after a reset; None on the
CPU).

Run: python -m wiser_tpu_torch.bench.run_exp --out results.jsonl [--quick]
     [--memory --index <dir> --fracs 0.05,0.25 --cold-compute device]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from dataclasses import asdict, dataclass, replace
from typing import List, Optional

import numpy as np


@dataclass
class Treatment:
    name: str
    n_docs: int = 5000
    vocab: int = 5000
    mean_len: int = 80
    workload: str = "aol_mix"  # aol_mix | single | two_term | phrase | worklocal_mix
    n_queries: int = 8192
    batch: int = 8192
    n_results: int = 10
    bloom_factor: Optional[int] = 1
    engine: str = "torch"  # torch | staged | oracle
    # device budget as a fraction of full_device_bytes (engine="staged"):
    # the hot tier keeps this share resident, the rest is staged per batch
    hbm_budget_frac: Optional[float] = None
    columns: str = "raw"  # raw | tc
    # a saved PackedIndex directory served instead of a synthetic corpus
    index_dir: Optional[str] = None
    # hot-tier admission (engine="staged"): "df" = df order; "qfreq" =
    # per-batch presence counts from the first half of the query log,
    # evaluated on the second half
    residency: str = "df"
    # the staged engine's cold backend: "host" (its default: the memoized
    # exact host search) or "device" (cold runs staged to the card, doc
    # columns decoded by the unpack kernel)
    cold_compute: str = "host"


@dataclass
class ExpResult:
    treatment: dict
    qps: float
    wall_s: float
    warmup_s: float
    batch_p50_s: float
    device_mem_bytes: Optional[int] = None  # peak of the timed pass
    hot_fraction: Optional[float] = None  # staged: share of terms resident
    # staged: share of terms with phrase components resident
    phrase_hot_fraction: Optional[float] = None
    # staged: share of terms with a dense row
    dense_fraction: Optional[float] = None
    budget_bytes: Optional[int] = None
    # staged: bytes the hot tier charged against the budget, and the
    # engine's resident bytes per column family
    hot_bytes_used: Optional[int] = None
    resident_bytes: Optional[dict] = None


def default_matrix(quick: bool = False) -> List[Treatment]:
    if quick:
        return [
            Treatment("quick_mix", n_docs=500, vocab=500, mean_len=30,
                      n_queries=512, batch=512),
            Treatment("quick_phrase", n_docs=500, vocab=80, mean_len=30,
                      workload="phrase", n_queries=256, batch=256),
        ]
    out = []
    for workload, batch in itertools.product(
            ["single", "two_term", "aol_mix", "phrase"], [1024, 8192]):
        out.append(Treatment(
            name=f"{workload}_b{batch}", workload=workload, batch=batch))
    return out


def memory_matrix(quick: bool = False, n_docs: int = 50_000,
                  vocab: int = 20_000, batch: int = 8192,
                  index_dir: Optional[str] = None,
                  columns: str = "raw",
                  n_queries: Optional[int] = None,
                  fracs=None, cold_compute: str = "host") -> List[Treatment]:
    """The memory-cap grid: the staged engine's device budget at each
    fraction of full_device_bytes over a fixed workload (at 1.0 every
    term is resident; lower fractions stage cold posting runs per
    batch)."""
    if quick:
        n_docs, vocab = 3000, 2000
    out = []
    for frac in fracs or (0.05, 0.1, 0.25, 0.5, 1.0):
        out.append(Treatment(
            name=f"membudget_{frac}", n_docs=n_docs, vocab=vocab,
            workload="aol_mix", engine="staged", hbm_budget_frac=frac,
            n_queries=2048 if quick else (n_queries or 8192),
            batch=2048 if quick else batch, index_dir=index_dir,
            columns=columns, cold_compute=cold_compute))
    return out


def residency_matrix(index_dir: Optional[str], batch: int = 8192,
                     fracs=(0.05, 0.1, 0.25), n_queries: int = 16384,
                     columns: str = "raw") -> List[Treatment]:
    """df-order vs workload-aware (qfreq) hot-tier admission at equal
    budgets, on a workload whose accesses diverge from df order
    (worklocal_mix: half the queries hit a small working set of mid-df
    terms)."""
    out = []
    for frac in fracs:
        for residency in ("df", "qfreq"):
            out.append(Treatment(
                name=f"residency_{residency}_{frac}",
                workload="worklocal_mix", engine="staged",
                hbm_budget_frac=frac, residency=residency,
                n_queries=n_queries, batch=batch, index_dir=index_dir,
                columns=columns))
    return out


def build_workload(packed, oracle, t: Treatment):
    from wiser_tpu_torch.data.synth_log import (
        aol_shape_mixed_log, gen_phrase_log, gen_single_term_log,
        gen_two_term_log, mine_phrases_from_index)
    from wiser_tpu_torch.types import SearchQuery

    terms, dfs = packed.terms, packed.df
    if t.workload in ("single", "two_term", "phrase"):
        if t.workload == "single":
            qs = gen_single_term_log(terms, t.n_queries)
        elif t.workload == "two_term":
            qs = gen_two_term_log(terms, terms, t.n_queries)
        else:
            pairs = mine_phrases_from_index(oracle, max_phrases=500)
            qs = gen_phrase_log(pairs, t.n_queries)
        for q in qs:
            q.n_results = t.n_results
        return qs
    if t.workload == "worklocal_mix":
        # half the traffic hits a small working set of mid-df terms, half
        # is the Zipf-by-df-rank mix: an access pattern df order predicts
        # badly
        rng = np.random.default_rng(23)
        order = np.argsort(np.asarray(dfs))[::-1]
        n = len(order)
        band = order[min(n - 1, n // 50) : max(1, n // 2)]  # mid-df band
        ws = rng.choice(band, size=min(2000, len(band)), replace=False)
        base = aol_shape_mixed_log(terms, dfs, t.n_queries,
                                   n_results=t.n_results)
        out = []
        for q in base:
            if rng.random() < 0.5:
                nt = len(q.terms)
                out.append(SearchQuery(
                    [terms[r] for r in rng.choice(ws, size=nt)],
                    n_results=t.n_results))
            else:
                out.append(q)
        return out
    return aol_shape_mixed_log(terms, dfs, t.n_queries, n_results=t.n_results)


def qfreq_weights(packed, train, batch: int) -> np.ndarray:
    """Per-term admission weights: the number of query windows of the
    train split (min(batch, 1024) queries each) a term appears in. Cold
    staging is deduplicated per batch, so a term's benefit per byte of
    residency is its batch-presence rate, not its query count."""
    lookup = packed.term_to_row.get
    w = np.zeros(packed.n_terms, dtype=np.int64)
    win = min(batch, 1024)
    for b0 in range(0, len(train), win):
        rows = {lookup(term, -1)
                for q in train[b0 : b0 + win] for term in q.terms}
        rows.discard(-1)
        for r in rows:
            w[r] += 1
    return w


def run_treatment(t: Treatment, device="cuda", packed=None,
                  oracle=None) -> ExpResult:
    """One treatment on `device` ("cuda", the default, raises without a
    card). packed (with its oracle, if any) serves an index already in
    memory instead of t.index_dir or a synthetic corpus."""
    from wiser_tpu_torch.runtime import resolve_device
    from wiser_tpu_torch.utils import device_peak_bytes, reset_device_peak

    device = resolve_device(device)
    if packed is None and t.index_dir:
        from wiser_tpu_torch.index.format import PackedIndex

        packed = PackedIndex.load(t.index_dir)
    if packed is not None:
        # record the served corpus shape, not the synthetic defaults
        t = replace(t, n_docs=packed.n_docs, vocab=packed.n_terms)
    else:
        from wiser_tpu_torch.data.synth import synth_docinfos
        from wiser_tpu_torch.index.builder import build_index

        phrase = t.workload == "phrase"
        docs = synth_docinfos(t.n_docs, t.vocab, t.mean_len, seed=42,
                              with_blooms=phrase)
        packed, oracle = build_index(docs, with_blooms=phrase)
    queries = build_workload(packed, oracle, t)

    term_weights = None
    if t.engine == "staged" and t.residency == "qfreq":
        term_weights = qfreq_weights(packed, queries[: len(queries) // 2],
                                     t.batch)
    if t.engine == "staged" and t.workload == "worklocal_mix":
        queries = queries[len(queries) // 2 :]  # the eval half

    if t.engine == "oracle":
        t0 = time.time()
        for q in queries:
            oracle.search(q)
        wall = time.time() - t0
        return ExpResult(asdict(t), len(queries) / wall, wall, 0.0, wall)

    hot_fraction = phrase_hot = dense_frac = budget = None
    doc_bodies = oracle.doc_bodies if oracle is not None else None
    if t.engine == "staged":
        from wiser_tpu_torch.engine.staged import (StagedEngine,
                                                   full_device_bytes)

        # the fraction is of the full served footprint (postings,
        # positions, blooms and the dense tier), as the reference grid's
        # cap is a fraction of the whole index
        budget = int(full_device_bytes(packed, t.columns)
                     * (t.hbm_budget_frac or 1.0))
        engine = StagedEngine(packed, budget, device=device,
                              doc_bodies=doc_bodies, columns=t.columns,
                              term_weights=term_weights)
        engine.COLD_COMPUTE = t.cold_compute
        hot_fraction = round(engine.hot_fraction, 4)
        phrase_hot = round(engine.phrase_hot_fraction, 4)
        dense_frac = round(float(engine.dense_mask.mean()), 4)
    elif t.engine == "torch":
        from wiser_tpu_torch.engine.device import TorchEngine

        engine = TorchEngine(packed, device=device, doc_bodies=doc_bodies,
                             bloom_enable_factor=t.bloom_factor,
                             columns=t.columns)
    else:
        raise ValueError(f"unknown engine {t.engine!r}")
    w0 = time.time()
    for i in range(0, len(queries), t.batch):
        engine.search_batch(queries[i : i + t.batch])
    warmup = time.time() - w0
    # the timed pass pays for its host searches: memos from the warm pass
    # are dropped (repeats within the pass still hit)
    engine.clear_result_memos()

    reset_device_peak(device)
    lat = []
    t0 = time.time()
    for i in range(0, len(queries), t.batch):
        bt = time.time()
        engine.search_batch(queries[i : i + t.batch])
        lat.append(time.time() - bt)
    wall = time.time() - t0
    mem = device_peak_bytes(device)
    inner = getattr(engine, "hot", engine)
    resident = {k: int(v) for k, v in inner.device_bytes().items()}
    return ExpResult(asdict(t), round(len(queries) / wall, 1), round(wall, 3),
                     round(warmup, 2), round(float(np.median(lat)), 3), mem,
                     hot_fraction=hot_fraction, phrase_hot_fraction=phrase_hot,
                     dense_fraction=dense_frac, budget_bytes=budget,
                     hot_bytes_used=getattr(engine, "hot_bytes_used", None),
                     resident_bytes=resident)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="exp_results.jsonl")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--memory", action="store_true",
                    help="run the device-budget grid (the cgroup-cap analog)")
    ap.add_argument("--batch", type=int, default=8192,
                    help="memory-grid batch width")
    ap.add_argument("--index", default=None,
                    help="saved PackedIndex dir (reference-scale grids)")
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--n-queries", type=int, default=None)
    ap.add_argument("--fracs", default=None,
                    help="comma list of budget fractions (--memory); "
                         "default 0.05,0.1,0.25,0.5,1.0")
    ap.add_argument("--cold-compute", default="host",
                    choices=["host", "device"],
                    help="the staged engine's cold backend (--memory)")
    ap.add_argument("--residency-compare", action="store_true",
                    help="df vs workload-aware hot-tier admission at equal "
                         "budget (worklocal_mix workload)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    fracs = (tuple(float(x) for x in args.fracs.split(","))
             if args.fracs else None)
    if args.residency_compare:
        matrix = residency_matrix(args.index, batch=args.batch,
                                  n_queries=args.n_queries or 16384,
                                  columns=args.columns,
                                  **({"fracs": fracs} if fracs else {}))
    elif args.memory:
        matrix = memory_matrix(args.quick, batch=args.batch,
                               index_dir=args.index, columns=args.columns,
                               n_queries=args.n_queries, fracs=fracs,
                               cold_compute=args.cold_compute)
    else:
        matrix = default_matrix(args.quick)
    with open(args.out, "a") as f:
        for t in matrix:
            print(f"== {t.name}", file=sys.stderr)
            r = run_treatment(t, device=args.device)
            f.write(json.dumps(asdict(r)) + "\n")
            f.flush()
            extra = (f" (hot {r.hot_fraction})" if r.hot_fraction is not None
                     else "")
            print(f"   {r.qps} qps{extra}", file=sys.stderr)


if __name__ == "__main__":
    main()
