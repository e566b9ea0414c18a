"""Host probe: can candidate-side block-max pruning of the semidense
route pass its guard? (The port's copy of wiser_tpu/tools/prune_probe.py;
the roadmap's "posting-block maxima + coarse doc-block range-max" lever.)

The semidense step's cost is L x (T-1) doc-indexed element gathers.
Compacting the candidate list to its top-C 128-lane posting blocks by
score upper bound would cut that to C*128 x (T-1), if the prune guard
(next_ub < the k-th kept score, the pruned dense scan's proof) passes
often enough. This measures the pass rate per workload class before any
kernel is built.

Three upper bounds per candidate posting block:
  oracle   the exact max total score in the block (if even this fails
           the guard, pruning is dead here);
  g128     the candidate block's max + each dense term's range-max over
           the block's doc span at 128-doc granularity;
  coarse   the same at 8192-doc granularity (the cheap masked max a
           kernel would run) + each non-dense (bs) term's global max.

Pure numpy over the PackedIndex: no device. One departure from the JAX
probe: the dense set is the engine's own (engine/device.py's
admit_dense_rows, which TorchEngine's dense tier calls), not a hand copy
of the admission rule; `dense=` takes an explicit mask instead.

History, a TPU-era record of the JAX probe (idx_c1m, 2026-08-18), not a
reading of this port: "DEAD END at this corpus shape" — every term with
df >= the dense floor was admitted, semidense candidates had <= 21
posting blocks, prunable_frac 0.0 at C=32; the question reopens where
the dense tier is budget-pruned (>= 20M docs). The card's readings are in
PERF.md.

Run: python -m wiser_tpu_torch.tools.prune_probe --index <dir> \
         [--n 200] [--C 32,64,128] [--k 10] [--columns tc]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


COARSE_DOCS = 8192  # 64 x 128-doc blocks per coarse cell
VARIANTS = ("oracle", "g128", "coarse")


class Probe:
    def __init__(self, packed, columns="tc", dense_budget_bytes=7 << 29,
                 dense: Optional[np.ndarray] = None):
        """dense: a (n_terms,) bool mask of the dense terms; by default
        the rows TorchEngine(packed, columns=columns,
        dense_budget_bytes=dense_budget_bytes) admits."""
        from wiser_tpu_torch.engine.device import admit_dense_rows
        from wiser_tpu_torch.scoring import Bm25Similarity

        self.packed = packed
        sim = Bm25Similarity(packed.avg_len)
        self.score32 = packed.partial_scores(sim.cache).astype(np.float32)
        if dense is None:
            dense = np.zeros(packed.n_terms, dtype=bool)
            dense[admit_dense_rows(packed, dense_budget_bytes, columns)] = True
        self.dense = np.asarray(dense, dtype=bool)
        n_pad = (packed.n_docs + 127) // 128 * 128
        self.n_pad = n_pad
        self.nb_docs = n_pad // 128
        self.ncoarse = (n_pad + COARSE_DOCS - 1) // COARSE_DOCS
        # per-term global max partial score (the bs-other bound)
        self.term_max = np.maximum.reduceat(
            self.score32, packed.term_starts[:-1].astype(np.int64))
        self._bm_cache: dict = {}

    def _blockmax(self, r):
        """(nb_docs,) 128-doc block max + (ncoarse,) coarse max of term r."""
        got = self._bm_cache.get(r)
        if got is not None:
            return got
        p = self.packed
        s, e = int(p.term_starts[r]), int(p.term_starts[r] + p.df[r])
        docs = p.postings_doc[s:e].astype(np.int64)
        sc = self.score32[s:e]
        bm = np.zeros(self.nb_docs, dtype=np.float32)
        np.maximum.at(bm, docs >> 7, sc)
        cm = np.zeros(self.ncoarse, dtype=np.float32)
        np.maximum.at(cm, docs // COARSE_DOCS, sc)
        if len(self._bm_cache) < 4096:
            self._bm_cache[r] = (bm, cm)
        return bm, cm

    def run_query(self, rows, k, Cs, eps3=3e-5):
        """({variant: {C: guard passes}}, stats) of one query's rows."""
        p = self.packed
        dfs = p.df[rows]
        cslot = int(np.argmin(dfs))
        crow = rows[cslot]
        s0 = int(p.term_starts[crow])
        Lr = int(p.df[crow])
        cd = p.postings_doc[s0 : s0 + Lr].astype(np.int64)
        cs = self.score32[s0 : s0 + Lr].astype(np.float64)
        others = [r for t, r in enumerate(rows) if t != cslot]

        total = cs.copy()
        match = np.ones(Lr, dtype=bool)
        for r in others:
            s, e = int(p.term_starts[r]), int(p.term_starts[r] + p.df[r])
            run = p.postings_doc[s:e]
            lo = np.searchsorted(run, cd)
            found = (lo < (e - s)) & (run[np.minimum(lo, e - s - 1)] == cd)
            contrib = np.where(found, self.score32[s + np.minimum(lo, e - s - 1)], 0.0)
            match &= found
            total += contrib
        mtotal = np.where(match, total, -np.inf)
        n_match = int(match.sum())

        nb = (Lr + 127) // 128
        pad = nb * 128 - Lr
        cd_p = np.pad(cd, (0, pad), constant_values=np.int64(2**31 - 1))
        cs_p = np.pad(cs, (0, pad), constant_values=-np.inf).reshape(nb, 128)
        mt_p = np.pad(mtotal, (0, pad), constant_values=-np.inf).reshape(nb, 128)
        valid = np.pad(np.ones(Lr, bool), (0, pad)).reshape(nb, 128)
        dmin = np.where(valid, cd_p.reshape(nb, 128), 2**31 - 1).min(axis=1)
        dmax = np.where(valid, cd_p.reshape(nb, 128), -1).max(axis=1)

        ub_oracle = mt_p.max(axis=1)
        cand_bm = np.where(valid, cs_p, -np.inf).max(axis=1)
        ub_g128 = cand_bm.copy()
        ub_coarse = cand_bm.copy()
        for r in others:
            if self.dense[r]:
                bm, cm = self._blockmax(r)
                blo, bhi = dmin >> 7, dmax >> 7
                clo, chi = dmin // COARSE_DOCS, dmax // COARSE_DOCS
                ub_g128 += np.array([bm[a : b + 1].max(initial=0.0)
                                     for a, b in zip(blo, bhi)])
                ub_coarse += np.array([cm[a : b + 1].max(initial=0.0)
                                       for a, b in zip(clo, chi)])
            else:
                tm = float(self.term_max[r])
                ub_g128 += tm
                ub_coarse += tm

        out = {}
        order_m = np.sort(mtotal)[::-1]
        for name, ub in zip(VARIANTS, (ub_oracle, ub_g128, ub_coarse)):
            res = {}
            srt = np.argsort(ub)[::-1]  # block ids by ub desc
            for C in Cs:
                if nb <= C:
                    res[C] = True  # nothing pruned; trivially exact
                    continue
                sel = srt[:C]
                next_ub = ub[srt[C]]
                exam = mt_p[sel].reshape(-1)
                exam = exam[np.isfinite(exam)]
                if len(exam) < k:
                    res[C] = bool(next_ub <= 0.0)
                    continue
                kth = np.sort(exam)[::-1][k - 1]
                res[C] = bool(next_ub < kth * (1.0 - eps3))
            out[name] = res
        return out, dict(Lr=Lr, nb=nb, n_match=n_match,
                         kth=(float(order_m[k - 1]) if n_match >= k
                              else None))


def build_classes(packed, probe, n, k, seed=3):
    """{class name: [query rows]}: mid-df candidates against one or two
    dense terms, tail candidates against a dense term, and df-Zipf 3- and
    4-term draws that would take semidense with a candidate of >= 4,096
    postings. A class the index cannot fill is left out."""
    rng = np.random.default_rng(seed)
    df = packed.df
    n_docs = packed.n_docs
    dense_rows = np.nonzero(probe.dense)[0]
    # mid-df candidates big enough that pruning matters (>= 32 blocks)
    mid = np.nonzero((df >= 4096) & (df < max(1024, n_docs // 384)))[0]
    tail = np.nonzero((df >= 256) & (df < 4096))[0]

    def pick(rows, m):
        return rows[rng.integers(0, len(rows), size=m)]

    classes = {}
    if len(mid) and len(dense_rows) >= 2:
        a = pick(mid, n)
        b, c = pick(dense_rows, n), pick(dense_rows, n)
        classes["midcand_x_2head_t3"] = [[x, y, z]
                                         for x, y, z in zip(a, b, c)]
        classes["midcand_x_head_t2"] = [[x, y] for x, y in zip(a, b)]
    if len(tail) and len(dense_rows):
        a, b = pick(tail, n), pick(dense_rows, n)
        classes["tail_x_head_t2"] = [[x, y] for x, y in zip(a, b)]
    order = np.argsort(df)[::-1].astype(np.int64)
    for nt in (3, 4):
        ranks = np.minimum(rng.zipf(1.25, size=(n * 3, nt)) - 1,
                           packed.n_terms - 1)
        rows_all = order[ranks]
        keep = []
        for rr in rows_all:
            rr = list(dict.fromkeys(int(x) for x in rr))
            if len(rr) < 2:
                continue
            cslot = int(np.argmin(df[rr]))
            others = [r for t, r in enumerate(rr) if t != cslot]
            if any(probe.dense[r] for r in others) \
                    and not all(probe.dense[r] for r in rr) \
                    and df[rr[cslot]] >= 4096:
                keep.append(rr)
            if len(keep) >= n:
                break
        if keep:
            classes[f"zipf_t{nt}_semidense_bigL"] = keep
    return classes


def report_classes(probe, classes, k, Cs) -> dict:
    """Per class: n, mean_blocks, prunable_frac (candidates with more
    than min(Cs) blocks) and each variant's pass rate per C."""
    report = {}
    for name, queries in classes.items():
        counts = {v: {C: 0 for C in Cs} for v in VARIANTS}
        prunable = 0
        tot_nb = 0
        for rows in queries:
            out, st = probe.run_query(rows, k, Cs)
            if st["nb"] > min(Cs):
                prunable += 1
            tot_nb += st["nb"]
            for v, res in out.items():
                for C, ok in res.items():
                    counts[v][C] += int(ok)
        nq = len(queries)
        report[name] = {
            "n": nq, "mean_blocks": round(tot_nb / max(nq, 1), 1),
            "prunable_frac": round(prunable / max(nq, 1), 3),
            "pass_rate": {v: {C: round(c / max(nq, 1), 3)
                              for C, c in cs.items()}
                          for v, cs in counts.items()},
        }
        log(f"{name}: {report[name]}")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--C", default="32,64,128")
    ap.add_argument("--columns", default="tc")
    args = ap.parse_args(argv)
    Cs = [int(x) for x in args.C.split(",")]

    from wiser_tpu_torch.index.format import PackedIndex

    packed = PackedIndex.load(args.index)
    probe = Probe(packed, columns=args.columns)
    log(f"index: {packed.n_docs} docs, {packed.n_terms} terms, "
        f"dense rows {int(probe.dense.sum())}")
    report = report_classes(probe, build_classes(packed, probe, args.n,
                                                 args.k), args.k, Cs)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
