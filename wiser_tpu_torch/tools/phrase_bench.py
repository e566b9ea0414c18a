"""The semidense phrase route's kernels, the list chain's and the compact
route's (ops/phrase_route.py, csrc/phrase_route.cu) held against their
plain torch versions (engine/kernels.semidense_phrase_torch,
list_phrase_torch, compact_phrase_body_torch) and timed beside them; and
the phrase route sets split by the route each query takes, on the
resident engine and on the mesh.

    python -m wiser_tpu_torch.tools.phrase_bench [--check-only] [--kinds K,..] [--out r.json]
    python -m wiser_tpu_torch.tools.phrase_bench --probe [--out r.json]
    python -m wiser_tpu_torch.tools.phrase_bench --tune-list [--out r.json]
    python -m wiser_tpu_torch.tools.phrase_bench --split --index IDX \
        [--sets phrase_mixed,phrase_mega] [--select-path one|two] --out r.json
    python -m wiser_tpu_torch.tools.phrase_bench --trees OLD,.,.,OLD \
        --index IDX [--sets S,..] [--mesh-sets S,..] [--kinds K,..] --out r.json

(on a card: the kernels build at first use). `semidense_phrase_cases`
and `list_phrase_cases` run raw and tc columns at T 2-4 over synthetic
columns with planted phrases (`synth_columns`, `phrase_batch`): ties
straddling the (KV+1)-th lane, fewer than KV + 1 matches, absent bloom
rows and an all-inactive probe set, PP larger than a bag, a bag holding
65,535, bags in no sorted order, every list case also without its gate
(on a card), a list group over a cluster's 8 segments with ties across
their edges and hundreds of verified lanes, and (SDP_EDGE_CASES) the
segmented selection's edges: B 1 over a cluster's 8 segments with ties
across their edges, B 8 at L 2,049, a recovery past its iteration
count; each packed (B, T+2, M) output must equal the plain version's
bit for bit. `compact_phrase_cases` runs COMPACT_CASES raw and tc, T
2-4 (ties straddling the (KV+1)-th place, fewer than KV + 1 survivors,
every lane gated out, a candidate run clamped at the column's end, no
active probe, searches stopped short of their count, B 1 over a
cluster's 8 segments) and COMPACT_LONG_CASES (a mesh shard's L
131,072 and 524,288): packed output and kept scores bit for bit; on a
card every list case also runs without its gate, its packed output held
against the plain chain with no probe and its kept scores against
phrase_body's.
`time_semidense_phrase`, `time_list_phrase`, `time_compact_phrase`
(COMPACT_TIME, COMPACT_ENGINE) and `time_list_nogate` (LIST_NOGATE_TIME)
time the
entry points at synthetic 1M shapes (the semidense phrase: B 128, T 2,
L 2,048 and 32,768, KV 1,024, and the engines' B 8 and 32 groups,
SDP_ENGINE; the list chain: the engines' B 8 and 128 groups at T 2-4, L
128-1,024, LIST_ENGINE, and B 1,024, LIST_TIME) in turns with the plain
versions (semidense_bench.time_pair: CUDA events, calls queued behind a
sleep, an L2-flushed reading, torch.profiler per launch, host µs, peak
memory above the inputs, the bytes bound). `--tune-list` forces the list
chain's segments a query at LIST_ENGINE (tune_list).

`--split` runs route_bench's phrase sets of a saved index (pairs from
`<index>/phrase_pairs.json`), raw and tc: one untraced pass records the
route each distinct query takes (`_dispatch_phrase`'s semidense, compact
and list branches, the mega routes, the host), then each route's
queries run alone as a set (route_bench.run_set, traced), so a set's
device ms splits by route; each phrase group's peak device memory above
its inputs is kept by route; `--select-path` forces the full-scan
selection's path for the run. The mesh's sets (`--mesh-sets`) split the
same way on a ShardedEngine of MESH_SHARDS shards on the card
(`mesh_split`, MeshRouteSpy: compact, list or host). `--trees` measures
each listed tree in its own process (tools/unpack_bench.run_trees): the
`--kinds` at the timed shapes, then, with `--index`, the splits.
`--probe` reads the semidense phrase route's and the list chain's phase
cycles from a measuring build (clock64() marks, csrc/clocks.cuh;
tools/dense_bench.clocks_build, phase_split; LIST_GROUPS).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

SECTOR = 32
SETS = ("phrase_mixed", "phrase_mega")
ROUTE_KEYS = ("phrase_semidense", "phrase_compact", "phrase_list", "mega",
              "host")
SPLIT_N = 2048


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- the route split ---------------------------------------------------------


class RouteSpy:
    """While installed on an engine (`with RouteSpy(eng) as spy:`),
    records the route of every phrase query the engine dispatches (keyed
    by (terms, k)) and each phrase group's peak device memory above its
    inputs, by route."""

    def __init__(self, eng):
        self.eng = eng
        self.route = {}
        self.peaks = {k: 0 for k in ROUTE_KEYS}
        self.groups = {k: 0 for k in ROUTE_KEYS}

    @staticmethod
    def key(q):
        return (tuple(q.terms), int(q.n_results))

    def _measured(self, kind, fn):
        import torch

        def run(*args, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.peaks[kind] = max(self.peaks[kind], int(
                torch.cuda.max_memory_allocated() - before))
            return out
        return run

    def __enter__(self):
        eng = self.eng
        dispatch, mega, host = (eng._dispatch_phrase, eng._submit_mega_phrase,
                                eng._run_host_phrases)
        KV = eng.PRUNED_PHRASE_KV

        def dispatch_rec(group, T, L, PP, PW, sd):
            kind = ("phrase_semidense" if sd else
                    "phrase_compact" if L > KV else "phrase_list")
            for pq in group:
                self.route[self.key(pq.query)] = kind
            self.groups[kind] += 1
            return self._measured(kind, dispatch)(group, T, L, PP, PW, sd)

        def mega_rec(planned, rq):
            for pq in planned:
                self.route[self.key(pq.query)] = "mega"
            self.groups["mega"] += 1
            return self._measured("mega", mega)(planned, rq)

        def host_rec(group):
            for pq in group:
                self.route[self.key(pq.query)] = "host"
            self.groups["host"] += 1
            return host(group)

        eng._dispatch_phrase = dispatch_rec
        eng._submit_mega_phrase = mega_rec
        eng._run_host_phrases = host_rec
        return self

    def __exit__(self, *exc):
        for name in ("_dispatch_phrase", "_submit_mega_phrase",
                     "_run_host_phrases"):
            del self.eng.__dict__[name]
        return False


class MeshRouteSpy(RouteSpy):
    """RouteSpy on a ShardedEngine: its phrase groups take the compact or
    the list route (`_dispatch_phrase`), or the exact host search
    (`_run_host` of phrases)."""

    def __enter__(self):
        eng = self.eng
        dispatch, host = eng._dispatch_phrase, eng._run_host

        def dispatch_rec(group, T, L, PP, PW, compact):
            kind = "phrase_compact" if compact else "phrase_list"
            for pq in group:
                self.route[self.key(pq.query)] = kind
            self.groups[kind] += 1
            return self._measured(kind, dispatch)(group, T, L, PP, PW,
                                                  compact)

        def host_rec(group, is_phrase):
            if is_phrase:
                for pq in group:
                    self.route[self.key(pq.query)] = "host"
                self.groups["host"] += 1
            return host(group, is_phrase)

        eng._dispatch_phrase = dispatch_rec
        eng._run_host = host_rec
        return self

    def __exit__(self, *exc):
        for name in ("_dispatch_phrase", "_run_host"):
            del self.eng.__dict__[name]
        return False


def split_set(eng, queries, batch: int = 2048, spy_cls=RouteSpy) -> dict:
    """One set's device ms split by route: a pass under `spy_cls` (routes
    and group peaks), the whole set by route_bench.run_set (traced), then
    each route's queries alone, traced."""
    import torch

    from wiser_tpu_torch.tools import route_bench as RB

    eng.clear_result_memos()
    with spy_cls(eng) as spy:
        eng.search_batch(queries)
    eng.stats_take()
    out = {"queries": len(queries), "group_peak_bytes": spy.peaks,
           "groups": spy.groups}
    with tempfile.TemporaryDirectory() as tmp:
        out["all"] = RB.run_set(eng, queries, batch, trace_dir=tmp)
    by = {}
    for q in queries:
        by.setdefault(spy.route.get(RouteSpy.key(q), "unrouted"), []).append(q)
    out["routes"] = {}
    for kind, qs in sorted(by.items()):
        with tempfile.TemporaryDirectory() as tmp:
            row = RB.run_set(eng, qs, batch, trace_dir=tmp)
        row["queries"] = len(qs)
        out["routes"][kind] = row
        log(f"  {kind}: {len(qs)} queries, device ms "
            f"{(row.get('traced') or {}).get('device_busy_ms')}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def route_split(index: str, columns: str, sets=SETS, n: int = SPLIT_N):
    """route_bench's phrase sets of a saved index on a TorchEngine of
    these columns, each split by route (split_set)."""
    import torch

    from wiser_tpu_torch import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import route_bench as RB

    packed = PackedIndex.load(index, skip_offsets=True)
    eng = TorchEngine(packed, device="cuda", columns=columns)
    with open(os.path.join(index, "phrase_pairs.json")) as f:
        pairs = [tuple(x) for x in json.load(f)]
    all_sets = RB.build_phrase_route_sets(packed, eng, None, n, 10,
                                          pairs=pairs)
    out = {}
    for name in sets:
        if not all_sets.get(name):
            continue
        log(f"== {columns} {name}")
        out[name] = split_set(eng, all_sets[name])
    del eng
    torch.cuda.empty_cache()
    return out


MESH_SHARDS = 4  # the chip smoke's mesh: four shards on one card
MESH_SETS = ("phrase_list", "phrase_mixed", "phrase_mega")


def mesh_split(index: str, columns: str, sets=MESH_SETS, n: int = SPLIT_N,
               shards: int = MESH_SHARDS, devices=None):
    """route_bench's phrase sets of a saved index on a ShardedEngine of
    these columns (`shards` shards, by default all on the card, as the
    chip smoke's mesh phase runs them; `devices` a device a shard), each
    split by the route each query takes on the mesh (MeshRouteSpy:
    compact, list or host)."""
    import torch

    from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
    from wiser_tpu_torch.index.format import PackedIndex
    from wiser_tpu_torch.tools import route_bench as RB

    packed = PackedIndex.load(index, skip_offsets=True)
    eng = ShardedEngine(ShardedIndex.from_packed(packed, shards),
                        devices=devices, columns=columns)
    with open(os.path.join(index, "phrase_pairs.json")) as f:
        pairs = [tuple(x) for x in json.load(f)]
    all_sets = RB.build_phrase_route_sets(packed, eng, None, n, 10,
                                          pairs=pairs)
    out = {}
    for name in sets:
        if not all_sets.get(name):
            continue
        log(f"== mesh {columns} {name}")
        out[name] = split_set(eng, all_sets[name], spy_cls=MeshRouteSpy)
    del eng
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def split_summary(split: dict) -> dict:
    """{columns_set: {"all": device ms, route: [queries, device ms],
    "peak": {route: bytes}}}."""
    res = {}
    for columns, sets in split.items():
        for name, s in sets.items():
            dm = lambda row: (row.get("traced") or {}).get("device_busy_ms")
            res[f"{columns}_{name}"] = {
                "all": [s["queries"], dm(s["all"]), s["all"]["wall_s"]],
                **{k: [r["queries"], dm(r), r["wall_s"]]
                   for k, r in s["routes"].items()},
                "peak": s["group_peak_bytes"]}
    return res


# -- synthetic columns ---------------------------------------------------------

POS_PAD = 1024  # the engine's trailing pad of the positions column


def synth_columns(seed: int, n_docs: int, dfs, *, n_cands: int = 1,
                  max_tf: int = 4, tie: bool = False, plant: float = 0.4,
                  sorted_bags: bool = False, pos65535: bool = True) -> dict:
    """A small index as host columns (numpy, the engine's host dtypes).
    Terms 0..n_cands-1 are candidates of df dfs[0] each, the later terms
    heads of dfs[1:]; every term's run is a sorted random doc set. Per
    posting a tf in 1..max_tf and as many positions (random, so in no
    sorted order unless `sorted_bags`). A doc holding a candidate and
    heads 1..j is, with probability `plant`, given a phrase at some x: each
    candidate's first position x, head i's x + i (so the query
    (candidate, head 1, ..., head T-1) matches there); with `pos65535` the
    deepest such doc's phrase ends at 65,535. raw scores are random f32
    (with `tie`, three values, so AND scores tie); tc lanes carry random
    len codes and tf bytes (2% saturated at 255); the dense planes hold
    the heads' rows (score, tf, tf byte); the bloom columns are random
    (bitmap bits 85% set, rows mostly all ones)."""
    rng = np.random.default_rng(seed)
    all_dfs = [int(dfs[0])] * n_cands + [int(d) for d in dfs[1:]]
    nh = len(dfs) - 1
    runs = [np.sort(rng.choice(n_docs, size=df, replace=False)).astype(
        np.int32) for df in all_dfs]
    has_cand = np.zeros(n_docs, dtype=bool)
    for r in runs[:n_cands]:
        has_cand[r] = True
    depth = np.zeros(n_docs, dtype=np.int64)  # heads 1..depth in the doc
    chain = has_cand.copy()
    for r in runs[n_cands:]:
        m = np.zeros(n_docs, dtype=bool)
        m[r] = True
        chain &= m
        depth += chain
    planted = has_cand & (depth >= 1) & (rng.random(n_docs) < plant)
    x = rng.integers(0, 60000, size=n_docs)
    if pos65535 and planted.any():
        d = int(np.argmax(np.where(planted, depth, -1)))
        x[d] = 65535 - depth[d]
    doc = np.concatenate(runs)
    term = np.repeat(np.arange(len(runs)), all_dfs)
    P = len(doc)
    tf = rng.integers(1, max_tf + 1, size=P).astype(np.int32)
    pos_starts = np.zeros(P + 1, dtype=np.int32)
    pos_starts[1:] = np.cumsum(tf)
    pos = rng.integers(0, 60000, size=int(pos_starts[-1]))
    head_i = np.where(term >= n_cands, term - n_cands + 1, 0)
    hit = planted[doc] & (head_i <= depth[doc])
    pos[pos_starts[:-1][hit]] = x[doc[hit]] + head_i[hit]
    if sorted_bags:
        owner = np.repeat(np.arange(P), tf)
        pos = pos[np.lexsort((pos, owner))]
    positions = np.concatenate([pos, np.full(POS_PAD, 65535)]).astype(
        np.uint16)
    if tie:
        score = rng.choice(np.float32([0.5, 1.0, 1.5]), size=P)
    else:
        score = (rng.random(P) * 2 + 0.1).astype(np.float32)
    code = rng.integers(0, 232, size=n_docs)
    tfb = np.minimum(tf, 254)
    tfb[rng.random(P) < 0.02] = 255
    tc = ((code[doc] << 8) | tfb).astype(np.uint16)
    term_starts = np.concatenate([[0], np.cumsum(all_dfs)]).astype(np.int64)
    n_pad = -(-n_docs // 128) * 128
    dense_sc = np.zeros((max(nh, 1), n_pad), dtype=np.float32)
    dense_tf = np.zeros((max(nh, 1), n_pad), dtype=np.int32)
    dense_tf8 = np.zeros((max(nh, 1), n_pad), dtype=np.uint8)
    for h in range(nh):
        a, b = term_starts[n_cands + h], term_starts[n_cands + h + 1]
        dense_sc[h, doc[a:b]] = score[a:b]
        dense_tf[h, doc[a:b]] = tf[a:b]
        dense_tf8[h, doc[a:b]] = tfb[a:b]
    Pw = -(-P // 32)
    bitmap = np.zeros(2 * Pw, dtype=np.uint32)
    for i in range(32):
        bitmap |= (rng.random(2 * Pw) < 0.85).astype(np.uint32) << np.uint32(i)
    pop = np.unpackbits(bitmap.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    rank = np.concatenate([[0], np.cumsum(pop)[:-1]]).astype(np.int32)
    nnz = max(1, int(pop.sum()))
    rows = np.full(nnz, 0xFFFFFFFF, dtype=np.uint32)
    some = rng.random(nnz) < 0.2
    rows[some] = rng.integers(0, 2**32, size=int(some.sum()),
                              dtype=np.uint64).astype(np.uint32)
    return {"doc": doc.astype(np.int32), "score": score, "tf": tf, "tc": tc,
            "positions": positions, "pos_starts": pos_starts,
            "term_starts": term_starts,
            "dfs": np.asarray(all_dfs, dtype=np.int64), "n_cands": n_cands,
            "dense_sc": dense_sc, "dense_tf": dense_tf,
            "dense_tf8": dense_tf8,
            "avg32": np.float32([np.float32(rng.random() * 100 + 20)]),
            "bloom_rows": rows, "bloom_bitmap": bitmap, "bloom_rank": rank,
            "n_docs": n_docs, "max_tf": int(tf.max())}


def phrase_batch(cols: dict, B: int, T: int, M: int, seed: int, *,
                 in_order: float = 0.7, probes_off: bool = False) -> dict:
    """A group of B phrase queries of T terms over synth_columns: a
    candidate (slot 0) and T - 1 heads; with probability `in_order` the
    query is (candidate, head 1, ..., head T-1) (the planted phrase),
    else the candidate and T - 1 random heads in a shuffled order. Slot
    order: the candidate, then the heads in query order. raw weights
    use_score 1; tc weights random idf32; slots name the heads' dense
    rows; ks in 1..M; bloom probes as the engine assembles them (C = T -
    1 a query: the probed slot, the side, a folded mask of up to 3 bits,
    active or not; `probes_off`: none active), and query 0 with no
    active probe."""
    rng = np.random.default_rng(seed)
    nc = cols["n_cands"]
    ts, dfs = cols["term_starts"], cols["dfs"]
    nh = len(dfs) - nc
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    idf = np.zeros((B, T), dtype=np.float32)
    slots = np.zeros((B, T), dtype=np.int32)
    slot_of = np.zeros((B, T), dtype=np.int32)
    for b in range(B):
        c = int(rng.integers(nc))
        if rng.random() < in_order:
            q = [c] + [nc + h for h in range(T - 1)]
        else:
            q = [c] + [nc + int(h) for h in rng.choice(nh, size=T - 1,
                                                        replace=False)]
            rng.shuffle(q)
        slot_terms = [c] + [t for t in q if t != c]
        for s, t in enumerate(slot_terms):
            starts[b, s] = ts[t]
            ends[b, s] = ts[t] + dfs[t]
            slots[b, s] = max(0, t - nc)
            use[b, s] = 1.0
            idf[b, s] = np.float32(rng.random() * 4 + 0.5)
        for i, t in enumerate(q):
            slot_of[b, i] = slot_terms.index(t)
    C = T - 1
    probe_slot = rng.integers(0, T, size=(B, C)).astype(np.int32)
    probe_begins = rng.random((B, C)) < 0.5
    masks = np.zeros((B, C), dtype=np.uint32)
    for _ in range(3):
        bit = np.uint32(1) << rng.integers(0, 32, size=(B, C)).astype(
            np.uint32)
        masks |= bit * (rng.random((B, C)) < 0.7).astype(np.uint32)
    probe_active = (rng.random((B, C)) < 0.8) & (not probes_off)
    probe_active[0] = False
    return {"starts": starts, "ends": ends, "use": use, "idf": idf,
            "slots": slots, "slot_of": slot_of,
            "ks": rng.integers(1, M + 1, size=B).astype(np.int32),
            "probe_slot": probe_slot, "probe_begins": probe_begins,
            "probe_mask": masks, "probe_active": probe_active}


def to_torch(a, dev):
    """numpy -> torch on dev; unsigned columns travel as their signed
    bits, as the engine holds them on the device."""
    import torch

    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def semidense_args(cols: dict, batch: dict, mode: str, dev):
    """(args, kw) of kernels.semidense_phrase_body on dev (kw lacks the
    shapes)."""
    t = lambda k, src=cols: to_torch(src[k], dev)
    if mode == "tc":
        head = (t("doc"), t("tc"), t("dense_tf8"))
        kw = {"avg32": t("avg32")}
    else:
        head = (t("doc"), t("score"), t("dense_sc"))
        kw = {"postings_tf": t("tf")}
    args = head + (t("positions"), t("pos_starts"), t("starts", batch),
                   t("ends", batch), t("idf" if mode == "tc" else "use",
                                        batch),
                   t("slots", batch), t("slot_of", batch), t("ks", batch))
    return args, kw


def compact_args(cols: dict, batch: dict, mode: str, dev):
    """(args, kw) of kernels.compact_phrase_body on dev (kw lacks the
    shapes)."""
    t = lambda k, src=cols: to_torch(src[k], dev)
    if mode == "tc":
        head, kw = (t("doc"), t("tc"), None), {"tc_mode": True,
                                               "avg32": t("avg32")}
    else:
        head, kw = (t("doc"), t("score"), t("tf")), {}
    args = head + (t("positions"), t("pos_starts"), t("starts", batch),
                   t("ends", batch), t("idf" if mode == "tc" else "use",
                                       batch),
                   t("slot_of", batch), t("ks", batch), t("bloom_rows"),
                   t("bloom_bitmap"), t("bloom_rank"), t("probe_slot", batch),
                   t("probe_begins", batch), t("probe_mask", batch),
                   t("probe_active", batch))
    return args, kw


def list_args(cols: dict, batch: dict, mode: str, dev):
    """(args, kw) of kernels.list_phrase on dev (kw lacks the shapes)."""
    t = lambda k, src=cols: to_torch(src[k], dev)
    if mode == "tc":
        col, kw = t("tc"), {"avg32": t("avg32")}
    else:
        col, kw = t("score"), {"postings_tf": t("tf")}
    args = (t("doc"), col, t("positions"), t("pos_starts"),
            t("starts", batch), t("ends", batch),
            t("idf" if mode == "tc" else "use", batch), t("slot_of", batch),
            t("bloom_rows"), t("bloom_bitmap"), t("bloom_rank"),
            t("probe_slot", batch), t("probe_begins", batch),
            t("probe_mask", batch), t("probe_active", batch))
    return args, kw


def _iters(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, int(n) + 1)))))


# (name, seed, n_docs, dfs, B, T, L, KV, PP, PW, M, tie, sorted bags): the
# semidense phrase cases. KV 4-64 over thousands of candidates straddles
# ties at the (KV+1)-th lane; KV 1,024 leaves fewer than KV + 1 matches.
SDP_CASES = (
    ("ties_kv4", 1, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 4, 8, 8, 4,
     True, False),
    ("ties_kv16_t3", 2, 4096, (1900, 3000, 2600, 2200), 8, 3, 2048, 16, 8, 8,
     8, True, False),
    ("ties_kv64_t4", 3, 4096, (1900, 3000, 2600, 2200), 8, 4, 2048, 64, 8,
     16, 16, True, True),
    ("short_kv1024", 4, 4096, (1500, 2000, 1800, 1700), 8, 2, 2048, 1024, 4,
     8, 24, False, False),
    ("short_kv1024_t3", 5, 4096, (1500, 2600, 2000, 1700), 8, 3, 2048, 1024,
     8, 8, 24, False, False),
    ("pp_over_bags_t2", 6, 4096, (1900, 3500, 2600, 2200), 16, 2, 2048, 256,
     32, 32, 12, False, False),
    ("long_l", 7, 40000, (30000, 36000, 33000, 31000), 4, 2, 32768, 1024, 8,
     8, 12, False, False),
)
# the segmented selection's edges (csrc/segsel.cuh), in the same form: B
# 1 over 8,192 lanes (8 segments of one cluster, ties straddling their
# edges), B 8 at L 2,049 (a unit past a segment), a run searched past
# its iteration count (SDP_ITERS: the recovery's replay)
SDP_EDGE_CASES = (
    ("b1_segments_ties", 28, 16384, (8000, 12000, 10000, 9000), 1, 2, 8192,
     64, 8, 8, 16, True, False),
    ("b8_l2049_t3", 9, 8192, (2040, 5000, 4000, 3000), 8, 3, 2049, 128, 8,
     8, 16, True, False),
    ("past_iters", 10, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 256, 8,
     8, 12, False, False),
)
SDP_ITERS = {"past_iters": 10}  # below the head runs' ceil(log2(df + 1))
# the list chain's: (name, seed, n_docs, dfs, B, T, L, PP, M, tie, probes
# off, sorted bags)
LIST_CASES = (
    ("ties_t2", 11, 4096, (900, 3000, 2600, 2200), 16, 2, 1024, 8, 8, True,
     False, False),
    ("t3", 12, 4096, (900, 3000, 2600, 2200), 16, 3, 1024, 8, 16, False,
     False, False),
    ("t4", 13, 4096, (700, 3000, 2600, 2200), 8, 4, 1024, 8, 16, False,
     False, True),
    ("no_probes", 14, 4096, (900, 3000, 2600, 2200), 8, 2, 1024, 8, 8, False,
     True, False),
    ("pp_over_bags", 15, 4096, (100, 3000, 2600, 2200), 8, 2, 128, 32, 10,
     False, False, False),
    ("short_l", 16, 2048, (60, 1500, 1200, 900), 8, 3, 128, 4, 64, True,
     False, False),
    # B 2 over a cluster's 8 segments, quantized scores tied across their
    # edges, hundreds of verified lanes (the top M cut by the radix
    # select past 256 keys)
    ("many_verified", 17, 4096, (1000, 4000, 3900, 3800), 2, 2, 1024, 8, 16,
     True, True, True),
)


# the compact route's: (name, seed, n_docs, dfs, B, T, L, KV, PP, PW, M,
# tie, sorted bags, edge). KV 4-64 over thousands of candidates with
# quantized scores straddles ties at the (KV+1)-th lane; KV 1,024 leaves
# fewer than KV + 1 survivors; the edges: "gate_all" (every bloom row
# empty and every probe active but query 0's: every such lane gated out),
# "clamp" (query 1's candidate run is the column's last, so its L-lane
# slice clamps at the column's end), "probes_off" (no active probe),
# "iters" (the searches stop COMPACT_SHORT_ITERS halvings short of the
# longest run's count, so the recovery replays the fixed-count search);
# B 1 over a cluster's 8 segments with ties across their edges; T 2-4;
# tc tf bytes of 255 in every case (synth_columns)
COMPACT_CASES = (
    ("ties_kv4", 41, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 4, 8, 8, 4,
     True, False, None),
    ("ties_kv16_t3", 42, 4096, (1900, 3000, 2600, 2200), 8, 3, 2048, 16, 8,
     8, 8, True, False, None),
    ("ties_kv64_t4", 43, 4096, (1900, 3000, 2600, 2200), 8, 4, 2048, 64, 8,
     16, 16, True, True, None),
    ("short_kv1024", 44, 4096, (1500, 2000, 1800, 1700), 8, 2, 2048, 1024,
     4, 8, 24, False, False, None),
    ("short_kv1024_t3", 45, 4096, (1500, 2600, 2000, 1700), 8, 3, 2048,
     1024, 8, 8, 24, False, False, None),
    ("gated_out", 46, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 64, 8, 8,
     8, False, False, "gate_all"),
    ("clamped_t3", 47, 4096, (1900, 3000, 2600, 2200), 8, 3, 4096, 256, 8,
     8, 16, False, False, "clamp"),
    ("probes_off", 48, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 128, 8,
     8, 8, True, False, "probes_off"),
    ("past_iters", 49, 4096, (1900, 3000, 2600, 2200), 8, 2, 2048, 256, 8,
     8, 12, False, False, "iters"),
    ("b1_segments_ties", 50, 16384, (8000, 12000, 10000, 9000), 1, 2, 8192,
     64, 8, 8, 16, True, False, None),
)
# a mesh shard's long lanes (many steps a segment), on a card only: L
# 131,072, and the mesh's most common compact group, B 8 T 2 at L 524,288
COMPACT_LONG_CASES = (
    ("mesh_l131072", 51, 300_000, (140_000, 200_000, 180_000), 8, 2, 131072,
     1024, 8, 8, 64, False, False, None),
    ("mesh_l524288", 52, 1_200_000, (560_000, 800_000), 8, 2, 524288, 1024,
     8, 8, 64, False, False, None),
)
COMPACT_SHORT_ITERS = 3  # "iters": halvings short of ceil(log2(df + 1))


def compact_inputs(case):
    """(cols, batch, shapes kw) of one COMPACT_CASES case, its edge
    applied."""
    (name, seed, n_docs, dfs, B, T, L, KV, PP, PW, M, tie, sb, edge) = case
    cols = synth_columns(seed, n_docs, dfs, tie=tie, sorted_bags=sb)
    batch = phrase_batch(cols, B, T, M, seed + 100,
                         probes_off=edge == "probes_off")
    if edge == "gate_all":
        cols["bloom_rows"] = np.zeros_like(cols["bloom_rows"])
        batch["probe_mask"] |= np.uint32(1)
        batch["probe_active"][1:] = True
    if edge == "clamp":
        last = len(cols["dfs"]) - 1
        batch["starts"][1, 0] = cols["term_starts"][last]
        batch["ends"][1, 0] = cols["term_starts"][last] + cols["dfs"][last]
    kw = dict(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M,
              n_bs_iters=_iters(max(dfs)) - (COMPACT_SHORT_ITERS
                                             if edge == "iters" else 0),
              eps3=3e-6)
    return cols, batch, kw


def compact_case(case, mode: str, dev):
    """(args, kw) of one COMPACT_CASES case, shapes included."""
    cols, batch, shapes = compact_inputs(case)
    args, kw = compact_args(cols, batch, mode, dev)
    kw.update(shapes, eps3=3e-6 if mode == "raw" else 3e-5)
    return args, kw


def semidense_case(case, mode: str, dev):
    """(args, kw) of one SDP_CASES case, shapes included."""
    (_, seed, n_docs, dfs, B, T, L, KV, PP, PW, M, tie, sb) = case
    cols = synth_columns(seed, n_docs, dfs, tie=tie, sorted_bags=sb)
    batch = phrase_batch(cols, B, T, M, seed + 100)
    args, kw = semidense_args(cols, batch, mode, dev)
    kw.update(T=T, L=L, KV=KV, PP=PP, PW=PW, M=M,
              n_rec_iters=SDP_ITERS.get(case[0], _iters(max(dfs))),
              eps3=3e-6 if mode == "raw" else 3e-5)
    return args, kw


def list_case(case, mode: str, dev):
    """(args, kw) of one LIST_CASES case, shapes included."""
    (_, seed, n_docs, dfs, B, T, L, PP, M, tie, off, sb) = case
    cols = synth_columns(seed, n_docs, dfs, tie=tie, sorted_bags=sb)
    batch = phrase_batch(cols, B, T, M, seed + 100, probes_off=off)
    args, kw = list_args(cols, batch, mode, dev)
    kw.update(T=T, L=L, PP=PP, M=M, n_bs_iters=_iters(max(dfs)),
              n_pos_iters=_iters(cols["max_tf"]))
    return args, kw


def _summary(got, want, what: str) -> dict:
    """Bit-equality of two packed outputs, or of two (packed, top_score)
    pairs, the scores' bits too (raises where they differ)."""
    if isinstance(got, tuple):
        import torch

        gs = got[1].cpu().contiguous().view(torch.int32).numpy()
        ws = want[1].cpu().contiguous().view(torch.int32).numpy()
        if gs.shape != ws.shape or not np.array_equal(gs, ws):
            raise AssertionError(f"{what}: the kernel's top scores differ "
                                 f"from the plain version's")
        got, want = got[0], want[0]
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(g, w):
        bad = np.nonzero((g != w).reshape(g.shape[0], -1).any(axis=1))[0] \
            if g.shape == w.shape else "shape"
        raise AssertionError(f"{what}: the kernel's packed output differs "
                             f"from the plain version's (rows {bad})")
    T = g.shape[1] - 2
    return {"kept": int((g[:, 0] >= 0).sum()),
            "flags": sorted({int(f) for f in g[:, T + 1, 0]})}


def semidense_phrase_cases(dev, modes=("raw", "tc")) -> dict:
    """Every SDP_CASES and SDP_EDGE_CASES case, raw and tc: the kernels'
    packed output equal to the plain version's bit for bit."""
    from wiser_tpu_torch.engine import kernels as K

    rows = []
    for case in SDP_CASES + SDP_EDGE_CASES:
        for mode in modes:
            args, kw = semidense_case(case, mode, dev)
            row = {"case": case[0], "mode": mode}
            row.update(_summary(K.semidense_phrase_body(*args, **kw),
                                K.semidense_phrase_torch(*args, **kw),
                                f"semidense phrase {row}"))
            rows.append(row)
    return {"cases": len(rows), "rows": rows}


def list_phrase_cases(dev, modes=("raw", "tc")) -> dict:
    """Every LIST_CASES case, raw and tc: the kernel's packed output equal
    to the plain version's bit for bit; on a card each also by the
    gate-off kernel against the plain version with every probe
    inactive."""
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import phrase_route as R

    rows = []
    for case in LIST_CASES:
        for mode in modes:
            args, kw = list_case(case, mode, dev)
            row = {"case": case[0], "mode": mode}
            row.update(_summary(K.list_phrase(*args, **kw),
                                K.list_phrase_torch(*args, **kw),
                                f"list phrase {row}"))
            rows.append(row)
            if dev.type == "cuda":
                r2 = {"case": f"{case[0]}_gate_off", "mode": mode}
                r2.update(_summary(R.list_phrase(*args, gate=False, **kw),
                                   gate_off_plain(args, kw),
                                   f"list phrase {r2}"))
                rows.append(r2)
    return {"cases": len(rows), "rows": rows}


def no_probes(args, B: int):
    """The list chain's bloom and probe arguments with no probe (C 0):
    the plain version's gate passes every lane."""
    import torch

    dev = args[0].device
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    e = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    b = torch.zeros((B, 0), dtype=torch.bool, device=dev)
    return (z[:1], z, z, e, b, e, b)


def gate_off_plain(args, kw):
    """The gate-off list chain's plain version, (packed, top_score): the
    packed output of list_phrase_torch with no probe (lanes tied by
    ascending lane, as the kernel keeps them) and phrase_body's top
    scores (the bloomless pipeline the mesh's merge reads)."""
    from wiser_tpu_torch.engine import kernels as K

    kw = {k: v for k, v in kw.items() if k != "gate"}
    return (K.list_phrase_torch(*args[:8], *no_probes(args, args[4].shape[0]),
                                **kw), phrase_body_scores(args, kw))


def phrase_body_scores(args, kw):
    """kernels.phrase_body's top_score on the list chain's arguments (the
    bloomless pipeline the mesh's list route ran in torch)."""
    from wiser_tpu_torch.engine import kernels as K

    tc = kw.get("avg32") is not None
    _, score = K.phrase_body(
        args[0], None if tc else args[1], kw.get("postings_tf"), args[2],
        args[3], args[4], args[5], None if tc else args[6], args[7],
        tc=args[1] if tc else None, idf32=args[6] if tc else None,
        avg32=kw.get("avg32"),
        **{k: kw[k] for k in ("T", "L", "PP", "M", "n_bs_iters",
                              "n_pos_iters")})
    return score


def compact_phrase_cases(dev, modes=("raw", "tc"), long: bool = True) -> dict:
    """Every COMPACT_CASES case (and, with `long`, COMPACT_LONG_CASES),
    raw and tc: the kernels' packed output and top scores equal to the
    plain version's (compact_phrase_body_torch) bit for bit."""
    from wiser_tpu_torch.engine import kernels as K

    rows = []
    for case in COMPACT_CASES + (COMPACT_LONG_CASES if long else ()):
        for mode in modes:
            args, kw = compact_case(case, mode, dev)
            row = {"case": case[0], "mode": mode}
            row.update(_summary(K.compact_phrase_body(*args, **kw),
                                K.compact_phrase_body_torch(*args, **kw),
                                f"compact phrase {row}"))
            rows.append(row)
    return {"cases": len(rows), "rows": rows}


# -- bounds and timing ------------------------------------------------------------


def semidense_bound_bytes(args, kw) -> int:
    """The least bytes the semidense phrase route must move on these
    inputs: the candidate slices (8 B a valid lane raw, 6 tc), the
    distinct 32-byte sectors of the dense rows the valid lanes' docs
    touch (4 B a lane raw, 1 tc), the K keys, and for each kept matched
    lane (at most KV a query) a sector of each searched run, of
    pos_starts and of each bag; the packed output."""
    import torch

    doc, col, dense = args[0], args[1], args[2]
    starts, ends, slots = args[5], args[6], args[8]
    T, L, KV, M = kw["T"], kw["L"], kw["KV"], kw["M"]
    tc = kw.get("avg32") is not None
    B = starts.shape[0]
    lane = torch.arange(L, device=doc.device)
    cs = starts[:, 0].long()
    nv = (ends[:, 0].long() - cs).clamp(0, L)
    valid = lane[None, :] < nv[:, None]
    s = cs.clamp(0, max(0, doc.shape[0] - L))
    cdoc = doc[(s[:, None] + lane[None, :]).clamp(max=doc.shape[0] - 1)].long()
    cdoc = cdoc.clamp(0, dense.shape[1] - 1)
    eb = 1 if tc else 4
    match = valid.clone()
    sectors = 0
    for t in range(1, T):
        row = slots[:, t].long()[:, None]
        key = (row * dense.shape[1] + cdoc) * eb // SECTOR
        sectors += int(torch.unique(key[valid]).numel())
        match &= dense[row.expand(-1, L), cdoc] > 0
    kept = int(match.sum(dim=1).clamp(max=KV).sum())
    return (int(nv.sum()) * (6 if tc else 8) + sectors * SECTOR
            + B * (KV + 1) * 8 + kept * (3 * T - 1) * SECTOR
            + B * (T + 2) * M * 4)


def list_bound_bytes(args, kw) -> int:
    """The least bytes the list chain must move on these inputs: the
    candidate slices (8 B a valid lane raw, 6 tc), each searched slot's
    run or a sector a lane still searching it where that is fewer, 12 B
    (bloom word, rank and row) a (matched lane, active probe), a sector
    of pos_starts and of each bag of every lane the gate passes, and the
    packed output (without the gate, the kept scores too). The lanes and
    their survival are the plain version's."""
    import torch

    from wiser_tpu_torch.engine import kernels as K

    doc, col = args[0], args[1]
    starts, ends, w = args[4], args[5], args[6]
    T, L, M = kw["T"], kw["L"], kw["M"]
    avg32 = kw.get("avg32")
    cdocs, _, cvalid, _ = K._candidates(doc, col, starts, ends, L)
    _, found, _, _ = K._others(doc, col, cdocs, starts[:, 1:], ends[:, 1:],
                               kw["n_bs_iters"], weights=w[:, 1:],
                               avg32=avg32)
    _, match, pidx, _, _ = K._match_step(doc, col, starts, ends, w, T=T,
                                         L=L, n_bs_iters=kw["n_bs_iters"],
                                         avg32=avg32)
    gate = args[8] is not None and kw.get("gate", True)
    active = match & K._bloom_gate(pidx, *args[8:15]) if gate else match
    alive = cvalid.clone()
    total = int(cvalid.sum()) * (6 if avg32 is not None else 8)
    for t in range(1, T):
        run = (ends[:, t] - starts[:, t]).long().clamp(min=0) * 4
        total += int(torch.minimum(run, alive.sum(dim=1) * SECTOR).sum())
        alive &= found[:, t - 1]
    if gate:
        total += int((match.sum(dim=1) * args[14].sum(dim=1)).sum()) * 12
    total += int(active.sum()) * T * 2 * SECTOR
    kept_scores = 0 if kw.get("gate", True) else 4 * M
    return total + starts.shape[0] * ((T + 2) * M * 4 + kept_scores)


def compact_bound_bytes(args, kw) -> int:
    """The least bytes the compact route must move on these inputs: the
    candidate slices (8 B a valid lane raw, 6 tc), each searched slot's
    run or a sector a lane still searching it where that is fewer, 12 B
    (bloom word, rank and row) a (matched lane, active probe), the K = KV
    + 1 keys, and for each kept lane (at most KV a query) a sector of
    each searched run (the recovery), of pos_starts and of each bag; the
    packed output and the top scores. The lanes and their survival are
    the plain version's."""
    import torch

    from wiser_tpu_torch.engine import kernels as K

    doc, col = args[0], args[1]
    starts, ends, w = args[5], args[6], args[7]
    T, L, KV, M = kw["T"], kw["L"], kw["KV"], kw["M"]
    avg32 = kw.get("avg32") if kw.get("tc_mode") else None
    B = starts.shape[0]
    cdocs, _, cvalid, _ = K._candidates(doc, col, starts, ends, L)
    _, found, _, _ = K._others(doc, col, cdocs, starts[:, 1:], ends[:, 1:],
                               kw["n_bs_iters"], weights=w[:, 1:],
                               avg32=avg32)
    match = found.all(dim=1) & cvalid
    cs = starts[:, 0]
    lane = torch.arange(L, dtype=torch.int32, device=doc.device)
    pidx = torch.cat([(cs[:, None] + lane[None, :])[:, None, :],
                      K._binary_search(doc, cdocs[:, None, :].expand(
                          B, T - 1, L), starts[:, 1:, None],
                          ends[:, 1:, None], kw["n_bs_iters"])], dim=1)
    active = match & K._bloom_gate(pidx, *args[10:17])
    alive = cvalid.clone()
    total = int(cvalid.sum()) * (6 if avg32 is not None else 8)
    for t in range(1, T):
        run = (ends[:, t] - starts[:, t]).long().clamp(min=0) * 4
        total += int(torch.minimum(run, alive.sum(dim=1) * SECTOR).sum())
        alive &= found[:, t - 1]
    total += int((match.sum(dim=1) * args[16].sum(dim=1)).sum()) * 12
    kept = int(active.sum(dim=1).clamp(max=KV).sum())
    return (total + B * (KV + 1) * 8 + kept * (3 * T - 1) * SECTOR
            + B * (T + 2) * M * 4 + B * M * 4)


ROUTE_TAGS = ("wiser_phrase_route::", "tc_norm_kernel")
N_DOCS_1M = 1_000_000
TIME_KV = 1024
TIME_M = 64  # k 10 + the engine's margin 54
# (B, T, L) of the timed groups on synthetic 1M columns: the semidense
# phrase at the mega chunk's B, the list chain at a list group's
SDP_TIME = ((128, 2, 2048), (128, 2, 32768))
# the engines' most called semidense phrase groups (the chip smoke's
# serve phase: B 8 at every L bucket, then B 32; PERF.md §6)
SDP_ENGINE = ((8, 2, 2048), (8, 2, 8192), (8, 2, 32768), (32, 2, 32768))
LIST_TIME = ((1024, 2, 128), (1024, 2, 1024), (1024, 3, 1024))
# the list groups the engines call: the serve phase's B 8 and the dense
# and harness phases' B 128, T 2-4, L 128-1,024 (PERF.md §6)
LIST_ENGINE = ((8, 2, 128), (8, 2, 512), (8, 2, 1024), (8, 3, 512),
               (128, 2, 128), (128, 2, 512), (128, 2, 1024), (128, 3, 512),
               (128, 4, 1024))
# the list kernel's marks (list_kernel, counters 14-21): a CTA's rounds
# (the match and gate, the bags, the verification and the push, then the
# wait at the cluster's last barrier) over its CTAs in 20; the first
# CTA's top M and output over those CTAs in 21
LIST_GROUPS = (("rounds", ("match", "bags", "verify", "push", "wait"), 14,
                20, {}),
               ("top", ("top",), 19, 21, {}))
# the list chain's forced segments a query (--tune-list; None: the
# plan's)
TUNE_LIST = (None, 1, 2, 3, 4, 8)
# the phase marks of phrase_route.cu's measuring build (WISER_CLOCKS,
# csrc/clocks.cuh), as tools/dense_bench.phase_split reads them: the
# selection's (csrc/segsel.cuh) candidates, dense gathers, key pushes with
# flushes and sort, and its keys' write in counters 0-4 over its CTAs in
# 6 (flushes counted in 11), a split query's cluster merge in 5 over the
# merging CTAs in 7; the verification's recovery and window check in 8-9
# over its CTAs in 10; the output in 12 over 13.
SDP_GROUPS = (("select", ("candidates", "windows", "gathers", "flush",
                          "keys"), 0, 6, {"flushes": 11}),
              ("merge", ("merge",), 5, 7, {}),
              ("verify", ("recovery", "verification"), 8, 10, {}),
              ("output", ("output",), 12, 13, {}))


def _route_fns(kind):
    """(entry point, plain version, bytes bound, B argument) of a kind."""
    from wiser_tpu_torch.engine import kernels as K

    if kind == "semidense_phrase":
        return (K.semidense_phrase_body, K.semidense_phrase_torch,
                semidense_bound_bytes, 5)
    if kind == "compact_phrase":
        return (K.compact_phrase_body, K.compact_phrase_body_torch,
                compact_bound_bytes, 5)
    if kind == "list_phrase_nogate":
        return (K.list_phrase, lambda *a, **k: gate_off_plain(a, k),
                list_bound_bytes, 4)
    return K.list_phrase, K.list_phrase_torch, list_bound_bytes, 4


def _timed(kind, args, kw, mode, plain: bool, compare: bool, what) -> dict:
    """One group: the kernel against the plain version (`compare`), then
    timed in turns with it (semidense_bench.time_pair), with the bytes
    bound of these inputs."""
    from wiser_tpu_torch.tools import semidense_bench as SDB

    fn, plain_fn, bound, b_arg = _route_fns(kind)
    row = {"kind": kind, "mode": mode, "B": int(args[b_arg].shape[0]),
           **{k: kw[k] for k in ("T", "L", "M", "PP") if k in kw}}
    if "KV" in kw:
        row["KV"] = kw["KV"]
    if compare:
        row["check"] = _summary(fn(*args, **kw), plain_fn(*args, **kw),
                                f"{what} {row}")
    row.update(SDB.time_pair(lambda: fn(*args, **kw),
                             lambda: plain_fn(*args, **kw),
                             bound(args, kw), ROUTE_TAGS, with_plain=plain))
    log(f"{what} {json.dumps(row)}")
    return row


def time_semidense_phrase(dev, shapes=SDP_TIME, modes=("raw", "tc"),
                          plain: bool = True, compare: bool = True) -> list:
    """The semidense phrase route at `shapes` on synthetic 1M columns (64
    candidate terms of df L - L / 16, heads of df 300,000; KV 1,024, M
    64, PP = PW = 8), raw and tc."""
    import torch

    rows = []
    for B, T, L in shapes:
        cols = synth_columns(1, N_DOCS_1M, (L - L // 16,) + (300_000,) *
                             (T - 1), n_cands=64)
        batch = phrase_batch(cols, B, T, TIME_M, 101)
        for mode in modes:
            args, kw = semidense_args(cols, batch, mode, dev)
            kw.update(T=T, L=L, KV=TIME_KV, PP=8, PW=8, M=TIME_M,
                      n_rec_iters=_iters(300_000),
                      eps3=3e-6 if mode == "raw" else 3e-5)
            rows.append(_timed("semidense_phrase", args, kw, mode, plain,
                               compare, "semidense phrase timing"))
            del args
            torch.cuda.empty_cache()
    return rows


def probe(dev, shapes=SDP_TIME + SDP_ENGINE[:1], modes=("raw", "tc"),
          iters: int = 10) -> list:
    """Each phase's cycles of the semidense phrase route by clock64()
    marks (its measuring build, tools/dense_bench.clocks_build) at the
    timed shapes (time_semidense_phrase's inputs), each beside its
    event-timed ms in that build. The entry point uses the library it
    loaded again afterwards."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import phrase_route as PR
    from wiser_tpu_torch.tools.dense_bench import clocks_build, phase_split
    from wiser_tpu_torch.tools.search_bench import event_ms

    loaded = PR._kernel_fns()
    fns = clocks_build("phrase_route", PR._Fns)
    rows = []
    try:
        PR._fns = fns
        for B, T, L in shapes:
            cols = synth_columns(1, N_DOCS_1M, (L - L // 16,) + (300_000,)
                                 * (T - 1), n_cands=64)
            batch = phrase_batch(cols, B, T, TIME_M, 101)
            for mode in modes:
                args, kw = semidense_args(cols, batch, mode, dev)
                kw.update(T=T, L=L, KV=TIME_KV, PP=8, PW=8, M=TIME_M,
                          n_rec_iters=_iters(300_000),
                          eps3=3e-6 if mode == "raw" else 3e-5)

                def fn(args=args, kw=kw):
                    return K.semidense_phrase_body(*args, **kw)

                row = dict(kind="semidense_phrase", mode=mode, B=B, T=T, L=L,
                           KV=TIME_KV, M=TIME_M, ms=event_ms(fn, iters),
                           **phase_split(fn, fns, groups=SDP_GROUPS))
                log(f"semidense phrase probe {json.dumps(row)}")
                rows.append(row)
                del args
                torch.cuda.empty_cache()
    finally:
        PR._fns = loaded
    return rows


# (B, T, L) of the compact route's timed groups on synthetic 1M columns:
# the resident engine's groups at each L bucket (B by its lane budget:
# 4,096 at L 2,048, 1,024 at 8,192, 128 at 32,768) and the serve phase's
# B 8; a mesh shard's L 131,072 at its B 32, and the mesh's most common
# group, B 8 at L 524,288
COMPACT_TIME = ((128, 2, 32768), (1024, 2, 8192))
COMPACT_ENGINE = ((8, 2, 2048), (8, 2, 32768), (32, 2, 131072),
                  (4096, 2, 2048), (8, 2, 524288))
# the mesh's list route (the list chain without its gate) at a shard's
# B 128 groups
LIST_NOGATE_TIME = ((128, 2, 512), (128, 2, 1024), (32, 3, 512))


def compact_inputs_1m(shapes, modes, dev):
    """(B, T, L, mode, args, kw) of the compact route at each (B, T, L) of
    `shapes` on synthetic 1M columns (candidate terms of df L - L / 16,
    as many as keep their postings near 4M, heads of df 300,000; KV
    1,024, M 64, PP = PW = 8); one column set a (T, L)."""
    cols_of = {}
    for B, T, L in shapes:
        if (T, L) not in cols_of:
            cols_of = {(T, L): synth_columns(
                3, N_DOCS_1M, (L - L // 16,) + (300_000,) * (T - 1),
                n_cands=max(1, min(64, (4 << 20) // L)))}
        cols = cols_of[(T, L)]
        batch = phrase_batch(cols, B, T, TIME_M, 103)
        for mode in modes:
            args, kw = compact_args(cols, batch, mode, dev)
            kw.update(T=T, L=L, KV=TIME_KV, PP=8, PW=8, M=TIME_M,
                      n_bs_iters=_iters(300_000),
                      eps3=3e-6 if mode == "raw" else 3e-5)
            yield B, T, L, mode, args, kw


def time_compact_phrase(dev, shapes=COMPACT_TIME, modes=("raw", "tc"),
                        plain: bool = True, compare: bool = True) -> list:
    """The compact route at `shapes` (compact_inputs_1m), raw and tc:
    compared with the plain version (`compare`), timed (`_timed`)."""
    import torch

    rows = []
    for B, T, L, mode, args, kw in compact_inputs_1m(shapes, modes, dev):
        rows.append(_timed("compact_phrase", args, kw, mode, plain, compare,
                           "compact phrase timing"))
        del args
        torch.cuda.empty_cache()
    return rows


def time_list_nogate(dev, shapes=LIST_NOGATE_TIME, modes=("raw", "tc"),
                     plain: bool = True, compare: bool = True) -> list:
    """The list chain without its gate (the mesh's list route) at
    `shapes` (list_inputs, no bloom arguments), raw and tc, its top
    scores with it: compared with the plain version, timed."""
    import torch

    rows = []
    for B, T, L, mode, args, kw in list_inputs(shapes, modes, dev):
        args = args[:8] + (None,) * 7
        kw.update(gate=False)
        rows.append(_timed("list_phrase_nogate", args, kw, mode, plain,
                           compare, "list phrase (no gate) timing"))
        del args
        torch.cuda.empty_cache()
    return rows


def list_inputs(shapes, modes, dev):
    """(B, T, L, mode, args, kw) of the list chain at each (B, T, L) of
    `shapes` on synthetic 1M columns (256 candidate terms of df L - L / 8,
    heads of df 50,000; PP 8, M min(L, 64); one column set a (T, L)), the
    bloom gate on."""
    cols_of = {}
    for B, T, L in shapes:
        if (T, L) not in cols_of:
            cols_of = {(T, L): synth_columns(
                2, N_DOCS_1M, (L - L // 8,) + (50_000,) * (T - 1),
                n_cands=256)}
        cols = cols_of[(T, L)]
        M = min(L, TIME_M)
        batch = phrase_batch(cols, B, T, M, 102)
        for mode in modes:
            args, kw = list_args(cols, batch, mode, dev)
            kw.update(T=T, L=L, PP=8, M=M, n_bs_iters=_iters(50_000),
                      n_pos_iters=_iters(cols["max_tf"]))
            yield B, T, L, mode, args, kw


def time_list_phrase(dev, shapes=LIST_TIME, modes=("raw", "tc"),
                     plain: bool = True, compare: bool = True) -> list:
    """The list chain at `shapes` (list_inputs), raw and tc: compared with
    the plain version (`compare`), timed (`_timed`)."""
    import torch

    rows = []
    for B, T, L, mode, args, kw in list_inputs(shapes, modes, dev):
        rows.append(_timed("list_phrase", args, kw, mode, plain, compare,
                           "list phrase timing"))
        del args
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def forced_list_segments(nseg):
    """ops/phrase_route.list_plan with `nseg` segments a query (as far as
    the lanes allow; None: the plan's own rule) while the block runs."""
    from wiser_tpu_torch.ops import phrase_route as R

    plan = R.list_plan
    if nseg is not None:
        R.list_plan = lambda B, T, L, sms: R.segment_plan(L, nseg, T)
    try:
        yield
    finally:
        R.list_plan = plan


def tune_list(dev, shapes=LIST_ENGINE, modes=("raw", "tc"),
              grid=TUNE_LIST, iters: int = 10) -> list:
    """The list chain's segments a query forced to each of `grid` at
    `shapes` (list_inputs): each checked against the plain version, then
    its queued device ms (search_bench.queued_ms)."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools.search_bench import queued_ms

    rows = []
    for B, T, L, mode, args, kw in list_inputs(shapes, modes, dev):
        want = K.list_phrase_torch(*args, **kw)
        row = {"mode": mode, "B": B, "T": T, "L": L, "ms": {}}
        for forced in grid:
            with forced_list_segments(forced):
                _summary(K.list_phrase(*args, **kw), want,
                         f"list tune {forced} {row}")
                row["ms"][str(forced)] = queued_ms(
                    lambda: K.list_phrase(*args, **kw), iters)
        log(f"list tune {json.dumps(row)}")
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def probe_list(dev, shapes=LIST_ENGINE, modes=("raw", "tc"),
               iters: int = 10) -> list:
    """The list kernel's phase cycles (LIST_GROUPS) by clock64() marks in
    its measuring build at `shapes` (list_inputs), each beside its
    event-timed ms in that build."""
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import phrase_route as PR
    from wiser_tpu_torch.tools.dense_bench import clocks_build, phase_split
    from wiser_tpu_torch.tools.search_bench import event_ms

    loaded = PR._kernel_fns()
    fns = clocks_build("phrase_route", PR._Fns)
    rows = []
    try:
        PR._fns = fns
        for B, T, L, mode, args, kw in list_inputs(shapes, modes, dev):
            def fn(args=args, kw=kw):
                return K.list_phrase(*args, **kw)

            row = dict(kind="list_phrase", mode=mode, B=B, T=T, L=L,
                       M=kw["M"], ms=event_ms(fn, iters),
                       **phase_split(fn, fns, groups=LIST_GROUPS))
            log(f"list phrase probe {json.dumps(row)}")
            rows.append(row)
            del args
            torch.cuda.empty_cache()
    finally:
        PR._fns = loaded
    return rows


class Recorder:
    """Records the calls an engine makes of kernels.semidense_phrase_body,
    kernels.list_phrase (with its gate, and without: the mesh's list
    route) and kernels.compact_phrase_body (each distinct shape's largest
    group, at most `per_kind` shapes a kind) while installed (`with
    Recorder() as rec:`), so that `time_calls` can hold and time them
    afterwards."""

    KINDS = ("semidense_phrase", "list_phrase", "list_phrase_nogate",
             "compact_phrase")

    def __init__(self, per_kind: int = 16):
        self.per_kind = per_kind
        self.calls = {k: {} for k in self.KINDS}
        self.counts = {k: {} for k in self.KINDS}

    def __enter__(self):
        from wiser_tpu_torch.engine import kernels as K

        self._orig = (K.semidense_phrase_body, K.list_phrase,
                      K.compact_phrase_body)
        sdp, lst, cpt = self._orig

        def rec(kind_of, fn, b_arg):
            def run(*args, **kw):
                kind = kind_of(kw)
                mode = "tc" if kw.get("avg32") is not None else "raw"
                key = (mode, kw["T"], kw["L"], kw["M"])
                B = args[b_arg].shape[0]
                c = self.counts[kind]
                c[key] = c.get(key, 0) + 1
                calls = self.calls[kind]
                if (key in calls and B > calls[key][0]) or (
                        key not in calls and len(calls) < self.per_kind):
                    calls[key] = (B, args, kw)
                return fn(*args, **kw)
            return run

        K.semidense_phrase_body = rec(lambda kw: "semidense_phrase", sdp, 5)
        K.list_phrase = rec(lambda kw: "list_phrase" + (
            "" if kw.get("gate", True) else "_nogate"), lst, 4)
        K.compact_phrase_body = rec(lambda kw: "compact_phrase", cpt, 5)
        return self

    def __exit__(self, *exc):
        from wiser_tpu_torch.engine import kernels as K

        (K.semidense_phrase_body, K.list_phrase,
         K.compact_phrase_body) = self._orig
        return False

    def chosen(self, kind: str, busiest: bool = True):
        """A kind's recorded shape with the most lanes (B * L; its largest
        group), then, with `busiest`, its most called one where that is
        another."""
        c, calls = self.counts[kind], self.calls[kind]
        if not calls:
            return []
        biggest = max(calls, key=lambda k: calls[k][0] * k[2])
        most = max(calls, key=lambda k: c[k])
        keys = [biggest] + ([most] if busiest and most != biggest else [])
        return [(k, c[k], calls[k]) for k in keys]


def time_calls(rec: Recorder, plain: bool = True,
               busiest: bool = True) -> dict:
    """Each kind's chosen recorded groups (`Recorder.chosen`): the kernel
    against the plain version on the recorded inputs, then timed."""
    out = {}
    for kind in Recorder.KINDS:
        out[kind] = []
        for key, calls, (B, args, kw) in rec.chosen(kind, busiest):
            row = _timed(kind, args, kw, key[0], plain, True,
                         f"{kind} engine call")
            row["calls"] = calls
            out[kind].append(row)
    return out


def kernel_rows(rows: list, source: str) -> dict:
    """The chip smoke's kernels-line entries from timing rows: the first
    row of each kind and column mode."""
    out = {}
    for r in rows:
        name = r["kind"] + ("_tc" if r["mode"] == "tc" else "")
        if name in out:
            continue
        shape = " ".join(f"{k}={r[k]}" for k in ("B", "T", "L", "KV", "M",
                                                  "PP") if k in r)
        out[name] = {
            "max_abs_err": 0.0, "ms": r["device_ms"], "timing": r["timing"],
            "host_us": r["host_us"],
            "plain_ms": min(r["plain_ms"]) if r["plain_ms"] else None,
            "bound_ms": r["bound_ms"], "share": r["share"],
            "launches_per_call": r["launches_per_call"],
            "peak_extra": r["peak_extra"], "shape": f"{shape} ({source})"}
    return out


# -- one tree -----------------------------------------------------------------


KINDS = ("semidense_phrase", "list_phrase", "compact_phrase",
         "list_phrase_nogate")


def timing(dev, kinds=KINDS, plain: bool = True,
           compare: bool = True) -> list:
    """Each kind's entry point at its timed shapes on synthetic 1M
    columns: the semidense phrase route (SDP_TIME, SDP_ENGINE), the list
    chain (LIST_ENGINE, LIST_TIME), the compact route (COMPACT_TIME,
    COMPACT_ENGINE), the list chain without its gate (LIST_NOGATE_TIME)."""
    runs = {"semidense_phrase": lambda: time_semidense_phrase(
                dev, SDP_TIME + SDP_ENGINE, plain=plain, compare=compare),
            "list_phrase": lambda: time_list_phrase(
                dev, LIST_ENGINE + LIST_TIME, plain=plain, compare=compare),
            "compact_phrase": lambda: time_compact_phrase(
                dev, COMPACT_TIME + COMPACT_ENGINE, plain=plain,
                compare=compare),
            "list_phrase_nogate": lambda: time_list_nogate(
                dev, plain=plain, compare=compare)}
    return [r for k in kinds for r in runs[k]()]


def measure(root: str, index=None, sets=SETS, mesh_sets=MESH_SETS,
            kinds=KINDS) -> dict:
    """One tree's readings, in this process: the routes' entry points at
    the timed shapes; with `index`,
    the route split, raw and tc, on the resident engine (`sets`) and the
    mesh (`mesh_sets`)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.tools.unpack_bench import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("phrase_bench measures a card: none is available")
    dev = torch.device("cuda", 0)
    out = {"tree": root, "card": card_line(),
           "module": os.path.abspath(K.__file__),
           "timing": timing(dev, kinds, plain=False, compare=False)}
    if index:
        out["split"] = {c: route_split(index, c, sets) for c in ("raw", "tc")
                        if sets}
        out["split"].update({f"mesh_{c}": mesh_split(index, c, mesh_sets)
                             for c in ("raw", "tc") if mesh_sets})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--trees", default=None,
                    help="comma-separated trees, measured in turns")
    ap.add_argument("--root", help="measure this tree in this process")
    ap.add_argument("--index", help="a saved 1M index (with phrase_pairs.json)")
    ap.add_argument("--sets", default=",".join(SETS),
                    help="the resident engine's route sets of --index")
    ap.add_argument("--mesh-sets", default=",".join(MESH_SETS),
                    help="the mesh's route sets of --index ('' for none)")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="the kinds timed at synthetic shapes")
    ap.add_argument("--split", action="store_true",
                    help="the route split of --index in this tree only")
    ap.add_argument("--select-path", choices=("one", "two"), default=None,
                    help="--split: the full-scan selection forced to this "
                    "path (tools/dense_bench.forced_path)")
    ap.add_argument("--check-only", action="store_true",
                    help="build and compare the kernels, no timing")
    ap.add_argument("--probe", action="store_true",
                    help="the semidense phrase route's and the list "
                    "chain's phase cycles at the timed and the engines' "
                    "shapes (a measuring build), then stop")
    ap.add_argument("--tune-list", action="store_true",
                    help="the list chain's segments forced at the engines' "
                    "shapes (tune_list), then stop")
    args = ap.parse_args(argv)
    sets = [s for s in args.sets.split(",") if s]
    mesh_sets = [s for s in args.mesh_sets.split(",") if s]
    kinds = [s for s in args.kinds.split(",") if s]
    if args.root:
        res = measure(args.root, args.index, sets, mesh_sets, kinds)
        print(json.dumps(res), flush=True)
        return res
    if args.trees:
        from wiser_tpu_torch.tools.unpack_bench import run_trees

        extra = ["--sets", ",".join(sets), "--mesh-sets",
                 ",".join(mesh_sets), "--kinds", ",".join(kinds)]
        if args.index:
            extra += ["--index", os.path.abspath(args.index)]
        res = {"runs": run_trees(__file__, args.trees.split(","), extra)}
        print(json.dumps({"phrase_bench": [
            {"tree": r["tree"], "card": r["card"],
             **{f"{x['kind']}_{x['mode']}_B{x['B']}"
                + (f"_T{x['T']}" if x["kind"].startswith("list") else "")
                + f"_L{x['L']}":
                [x["device_ms"], x["queued_ms"], x["flushed_ms"], x["share"]]
                for x in r.get("timing", [])},
             **split_summary(r.get("split", {}))} for r in res["runs"]]}),
            flush=True)
    elif args.split:
        from wiser_tpu_torch.tools.dense_bench import forced_path

        with forced_path(args.select_path):
            res = measure(".", args.index, sets, mesh_sets, kinds)
        res["select_path"] = args.select_path
        print(json.dumps(split_summary(res["split"])), flush=True)
    else:
        import torch

        from wiser_tpu_torch.build import build_log, load_libraries
        from wiser_tpu_torch.runtime import resolve_device
        from wiser_tpu_torch.tools.unpack_bench import card_line

        dev = resolve_device("cuda")
        res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
        load_libraries(("phrase_route", "dense"))
        res["build_s"] = build_log["phrase_route"][0]
        log(build_log["phrase_route"][1])
        probing = args.probe or args.tune_list
        if args.probe:
            res["probe"] = probe(dev) + probe_list(dev)
        if args.tune_list:
            res["tune_list"] = tune_list(dev)
        checks = () if probing else (
            ("semidense_phrase_check", semidense_phrase_cases),
            ("list_phrase_check", list_phrase_cases),
            ("compact_phrase_check", compact_phrase_cases))
        for name, fn in checks:
            t0 = time.perf_counter()
            res[name] = fn(dev)
            res[name]["wall_s"] = time.perf_counter() - t0
            log(f"{name}: {res[name]}")
        if not (args.check_only or probing):
            res["timing"] = timing(dev, kinds)
        print(json.dumps({k: v for k, v in res.items() if k != "timing"}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
