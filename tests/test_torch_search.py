"""The bs search kernel's wrapper (wiser_tpu_torch/ops/search.py) on the
CPU: its launch plan at every group shape the engine makes, its cheap
argument check against check_inputs, the plain step (engine/kernels.
search_body) against the JAX search_body at the edges of
tools/search_bench's check grid, and search_bench's --trees runner.

Tolerances: none. Flags are bit-equal on every row; kept lanes are
compared after the (score desc, doc asc) canon (tools/search_bench.canon)
as docs, f32 score bits, tfs and posting indices on every row without
FLAG_TRUNC (a flagged row's choice among tied boundary lanes is free for
torch.topk), and the sorted top-M scores on every row. The JAX tc steps
run without XLA's FMA contraction (test_torch_tc_kernels.jref).
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiser_tpu.engine import kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.device import bs_chunk
from wiser_tpu_torch.engine.host import L_BUCKETS, T_BUCKETS
from wiser_tpu_torch.ops import search as S
from wiser_tpu_torch.tools import search_bench as SB
from wiser_tpu_torch.tools import unpack_bench as UB

NO_FMA = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the launch plan -------------------------------------------------------------


def _ms(L: int):
    """M in {1, 64, 254 (the engine's k = 200), the key cap's M, one
    above, L}, at most L."""
    return sorted({m for m in (1, 64, 254, S.KEY_CAP - 1, S.KEY_CAP, L)
                   if m <= L})


@pytest.mark.parametrize("L", L_BUCKETS)
@pytest.mark.parametrize("T", T_BUCKETS)
def test_plan_at_every_engine_shape(T, L):
    """Every T and L bucket (single terms take bs at any L), at the
    engine's group width and at a narrow one: the tile path where K =
    min(M + 1, L) fits the key cap, with no score plane, shared bytes
    within the H100's 227 KB, one launch where L fits a tile and at most
    two otherwise; the plane path above the cap."""
    for B in sorted({8, bs_chunk(T, L)}):
        for M in _ms(L):
            p = S.plan(B, T, L, M)
            K = min(M + 1, L)
            assert p.K == K and p.out_words == B * (2 * M + 2 * T * M + 1)
            if K > S.KEY_CAP:
                assert p.path == "plane" and p.launches == 2 and p.P >= K
                assert p.plane_bytes == B * L * 4 and p.scratch_words == 0
                continue
            assert p.path == "tile" and p.plane_bytes == 0
            assert p.KP >= K and p.KP & (p.KP - 1) == 0
            assert p.G * p.LPT == p.TL and p.G in (32, S.THREADS)
            assert p.G == 32 or p.TL <= S.MAX_TILE
            assert (p.ntiles - 1) * p.TL < L <= p.ntiles * p.TL
            assert (p.nseg - 1) * p.tps < p.ntiles <= p.nseg * p.tps
            assert p.launches == 1 + (p.nseg > 1)
            if L <= p.TL:
                assert p.ntiles == 1 and p.launches == 1
            if B >= S.TARGET_CTAS:
                assert p.launches == 1
            assert 0 < p.smem <= S.MAX_SMEM and p.merge_smem <= S.MAX_SMEM
            assert p.smem == (S.THREADS // p.G) * S.worker_bytes(
                p.G, T, p.TL, p.KP, p.ntiles > 1)
            parts = 3 * B * p.nseg * K if p.nseg > 1 else 0
            los = B * (T - 1) * p.ntiles * K if p.ntiles > 1 else 0
            assert p.scratch_words == parts + los


def test_plan_takes_the_plane_path_past_the_shared_bytes():
    """A T far past the engine's buckets would need more shared memory a
    worker than a block has: the plane path computes it instead."""
    tile = S.plan(64, 8, 2048, 64)
    wide = S.plan(64, 80, 2048, 64)
    assert tile.path == "tile" and tile.smem <= S.MAX_SMEM
    assert S.worker_bytes(256, 80, 1024, 128, True) > S.MAX_SMEM
    assert wide.path == "plane" and wide.plane_bytes == 64 * 2048 * 4


def test_tile_layout_counts_every_region():
    """worker_bytes: Misc, the staged docs, the keys or three window
    chunks, two running top-K lists (several tiles only) and the tile's
    lower bounds; a warp worker's chunks are 256 ids."""
    assert S.worker_bytes(256, 4, 1024, 128, True) == (
        S.MISC_BYTES + 4096 + 3 * 1024 * 4 + 2 * 128 * 12 + 3 * 1024 * 4)
    assert S.worker_bytes(256, 1, 512, 64, False) == (
        S.MISC_BYTES + 2048 + 3 * 512 * 4)
    assert S.worker_bytes(32, 2, 128, 64, False) == (
        S.MISC_BYTES + 512 + 3 * 256 * 4 + 512)


# -- the cheap argument check ----------------------------------------------------


def _bad(case: str, t: dict) -> dict:
    t = dict(t)
    if case == "doc_int64":
        t["doc"] = t["doc"].to(torch.int64)
    elif case == "score_f64":
        t["score"] = t["score"].to(torch.float64)
    elif case == "tf_int16":
        t["tf"] = t["tf"].to(torch.int16)
    elif case == "tc_uint8":
        t["tc"] = t["tc"].to(torch.uint8)
    elif case == "doc_strided":
        t["doc"] = torch.stack([t["doc"], t["doc"]], dim=1)[:, 0]
    elif case == "doc_2d":
        t["doc"] = t["doc"][None, :]
    elif case == "starts_t":
        t["starts"] = t["starts"].t().contiguous().t()
    elif case == "starts_1d":
        t["starts"] = t["starts"][:, 0].contiguous()
    elif case == "ends_shape":
        t["ends"] = t["ends"][:, :1].contiguous()
    elif case == "ends_rows":
        t["ends"] = t["ends"][1:].contiguous()
    elif case == "use_f64":
        t["use"] = t["use"].to(torch.float64)
    elif case == "idf_f64":
        t["idf32"] = t["idf32"].to(torch.float64)
    elif case == "avg_two":
        t["avg32"] = torch.stack([t["avg32"], t["avg32"]])
    elif case == "doc_list":
        t["doc"] = t["doc"].tolist()
    return t


GOOD = [("raw", 2, 128, 16, 9), ("tc", 2, 128, 16, 9), ("raw", 1, 128, 128, 0)]
BAD = [("doc_int64", "raw"), ("score_f64", "raw"), ("tf_int16", "raw"),
       ("tc_uint8", "tc"), ("doc_strided", "tc"), ("doc_2d", "raw"),
       ("starts_t", "raw"), ("starts_1d", "tc"), ("ends_shape", "tc"),
       ("ends_rows", "raw"), ("use_f64", "raw"), ("idf_f64", "tc"),
       ("avg_two", "tc"), ("doc_list", "raw")]


@pytest.fixture(scope="module")
def synth_t():
    cols = SB.synth_columns(128, 5)
    return cols, SB.to_device(cols, SB.synth_batch(cols, 8, 2, seed=4),
                              torch.device("cpu"))


def _args(t: dict, mode: str):
    if mode == "tc":
        return ((t["doc"], None, None, t["starts"], t["ends"], None),
                dict(tc=t["tc"], idf32=t["idf32"], avg32=t["avg32"]))
    return ((t["doc"], t["score"], t["tf"], t["starts"], t["ends"],
             t["use"]), {})


@pytest.mark.parametrize("case", GOOD)
def test_args_ok_accepts_what_check_inputs_accepts(synth_t, case):
    mode, T, L, M, iters = case
    t = dict(synth_t[1])
    for k in ("starts", "ends", "use", "idf32"):
        t[k] = t[k][:, :T].contiguous()
    args, kw = _args(t, mode)
    kw.update(T=T, L=L, M=M, n_bs_iters=iters)
    S.check_inputs(*args, **kw)
    assert S.args_ok(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.bs_search(*args, **kw)


@pytest.mark.parametrize("case,mode", BAD + [("M_over_L", "raw"),
                                             ("M_zero", "tc"),
                                             ("T_zero", "raw"),
                                             ("iters_negative", "raw"),
                                             ("L_over_column", "tc")])
def test_args_ok_refuses_what_check_inputs_refuses(synth_t, case, mode):
    """Each bad argument: check_inputs raises ValueError, args_ok is
    False, and bs_search raises ValueError (check_inputs's) before any
    launch or count."""
    cols, t = synth_t
    T, L, M, iters = 2, 128, 16, 9
    if case == "M_over_L":
        M = L + 1
    elif case == "M_zero":
        M = 0
    elif case == "T_zero":
        T = 0
    elif case == "iters_negative":
        iters = -1
    elif case == "L_over_column":
        L = cols["doc"].shape[0] + 1
    else:
        t = _bad(case, t)
    args, kw = _args(t, mode)
    kw.update(T=T, L=L, M=M, n_bs_iters=iters)
    with pytest.raises(ValueError):
        S.check_inputs(*args, **kw)
    assert not S.args_ok(*args, **kw)
    S.reset_launch_counts()
    with pytest.raises(ValueError) as err:
        S.bs_search(*args, **kw)
    assert "CUDA tensors" not in str(err.value)
    assert S.launch_counts == {"bs_search": 0, "bs_search_plane": 0}


# -- the plain step against the JAX step at the grid's edges ---------------------


def _jax_step(cols, batch, mode: str, kw: dict):
    if mode == "tc":
        args = [jnp.asarray(a) for a in (
            cols["doc"], batch["starts"], batch["ends"],
            cols["tc"].view(np.uint16), batch["idf32"], batch["avg32"])]

        def fn(d, s, e, c, i, a):
            return JK.search_body(d, None, None, s, e, None, tc=c, idf32=i,
                                  avg32=a, **kw)

        out = jax.jit(fn).lower(*args).compile(NO_FMA)(*args)
    else:
        out = jax.jit(partial(JK.search_body, **kw))(*(jnp.asarray(a) for a in (
            cols["doc"], cols["score"], cols["tf"], batch["starts"],
            batch["ends"], batch["use"])))
    return [np.asarray(o) for o in out]


def _assert_same(got, want, M: int, what: str):
    np.testing.assert_array_equal(got[4], want[4], err_msg=f"{what} flags")
    g = SB.canon(*got[:4], M)
    w = SB.canon(*want[:4], M)
    clean = (got[4] & TK.FLAG_TRUNC) == 0
    for name, a, b in (("docs", g[0], w[0]), ("tfs", g[2], w[2]),
                       ("pidx", g[3], w[3]),
                       ("score bits", g[1].astype(np.float32).view(np.int32),
                        w[1].astype(np.float32).view(np.int32))):
        np.testing.assert_array_equal(a[clean], b[clean],
                                      err_msg=f"{what} {name}")
    np.testing.assert_array_equal(
        np.sort(got[1], axis=1).view(np.int32),
        np.sort(want[1], axis=1).view(np.int32),
        err_msg=f"{what} top-M scores")


# the grid's edges with the wide group cut to 32 queries (its rows are
# the same draws; a CPU pass over 1,024 of them takes too long)
EDGES = SB.edge_cases(wide_B=32)


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("i", range(len(EDGES)),
                         ids=[e["name"].replace(" ", "_") for e in EDGES])
def test_plain_matches_jax_at_the_grid_edges(i, mode):
    e = EDGES[i]
    kw = dict(T=e["T"], L=e["L"], M=e["M"], n_bs_iters=e["n_iters"])
    want = _jax_step(e["cols"], e["batch"], mode, kw)
    t = SB.to_device(e["cols"], e["batch"], torch.device("cpu"))
    got = SB._np(SB.call(TK.search_body, t, mode, e["T"], e["L"], e["M"],
                         e["n_iters"]))
    _assert_same(got, want, e["M"], f"{mode} {e['name']}")


def test_edges_reach_every_path():
    """The edges hold what they are named for: the key cap on both
    sides, slices clamped across runs (lanes out of doc order), a run
    past shared memory and past the streaming budget of a short
    candidate run, runs past 2^n_bs_iters - 1, several tiles a worker."""
    names = [e["name"] for e in EDGES]
    plans = {e["name"]: S.plan(e["batch"]["starts"].shape[0], e["T"],
                               e["L"], e["M"]) for e in EDGES}
    assert {plans[n].path for n in names if n.startswith("cap")} == {
        "tile", "plane"}
    assert any(plans[n].ntiles > 1 for n in names if n.startswith("cap"))
    for e in EDGES:
        if e["name"].startswith("clamped"):
            cs = int(e["batch"]["starts"][0, 0])
            n = len(e["cols"]["doc"])
            assert cs > n - e["L"] >= 0  # the load starts before the run
            lanes = e["cols"]["doc"][n - e["L"]:]
            assert (np.diff(lanes[: n - cs + e["L"]]) < 0).any()
        if e["name"].startswith("wide"):
            run = int(e["cols"]["t_len"].max())
            assert run > 2**20
            assert e["name"].endswith("iters=21") == (
                run <= 2 ** e["n_iters"] - 1)
    wide = SB.edge_cases()[-1]
    p = S.plan(wide["batch"]["starts"].shape[0], wide["T"], wide["L"],
               wide["M"])
    assert p.tps > 1 and not wide["full"]


# -- search_bench's --trees runner -----------------------------------------------


def _run(tree: str) -> dict:
    rows = {m: [{"T": 2, "L": 128, "device_ms": 0.1, "flushed_ms": 0.2,
                 "host_us": 30.0, "share": 0.5}] for m in ("raw", "tc")}
    return {"tree": tree, "card": "card", "timing": rows,
            "routes": {"raw": {"bsearch_tail_pair": {
                "wall_s": 1.0, "traced": {"device_busy_ms": 2.0, "top_ops": [
                    {"kernel": "void wiser_search::tile_kernel<32, 4>",
                     "self_ms": 0.5},
                    {"kernel": "gatherTopK", "self_ms": 0.25}]}}}}}


def test_trees_run_each_tree_in_turn(tmp_path, monkeypatch):
    """--trees OLD,.,.,OLD hands the trees in order, with the route sets
    and the index's absolute path, to unpack_bench.run_trees (a process
    each), and writes every run and their summary."""
    seen = []

    def fake(script, trees, args):
        seen.append((os.path.basename(script), list(trees), list(args)))
        return [_run(t) for t in trees]

    monkeypatch.setattr(UB, "run_trees", fake)
    out = tmp_path / "r.json"
    res = SB.main(["--trees", "old,.,.,old", "--index", "idx",
                   "--out", str(out)])
    assert seen == [("search_bench.py", ["old", ".", ".", "old"],
                     ["--routes", SB.ROUTES, "--index",
                      os.path.abspath("idx")])]
    assert [r["tree"] for r in res["runs"]] == ["old", ".", ".", "old"]
    assert json.loads(out.read_text()) == res
    s = SB.summary(res["runs"])["search_bench"]
    assert s[0]["raw_T2_L128"] == [0.1, 0.2, 30.0, 0.5]
    assert s[0]["raw_bsearch_tail_pair"] == [1.0, 0.5, 2.0]


def test_unpack_bench_trees_share_the_runner(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(UB, "make_columns", lambda d: None)
    monkeypatch.setattr(UB, "run_trees", lambda script, trees, args: (
        seen.append((os.path.basename(script), list(trees), list(args)))
        or []))
    UB.main(["--columns", str(tmp_path), "--trees", "a,b"])
    assert seen == [("unpack_bench.py", ["a", "b"],
                     ["--columns", str(tmp_path)])]


def test_run_trees_reads_each_childs_last_line(tmp_path):
    """run_trees starts `python -P script --root TREE ...` per tree and
    returns the JSON each printed last; a failing child raises."""
    script = tmp_path / "child.py"
    script.write_text(
        "import json, sys\n"
        "i = sys.argv.index('--root')\n"
        "if sys.argv[i + 1] == 'bad':\n"
        "    sys.exit(3)\n"
        "print('noise')\n"
        "print(json.dumps({'tree': sys.argv[i + 1], 'rest': sys.argv[i + 2:]}))\n")
    runs = UB.run_trees(str(script), ["x", "y"], ["--k", "1"])
    assert runs == [{"tree": "x", "rest": ["--k", "1"]},
                    {"tree": "y", "rest": ["--k", "1"]}]
    with pytest.raises(RuntimeError, match="bad"):
        UB.run_trees(str(script), ["bad"], [])
