"""The semidense step on the CPU (engine/kernels._semidense_step, its plain
version _semidense_step_torch, and the kernel's entry in
ops/semidense.py).

The plain step, through make_semidense_kernel{,_tc}, against the JAX
package's make_semidense_kernel{,_tc} on tools/search_bench's synthetic
columns (tie-prone payloads, saturated tc lanes) and half-full dense
rows, raw and tc, at n_bs 0, 1 and 2 and T up to the engine's largest
bucket (8); with doc_base, a mesh shard's step per shard merged by
shard_steps.merge_shards against the JAX make_sharded_semidense_kernel
over the conftest's virtual devices; one case whose values make (s0 +
b1) + b2 differ from s0 + (b1 + b2) in f32, which pins the order the
kernel keeps (the searched others summed among themselves first). Then
the checks (args_ok refuses exactly what check_inputs refuses, and the
kernel's entry raises ValueError on any CPU call before a launch), the
dispatch (CPU tensors take the plain version and launch nothing), the
launch plans at every engine shape and a hand count of the bytes bound.

Tolerances: none for flags and integers (docs, tfs); f32 score bits
equal. Where FLAG_TRUNC is set the rows may keep other boundary lanes
(lax.top_k and torch.topk order ties their own ways), so flagged rows
compare their flags only. The JAX programs run without XLA's FMA
contraction (xla_backend_optimization_level 0, as test_torch_tc_kernels
.jref). The card's check (the kernel against the plain version) is
marked cuda and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
import wiser_tpu.engine.shard as JSH
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine import shard_steps as SS
from wiser_tpu_torch.engine.device import SEMIDENSE_LANE_BUDGET, _chunk_within
from wiser_tpu_torch.engine.host import (B_BUCKETS, DEFAULT_MARGIN,
                                         L_BUCKETS, T_BUCKETS)
from wiser_tpu_torch.ops import search as S
from wiser_tpu_torch.ops import semidense as SD
from wiser_tpu_torch.tools import search_bench as SB
from wiser_tpu_torch.tools import semidense_bench as SDB

NO_FMA = {"xla_backend_optimization_level": 0}
INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jref(fn, *args):
    """fn(*args) as one JAX program without FMA contraction."""
    args = [None if a is None else jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(NO_FMA)(*args)


def T_(a):
    """numpy -> torch; uint16 columns travel as their int16 bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def rows_by_doc(packed, T):
    lanes = np.concatenate([packed[:, 0:1], packed[:, 1 : T + 1]], axis=1)
    order = np.argsort(lanes[:, 0, :], axis=1, kind="stable")
    return np.take_along_axis(lanes, order[:, None, :].repeat(T + 1, 1), 2)


def assert_packed_match(got, want, T):
    """Flags equal on every row; the clean rows' (doc, tfs) lanes equal.
    Returns the clean-row mask."""
    gf, wf = got[:, T + 1, 0], want[:, T + 1, 0]
    np.testing.assert_array_equal(gf, wf)
    clean = (wf & TK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(rows_by_doc(got[clean], T),
                                  rows_by_doc(want[clean], T))
    assert clean.any()
    return clean


L = 256
M = 24
H = 5


@pytest.fixture(scope="module")
def synth():
    """search_bench's synthetic columns (runs empty to 2L long over 2L +
    64 docs) and H half-full dense rows over them."""
    cols = SB.synth_columns(L, 7)
    n_pad = -(-(2 * L + 64) // 128) * 128
    return cols, SDB.dense_rows(H, n_pad, 8), n_pad


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T,n_bs", [(2, 0), (3, 1), (4, 2), (8, 1)])
def test_plain_matches_jax(synth, mode, T, n_bs):
    cols, planes, n_pad = synth
    b = SDB.semi_batch(cols, 16, T, n_bs, H, 30 + T + n_bs)
    n_it = SB._n_iters(cols) if n_bs else 0
    tc = cols["tc"].view(np.uint16)
    if mode == "tc":
        args = (cols["doc"], tc, b["avg32"], planes["dense_tf8"],
                b["starts"], b["ends"], b["idf32"], b["slots"])
        want = np.asarray(jref(JK.make_semidense_kernel_tc(
            T, L, M, n_pad, n_bs, n_it), *args))
        got = TK.make_semidense_kernel_tc(T, L, M, n_pad, n_bs, n_it)(
            *(T_(a) for a in args)).numpy()
    else:
        args = (cols["doc"], cols["score"], cols["tf"], planes["dense_sc"],
                planes["dense_tf"], b["starts"], b["ends"], b["use"],
                b["slots"])
        want = np.asarray(jref(JK.make_semidense_kernel(
            T, L, M, n_pad, n_bs, n_it), *args))
        got = TK.make_semidense_kernel(T, L, M, n_pad, n_bs, n_it)(
            *(T_(a) for a in args)).numpy()
    clean = assert_packed_match(got, want, T)
    assert (got[clean, 0] >= 0).sum() > 0


def _shards(D: int, Npd: int, seed: int):
    """D shards of a synthetic 2-D layout (the JAX mesh's): per shard the
    local runs of 10 terms over its doc range [s * Npd, (s + 1) * Npd),
    each padded to 128 lanes, the columns ending in L + 128 pad lanes;
    ts / dfs (D, 10) local starts and counts; H dense rows' local slices
    (D, H, Npd)."""
    rng = np.random.default_rng(seed)
    N = D * Npd
    runs = [np.sort(rng.choice(N, size=int(n), replace=False))
            for n in [0, 5, 60, 300, 700, 1200, 400, 900, 1500, 30]]
    rng_p = np.random.default_rng(seed + 1)
    per = []
    for s in range(D):
        loc = [r[(r >= s * Npd) & (r < (s + 1) * Npd)] for r in runs]
        per.append(SB.build_columns(loc, rng_p, slack=L + 128))
    n = max(len(p["doc"]) for p in per)

    def stack(key, fill):
        return np.stack([np.concatenate([p[key], np.full(
            n - len(p[key]), fill, p[key].dtype)]) for p in per])

    planes = SDB.dense_rows(H, N, seed + 2)
    local = {k: np.stack([v[:, s * Npd : (s + 1) * Npd] for s in range(D)])
             for k, v in planes.items()}
    return {"doc": stack("doc", INT32_MAX), "score": stack("score", 0),
            "tf": stack("tf", 0), "tc": stack("tc", 0),
            "ts": np.stack([p["t_start"] for p in per]).astype(np.int32),
            "dfs": np.stack([p["t_len"] for p in per]).astype(np.int32),
            **local}


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_doc_base_matches_jax_mesh(mode):
    """Each shard's step at doc_base s * Npd, merged, against the JAX
    mesh's semidense kernel (local lane = doc - s * Npd)."""
    D, Npd, T, n_bs, B, Mo = 2, 1024, 3, 1, 12, 32
    sh = _shards(D, Npd, 21)
    rng = np.random.default_rng(22)
    rows = np.zeros((B, T), dtype=np.int32)
    rows[:, 0] = rng.integers(1, 10, size=B)
    rows[:, 1] = rng.integers(3, 10, size=B)
    slots = np.zeros((B, T), dtype=np.int32)
    slots[:, 2] = rng.integers(0, H, size=B)
    use = np.ones((B, T), dtype=np.float32)
    idf = rng.uniform(0.5, 6.0, size=(B, T)).astype(np.float32)
    n_it = TK.n_iters_for(int(sh["dfs"].max()))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:D]), ("d",))
    avg32 = np.float32(57.25)
    if mode == "tc":
        want = JSH.make_sharded_semidense_kernel_tc(
            T, L, M, Npd, n_bs, n_it, mesh, float(avg32), M_out=Mo)(
            *(jnp.asarray(a) for a in (
                sh["doc"], sh["tc"].view(np.uint16), sh["ts"], sh["dfs"],
                sh["dense_tf8"], rows, idf, slots)))
    else:
        want = JSH.make_sharded_semidense_kernel(
            T, L, M, Npd, n_bs, n_it, mesh, M_out=Mo)(
            *(jnp.asarray(a) for a in (
                sh["doc"], sh["score"], sh["tf"], sh["ts"], sh["dfs"],
                sh["dense_sc"], sh["dense_tf"], rows, use, slots)))
    outs = []
    for s in range(D):
        starts = sh["ts"][s][rows]
        ends = starts + sh["dfs"][s][rows]
        kw = dict(T=T, L=L, M=M, n_bs=n_bs, n_bs_iters=n_it,
                  doc_base=s * Npd)
        if mode == "tc":
            outs.append(TK._semidense_step(
                T_(sh["doc"][s]), T_(sh["tc"][s]), T_(sh["dense_tf8"][s]),
                T_(starts), T_(ends), T_(idf), T_(slots),
                avg32=torch.tensor(avg32), **kw))
        else:
            outs.append(TK._semidense_step(
                T_(sh["doc"][s]), T_(sh["score"][s]), T_(sh["dense_sc"][s]),
                T_(starts), T_(ends), T_(use), T_(slots),
                postings_tf=T_(sh["tf"][s]), dense_tf=T_(sh["dense_tf"][s]),
                **kw))
    d2, _, t2, flags = SS.merge_shards(
        *(torch.stack([o[i] for o in outs]) for i in range(4)), M_out=Mo)
    got = TK.pack_with_flags(d2, t2, flags).numpy()
    clean = assert_packed_match(got, np.asarray(want), T)
    assert (got[clean, 0] >= Npd).sum() > 0  # the second shard's docs


def test_sum_order_searched_others_first():
    """s0 = 1, b1 = b2 = 2^-24, d1 = 0.5: (s0 + b1) + b2 rounds to 1, s0 +
    (b1 + b2) to 1 + 2^-23; the plain step and the JAX kernel both keep
    the latter, then add d1."""
    tiny = np.float32(2.0 ** -24)
    docs = np.full(512, INT32_MAX, dtype=np.int32)
    score = np.zeros(512, dtype=np.float32)
    tf = np.zeros(512, dtype=np.int32)
    for run, at in ((0, 0), (1, 128), (2, 256)):
        docs[at : at + 3] = [3, 40, 77]
        score[at : at + 3] = 1.0 if run == 0 else tiny
        tf[at : at + 3] = run + 1
    dense = np.zeros((1, 128), dtype=np.float32)
    dense[0, [3, 40, 77]] = 0.5
    dense_tf = (dense > 0).astype(np.int32) * 9
    T, n_bs, Lx, Mx = 4, 2, 128, 4
    starts = np.array([[0, 128, 256, 0]], dtype=np.int32)
    ends = np.array([[3, 131, 259, 0]], dtype=np.int32)
    use = np.ones((1, T), dtype=np.float32)
    slots = np.zeros((1, T), dtype=np.int32)
    args = (docs, score, tf, dense, dense_tf, starts, ends, use, slots)
    want = np.float32(np.float32(1.0) + np.float32(tiny + tiny)) \
        + np.float32(0.5)
    wrong = np.float32(np.float32(np.float32(1.0) + tiny) + tiny) \
        + np.float32(0.5)
    assert want != wrong
    d, s, tfs, flags = TK._semidense_step(
        *(T_(a) for a in args[:2]), T_(dense), *(T_(a) for a in args[5:]),
        T=T, L=Lx, M=Mx, n_bs=n_bs, n_bs_iters=8, postings_tf=T_(tf),
        dense_tf=T_(dense_tf))
    np.testing.assert_array_equal(np.sort(d.numpy()[0, :3]), [3, 40, 77])
    np.testing.assert_array_equal(s.numpy()[0, :3].view(np.int32),
                                  np.full(3, want).view(np.int32))
    np.testing.assert_array_equal(tfs.numpy()[0, :, 0], [1, 2, 3, 9])
    assert flags.numpy()[0] == 0
    jw = np.asarray(jref(JK.make_semidense_kernel(T, Lx, Mx, 128, n_bs, 8),
                         *args))
    got = TK.make_semidense_kernel(T, Lx, Mx, 128, n_bs, 8)(
        *(T_(a) for a in args)).numpy()
    assert_packed_match(got, jw, T)


def _good(mode):
    cols = SB.synth_columns(128, 3)
    planes = SDB.dense_rows(3, 384, 4)
    b = SDB.semi_batch(cols, 4, 3, 1, 3, 5)
    t = SDB.semi_tensors(cols, planes, b, torch.device("cpu"))
    if mode == "tc":
        args = [t["doc"], t["tc"], t["dense_tf8"], t["starts"], t["ends"],
                t["idf32"], t["slots"]]
        kw = dict(avg32=t["avg32"])
    else:
        args = [t["doc"], t["score"], t["dense_sc"], t["starts"], t["ends"],
                t["use"], t["slots"]]
        kw = dict(postings_tf=t["tf"], dense_tf=t["dense_tf"])
    kw.update(T=3, L=128, M=16, n_bs=1, n_bs_iters=9, doc_base=0)
    return args, kw


def _bad(mode):
    """(what, args, kw) each refused."""
    args, kw = _good(mode)
    out = []

    def arg(i, v, what):
        a = list(args)
        a[i] = v
        out.append((what, a, dict(kw)))

    def key(k, v, what):
        out.append((what, list(args), dict(kw, **{k: v})))

    arg(0, args[0].to(torch.int64), "doc int64")
    arg(0, args[0][:100], "doc shorter than L")
    arg(1, args[1].to(torch.float64 if mode == "raw" else torch.int32),
        "column dtype")
    arg(2, args[2][:, :0], "dense plane with no lanes")
    arg(2, args[2].t(), "dense plane not contiguous")
    arg(2, args[2].to(torch.float64 if mode == "raw" else torch.int32),
        "dense dtype")
    arg(3, args[3][:, :2], "starts of the wrong shape")
    arg(4, args[4].to(torch.int64), "ends int64")
    arg(5, args[5].to(torch.float64), "weights float64")
    arg(6, args[6].to(torch.int64), "slots int64")
    arg(6, args[6].t().contiguous().t(), "slots not contiguous")
    key("T", 1, "n_bs >= T")
    key("n_bs", -1, "negative n_bs")
    key("M", 0, "M 0")
    key("M", 129, "M > L")
    key("n_bs_iters", -1, "negative iterations")
    key("doc_base", -1, "negative doc_base")
    if mode == "tc":
        key("avg32", torch.tensor([1.0, 2.0]), "avg32 of two elements")
    else:
        key("postings_tf", kw["postings_tf"].to(torch.int16), "tf dtype")
        key("dense_tf", kw["dense_tf"][:2], "dense_tf of another shape")
    return out


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_args_ok_refuses_what_check_inputs_refuses(mode):
    args, kw = _good(mode)
    assert SD.args_ok(*args, **kw)
    SD.check_inputs(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        SD.semidense(*args, **kw)
    for what, a, k in _bad(mode):
        assert not SD.args_ok(*a, **k), what
        with pytest.raises(ValueError):
            SD.check_inputs(*a, **k)
        with pytest.raises(ValueError):  # the dispatch, on the CPU
            TK._semidense_step(*a, **k)
        with pytest.raises(ValueError):  # the kernel's entry, no launch
            SD.semidense(*a, **k)
    assert SD.launch_counts == {"semidense": 0, "semidense_tc": 0}


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_cpu_tensors_take_the_plain_version(mode, monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel's entry ran on CPU tensors")

    monkeypatch.setattr(SD, "semidense", no_kernel)
    args, kw = _good(mode)
    got = TK._semidense_step(*args, **kw)
    want = TK._semidense_step_torch(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert SD.launch_counts == {"semidense": 0, "semidense_tc": 0}


def test_launch_plans_at_every_engine_shape():
    """Every engine group (T bucket >= 2, 0 <= n_bs < T - 1, L bucket, B
    by the lane budget, M = min(L, k + margin) at k 10, 100 and 1,000) on
    an H100 of 132 SMs: K = min(M + 1, L) keys, the
    CTA's buffer within the card's shared memory (a deep k's past it in
    device memory, one CTA a query), whole 256-lane segments covering L
    in at most a cluster's 8, a split only where the merge's three lists
    fit the buffer; the output without posting indices."""
    seen = set()
    for T in (t for t in T_BUCKETS if t >= 2):
        for n_bs in range(T - 1):
            for Lb in L_BUCKETS:
                B = _chunk_within(SEMIDENSE_LANE_BUDGET, (T - 1) * Lb,
                                  B_BUCKETS)
                for k in (10, 100, 1000):
                    Mx = min(Lb, k + DEFAULT_MARGIN)
                    p = SD.plan(B, T, n_bs, Lb, Mx, 132)
                    g = p.seg
                    assert p.out_words == B * (2 * Mx + T * Mx + 1)
                    assert g.K == min(Mx + 1, Lb)
                    assert g.KP >= g.K and g.KP < 2 * g.K
                    assert g.XC == (3 * g.KP if g.KP == 2 * SD.STEP
                                    else g.KP + 2 * SD.STEP)
                    assert g.smem <= SD.MAX_SMEM
                    assert g.global_x == (SD.HEAD_BYTES + 8 * g.XC
                                          > SD.MAX_SMEM)
                    assert 1 <= g.nseg <= SD.MAX_CLUSTER
                    assert g.seg_lanes % SD.UNIT == 0
                    assert g.nseg * g.seg_lanes >= Lb
                    assert (g.nseg - 1) * g.seg_lanes < Lb
                    assert g.nseg == 1 or 3 * g.KP <= g.XC
                    assert p.scratch_bytes == (8 * B * g.XC if g.global_x
                                               else 0)
                    seen.add((g.nseg > 1, g.global_x))
    # split groups and one-CTA groups both occur
    assert {(True, False), (False, False)} <= seen


def test_bound_bytes_hand_count():
    """One raw query, L 128: 3 valid candidate lanes (8 B each), one
    searched run of 3 docs (4 B each) holding 2 of them (4 B payload
    each), one dense slot whose row both survivors hit in one 32-byte
    sector (docs 3 and 5), then M = 2 winners' tf loads (T 3 slots, 4 B),
    the outputs B * (2M + TM + 1) * 4 and the (B, T) bounds, weights and
    slots (16 B each)."""
    docs = np.full(512, INT32_MAX, dtype=np.int32)
    docs[:3] = [3, 5, 9]
    docs[128:131] = [3, 5, 100]
    dense = np.zeros((2, 128), dtype=np.float32)
    dense[1, [3, 5]] = 1.0
    t = {"doc": torch.from_numpy(docs),
         "starts": torch.tensor([[0, 128, 0]], dtype=torch.int32),
         "ends": torch.tensor([[3, 131, 0]], dtype=torch.int32),
         "slots": torch.tensor([[0, 0, 1]], dtype=torch.int32),
         "dense_sc": torch.from_numpy(dense)}
    want = 3 * 8 + 3 * 4 + 2 * 4 + 1 * 32 + 3 * 2 * 4 \
        + (2 * 2 + 3 * 2 + 1) * 4 + 3 * 16
    assert SDB.semidense_bound_bytes(t, "raw", 3, 128, 2, 1) == want
    # tc: 6 B a candidate lane, 2 B a hit's payload, 1 B a tf byte
    t["dense_tf8"] = torch.from_numpy((dense > 0).astype(np.uint8))
    want_tc = 3 * 6 + 3 * 4 + 2 * 2 + 1 * 32 + 3 * 2 * 1 \
        + (2 * 2 + 3 * 2 + 1) * 4 + 3 * 16
    assert SDB.semidense_bound_bytes(t, "tc", 3, 128, 2, 1) == want_tc


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = SDB.semidense_cases(torch.device("cuda", 0))
    assert out["cases"] > 0 and out["max_abs_err"] == 0.0
