"""The dense tier's kernels (wiser_tpu_torch/ops/dense.py, csrc/dense.cu)
on the CPU: the plain versions they are held to (engine/kernels.
dense_scan_body_torch, dense_scan_body_tc_torch, _select_ub_blocks_torch,
pruned_scan_body_torch) against the JAX steps (make_dense_search_kernel
{,_tc}, _select_ub_blocks, make_pruned_dense_kernel{,_tc}) at the check
grid's edges; the dispatch (CPU tensors take the plain version after
check_inputs; the cheap args_ok refuses what check_inputs refuses); the
launch plans at every engine shape; the bytes bound; the build digest
over the shared headers; dense_bench's --trees runner; and the slice as
a whole, TorchEngine and a 2-shard ShardedEngine against the JAX engines
on an all-head mix.

Tolerances: none. Flags are bit-equal on every row; on rows without
FLAG_TRUNC the kept lanes (docs and per-slot tfs) are equal as sets
(a flagged row's choice among tied boundary lanes is free for
torch.topk), and the kept lanes' f32 score bits equal the JAX program's
sum at those docs; blk and next_ub are bit-equal. The JAX tc steps run
as programs compiled without XLA's FMA contraction
(xla_backend_optimization_level 0, as test_torch_tc_kernels.jref).
The engines give the same results, and TorchEngine and TpuEngine the
same flag and rescue counts. The
card's own check (the kernels against these plain versions) is marked
cuda and skips here.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.engine.shard import ShardedEngine as JShardedEngine
from wiser_tpu.engine.shard import ShardedIndex as JShardedIndex
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import TorchEngine, build
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.host import T_BUCKETS
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
from wiser_tpu_torch.ops import dense as D
from wiser_tpu_torch.tools import dense_bench as DB
from wiser_tpu_torch.tools import unpack_bench as UB
from wiser_tpu_torch.types import SearchQuery

NO_FMA = {"xla_backend_optimization_level": 0}


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
    return torch.from_numpy(np.ascontiguousarray(a))


H = 10
NB = 40  # the scan's planes: 5,120 lanes
NB_WIDE = 1100  # the pick's and the pruned scan's: C up to 1,024


@pytest.fixture(scope="module")
def planes():
    return DB.synth_planes(H, NB, seed=3)


@pytest.fixture(scope="module")
def wide():
    return DB.synth_planes(8, NB_WIDE, seed=4)


# the edge rows of every scan batch: no match (rows 0 and 1 hold
# disjoint docs), fewer than M matches (the sparse row 2), a padded slot,
# tie-prone rows (odd rows draw four values) and plain rows
EDGE_ROWS = [[0, 1], [2, 4], [2], [3, 5, 7], [5, 7], [4, 6, 8], [3], [9, 6]]


def _slots(B: int, T: int, seed: int, rows=EDGE_ROWS):
    return DB.synth_slots(B, T, H, seed, rows=[r[:T] for r in rows])


def _pack(parts, T: int):
    docs, _, tfs, flags = parts[:4]
    return TK.pack_with_flags(docs, tfs, flags).numpy()


def _lanes_by_doc(packed, T: int):
    """Each row's kept (doc, tfs...) lanes sorted by doc."""
    out = []
    for row in packed:
        kept = row[0] >= 0
        lanes = np.concatenate([row[0:1, kept], row[1: T + 1, kept]]).T
        out.append(sorted(map(tuple, lanes.tolist())))
    return out


def _assert_packed(got, want, T: int):
    """Flags bit-equal; kept lanes equal as sets on unflagged rows.
    Returns the clean-row mask."""
    np.testing.assert_array_equal(got[:, T + 1, 0], want[:, T + 1, 0])
    clean = (want[:, T + 1, 0] & TK.FLAG_TRUNC) == 0
    g, w = _lanes_by_doc(got[clean], T), _lanes_by_doc(want[clean], T)
    assert g == w
    return clean


def _jax_scores(mode: str, p: dict, slots, w, docs, T: int):
    """The JAX program's f32 sum at docs (B, M): raw v * use per slot,
    tc tc_score of the composed lane, in slot order from 0."""
    plane = p["tf8"] if mode == "tc" else p["sc"]

    def fn(plane, code, avg, slots, w, docs):
        d = jnp.maximum(docs, 0)
        acc = jnp.zeros(docs.shape, jnp.float32)
        for t in range(T):
            v = plane[slots[:, t : t + 1], d]
            if mode == "tc":
                lane = jnp.where(v > 0, (code[d].astype(jnp.int32) << 8)
                                 | v.astype(jnp.int32), 0)
                acc = acc + JK.tc_score(lane, w[:, t : t + 1], avg)
            else:
                acc = acc + v * w[:, t : t + 1]
        return acc

    return np.asarray(jref(fn, plane, p["code"], p["avg32"], slots, w, docs))


def _assert_scores(parts, mode, p, q, T: int):
    docs, score = parts[0].numpy(), parts[1].numpy()
    kept = docs >= 0
    want = _jax_scores(mode, p, q["slots"], DB.weights(q, mode), docs, T)
    np.testing.assert_array_equal(score[kept].view(np.int32),
                                  want[kept].view(np.int32))
    assert (score[~kept] == -np.inf).all()


# -- the plain versions against the JAX steps ---------------------------------


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T,M", [(1, 16), (2, 64), (3, 254), (4, 16)])
def test_plain_full_scan_matches_jax(planes, mode, T, M):
    """The full scan over 40 blocks: M 16 takes the plain version's
    two-level top-M, M 64 and 254 (fewer than M + 1 blocks) its flat one;
    the edge rows, T 1 and padded slots; tc planes with saturated tf
    bytes and len codes >= 128."""
    p = planes
    q = _slots(8, T, 10 + T)
    N_pad = NB * 128
    tq = {k: T_(v) for k, v in q.items()}
    tp = {k: T_(v) if np.ndim(v) else torch.tensor(v) for k, v in p.items()}
    if mode == "tc":
        want = np.asarray(jref(JK.make_dense_search_kernel_tc(T, N_pad, M),
                               p["tf8"], p["code"], p["avg32"], q["slots"],
                               q["idf32"]))
        parts = TK.dense_scan_body_tc_torch(
            tp["tf8"], tp["code"], tp["avg32"], tq["slots"], tq["idf32"],
            T=T, N_pad=N_pad, M=M)
    else:
        want = np.asarray(JK.make_dense_search_kernel(T, N_pad, M)(
            *(jnp.asarray(a) for a in (p["sc"], p["tf"], q["slots"],
                                       q["use"]))))
        parts = TK.dense_scan_body_torch(tp["sc"], tp["tf"], tq["slots"],
                                         tq["use"], T=T, N_pad=N_pad, M=M)
    got = _pack(parts, T)
    clean = _assert_packed(got, want, T)
    _assert_scores(parts, mode, p, q, T)
    if T >= 2:
        assert (got[0, 0] == -1).all()  # rows 0 and 1: no match
    assert 0 < (got[2, 0] >= 0).sum() < 64  # the sparse row alone
    assert clean.any() and (got[:, 0] >= 0).sum() > M
    if mode == "tc":
        assert ((got[:, T + 1, 0] & TK.FLAG_TF_SAT) != 0).any()


@pytest.mark.parametrize("T,C,second", [(1, 256, False), (2, 512, True),
                                        (3, 1024, True), (2, 1024, False),
                                        (3, 4, True)])
def test_plain_pick_matches_jax(wide, T, C, second):
    """Both bound forms at C 256, 512 and 1,024 of 1,100 blocks (the
    tie-prone rows tie block bounds at the C-th place), and a small C;
    raw weights and tc's idf32 > 0; padded slots."""
    p = wide
    q = DB.synth_slots(8, T, 8, seed=T + C)
    for w in (q["use"], (q["idf32"] > 0).astype(np.float32)):
        kw = dict(T=T, NB=NB_WIDE, C=C)
        extra = (dict(blockmax2=p["bm2"], argpos=p["ap"]) if second
                 else {})
        jb, jn = JK._select_ub_blocks(
            jnp.asarray(p["bm"]), jnp.asarray(q["slots"]), jnp.asarray(w),
            **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
        tb, tn = TK._select_ub_blocks_torch(
            T_(p["bm"]), T_(q["slots"]), T_(w), **kw,
            **{k: T_(v) for k, v in extra.items()})
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tn.numpy().view(np.int32),
                                      np.asarray(jn).view(np.int32))
        assert (np.diff(tb.numpy(), axis=1) > 0).all()


@pytest.mark.parametrize("mode,T,C,M", [("raw", 2, 512, 64),
                                        ("tc", 3, 256, 16),
                                        ("raw", 3, 1024, 254),
                                        ("tc", 2, 1024, 64)])
def test_plain_pruned_scan_matches_jax(wide, mode, T, C, M):
    """The pruned scan (pick and scan) against the JAX pruned kernel with
    its prune guard: flags, kept lanes and their score bits, and next_ub
    against the JAX pick's."""
    p = wide
    q = DB.synth_slots(8, T, 8, seed=30 + T + C)
    ks = np.array([1, 5, 10, 30, 10, 5, 1, 10], dtype=np.int32)
    eps3 = 3e-6
    tp = {k: T_(v) if np.ndim(v) else torch.tensor(v) for k, v in p.items()}
    tq = {k: T_(v) for k, v in q.items()}
    if mode == "tc":
        want = np.asarray(jref(
            JK.make_pruned_dense_kernel_tc(T, NB_WIDE, C, M, eps3),
            p["tf8"], p["code"], p["avg32"], p["bm"], p["bm2"], p["ap"],
            q["slots"], q["idf32"], ks))
        bound_w = (q["idf32"] > 0).astype(np.float32)
    else:
        want = np.asarray(JK.make_pruned_dense_kernel(T, NB_WIDE, C, M, eps3)(
            *(jnp.asarray(a) for a in (p["sc"], p["tf"], p["bm"], p["bm2"],
                                       p["ap"], q["slots"], q["use"], ks))))
        bound_w = q["use"]
    parts = DB.pruned_call(TK.pruned_scan_body_torch, tp, tq, mode, C, M)
    got = TK._pack_pruned(parts, T_(ks), M, eps3).numpy()
    _assert_packed(got, want, T)
    _assert_scores(parts, mode, p, q, T)
    _, jn = JK._select_ub_blocks(
        jnp.asarray(p["bm"]), jnp.asarray(q["slots"]), jnp.asarray(bound_w),
        T=T, NB=NB_WIDE, C=C, blockmax2=jnp.asarray(p["bm2"]),
        argpos=jnp.asarray(p["ap"]))
    np.testing.assert_array_equal(parts[4].numpy().view(np.int32),
                                  np.asarray(jn).view(np.int32))


# -- the dispatch and the cheap checks ----------------------------------------


def _scan_args(planes, mode: str, T: int = 2, B: int = 4):
    t = {k: T_(v) if np.ndim(v) else torch.tensor(v)
         for k, v in planes.items()}
    q = {k: T_(v) for k, v in _slots(B, T, 1).items()}
    if mode == "tc":
        return ((t["tf8"], None, q["slots"], q["idf32"]),
                dict(len_code=t["code"], avg32=t["avg32"]))
    return (t["sc"], t["tf"], q["slots"], q["use"]), {}


def _bad_scan(case: str, args, kw):
    args, kw = list(args), dict(kw)
    if case == "plane_f64":
        args[0] = args[0].to(torch.float64)
    elif case == "plane_strided":
        args[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    elif case == "plane_offset":  # contiguous, but 4 bytes off 16
        args[0] = args[0].reshape(-1)[1:].contiguous()[: args[0].numel()]
    elif case == "tf_int64":
        args[1] = args[1].to(torch.int64)
    elif case == "slots_int64":
        args[2] = args[2].to(torch.int64)
    elif case == "slots_shape":
        args[2] = args[2][:, :1].contiguous()
    elif case == "weights_rows":
        args[3] = args[3][1:].contiguous()
    elif case == "weights_meta":
        args[3] = torch.empty(args[3].shape, device="meta")
    elif case == "code_int32":
        kw["len_code"] = kw["len_code"].to(torch.int32)
    elif case == "code_short":
        kw["len_code"] = kw["len_code"][:128].contiguous()
    elif case == "avg_two":
        kw["avg32"] = torch.stack([kw["avg32"], kw["avg32"]])
    elif case == "blocks_int32":
        kw["blocks"] = torch.zeros((args[2].shape[0], 2), dtype=torch.int32)
    elif case == "blocks_too_many":
        kw["blocks"] = torch.zeros((args[2].shape[0], NB + 1),
                                   dtype=torch.int64)
    return args, kw


SCAN_BAD = [("plane_f64", "raw"), ("plane_strided", "raw"),
            ("plane_offset", "raw"), ("tf_int64", "raw"),
            ("slots_int64", "tc"), ("slots_shape", "raw"),
            ("weights_rows", "tc"), ("weights_meta", "raw"),
            ("code_int32", "tc"), ("code_short", "tc"), ("avg_two", "tc"),
            ("blocks_int32", "raw"), ("blocks_too_many", "raw"),
            ("M_zero", "raw"), ("M_over_lanes", "tc"),
            ("M_over_block_lanes", "raw"), ("T_zero", "raw"),
            ("N_pad_ragged", "raw")]


@pytest.mark.parametrize("case,mode", SCAN_BAD)
def test_scan_args_ok_refuses_what_check_inputs_refuses(planes, case, mode):
    """Each bad argument: check_inputs raises ValueError, args_ok is
    False, the dispatcher raises ValueError (CPU) and dense_scan raises
    check_inputs's ValueError before any launch or count."""
    args, kw = _scan_args(planes, mode)
    T, N_pad, M = 2, NB * 128, 16
    if case == "M_zero":
        M = 0
    elif case == "M_over_lanes":
        M = N_pad + 1
    elif case == "M_over_block_lanes":  # C = 2 blocks hold 256 lanes
        M = 257
        kw = dict(kw, blocks=torch.zeros((args[2].shape[0], 2),
                                         dtype=torch.int64))
    elif case == "T_zero":
        T = 0
    elif case == "N_pad_ragged":
        N_pad = NB * 128 - 64
    else:
        args, kw = _bad_scan(case, args, kw)
    kw.update(T=T, N_pad=N_pad, M=M)
    with pytest.raises(ValueError):
        D.check_inputs(*args, **kw)
    assert not D.args_ok(*args, **kw)
    D.reset_launch_counts()
    with pytest.raises(ValueError) as err:
        D.dense_scan(*args, **kw)
    assert "CUDA tensors" not in str(err.value)
    assert D.launch_counts == {"dense_scan": 0, "dense_scan_tc": 0,
                               "dense_tc_table": 0, "dense_scan_merge": 0,
                               "dense_pick": 0, "phrase_sweep": 0,
                               "phrase_sweep_tc": 0, "phrase_select": 0,
                               "phrase_select_tc": 0, "phrase_band": 0,
                               "phrase_band_tc": 0}
    if "blocks" not in kw:
        with pytest.raises(ValueError):
            if mode == "tc":
                TK.dense_scan_body_tc(args[0], kw["len_code"], kw["avg32"],
                                      args[2], args[3], T=T, N_pad=N_pad,
                                      M=M)
            else:
                TK.dense_scan_body(*args, T=T, N_pad=N_pad, M=M)


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_cpu_tensors_take_the_plain_version(planes, mode):
    """Good arguments: check_inputs and args_ok accept them, the
    dispatcher's output is the plain version's, and dense_scan refuses
    CPU tensors (it runs on CUDA ones only)."""
    args, kw = _scan_args(planes, mode)
    kw.update(T=2, N_pad=NB * 128, M=16)
    D.check_inputs(*args, **kw)
    assert D.args_ok(*args, **kw)
    blk = torch.tensor([[0, 3, 7]] * 4, dtype=torch.int64)
    assert D.args_ok(*args, **dict(kw, blocks=blk))
    # any M up to the lane set (past KEY_SMEM_CAP keys the lists leave
    # shared memory)
    for M in (3 * 128, NB * 128):
        big = dict(kw, M=M, blocks=blk if M == 3 * 128 else None)
        D.check_inputs(*args, **big)
        assert D.args_ok(*args, **big)
    if mode == "tc":
        t = (args[0], kw["len_code"], kw["avg32"], args[2], args[3])
        got = TK.dense_scan_body_tc(*t, T=2, N_pad=NB * 128, M=16)
        want = TK.dense_scan_body_tc_torch(*t, T=2, N_pad=NB * 128, M=16)
    else:
        got = TK.dense_scan_body(*args, T=2, N_pad=NB * 128, M=16)
        want = TK.dense_scan_body_torch(*args, T=2, N_pad=NB * 128, M=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.dense_scan(*args, **kw)


PICK_BAD = ["bm_f64", "bm2_alone", "argpos_int32", "bm2_shape", "C_zero",
            "C_at_NB", "T_zero", "slots_float", "weights_cols"]


@pytest.mark.parametrize("case", PICK_BAD + ["good", "good_sum"])
def test_pick_args_ok_matches_check_pick_inputs(wide, case):
    p = {k: T_(v) for k, v in wide.items() if np.ndim(v)}
    q = {k: T_(v) for k, v in DB.synth_slots(4, 2, 8, 1).items()}
    args = [p["bm"], q["slots"], q["use"]]
    kw = dict(T=2, NB=NB_WIDE, C=16, blockmax2=p["bm2"], argpos=p["ap"])
    if case == "bm_f64":
        args[0] = args[0].double()
    elif case == "bm2_alone":
        kw["argpos"] = None
    elif case == "argpos_int32":
        kw["argpos"] = kw["argpos"].int()
    elif case == "bm2_shape":
        kw["blockmax2"] = kw["blockmax2"][:, :-1].contiguous()
    elif case == "C_zero":
        kw["C"] = 0
    elif case == "C_at_NB":
        kw["C"] = NB_WIDE
    elif case == "T_zero":
        kw["T"] = 0
    elif case == "slots_float":
        args[1] = args[1].float()
    elif case == "weights_cols":
        args[2] = args[2][:, :1].contiguous()
    elif case == "good_sum":
        kw.update(blockmax2=None, argpos=None)
    if case.startswith("good"):
        D.check_pick_inputs(*args, **kw)
        assert D.pick_args_ok(*args, **kw)
        blk, nxt = TK._select_ub_blocks(*args, **kw)
        want = TK._select_ub_blocks_torch(*args, **kw)
        np.testing.assert_array_equal(blk.numpy(), want[0].numpy())
        with pytest.raises(ValueError, match="CUDA tensors"):
            D.dense_pick(*args, **kw)
        return
    with pytest.raises(ValueError):
        D.check_pick_inputs(*args, **kw)
    assert not D.pick_args_ok(*args, **kw)
    D.reset_launch_counts()
    with pytest.raises(ValueError) as err:
        D.dense_pick(*args, **kw)
    assert "CUDA tensors" not in str(err.value)
    with pytest.raises(ValueError):
        TK._select_ub_blocks(*args, **kw)
    assert D.launch_counts["dense_pick"] == 0


def test_pruned_checks_cover_pick_and_scan(wide):
    """pruned_scan_body's check: the pick's and the scan's conditions,
    and M <= C * 128."""
    tp = {k: T_(v) if np.ndim(v) else torch.tensor(v)
          for k, v in wide.items()}
    tq = {k: T_(v) for k, v in DB.synth_slots(4, 2, 8, 2).items()}
    good = DB.pruned_call(TK.pruned_scan_body, tp, tq, "raw", 2, 64)
    want = DB.pruned_call(TK.pruned_scan_body_torch, tp, tq, "raw", 2, 64)
    for a, b in zip(good, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for C, M in ((2, 257), (NB_WIDE, 16)):
        with pytest.raises(ValueError):
            DB.pruned_call(TK.pruned_scan_body, tp, tq, "raw", C, M)
        args = (tp["sc"], tp["tf"], None, None, tp["bm"], tp["bm2"],
                tp["ap"], tq["slots"], tq["use"])
        assert not D.pruned_args_ok(*args, T=2, NB=NB_WIDE, C=C, M=M)
    tq["use"] = tq["use"].double()
    with pytest.raises(ValueError):
        DB.pruned_call(TK.pruned_scan_body, tp, tq, "raw", 4, 16)


# -- the launch plans ---------------------------------------------------------


def _eff(nseg: int, B: int, resident: int) -> float:
    """The grid's share of its whole waves."""
    items = nseg * B
    return items / (-(-items // resident) * resident)


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T", T_BUCKETS)
def test_plan_at_every_engine_shape(mode, T):
    """B in {1, 7, 8, 128, 512, 1,024}, the full scan over 157, 1,954 and
    7,816 blocks and the pruned scan over C 256, 512 and 1,024, M 64 and
    254 (and 1,500 and 5,000, past the shared lists), at three resident
    counts: shared bytes within the H100's 227 KB and equal to dense.cu's
    layout, the running lists in a scratch past KEY_SMEM_CAP, segments of
    whole steps that cover the lane set, whole waves wherever the plan
    says so, the pick's bounds in shared memory up to 51,200 blocks."""
    for B in (1, 7, 8, 128, 512, 1024):
        for nblk in (157, 1954, 7816, 256, 512, 1024):
            for M in (64, 254, 1500, 5000):
                if M > nblk * 128:
                    continue
                listed = nblk in (256, 512, 1024)  # the pruned scan's C
                for resident in (264, 396, 528):
                    p = D.plan(B, T, nblk, M, mode, resident, listed)
                    assert p.K == M + 1 and p.KP >= p.K
                    assert p.KP & (p.KP - 1) == 0
                    in_smem = p.KP <= D.KEY_SMEM_CAP
                    assert p.r_words == (0 if in_smem
                                         else 4 * B * p.nseg * p.KP)
                    assert D.MIN_STAGES <= p.NS <= D.MAX_STAGES
                    assert p.step_blocks in (1, 2, 4, 8)
                    assert p.bps % p.step_blocks == 0
                    assert (p.nseg - 1) * p.bps < nblk <= p.nseg * p.bps
                    assert p.smem == D.scan_bytes(T, p.KP, mode, p.NS,
                                                  p.step_blocks, listed)
                    assert not listed or p.bps <= D.IDS_CAP
                    assert p.smem <= D.MAX_SMEM and B <= D.MAX_B
                    assert p.launches == 1 + (p.nseg > 1) + (mode == "tc")
                    assert p.table_words == (D.TC_TABLE_WORDS
                                             if mode == "tc" else 0)
                    assert p.merge_smem == (D.merge_bytes(p.KP)
                                            if p.nseg > 1 else 0)
                    assert p.merge_smem <= D.MAX_SMEM
                    # whole waves: within WAVE_EFF of them, or one
                    # segment when the queries fill two waves, or the most
                    # the steps allow
                    items = B * p.nseg
                    waves = -(-items // resident)
                    assert p.wave_eff == pytest.approx(
                        items / (waves * resident))
                    steps = -(-nblk // p.step_blocks)
                    least = (-(-steps // (D.IDS_CAP // p.step_blocks))
                             if listed else 1)
                    most = max(least, steps // D.MIN_SEG_STEPS)
                    assert least <= p.nseg <= most
                    assert (p.wave_eff >= D.WAVE_EFF
                            or (p.nseg == least and B >= 2 * resident)
                            or p.wave_eff >= max(
                                _eff(-(-steps // -(-steps // n)), B,
                                     resident)
                                for n in range(least, most + 1)))
                    assert p.out_words == B * (2 * M + T * M + 1)
                    assert p.part_words == (2 * B * p.nseg * p.K
                                            if p.nseg > 1 else 0)
            for C in (256, 512, 1024):
                for NBp in (1954, 7816, 65536):
                    if C >= NBp:
                        continue
                    pp = D.pick_plan(B, T, NBp, C)
                    assert pp.smem <= D.MAX_SMEM
                    assert pp.ub_smem == (NBp * 4 <= D.UB_SMEM_BYTES)
                    assert pp.scratch_words == (
                        B * NBp if pp.nsplit > 1 or not pp.ub_smem else 0)
                    assert pp.done_words == (B if pp.nsplit > 1 else 0)


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T", range(1, 9))
def test_scan_layout_fits_every_T_and_M(mode, T):
    """Every T up to 8 and every M the engine asks (1 to 5,000, each side
    of the powers of 2 and of KEY_SMEM_CAP), over every block and over a
    block list: a layout within the block's shared memory, and room for
    two CTAs an SM wherever a step of one block leaves it."""
    Ms = sorted({1, 2, 5000} | {v + d for e in range(1, 13)
                                for v in (1 << e,) for d in (-2, -1, 0)})
    for M in Ms:
        KP = 1 << max(0, M).bit_length()
        for listed in (False, True):
            NS, SB, smem = D.scan_layout(T, KP, mode, listed)
            assert smem <= D.MAX_SMEM
            assert D.MIN_STAGES <= NS <= D.MAX_STAGES and SB in (1, 2, 4, 8)
            assert smem == D.scan_bytes(T, KP, mode, NS, SB, listed)
            assert (smem <= D.SMEM_TWO_CTAS or D.scan_bytes(
                T, KP, mode, D.MIN_STAGES, 1, listed) > D.SMEM_TWO_CTAS)
        p = D.plan(8, T, 7816, M, mode, 264)
        assert p.smem <= D.MAX_SMEM


@pytest.mark.parametrize("B,NB,want", [(1, 7816, 7), (8, 7816, 7),
                                       (8, 1954, 1), (16, 65536, 9),
                                       (100, 7816, 2), (132, 7816, 1),
                                       (1024, 7816, 1), (2, 1100, 1)])
def test_pick_plan_splits_small_groups(B, NB, want):
    """A group of fewer than PICK_SPLIT_CTAS queries splits each query's
    bounds over up to that many CTAs together, each part at least
    PICK_PART blocks; the parts write a (B, NB) scratch and count
    themselves on B words; a larger group takes one CTA a query."""
    pp = D.pick_plan(B, 2, NB, 256)
    assert pp.nsplit == want
    assert pp.nsplit == 1 or (B * pp.nsplit <= D.PICK_SPLIT_CTAS + B
                              and NB // pp.nsplit >= D.PICK_PART)
    assert pp.scratch_words == (B * NB if want > 1 or not pp.ub_smem else 0)
    assert pp.done_words == (B if want > 1 else 0)


def test_scan_layout_counts_every_region():
    """scan_bytes: the mbarriers and the row count (48 B), 3 counters, a
    flush's scratch, T row offsets, row indices and weights (each 16-byte
    aligned), a block list's ids, tc's cache and norm tables, NS stages
    of T row segments (and the len-code segment, tc), two running lists
    of KP keys (up to KEY_SMEM_CAP) and two steps of keys."""
    F = D.FLUSH_BYTES
    # raw, T 3, KP 128, 4 stages of 8 blocks: 3 rows of 4 KB a stage
    assert D.scan_bytes(3, 128, "raw", 4, 8) == (
        48 + 16 + F + 32 + 16 + 16 + 4 * 3 * 4096 + 16 * 128 + 16 * 1024)
    # tc, T 2, KP 256, 2 stages of 4 blocks: 2 rows and the codes
    assert D.scan_bytes(2, 256, "tc", 2, 4) == (
        48 + 16 + F + 16 + 16 + 16 + 1024 + 4 * 256 * D.TC_TFT
        + 2 * (2 * 512 + 512) + 16 * 256 + 16 * 512)
    # past KEY_SMEM_CAP the lists live in the scratch
    assert D.scan_bytes(2, 8192, "raw", 2, 8) == (
        48 + 16 + F + 16 + 16 + 16 + 2 * 2 * 4096 + 16 * 1024)
    # a block list: its segment's ids
    assert D.scan_bytes(2, 128, "raw", 2, 8, listed=True) == (
        48 + 16 + F + 16 + 16 + 16 + 8 * D.IDS_CAP + 2 * 2 * 4096
        + 16 * 128 + 16 * 1024)
    assert D.merge_bytes(128) == 16 + 16 * 1024 + F + 16 * 128
    assert D.merge_bytes(8192) == 16 + 16 * 1024 + F


# -- the tc tables -------------------------------------------------------------


@pytest.mark.parametrize("idf", [0.1, 2.75, 11.3])
@pytest.mark.parametrize("avg", [1.0, 57.25, 312.7])
def test_tc_tables_equal_jax_tc_score(avg, idf):
    """idf * norm[code, tf] (the shared table, below TC_TFT) and the
    device table (every tf byte, 255 the fixed bound) as the tc scan
    scores a lane equal the JAX tc_score bit for bit on all 65,536 (len
    code, tf) lanes; cache equals the length term of tc_score."""
    avg32 = np.float32(avg)
    lanes = (np.arange(256, dtype=np.int32)[:, None] << 8
             | np.arange(256, dtype=np.int32)[None, :])
    cache, norm = D.tc_tables(torch.tensor(avg32))
    assert cache.dtype == norm.dtype == torch.float32
    assert tuple(norm.shape) == (256, D.TC_TFT)
    w = np.float32(idf)
    want = np.asarray(jref(lambda l, i, a: JK.tc_score(l, i, a), lanes,
                           w, avg32))
    got = D.tc_lane_scores(torch.tensor(avg32), float(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    below = (torch.tensor(w) * norm).numpy()
    np.testing.assert_array_equal(below.view(np.int32),
                                  want[:, :D.TC_TFT].view(np.int32))
    # the device table's plain version: every (tf, code) lane at idf 1
    table = D.tc_table(torch.tensor(avg32)).numpy()
    want1 = np.asarray(jref(lambda l, i, a: JK.tc_score(l, i, a), lanes,
                            np.float32(1.0), avg32))
    np.testing.assert_array_equal(table.view(np.int32),
                                  want1.T.view(np.int32))
    # the length term: tc_score of tf 1 is idf * 2.2 / (1 + cache)
    one = np.asarray(jref(lambda l, i, a: JK.tc_score(l, i, a),
                          lanes[:, 1], np.float32(1.0), avg32))
    k1p1 = np.float32(2.2)
    np.testing.assert_array_equal(
        (k1p1 / (np.float32(1.0) + cache.numpy())).view(np.int32),
        one.view(np.int32))


# -- the bytes bound ----------------------------------------------------------


def test_bound_bytes_hand_count():
    """Two queries sharing row 1 over 2 blocks (256 lanes), M 2, 3 kept
    lanes: the group reads 3 distinct rows x 2 blocks, per query 4 (row,
    block) pairs each."""
    s = np.array([[1, 2], [1, 3]], dtype=np.int32)
    tail = 2 * 2 * 8 + 3 * 2 * 4 + 2 * (2 * 2 + 2 * 2 + 1) * 4  # 32 + 24 + 72
    assert DB.bound_bytes(s, "raw", 256, 2, kept=3) == 6 * 512 + tail
    assert DB.bound_bytes(s, "raw", 256, 2, kept=3, per_query=True) == (
        8 * 512 + tail)
    assert DB.bound_bytes(s, "tc", 256, 2, kept=3) == (
        6 * 128 + 2 * 128 + 32 + 3 * 2 + 72)
    # pruned: block 0 for query 0, block 1 for query 1; the list read
    blk = np.array([[0], [1]])
    assert DB.bound_bytes(s, "raw", 256, 2, kept=3, blocks=blk) == (
        4 * 512 + 16 + tail)
    assert DB.pick_bound_bytes(s, 10, 3) == 3 * 10 * 9 + 32 + 48 + 8
    assert DB.pick_bound_bytes(s, 10, 3, second=False,
                               per_query=True) == 4 * 10 * 4 + 32 + 48 + 8


# -- the build digest ---------------------------------------------------------


def test_build_digest_covers_the_shared_headers(tmp_path):
    """A library's file name hashes its source, every .cuh header of its
    directory and the flags: an edit to the shared header alone names
    another library, an unrelated file does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("dense.cu", "keys.cuh"):
        shutil.copy(os.path.join(build.CSRC, name), csrc / name)
    src = str(csrc / "dense.cu")
    flags = build.NVCC_FLAGS + build.EXTRA_NVCC_FLAGS["dense"]
    d0 = build.source_digest(src, flags)
    (csrc / "notes.txt").write_text("not a header")
    assert build.source_digest(src, flags) == d0
    with open(csrc / "keys.cuh", "a") as f:
        f.write("\n// an edit\n")
    d1 = build.source_digest(src, flags)
    assert d1 != d0
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert build.source_digest(src, flags) not in (d0, d1)
    assert build.source_digest(src, build.NVCC_FLAGS) != build.source_digest(
        src, flags)
    assert "-fmad=false" in build.EXTRA_NVCC_FLAGS["dense"]


# -- dense_bench's --trees runner ---------------------------------------------


def _run(tree: str) -> dict:
    rows = {m: [{"kind": "full", "B": 128, "T": 2, "device_ms": 0.5,
                 "flushed_ms": 0.6, "host_us": 40.0, "share": 0.1}]
            for m in ("raw", "tc")}
    return {"tree": tree, "card": "card", "timing": rows,
            "routes": {"raw": {"dense_t3": {
                "wall_s": 1.0, "traced": {
                    "device_busy_ms": 2.0, "busy_share": 0.5, "top_ops": [
                        {"kernel": "void wiser_dense::scan_kernel<false>",
                         "self_ms": 0.5},
                        {"kernel": "reduce_kernel", "self_ms": 0.25}]}}}}}


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
    res = DB.main(["--trees", "old,.,.,old", "--index", "idx",
                   "--out", str(out)])
    assert seen == [("dense_bench.py", ["old", ".", ".", "old"],
                     ["--routes", DB.ROUTES, "--index",
                      os.path.abspath("idx")])]
    assert [r["tree"] for r in res["runs"]] == ["old", ".", ".", "old"]
    assert json.loads(out.read_text()) == res
    s = DB.summary(res["runs"])["dense_bench"]
    assert s[0]["full_raw_B128_T2"] == [0.5, 0.6, 40.0, 0.1]
    assert s[0]["raw_dense_t3"] == [1.0, 2.0, 0.5, 0.5]
    assert set(DB.ROUTES.split(",")) == {
        "dense_t3", "zipf_t2", "zipf_t3", "zipf_t4", "dense_all_head_pair"}


# -- the slice as a whole -----------------------------------------------------


def _head_docs(seed: int, n: int = 1600):
    """All-head conjunctions: h0, h1, h2 in most docs, with varied tfs
    and lengths, beside rare r-terms."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        toks = []
        for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7)):
            if rng.random() < p:
                toks += [t] * int(rng.integers(1, 4))
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 30))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=False))
    return docs


@pytest.fixture(scope="module")
def head_corpus():
    jp, oracle = build_index(_head_docs(23))
    port = packed_from_arrays({f: getattr(jp, f)
                               for f in jp.__dataclass_fields__})
    return jp, port, oracle


HEAD_QS = [(["h0", "h1"], 10), (["h1", "h2"], 5), (["h0", "h1", "h2"], 10),
           (["h2", "h0"], 1), (["h1", "h0"], 37), (["h0", "h2", "h1"], 3)]

# the flag and rescue counters both engines keep (the route counters are
# the port's own)
FLAG_KEYS = ("flag_", "prune_rescued", "forced_host")


def _flags(st: dict) -> dict:
    return {k: v for k, v in st.items() if k.startswith(FLAG_KEYS) and v}


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(TK, name)

    def wrapped(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(TK, name, wrapped)
    return calls


def _lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_slice_matches_the_jax_engines(head_corpus, monkeypatch, columns):
    """TorchEngine against TpuEngine (and the oracle) over the all-head
    mix: the full scan at the default thresholds; the pruned scan with
    the rescue at C 4 of 13 blocks (PRUNED_DENSE_MIN_NB lowered, as
    test_torch_dense.py does); a 2-shard ShardedEngine's dense step
    against the JAX mesh on two virtual devices. Same results, and flag
    and rescue counts where the JAX engine keeps them (TpuEngine); every
    query takes the route named (the port's own route counters); the
    port's dispatchers ran."""
    jp, port, oracle = head_corpus
    qs = [SearchQuery(t, n_results=k) for t, k in HEAD_QS]
    jqs = [JQuery(q.terms, n_results=q.n_results) for q in qs]
    want = _lists(oracle.search(q) for q in jqs)
    scans = _spy(monkeypatch, "dense_scan_body" if columns == "raw"
                 else "dense_scan_body_tc")
    pruned = _spy(monkeypatch, "pruned_scan_body")
    for over in ({}, {"PRUNED_DENSE_C": 4, "PRUNED_DENSE_MIN_NB": 8}):
        je = TpuEngine(jp, columns=columns)
        te = TorchEngine(port, device="cpu", columns=columns)
        for e in (je, te):
            for k, v in over.items():
                setattr(e, k, v)
        got = _lists(te.search_batch(qs))
        assert got == _lists(je.search_batch(jqs)) == want
        st = te.stats_take()
        assert _flags(st) == _flags(je.stats_take())
        if over:
            assert st["route_pruned"] == len(qs) and st["prune_rescued"] > 0
        else:
            assert st["route_dense"] == len(qs)
    assert scans and pruned
    n_scans = len(scans)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
    tm = ShardedEngine(ShardedIndex.from_packed(port, 2), devices=["cpu"] * 2,
                       columns=columns)
    jm = JShardedEngine(JShardedIndex.from_packed(jp, 2), mesh=mesh,
                        columns=columns)
    got = _lists(tm.search_batch(qs))
    assert got == _lists(jm.search_batch(jqs)) == want
    assert tm.stats_take()["route_dense"] == len(qs)
    assert len(scans) >= n_scans + 2  # a step a shard


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = DB.check_cases(torch.device("cuda", 0))
    assert out["flagged_rows"] > 0 and out["max_abs_err"] == 0.0
