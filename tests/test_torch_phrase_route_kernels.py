"""The semidense phrase route and the list chain (wiser_tpu_torch/ops/
phrase_route.py, csrc/phrase_route.cu) on the CPU.

The same seeded numpy inputs (tools/phrase_bench.synth_columns and
phrase_batch: planted phrases, bags in no sorted order, a bag holding
65,535, random bloom columns with absent rows, one query a group without
an active probe) go through the JAX kernels and the port's entry points,
which on CPU tensors run the plain versions:

- make_semidense_phrase_kernel (raw and tc) against
  kernels.semidense_phrase_body, T 2-4, ties straddling the (KV+1)-th
  lane (KV 4-64 over quantized scores), fewer than KV + 1 matches (KV
  1,024), PP above every bag, L 32,768;
- the JAX list chain (make_match_kernel{,_tc} with the bloom gate,
  make_phrase_verify_kernel, make_select_topk_kernel{,_tc}, the torch
  glue of wiser_tpu's dispatch between them) against kernels.list_phrase,
  T 2-4, ties, every probe inactive, PP above every bag, L 128-1,024.

Tolerance: none. The packed (B, T+2, M) outputs are equal bit for bit:
both selections keep lax.top_k's order (the port's plain versions sort
stably), so tied lanes come out in the same places. The JAX tc programs
are compiled without XLA's FMA contraction (as test_torch_tc_kernels).
Also: the argument checks, CPU tensors taking the plain versions, the
engine's list branch as one call, the launch plans at the engine's
shapes, and hand counts of both bytes bounds. The card's check (the
kernels against the plain versions) is marked cuda and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.ops import phrase as P
from wiser_tpu_torch.ops import phrase_route as R
from wiser_tpu_torch.ops import semidense as SD
from wiser_tpu_torch.tools import phrase_bench as PB

NO_FMA = {"xla_backend_optimization_level": 0}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jref(fn, *args):
    """fn(*args) as one JAX program without FMA contraction, as numpy."""
    args = [None if a is None else jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(NO_FMA)(*args)


_COLS = {}


def columns(case):
    """synth_columns of a case (name, seed, n_docs, dfs, ...), cached
    for the module."""
    key = case[0]
    if key not in _COLS:
        tie, sb = (case[11], case[12]) if len(case) == 13 else (case[9],
                                                                 case[11])
        _COLS[key] = PB.synth_columns(case[1], case[2], case[3], tie=tie,
                                      sorted_bags=sb)
    return _COLS[key]


def sdp_inputs(case, mode):
    (_, seed, n_docs, dfs, B, T, L, KV, PP, PW, M, tie, sb) = case
    cols = columns(case)
    batch = PB.phrase_batch(cols, B, T, M, seed + 100)
    return cols, batch


# every case raw and tc, but L 32,768 raw only (time)
SDP_RUNS = [(c, m) for c in PB.SDP_CASES for m in ("raw", "tc")
            if not (c[0] == "long_l" and m == "tc")]


@pytest.mark.parametrize("case,mode", SDP_RUNS,
                         ids=[f"{c[0]}-{m}" for c, m in SDP_RUNS])
def test_semidense_phrase_equals_jax(case, mode):
    cols, batch = sdp_inputs(case, mode)
    args, kw = PB.semidense_case(case, mode, CPU)
    got = TK.semidense_phrase_body(*args, **kw).numpy()
    T, L, KV, PP, PW, M = (kw[k] for k in ("T", "L", "KV", "PP", "PW", "M"))
    if mode == "raw":
        ja = (cols["doc"], cols["score"], cols["tf"], cols["dense_sc"])
        w = batch["use"]
    else:
        ja = (cols["doc"], cols["tc"], cols["avg32"][0], cols["dense_tf8"])
        w = batch["idf"]
    ja += (cols["positions"], cols["pos_starts"], batch["starts"],
           batch["ends"], w, batch["slots"], batch["slot_of"], batch["ks"])
    want = np.asarray(jref(JK.make_semidense_phrase_kernel(
        T, L, KV, PP, PW, M, cols["dense_sc"].shape[1], kw["n_rec_iters"],
        kw["eps3"], mode=mode), *ja))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any()  # real phrase matches


def test_semidense_phrase_cases_cover_the_edges():
    """The cases hold what they are for: a TRUNC flag, a PRUNE_MISS flag
    and rows with unseen -inf (fewer than KV + 1 matches)."""
    flags = set()
    for case in PB.SDP_CASES[:4]:
        args, kw = PB.semidense_case(case, "raw", CPU)
        out = TK.semidense_phrase_body(*args, **kw).numpy()
        flags |= {int(f) for f in out[:, kw["T"] + 1, 0]}
    assert any(f & TK.FLAG_TRUNC for f in flags)
    assert any(f & TK.FLAG_PRUNE_MISS for f in flags)
    assert 0 in flags


def jax_list_chain(cols, batch, kw, mode):
    """The JAX list chain as wiser_tpu's dispatch runs it."""
    T, L, PP, M = kw["T"], kw["L"], kw["PP"], kw["M"]
    blooms = (cols["bloom_rows"], cols["bloom_bitmap"], cols["bloom_rank"],
              batch["probe_slot"], batch["probe_begins"], batch["probe_mask"],
              batch["probe_active"])
    if mode == "raw":
        out = jref(JK.make_match_kernel(T, L, kw["n_bs_iters"]), cols["doc"],
                   cols["score"], batch["starts"], batch["ends"],
                   batch["use"], *blooms)
        match, bpass, cdocs, pidx, score = (np.asarray(o) for o in out)
    else:
        out = jref(JK.make_match_kernel_tc(T, L, kw["n_bs_iters"]),
                   cols["doc"], cols["tc"], cols["avg32"][0], batch["starts"],
                   batch["ends"], batch["idf"], *blooms)
        match, bpass, cdocs, pidx, score, sat = (np.asarray(o) for o in out)
    active = match & bpass
    pidx_q = np.take_along_axis(pidx, batch["slot_of"][:, :, None].repeat(
        L, 2), 1)
    n = np.asarray(jref(JK.make_phrase_verify_kernel(T, L, PP,
                                                     kw["n_pos_iters"]),
                        cols["positions"], cols["pos_starts"], pidx_q,
                        active))
    final = active & (n > 0)
    if mode == "raw":
        return np.asarray(jref(JK.make_select_topk_kernel(T, L, M),
                               cols["tf"], cdocs, pidx, score, final)), active
    return np.asarray(jref(JK.make_select_topk_kernel_tc(T, L, M),
                           cols["tc"], cdocs, pidx, score, final, sat)), active


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("case", PB.LIST_CASES, ids=[c[0] for c in
                                                     PB.LIST_CASES])
def test_list_chain_equals_jax(case, mode):
    (_, seed, n_docs, dfs, B, T, L, PP, M, tie, off, sb) = case
    cols = columns(case)
    batch = PB.phrase_batch(cols, B, T, M, seed + 100, probes_off=off)
    args, kw = PB.list_case(case, mode, CPU)
    got = TK.list_phrase(*args, **kw).numpy()
    want, active = jax_list_chain(cols, batch, kw, mode)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).any() and active.any()
    assert not batch["probe_active"][0].any()  # a query with no probe


def test_list_cases_cover_the_edges():
    """An absent bloom row prunes some matched lanes; a bag holds the
    65,535 position; PP passes every bag of a case."""
    cols = columns(PB.LIST_CASES[1])
    assert (cols["positions"][:-PB.POS_PAD] == 65535).any()
    case = PB.LIST_CASES[1]
    batch = PB.phrase_batch(cols, case[4], case[5], case[8], case[1] + 100)
    args, kw = PB.list_case(case, "raw", CPU)
    match, bpass, *_ = TK.make_match_kernel(kw["T"], kw["L"],
                                            kw["n_bs_iters"])(
        args[0], args[1], args[4], args[5], args[6], *args[8:])
    assert (match & ~bpass).any() and (match & bpass).any()
    pp_case = PB.LIST_CASES[4]
    assert pp_case[7] > columns(pp_case)["max_tf"]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = []

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran for CPU tensors")

    monkeypatch.setattr(R, "semidense_phrase", refuse)
    monkeypatch.setattr(R, "list_phrase", refuse)
    for name in ("semidense_phrase_torch", "list_phrase_torch"):
        orig = getattr(TK, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(TK, name, wrapped)
    args, kw = PB.semidense_case(PB.SDP_CASES[0], "raw", CPU)
    TK.semidense_phrase_body(*args, **kw)
    args, kw = PB.list_case(PB.LIST_CASES[0], "tc", CPU)
    TK.list_phrase(*args, **kw)
    assert calls == ["semidense_phrase_torch", "list_phrase_torch"]


def test_the_wrappers_refuse_cpu_tensors():
    args, kw = PB.semidense_case(PB.SDP_CASES[0], "raw", CPU)
    with pytest.raises(ValueError, match="CUDA"):
        R.semidense_phrase(*args, **kw)
    args, kw = PB.list_case(PB.LIST_CASES[0], "raw", CPU)
    with pytest.raises(ValueError, match="CUDA"):
        R.list_phrase(*args, **kw)


def _bad_sdp(args, kw, what):
    args, kw = list(args), dict(kw)
    if what == "T":
        kw["T"] = 9
    elif what == "M":
        kw["M"] = kw["KV"] + 1
    elif what == "doc_dtype":
        args[0] = args[0].long()
    elif what == "dense_dtype":
        args[2] = args[2].double()
    elif what == "starts_shape":
        args[5] = args[5][:, :1].contiguous()
    elif what == "slot_of_dtype":
        args[9] = args[9].long()
    elif what == "ks_shape":
        args[10] = args[10][:-1]
    elif what == "no_tf":
        kw["postings_tf"] = None
    elif what == "eps3":
        kw["eps3"] = 1.0
    elif what == "positions_dtype":
        args[3] = args[3].float()
    elif what == "kv_past_smem":
        kw["KV"] = 1 << 15
    return args, kw


@pytest.mark.parametrize("what", ["T", "M", "doc_dtype", "dense_dtype",
                                  "starts_shape", "slot_of_dtype",
                                  "ks_shape", "no_tf", "eps3",
                                  "positions_dtype", "kv_past_smem"])
def test_semidense_phrase_argument_checks(what):
    args, kw = PB.semidense_case(PB.SDP_CASES[0], "raw", CPU)
    args, kw = _bad_sdp(args, kw, what)
    with pytest.raises(ValueError):
        TK.semidense_phrase_body(*args, **kw)


@pytest.mark.parametrize("what", ["L", "M", "tc_dtype", "avg32",
                                  "bitmap_odd", "rank_short",
                                  "probe_shape", "probe_dtype", "weights",
                                  "pos_starts_dtype"])
def test_list_phrase_argument_checks(what):
    args, kw = PB.list_case(PB.LIST_CASES[0], "tc", CPU)
    args, kw = list(args), dict(kw)
    if what == "L":
        kw["L"] = R.LIST_MAX_L + 1
    elif what == "M":
        kw["M"] = kw["L"] + 1
    elif what == "tc_dtype":
        args[1] = args[1].int()
    elif what == "avg32":
        kw["avg32"] = kw["avg32"].double()
    elif what == "bitmap_odd":
        args[9] = args[9][:-1].contiguous()
    elif what == "rank_short":
        args[10] = args[10][:-1].contiguous()
    elif what == "probe_shape":
        args[11] = args[11][:-1].contiguous()
    elif what == "probe_dtype":
        args[12] = args[12].int()
    elif what == "weights":
        args[6] = args[6].double()
    elif what == "pos_starts_dtype":
        args[3] = args[3].long()
    with pytest.raises(ValueError):
        TK.list_phrase(*args, **kw)


def test_list_branch_is_one_call(monkeypatch):
    """The engine's list branch calls kernels.list_phrase once a group,
    which on the CPU runs the three plain steps; the answers are the
    oracle's."""
    from wiser_tpu_torch import TorchEngine
    from wiser_tpu_torch.data.synth import synth_docinfos, synth_query_terms
    from wiser_tpu_torch.index.builder import build_index
    from wiser_tpu_torch.types import SearchQuery

    packed, oracle = build_index(synth_docinfos(300, 120, 40, seed=7),
                                 with_blooms=True)
    te = TorchEngine(packed, device="cpu")
    calls, steps = [], []
    orig = TK.list_phrase
    monkeypatch.setattr(TK, "list_phrase",
                        lambda *a, **k: calls.append(k["T"]) or orig(*a, **k))
    for name in ("make_match_kernel", "make_phrase_verify_kernel",
                 "make_select_topk_kernel"):
        o = getattr(TK, name)
        monkeypatch.setattr(TK, name, lambda *a, _o=o, _n=name: steps.append(
            _n) or _o(*a))
    qs = [SearchQuery(t, n_results=10, is_phrase=True)
          for t in synth_query_terms(30, 30, n_terms=2, seed=13)]
    got = te.search_batch(qs)
    assert te.stats_take()["route_phrase_list"] > 0 and calls
    assert [steps.count(n) for n in ("make_match_kernel",
                                     "make_phrase_verify_kernel",
                                     "make_select_topk_kernel")] == \
        [len(calls)] * 3
    want = [oracle.search(q) for q in qs]
    assert [[(e.doc_id, e.doc_score) for e in r.entries] for r in got] == \
        [[(e.doc_id, e.doc_score) for e in r.entries] for r in want]
    assert sum(len(r.entries) for r in got) > 20


@pytest.mark.parametrize("T", [2, 3, 4, 8])
def test_plans_at_engine_shapes(T):
    """Every engine shape's layout fits the card: the semidense phrase
    route at KV 1,024 (and the rescue-size 4,096), B up to 4,096, PW up
    to PHRASE_MAX_PW, M up to KV; the list chain at L up to 1,024."""
    for KV in (1024, 4096):
        for PW in (8, 32, 128):
            for M in (1, 64, KV):
                p = R.plan_semidense(4096, T, KV, PW, M)
                assert p.K == KV + 1 and p.KP >= p.K and p.KP < 2 * p.K
                # the segmented selection's buffer: two steps past KP, or
                # three lists of KP where a query may split (KP <= 2,048)
                xc = 3 * p.KP if p.KP <= 2048 else p.KP + 2048
                assert p.smem_select == SD.HEAD_BYTES + 8 * xc
                assert p.smem_select <= R.MAX_SMEM
                assert p.smem_verify == p.W * P.warp_bytes(T, PW)
                assert 1 <= p.W <= 8 and p.smem_verify <= R.MAX_SMEM
                assert p.smem_output == 4 * 8 * (M + 1) <= R.MAX_SMEM
                assert p.scratch_bytes == 4096 * (8 * (KV + 1) + 4 * KV
                                                  + 4 * T * KV)
    assert R.plan_semidense(128, 2, 1024, 8, 24).smem_select == 50480
    for L in (1, 128, 1000, 1024):
        s = R.plan_list(T, L)
        P2 = 1 << (L - 1).bit_length()
        # the counters, the query's rows, a round's 256 active lanes
        # (lane, score, count, saturation, T posting indices, T bag starts
        # and ends), the verified keys, their posting indices and
        # saturation bytes, a flush's scratch
        assert s == (16 + 4 * 4 * 8 + 4 * 256 * (4 + 3 * T) + 8 * P2
                     + (4 * T * L + 15) // 16 * 16 + (L + 15) // 16 * 16
                     + 1056)
        assert s <= R.MAX_SMEM
    assert R.plan_list(2, 1024) == (16 + 128 + 10240 + 8192 + 8192 + 1024
                                    + 1056)


def test_select_keys_fit_the_flush_scratch():
    """select.cuh's FlushSmem: 256 histogram words, 4 words and 2 keys,
    ahead of segsel.cuh's 4 step counters and the query's 16-slot rows."""
    assert SD.HEAD_BYTES == 256 * 4 + 4 * 4 + 2 * 8 + 16 + 4 * 4 * 16


def test_semidense_bound_by_hand():
    """One query, T 2, L 4: 3 valid lanes at docs 0, 8 and 100 of a dense
    row 1 of width 128 where docs 0 and 100 hold; raw: 8 B a lane, 4 B a
    dense lane (docs 0, 8 and 100 in three 32-byte sectors), the KV + 1
    keys, 2 kept lanes x (3 T - 1) sectors, the packed output."""
    doc = torch.tensor([0, 8, 100, 127, 5, 6], dtype=torch.int32)
    dense = torch.zeros((2, 128), dtype=torch.float32)
    dense[1, 0] = dense[1, 100] = 1.0
    starts = torch.tensor([[0, 3]], dtype=torch.int32)
    ends = torch.tensor([[3, 6]], dtype=torch.int32)
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    args = (doc, None, dense, None, None, starts, ends, None, slots)
    kw = dict(T=2, L=4, KV=16, M=2)
    out = 1 * 4 * 2 * 4
    assert PB.semidense_bound_bytes(args, kw) == (
        3 * 8 + 3 * 32 + 17 * 8 + 2 * 5 * 32 + out)
    # tc: 6 B a lane, 1 B a dense lane (docs 0 and 8 share a sector)
    kw["avg32"] = torch.ones(1)
    assert PB.semidense_bound_bytes(args, kw) == (
        3 * 6 + 2 * 32 + 17 * 8 + 2 * 5 * 32 + out)


def test_list_bound_by_hand():
    """One query, T 2, L 4: 3 valid candidate lanes (docs 1, 5, 9)
    against a 10-id run holding 5 and 9: 8 B a lane, min(40 B, 3 x 32)
    of the run, no active probe, 2 sectors a bag of each matched lane (2
    terms), the packed output."""
    doc = torch.tensor([1, 5, 9, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
                       dtype=torch.int32)
    score = torch.ones(14)
    starts = torch.tensor([[0, 4]], dtype=torch.int32)
    ends = torch.tensor([[3, 14]], dtype=torch.int32)
    w = torch.ones((1, 2))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    blooms = (i32(0), i32(0, 0), i32(0, 0), i32(0)[None], torch.tensor(
        [[False]]), i32(0)[None], torch.tensor([[False]]))
    args = (doc, score, None, None, starts, ends, w, None) + blooms
    kw = dict(T=2, L=4, M=3, n_bs_iters=4)
    assert PB.list_bound_bytes(args, kw) == (
        3 * 8 + min(40, 3 * 32) + 2 * 2 * 2 * 32 + 4 * 3 * 4)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    assert PB.semidense_phrase_cases(dev)["cases"] > 0
    assert PB.list_phrase_cases(dev)["cases"] > 0
