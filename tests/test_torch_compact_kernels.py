"""The compact phrase route as hand-written kernels (csrc/phrase_route.cu:
cp_select_kernel over csrc/segsel.cuh with the bi-bloom gate, then the
semidense phrase route's verification and output), and the mesh's list
route on the list chain without its gate, checked on the CPU:

- the port's plain version (engine/kernels.compact_phrase_body_torch,
  which compact_phrase_body runs for CPU tensors) equals wiser_tpu's
  compact_phrase_body (XLA-compiled without FMA contraction) bit for bit,
  packed output and top scores, raw and tc, T 2-4: ties straddling the
  (KV+1)-th place, fewer than KV + 1 survivors, every lane gated out, a
  candidate run clamped at the column's end, tf bytes of 255, searches
  stopped short of their iteration count;
- a numpy model of the kernel's segmented selection (each segment's
  steps of 1,024 lanes pushed above the running threshold, cut to the
  top K when the buffer fills, the segments merged in a tree) equals the
  plain version's stable top KV + 1 at forced segment counts of 1 to 8;
- the plan at the engines' shapes up to L 524,288, the argument checks,
  the dispatch (CPU tensors take the plain versions, the wrappers refuse
  them), the bytes bound worked by hand;
- the mesh's list route: phrase_body equals the list chain with no probe
  (list_phrase_torch's packed output, its steps' kept scores), top scores
  bit for bit and the packed lanes wherever torch.topk's tie order cannot
  differ.

The kernels run only on a card: the `cuda`-marked test holds them against
the plain versions and skips here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.host import L_BUCKETS, PP_BUCKETS
from wiser_tpu_torch.ops import phrase_route as R
from wiser_tpu_torch.ops import semidense as SD
from wiser_tpu_torch.tools import phrase_bench as PB

CPU = torch.device("cpu")
NO_FMA = {"xla_backend_optimization_level": 0}
F32 = np.float32

# (name, seed, n_docs, dfs, B, T, L, KV, PP, PW, M, tie, sorted bags,
# edge), as phrase_bench.COMPACT_CASES, at a few hundred docs
CASES = (
    ("ties_kv8", 61, 400, (150, 300, 260, 220), 4, 2, 256, 8, 8, 8, 4,
     True, False, None),
    ("ties_kv16_t3", 62, 400, (150, 300, 260, 220), 4, 3, 256, 16, 8, 8, 8,
     True, False, None),
    ("ties_kv32_t4", 63, 500, (200, 400, 380, 360), 4, 4, 512, 32, 8, 16,
     16, True, True, None),
    ("few_kv32", 64, 300, (60, 200, 180, 150), 4, 2, 64, 32, 4, 8, 8, False,
     False, None),
    ("gated_out", 65, 400, (150, 300, 260, 220), 4, 2, 256, 16, 8, 8, 8,
     False, False, "gate_all"),
    ("clamped_t3", 66, 400, (150, 300, 260, 220), 4, 3, 512, 16, 8, 8, 8,
     False, False, "clamp"),
    ("probes_off", 67, 400, (150, 300, 260, 220), 4, 2, 256, 16, 8, 8, 8,
     True, False, "probes_off"),
    ("past_iters", 68, 400, (150, 300, 260, 220), 4, 2, 256, 32, 8, 8, 8,
     False, False, "iters"),
    # B 2 over 2,048 lanes: eight 256-lane units, so every forced segment
    # count from 1 to 8 splits it
    ("segments_ties", 69, 3000, (2100, 2600, 2400, 2300), 2, 2, 2048, 16, 8,
     8, 8, True, False, None),
)
RUNS = [(c, m) for c in CASES for m in ("raw", "tc")]
IDS = [f"{c[0]}-{m}" for c, m in RUNS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _case(case, mode):
    """(cols, batch, kw, args, plain (packed, top_score) as numpy) of a
    case, cached for the module."""
    key = (case[0], mode)
    if key not in _CACHE:
        cols, batch, shapes = PB.compact_inputs(case)
        args, kw = PB.compact_args(cols, batch, mode, CPU)
        kw.update(shapes, eps3=3e-6 if mode == "raw" else 3e-5)
        packed, top = TK.compact_phrase_body(*args, **kw)
        _CACHE[key] = (cols, batch, kw, args, (packed.numpy(), top.numpy()))
    return _CACHE[key]


def _jax_compact(cols, batch, kw, mode):
    """wiser_tpu's compact_phrase_body on the same numpy inputs."""
    tc = mode == "tc"
    fn = functools.partial(
        JK.compact_phrase_body, T=kw["T"], L=kw["L"], KV=kw["KV"],
        PP=kw["PP"], PW=kw["PW"], M=kw["M"], n_bs_iters=kw["n_bs_iters"],
        eps3=kw["eps3"], tc_mode=tc)
    a = [cols["doc"], cols["score"], cols["tf"], cols["tc"],
         cols["avg32"][0], cols["positions"], cols["pos_starts"],
         batch["starts"], batch["ends"], batch["use"], batch["idf"],
         batch["slot_of"], batch["ks"], cols["bloom_rows"],
         cols["bloom_bitmap"], cols["bloom_rank"], batch["probe_slot"],
         batch["probe_begins"], batch["probe_mask"], batch["probe_active"]]
    a = [jnp.asarray(x) for x in a]
    packed, top = jax.jit(fn).lower(*a).compile(NO_FMA)(*a)
    return np.asarray(packed), np.asarray(top)


@pytest.mark.parametrize("case,mode", RUNS, ids=IDS)
def test_plain_compact_equals_jax(case, mode):
    cols, batch, kw, _, (packed, top) = _case(case, mode)
    want_packed, want_top = _jax_compact(cols, batch, kw, mode)
    np.testing.assert_array_equal(packed, want_packed)
    np.testing.assert_array_equal(top.view(np.int32),
                                  want_top.astype(F32).view(np.int32))


def _mscore(args, kw):
    """The plain version's (B, L) surviving AND scores (-inf where a lane
    did not match or was gated out), as the selection ranks them."""
    tc = kw.get("tc_mode", False)
    _, match, pidx, score, _ = TK._match_step(
        args[0], args[1], args[5], args[6], args[7], T=kw["T"], L=kw["L"],
        n_bs_iters=kw["n_bs_iters"], avg32=kw.get("avg32") if tc else None)
    gate = TK._bloom_gate(pidx, *args[10:17])
    return torch.where(match & gate, score, TK.NEG_INF).numpy()


def test_the_cases_reach_the_edges():
    """Some query ties at the (KV+1)-th place, some keeps fewer than KV +
    1 survivors, gated_out leaves none past its probe-free query 0, the
    clamped query's slice starts before its run, FLAG_TF_SAT, FLAG_TRUNC
    and FLAG_PRUNE_MISS are raised somewhere."""
    seen = dict(tie=False, few=False, gated=False, clamp=False, sat=False,
                trunc=False, miss=False)
    for case in CASES:
        for mode in ("raw", "tc"):
            cols, batch, kw, args, (packed, _) = _case(case, mode)
            ms = _mscore(args, kw)
            KV, T = kw["KV"], kw["T"]
            srt = -np.sort(-ms, axis=1)
            n_surv = (ms > -np.inf).sum(axis=1)
            seen["tie"] |= bool(((n_surv > KV)
                                 & (srt[:, KV - 1] == srt[:, KV])).any())
            seen["few"] |= bool(((n_surv > 0) & (n_surv <= KV)).any())
            if case[-1] == "gate_all":
                seen["gated"] = bool((n_surv[1:] == 0).all())
            if case[-1] == "clamp":
                n = len(cols["doc"])
                seen["clamp"] = bool(batch["starts"][1, 0] + kw["L"] > n)
            flags = packed[:, T + 1, 0]
            seen["sat"] |= bool((flags & TK.FLAG_TF_SAT).any())
            seen["trunc"] |= bool((flags & TK.FLAG_TRUNC).any())
            seen["miss"] |= bool((flags & TK.FLAG_PRUNE_MISS).any())
    assert all(seen.values()), seen


# -- the segmented selection ---------------------------------------------------


def _top_keys(score, lanes, K):
    """The K best (score desc, lane asc) of the given lanes: keys.cuh's
    64-bit key order (-0 compares equal to +0)."""
    s = score[lanes] + F32(0.0)  # -0 read as +0
    order = np.lexsort((lanes, -s))
    return lanes[order[:K]]


def _model_select(score, K, nseg, rng):
    """The kernel's selection of one query's surviving lanes (score > -inf)
    at nseg segments: segsel.cuh's segments of whole 256-lane units, each
    CTA's steps of 1,024 lanes pushed above the running threshold in an
    order no thread fixes, cut to the top K when the buffer would
    overflow (select.cuh keep_top), sorted once; the segments merged in a
    tree into the first. Returns the K kept lanes in key order."""
    L = len(score)
    XC = SD.layout(K)[1]
    units = -(-L // SD.UNIT)
    seg_lanes = -(-units // min(nseg, units)) * SD.UNIT
    n = -(-L // seg_lanes)
    lists = []
    for seg in range(n):
        buf = np.zeros(0, dtype=np.int64)
        tau = None
        for lane0 in range(seg * seg_lanes, min(L, (seg + 1) * seg_lanes),
                           SD.STEP):
            step = np.arange(lane0, min(L, lane0 + SD.STEP,
                                        (seg + 1) * seg_lanes))
            step = step[score[step] > -np.inf]
            if tau is not None:  # keys above the last cut's K-th
                keep = _top_keys(score, np.concatenate([step, [tau]]),
                                 len(step) + 1)
                step = keep[:list(keep).index(tau)]
            buf = np.concatenate([buf, rng.permutation(step)])
            if len(buf) > XC - SD.STEP:
                buf = _top_keys(score, buf, K)
                tau = buf[-1]
        lists.append(_top_keys(score, buf, K))
    half = 1
    while half < n:
        for seg in range(0, n, 2 * half):
            if seg + half < n:
                lists[seg] = _top_keys(score, np.concatenate(
                    [lists[seg], lists[seg + half]]), K)
        half *= 2
    return lists[0]


@pytest.mark.parametrize("case,mode", RUNS, ids=IDS)
def test_segmented_selection_equals_top_stable(case, mode):
    _, _, kw, args, _ = _case(case, mode)
    ms = _mscore(args, kw)
    K = kw["KV"] + 1
    vals, idx = TK._top_stable(torch.from_numpy(ms), K)
    rng = np.random.default_rng(len(case[0]))
    for nseg in range(1, 9):
        for b in range(ms.shape[0]):
            got = _model_select(ms[b], K, nseg, rng)
            n = int((ms[b] > -np.inf).sum())
            assert len(got) == min(n, K)
            np.testing.assert_array_equal(got, idx[b, :len(got)].numpy(),
                                          err_msg=f"nseg={nseg} b={b}")
            np.testing.assert_array_equal(
                ms[b, got].view(np.int32),
                vals[b, :len(got)].numpy().view(np.int32))


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("T", [2, 3, 5, 8])
def test_plan_fits_at_engine_shapes(T):
    """Every compact group the engines form (B 8 to 4,096, L 2,048 up to
    the mesh's 524,288, PW up to the largest bag bucket, M <= KV 1,024)
    on the H100's 132 SMs (PW within the positions column's pad, as the
    engines assert): at most a cluster's 8 segments of whole
    256-lane units covering L, none empty, a split only where the merge's
    three lists fit the shared buffer, every kernel's shared bytes within
    the card's 227 KB (the selection's: the head, the probes' rows, the
    keys' buffer)."""
    KV = TorchEngine.PRUNED_PHRASE_KV
    for B in TorchEngine.PHRASE_B_BUCKETS:
        for L in [x for x in L_BUCKETS if KV < x <= 524_288]:
            for PW in [x for x in PP_BUCKETS if x <= TorchEngine.POS_PAD]:
                for M in (1, 64, KV):
                    p = R.plan_compact(B, T, KV, PW, M)
                    seg = SD.segments(B, L, p.K, 132)
                    assert p.K == KV + 1 and p.KP == 2048
                    assert p.smem_select == (SD.HEAD_BYTES + R.GATE_BYTES
                                             + 8 * seg.XC)
                    assert max(p.smem_select, p.smem_verify,
                               p.smem_output) <= R.MAX_SMEM == 227 * 1024
                    assert 1 <= seg.nseg <= 8 and not seg.global_x
                    assert seg.seg_lanes % SD.UNIT == 0
                    assert (seg.seg_lanes * seg.nseg >= L
                            > seg.seg_lanes * (seg.nseg - 1))
                    assert seg.nseg == 1 or seg.XC >= 3 * seg.KP
    # a small group spreads a query over the cluster; a full one keeps a
    # query in one CTA
    assert SD.segments(8, 131072, KV + 1, 132).nseg == 8
    assert SD.segments(4096, 2048, KV + 1, 132).nseg == 1
    assert R.GATE_BYTES == 16 * SD.MAX_T == 256


# -- the argument checks and the dispatch -----------------------------------------


def _small(mode="raw"):
    args, kw = PB.compact_case(CASES[0], mode, CPU)
    return list(args), dict(kw)


def _to_op(args, kw):
    """compact_phrase_body's arguments as ops/phrase_route.compact_phrase
    takes them."""
    tc = kw.get("tc_mode", False)
    opkw = {k: v for k, v in kw.items() if k != "tc_mode"}
    opkw["postings_tf"] = None if tc else args[2]
    opkw["avg32"] = kw.get("avg32") if tc else None
    return [args[0], args[1]] + args[3:], opkw


BAD = ("doc_dtype", "doc_strided", "kv_not_below_l", "m_over_kv", "t_one",
       "ks_shape", "too_many_probes", "mask_dtype", "eps3", "tf_missing",
       "bitmap_odd")


def _break(what, args, kw):
    a, k = list(args), dict(kw)
    if what == "doc_dtype":
        a[0] = a[0].to(torch.int64)
    elif what == "doc_strided":
        a[0] = torch.stack([a[0], a[0]], 1)[:, 0]
    elif what == "kv_not_below_l":
        k["KV"] = k["L"]
    elif what == "m_over_kv":
        k["M"] = k["KV"] + 1
    elif what == "t_one":
        k["T"] = 1
    elif what == "ks_shape":
        a[9] = a[9][:-1]
    elif what == "too_many_probes":
        B = a[5].shape[0]
        a[13] = torch.zeros((B, 17), dtype=torch.int32)
        a[14] = torch.zeros((B, 17), dtype=torch.bool)
        a[15] = torch.zeros((B, 17), dtype=torch.int32)
        a[16] = torch.zeros((B, 17), dtype=torch.bool)
    elif what == "mask_dtype":
        a[15] = a[15].to(torch.int64)
    elif what == "eps3":
        k["eps3"] = 1.5
    elif what == "tf_missing":
        a[2] = None
    elif what == "bitmap_odd":
        a[11] = a[11][:-1]
        a[12] = a[12][:-1]
    return a, k


@pytest.mark.parametrize("what", BAD)
def test_argument_checks(what):
    args, kw = _break(what, *_small())
    with pytest.raises(ValueError):
        TK.compact_phrase_body(*args, **kw)
    opargs, opkw = _to_op(args, kw)
    with pytest.raises(ValueError):  # before any launch
        R.compact_phrase(*opargs, **opkw)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a wrapper ran for CPU tensors")

    monkeypatch.setattr(R, "compact_phrase", refuse)
    monkeypatch.setattr(R, "list_phrase", refuse)
    calls = []
    for name in ("compact_phrase_body_torch", "phrase_body"):
        orig = getattr(TK, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(TK, name, wrapped)
    args, kw = _small("tc")
    packed, top = TK.compact_phrase_body(*args, **kw)
    assert packed.shape == (4, 4, 4) and top.dtype == torch.float32
    largs, lkw = PB.list_case(PB.LIST_CASES[1], "raw", CPU)
    TK.list_phrase(*largs[:8], *(None,) * 7, gate=False, **lkw)
    assert calls == ["compact_phrase_body_torch", "phrase_body"]


def test_the_wrappers_refuse_cpu_tensors():
    args, kw = _small()
    opargs, opkw = _to_op(args, kw)
    with pytest.raises(ValueError, match="CUDA"):
        R.compact_phrase(*opargs, **opkw)
    largs, lkw = PB.list_case(PB.LIST_CASES[1], "raw", CPU)
    with pytest.raises(ValueError, match="CUDA"):
        R.list_phrase(*largs[:8], *(None,) * 7, gate=False, **lkw)


def test_compact_bound_by_hand():
    """One query of two terms: candidate docs (1, 3, 5), the other run (3,
    5, 7); L 3, KV 1, M 1, one active probe that passes. Candidate slice
    3 x 8 B; the other run 12 B (under 3 lanes x a sector); 2 matched
    lanes x 1 probe x 12 B; the 2 keys 16 B; 1 kept lane x (3 T - 1)
    sectors; the packed output 4 x 4 B and one top score 4 B."""
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)
    doc = i32(1, 3, 5, 3, 5, 7)
    args = (doc, torch.ones(6), i32(*[1] * 6), torch.zeros(8, dtype=torch.int16),
            i32(*range(7)), i32(0, 3)[None], i32(3, 6)[None],
            torch.ones((1, 2)), i32(0, 1)[None], i32(1),
            i32(-1, -1), i32(-1, -1), i32(0, 32),
            i32(1)[None], torch.tensor([[False]]), i32(1)[None],
            torch.tensor([[True]]))
    kw = dict(T=2, L=3, KV=1, PP=1, PW=1, M=1, n_bs_iters=2, eps3=0.0)
    got = PB.compact_bound_bytes(args, kw)
    assert got == 24 + 12 + 24 + 16 + 5 * 32 + 16 + 4 == 256


# -- the mesh's list route ---------------------------------------------------------


def _chain_scores(args, kw):
    """The list chain's kept scores with no probe: list_phrase_torch's
    steps (match, verification), then the stable top M of the verified
    lanes' scores, -inf past them."""
    T, L, M = kw["T"], kw["L"], kw["M"]
    blooms = PB.no_probes(args, args[4].shape[0])
    if kw.get("avg32") is None:
        match, passed, _, pidx, score = TK.make_match_kernel(
            T, L, kw["n_bs_iters"])(args[0], args[1], args[4], args[5],
                                    args[6], *blooms)
    else:
        match, passed, _, pidx, score, _ = TK.make_match_kernel_tc(
            T, L, kw["n_bs_iters"])(args[0], args[1], kw["avg32"], args[4],
                                    args[5], args[6], *blooms)
    active = match & passed
    n = TK.make_phrase_verify_kernel(T, L, kw["PP"], kw["n_pos_iters"])(
        args[2], args[3], TK._slot_gather_q(pidx, args[7]), active)
    return TK._top_stable(torch.where(active & (n > 0), score, TK.NEG_INF),
                          M)[0]


@pytest.mark.parametrize("case,mode", [(c, m) for c in PB.LIST_CASES
                                       for m in ("raw", "tc")],
                         ids=[f"{c[0]}-{m}" for c in PB.LIST_CASES
                              for m in ("raw", "tc")])
def test_phrase_body_equals_the_gate_off_chain(case, mode):
    """The mesh's list route ran phrase_body; on a card it runs the list
    chain without its gate, which equals the chain with no probe: the top
    scores are equal bit for bit, and so is each kept lane above its
    row's boundary score (phrase_body's top M ties in torch.topk's order,
    the kernel's and the JAX mesh's by lane)."""
    args, kw = PB.list_case(case, mode, CPU)
    tc = mode == "tc"
    body, score = TK.phrase_body(
        args[0], None if tc else args[1], kw.get("postings_tf"), args[2],
        args[3], args[4], args[5], None if tc else args[6], args[7],
        tc=args[1] if tc else None, idf32=args[6] if tc else None,
        avg32=kw.get("avg32"),
        **{k: kw[k] for k in ("T", "L", "PP", "M", "n_bs_iters",
                              "n_pos_iters")})
    plain = TK.list_phrase_torch(*args[:8],
                                 *PB.no_probes(args, args[4].shape[0]), **kw)
    pscore = _chain_scores(args, kw)
    np.testing.assert_array_equal(score.numpy().view(np.int32),
                                  pscore.numpy().view(np.int32))
    T, M = kw["T"], kw["M"]
    b_np, p_np, s_np = body.numpy(), plain.numpy(), pscore.numpy()
    np.testing.assert_array_equal(b_np[:, T + 1], p_np[:, T + 1])
    for b in range(b_np.shape[0]):
        # a full row's boundary class may keep other tied lanes; within
        # every other score class the lanes are the same, in any order
        keep = (s_np[b] > s_np[b, M - 1] if np.isfinite(s_np[b, M - 1])
                else np.isfinite(s_np[b]))
        cols = [x[b][:, keep] for x in (b_np, p_np)]
        cols = [c[:, np.lexsort((c[0], -s_np[b][keep]))] for c in cols]
        np.testing.assert_array_equal(cols[0], cols[1])
    assert (p_np[:, 0] >= 0).any()


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
def test_compact_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    out = PB.compact_phrase_cases(dev)
    assert out["cases"] == 2 * (len(PB.COMPACT_CASES)
                                + len(PB.COMPACT_LONG_CASES))
    assert PB.list_phrase_cases(dev)["cases"] == 4 * len(PB.LIST_CASES)
