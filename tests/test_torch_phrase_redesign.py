"""The full-scan phrase selection threshold first and the verification that
recovers its own posting indices (csrc/dense.cu's sweep and listed
selection, csrc/phrase.cu's group_kernel), checked on the CPU through
their plans, their plain versions and numpy models of what the kernels
do:

- a model of the threshold-first selection (each 128-doc block's largest
  key, the K-th largest block key kappa, the blocks at or above it in id
  order, their lanes pushed above kappa in segments that cut their keys
  to K as the kernel's buffer does, merged in the first segment) equals
  the stable top-(KV+1) of the score plane and the port's plain version
  (engine/kernels.full_phrase_select_torch): ties across block edges,
  blocks with no match, fewer than KV + 1 matched lanes, one score
  everywhere, the rescue's KV 4,096;
- ops/dense.select_path and select_plan at every engine shape;
- the verification's plain versions from kept docs and from posting
  indices (engine/kernels._verify_docs_torch, _verify_pidx_torch) against
  the JAX engine's _binary_search, gathers and _verify_pos_windows on the
  same numpy-made inputs, anchors on term 0 and on later terms;
- a model of the group's G-ary lower bound with its replay of the
  fixed-count search equals that search everywhere, past the iteration
  count too;
- the mega routes run the new plain versions on CPU tensors.

The kernels run only on a card: the `cuda`-marked tests hold them
against their plain versions at the new edges and skip here.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.ops import dense as D
from wiser_tpu_torch.ops import phrase as PH
from wiser_tpu_torch.tools import semidense_bench as SDB

NEG = -np.inf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the threshold-first selection ---------------------------------------------


def _keys(score):
    """Each lane's order as (score, -lane) pairs packed into one float64
    rank (unique, larger first), 0 where the lane matched nothing."""
    n = score.shape[-1]
    lane = np.arange(n)
    order = np.lexsort((lane, -score))  # (score desc, lane asc)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return np.where(np.isfinite(score), n - rank, 0)


def _stable_top(score, K):
    """The stable top K of one row: (scores, lanes) by (score desc, lane
    asc), -inf and -1 past the matched lanes."""
    lane = np.arange(len(score))
    order = np.lexsort((lane, -score))[:K]
    top = score[order]
    lanes = np.where(np.isfinite(top), order, -1)
    pad = K - len(order)
    return (np.concatenate([top, np.full(pad, NEG)]),
            np.concatenate([lanes, np.full(pad, -1)]))


def _threshold_first(score, K, nseg, SL=1024, KP=None):
    """dense.cu's sweep and listed selection over one row: block keys,
    kappa, the listed blocks in id order split into nseg segments, each
    pushing its keys above its threshold into a buffer of KP + 2 SL keys
    cut to its top K when fewer than SL places are free (raising the
    threshold), then the first segment pushing the others' kept keys the
    same way; returns (scores, lanes) of the kept keys in order."""
    KP = KP or 1 << (K - 1).bit_length()
    key = _keys(score)
    NB = len(score) // 128
    bkey = key.reshape(NB, 128).max(axis=1)
    kappa = np.sort(bkey)[::-1][K - 1]
    listed = np.nonzero(bkey >= max(kappa, 1))[0]
    assert kappa == 0 or len(listed) == K
    bps = -(-K // nseg)
    xcap = KP + 2 * SL

    def run(stream, tau, kept):
        buf = list(kept)
        for i0 in range(0, len(stream), SL):
            buf += [k for k in stream[i0:i0 + SL] if k > tau]
            if len(buf) > xcap - SL:
                buf = sorted(buf, reverse=True)[:K]
                tau = buf[-1]
        return sorted(buf, reverse=True)[:K], tau

    segs = []
    for s in range(nseg):
        blocks = listed[s * bps:(s + 1) * bps]
        lanes = (blocks[:, None] * 128 + np.arange(128)).ravel()
        segs.append(run(list(key[lanes]), max(kappa, 1) - 1, []))
    top, tau = segs[0]
    for other, _ in segs[1:]:
        top, tau = run(other, tau, top)
    top = sorted(top, reverse=True)[:K]
    by_key = {int(k): i for i, k in enumerate(key) if k}
    lanes = np.array([by_key[int(k)] for k in top] + [-1] * (K - len(top)))
    scores = np.where(lanes >= 0, score[np.maximum(lanes, 0)], NEG)
    return scores, lanes


def _row(NB, kind, rng):
    """A score row of NB blocks: `ties` from three values with runs
    straddling block edges; `holes` with whole blocks unmatched; `sparse`
    fewer matched lanes than the selection keeps; `flat` one score."""
    n = NB * 128
    if kind == "flat":
        return np.full(n, 2.5)
    score = rng.choice([1.5, 2.0, 3.25], size=n)
    if kind == "ties":
        score[120:140] = 3.25  # a tie class across a block edge
        score[rng.random(n) < 0.5] = NEG
    elif kind == "holes":
        score[rng.random(n) < 0.3] = NEG
        score.reshape(NB, 128)[rng.random(NB) < 0.4] = NEG
    elif kind == "sparse":
        keep = rng.choice(n, size=NB // 8, replace=False)
        score[np.setdiff1d(np.arange(n), keep)] = NEG
    return score


@pytest.mark.parametrize("kind", ["ties", "holes", "sparse", "flat"])
@pytest.mark.parametrize("KV,NB", [(64, 400), (1024, 4200), (4096, 7816)])
@pytest.mark.parametrize("nseg", [1, 3])
def test_threshold_first_equals_the_stable_top(kind, KV, NB, nseg):
    rng = np.random.default_rng(KV + NB + nseg)
    score = _row(NB, kind, rng)
    K = KV + 1
    got = _threshold_first(score, K, nseg, SL=256 if KV == 64 else 1024)
    want = _stable_top(score, K)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    # the port's plain version keeps the same lanes and scores
    s32 = torch.from_numpy(score.astype(np.float32))[None]
    cs, cl = TK.full_phrase_select_torch(lambda t: s32 if t == 0 else
                                         torch.zeros_like(s32) + 0.0, T=1,
                                         N_pad=NB * 128, KV=KV)
    np.testing.assert_array_equal(cl[0].numpy(), want[1])
    if kind == "sparse":
        assert (want[1] == -1).any()


def test_fewer_blocks_than_the_selection_keeps(monkeypatch):
    """NB < KV + 1: only one pass (the plain version's flat selection)."""
    assert D.select_path(8, 157, 1024) == "one"
    monkeypatch.setattr(D, "select_path", lambda B, NB, KV: "two")
    with pytest.raises(ValueError):
        D.select_plan(8, 2, 157, 1024, "raw", lambda k, l: 264)
    score = _row(157, "ties", np.random.default_rng(3))
    s32 = torch.from_numpy(score.astype(np.float32))[None]
    _, cl = TK.full_phrase_select_torch(lambda t: s32, T=1, N_pad=157 * 128,
                                        KV=1024)
    np.testing.assert_array_equal(cl[0].numpy(), _stable_top(score, 1025)[1])


ENGINE_B = (1, 8, 16, 32, 33, 64, 128)


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("T", [2, 3, 4, 8])
@pytest.mark.parametrize("B", ENGINE_B)
def test_the_plan_chooses_the_path_at_every_engine_shape(B, T, mode,
                                                         monkeypatch):
    """The 1M index's 7,816 blocks: KV 1,024 (the mega chunk) and the
    rescue's KV 4,096 threshold first at every B, the sweep and the
    listed selection each one launch (tc: the sweep's table too); a
    query's segments one cluster of at most 8, the listed ids within a
    segment's cap; either path where select_path is forced."""
    NB = 7816
    res = lambda kind, listed: 264
    for KV in (1024, 4096):
        sp = D.select_plan(B, T, NB, KV, mode, res)
        want = "two"
        assert sp.path == want == D.select_path(B, NB, KV)
        assert 1 <= sp.select.nseg <= D.MAX_CLUSTER
        assert sp.select.merge_smem == sp.select.part_words == 0
        if sp.path == "two":
            assert sp.sweep.KP == 0 and sp.sweep.out_words == 2 * B * NB
            assert sp.select.bps <= D.IDS_CAP
            assert (sp.select.nseg - 1) * sp.select.bps < KV + 1 \
                <= sp.select.nseg * sp.select.bps
            assert sp.launches == 2 + (mode == "tc")
        else:
            assert sp.sweep is None and sp.launches == 1 + (mode == "tc")
        for path in ("one", "two"):
            with monkeypatch.context() as m:
                m.setattr(D, "select_path", lambda B, NB, KV, p=path: p)
                assert D.select_plan(B, T, NB, KV, mode, res).path == path


# -- the verification from kept docs and from posting indices ------------------


def _jax_docs(v, T, NL, PP, PW, n_iters):
    pos = v["positions"]
    if pos.dtype == np.int16:
        pos = pos.view(np.uint16)
    B = v["docs"].shape[0]
    targets = jnp.broadcast_to(jnp.asarray(v["docs"])[:, None, :], (B, T, NL))
    lo = JK._binary_search(jnp.asarray(v["postings_doc"]), targets,
                           jnp.asarray(v["starts"])[:, :, None],
                           jnp.asarray(v["ends"])[:, :, None], n_iters)
    ps = JK._gather1d(jnp.asarray(v["pos_starts"]), lo)
    pe = JK._gather1d(jnp.asarray(v["pos_starts"]), lo + 1)
    fn = jax.jit(partial(JK._verify_pos_windows, T=T, NL=NL, PP=PP, PW=PW))
    return np.asarray(fn(jnp.asarray(pos), ps, pe, jnp.asarray(v["anchor"])))


def _jax_pidx(v, T, NL, PP, PW):
    pos = v["positions"]
    if pos.dtype == np.int16:
        pos = pos.view(np.uint16)
    pidx = jnp.take_along_axis(jnp.asarray(v["pidx"]),
                               jnp.asarray(v["slot_of"])[:, :, None], axis=1)
    ps = JK._gather1d(jnp.asarray(v["pos_starts"]), pidx)
    pe = JK._gather1d(jnp.asarray(v["pos_starts"]), pidx + 1)
    B = pidx.shape[0]
    fn = jax.jit(partial(JK._verify_pos_windows, T=T, NL=NL, PP=PP, PW=PW))
    return np.asarray(fn(jnp.asarray(pos), ps, pe,
                         jnp.zeros(B, jnp.int32)))


DOCS_EDGES = [  # (B, T, NL, PP, PW, docs_inputs options, n_iters or None)
    pytest.param(3, 2, 40, 8, 8, {"anchor": 0}, None, id="anchor-0"),
    pytest.param(3, 3, 40, 16, 16, {"anchor": 2}, None, id="anchor-2"),
    pytest.param(4, 3, 32, 32, 32, {}, None, id="random-anchors"),
    pytest.param(2, 4, 24, 8, 64, {"max_tf": 40}, None, id="PW-past-a-group"),
    pytest.param(2, 2, 30, 16, 16, {"long_run": 3000}, 8,
                 id="past-the-iteration-count"),
    pytest.param(2, 2, 24, 16, 16, {"wide": True}, None, id="int32-column"),
]


@pytest.mark.parametrize("B,T,NL,PP,PW,opt,it", DOCS_EDGES)
def test_docs_plain_matches_jax(B, T, NL, PP, PW, opt, it):
    v = SDB.docs_inputs(B, T, NL, PP, PW, 11 + NL + T, **opt)
    n_iters = v.pop("n_iters") if it is None else it
    v.pop("n_iters", None)
    t = SDB.verify_tensors(v, torch.device("cpu"))
    got = SDB.docs_call(TK._verify_docs, t, T, NL, PP, PW, n_iters).numpy()
    np.testing.assert_array_equal(got, _jax_docs(v, T, NL, PP, PW, n_iters))
    assert (got > 0).any() and (got == 0).any()
    got = SDB.pidx_call(TK._verify_pidx_torch, t, T, NL, PP, PW).numpy()
    np.testing.assert_array_equal(got, _jax_pidx(v, T, NL, PP, PW))


def test_docs_plain_is_the_old_composition():
    """_verify_docs_torch is the search, the two gathers and the window
    verification the mega routes ran before, step for step."""
    v = SDB.docs_inputs(3, 3, 40, 16, 16, 5)
    it = v.pop("n_iters")
    t = SDB.verify_tensors(v, torch.device("cpu"))
    B, T, NL = 3, 3, 40
    lo = TK._binary_search(t["postings_doc"],
                           t["docs"][:, None, :].expand(B, T, NL),
                           t["starts"][:, :, None], t["ends"][:, :, None], it)
    want = TK._verify_pos_windows_torch(
        t["positions"], TK._gather1d(t["pos_starts"], lo),
        TK._gather1d(t["pos_starts"], lo + 1), t["anchor"], T=T, NL=NL,
        PP=16, PW=16)
    got = SDB.docs_call(TK._verify_docs, t, T, NL, 16, 16, it)
    assert torch.equal(got, want)


def test_group_plans():
    """A group of 8 threads an item at the engine's T <= 8 and PW <= 32,
    four items a warp; a warp an item past either; the windows within
    VERIFY_SMEM (at least one warp a CTA)."""
    for T in (1, 2, 3, 4, 8, 9, 32):
        for PW in (8, 16, 32, 64, 128, 1024):
            for B, NL in ((128, 1024), (8, 1024), (1, 1)):
                g = PH.group_plan(B, T, NL, PW)
                assert g.G == (8 if T <= 8 and PW <= 32 else 32)
                per = PH.warp_bytes(T, PW) * (32 // g.G)
                assert 1 <= g.W <= PH.MAX_WARPS and g.smem == g.W * per
                assert g.W == 1 or g.smem <= PH.VERIFY_SMEM
                items = g.W * 32 // g.G
                assert g.ctas * items >= B * NL > (g.ctas - 1) * items


def test_checks_refuse_on_either_entry():
    v = SDB.docs_inputs(2, 2, 8, 8, 8, 1)
    it = v.pop("n_iters")
    t = SDB.verify_tensors(v, torch.device("cpu"))
    bad = dict(t, docs=t["docs"].to(torch.int64))
    with pytest.raises(ValueError):
        SDB.docs_call(TK._verify_docs, bad, 2, 8, 8, 8, it)
    with pytest.raises(ValueError, match="CUDA"):
        SDB.docs_call(PH.phrase_verify_docs, t, 2, 8, 8, 8, it)
    assert PH.launch_counts["phrase_verify_docs"] == 0


# -- the group's lower bound and its replay ------------------------------------


def _fixed(col, target, lo, hi, iters):
    """engine/kernels._binary_search of one target, int32 arithmetic."""
    n = len(col)
    for _ in range(iters):
        mid = int(np.int32(np.int32(lo) + np.int32(hi))) >> 1
        less = col[min(max(mid, 0), n - 1)] < target
        lo, hi = (mid + 1, hi) if less else (lo, mid)
    return lo


def _group_recover(col, target, lo0, hi0, iters, G):
    """bound.cuh recover<G>, then the replay where it returns -1."""
    run = hi0 - lo0
    max_run = (1 << 31) if iters >= 31 else (1 << iters) - 1
    if not (lo0 < 0 or run < 0 or hi0 > len(col) or hi0 >= 1 << 30
            or run > max_run):
        lo, hi = lo0, hi0
        while hi > lo:
            n = hi - lo
            if n <= G:
                probes = [lo + g for g in range(n)]
            else:
                probes = [lo + n * (g + 1) // G for g in range(G - 1)]
            c = sum(col[p] < target for p in probes)
            if n <= G:
                lo += c
                hi = lo
            else:
                l0 = lo
                if c > 0:
                    lo = l0 + n * c // G + 1
                if c < G - 1:
                    hi = l0 + n * (c + 1) // G
        if lo < hi0:
            return lo, False
    return _fixed(col, target, lo0, hi0, iters), True


@pytest.mark.parametrize("G", [8, 32])
def test_group_search_with_replay_equals_the_fixed_count_search(G):
    rng = np.random.default_rng(G)
    # sorted runs one after another, as a postings column lays them
    runs = [np.sort(rng.choice(10 ** 6, size=n, replace=False))
            for n in (50_000, 3000, 40, 1)]
    col = np.concatenate(runs)
    bounds = np.concatenate([[0], np.cumsum([len(r) for r in runs])])
    replays = searched = 0
    for _ in range(1500):
        r = int(rng.integers(0, len(runs)))
        lo = int(rng.integers(bounds[r], bounds[r + 1]))
        hi = min(int(bounds[r + 1]), lo + int(rng.choice(
            [0, 1, 5, 31, 33, 400, 9000, 40_000])))
        iters = int(rng.choice([3, 8, 14, 17, 20]))
        run_ids = col[lo:hi]
        pick = rng.random()
        if pick < 0.5 and len(run_ids):
            target = int(rng.choice(run_ids))
        elif pick < 0.7:
            target = int(col[hi - 1]) + 7 if hi > lo else 5
        else:
            target = int(rng.integers(-5, 10 ** 6 + 5))
        got, replayed = _group_recover(col, target, lo, hi, iters, G)
        assert got == _fixed(col, target, lo, hi, iters)
        replays += replayed
        searched += not replayed
    assert replays and searched


# -- the routes on CPU tensors -------------------------------------------------


def test_mega_routes_run_the_new_plain_versions(monkeypatch):
    """_full_phrase_body and the block-pruned body verify through
    _verify_docs (its plain version on CPU tensors), the compact tail
    through _verify_pidx_torch."""
    seen = []
    for name in ("_verify_docs_torch", "_verify_pidx_torch"):
        orig = getattr(TK, name)
        monkeypatch.setattr(TK, name, lambda *a, _o=orig, _n=name, **k:
                            seen.append(_n) or _o(*a, **k))
    v = SDB.docs_inputs(2, 2, 16, 8, 8, 3)
    it = v.pop("n_iters")
    t = SDB.verify_tensors(v, torch.device("cpu"))
    N_pad = 128 * 8
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.choice([0.0, 1.0, 2.0], size=(2, 2, N_pad))
                            .astype(np.float32))
    TK._full_phrase_body(lambda q: rows[:, q], t["postings_doc"],
                         t["positions"], t["pos_starts"], t["starts"],
                         t["ends"], t["anchor"], torch.tensor([3, 3]),
                         T=2, N_pad=N_pad, KV=16, PP=8, PW=8, M=4,
                         n_bs_iters=it, eps3=1e-6)
    assert seen == ["_verify_docs_torch"]
    TK._verify_and_select(t["positions"], t["pos_starts"],
                          torch.ones((2, 16)), t["docs"], t["pidx"],
                          t["slot_of"], torch.tensor([3, 3]),
                          torch.full((2,), float("-inf")), T=2, KV=16, PP=8,
                          PW=8, M=4, eps3=1e-6)
    assert seen == ["_verify_docs_torch", "_verify_pidx_torch"]


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_new_paths_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wiser_tpu_torch.tools import dense_bench as DB

    dev = torch.device("cuda", 0)
    out = SDB.docs_cases(dev)
    assert out["cases"] > 0 and out["max_abs_err"] == 0.0
    out = DB.check_phrase_cases(dev)  # both paths, ties at kappa, KV 4,096
    assert out["cases"] > 0 and out["max_abs_err"] == 0.0
