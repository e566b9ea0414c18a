"""The full-scan phrase's band pass redesigned for Hopper (csrc/dense.cu
scan_kernel<TC, kBand> over a block list: the listed band), checked on the
CPU through a numpy model of what the kernel does and the plain version:

- the model scores each lane by the sweep's rule (raw the f32 row times
  use_score, tc idf32 times the table entry of its (tf byte, len code),
  summed in query-term order from 0, matched where every term's part is
  > 0), takes each 128-doc block's largest key as the sweep writes it,
  lists the blocks whose key scores at least thr (tc; every block where
  the selection took one pass, and raw) and flags a lane of a listed
  block that matches, scores at least thr, ranks after the KV-th
  selected key and, tc, differs from the k-th kept doc's payload on some
  term or lies below it; a query needs the band only where its (KV+1)-th
  score reaches thr.
  Its word equals the plain version's (engine/kernels.
  full_phrase_band_torch) with thr at, just under, just over and far
  under each row's (KV+1)-th score, the k-th doc at that lane (a payload
  tie), at doc 0 and past the last, raw and tc, on tie-heavy planes by
  both selection paths; on planes whose one band lane lies outside the
  selection's K listed blocks; and inside the full-scan phrase
  (_full_phrase_body), whose flags and docs equal the JAX
  _full_phrase_body's on the same numpy inputs;
- the model's lane scores equal the plain version's score plane bit for
  bit (the sweep's table entry past kTft and the band's division give
  one f32), so a block's key bounds every lane of it.

The kernel runs only on a card: the `cuda`-marked test holds it against
the plain version and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.ops import dense as D
from wiser_tpu_torch.tools import phrase_bench as PB

NO_FMA = {"xla_backend_optimization_level": 0}
NEG = -np.inf
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed: int, NB: int, B: int, T: int, H: int = 6) -> dict:
    """Tie-heavy planes: raw scores of four values (0: no match), tc tf
    bytes of five (0 and the saturated 255 among them) over three len
    codes; each query T distinct rows, use 1, idf 0.5-4."""
    rng = np.random.default_rng(seed)
    N = NB * 128
    p = {"sc": rng.choice(F32([0, 0.5, 1, 1.5]), size=(H, N),
                          p=[0.2, 0.3, 0.3, 0.2]),
         "tf8": rng.choice(np.uint8([0, 1, 2, 3, 255]), size=(H, N),
                           p=[0.2, 0.4, 0.2, 0.15, 0.05]),
         "code": rng.choice(np.uint8([10, 40, 90]), size=N),
         "avg32": F32(57.25)}
    p["slots"] = np.stack([rng.choice(H, size=T, replace=False)
                           for _ in range(B)]).astype(np.int32)
    p["use"] = np.ones((B, T), F32)
    p["idf"] = rng.uniform(0.5, 4.0, size=(B, T)).astype(F32)
    return p


def _args(p, mode):
    tc = mode == "tc"
    plane = torch.from_numpy(p["tf8" if tc else "sc"])
    w = torch.from_numpy(p["idf" if tc else "use"])
    kw = dict(T=p["slots"].shape[1], N_pad=plane.shape[1])
    if tc:
        kw.update(len_code=torch.from_numpy(p["code"]),
                  avg32=torch.tensor([p["avg32"]]))
    return (plane, torch.from_numpy(p["slots"]), w), kw


def _lanes(p, mode):
    """The sweep's rule: each lane's f32 score and match, (B, N)."""
    sl, T = p["slots"], p["slots"].shape[1]
    B, N = sl.shape[0], p["code"].shape[0]
    acc = np.zeros((B, N), F32)
    match = np.ones((B, N), bool)
    if mode == "tc":
        norm = D.tc_lane_scores(torch.tensor([p["avg32"]]), 1.0).numpy()
    for t in range(T):
        if mode == "tc":
            part = p["idf"][:, t:t + 1] * norm[p["code"][None, :],
                                               p["tf8"][sl[:, t]]]
        else:
            part = p["sc"][sl[:, t]] * p["use"][:, t:t + 1]
        match &= part > 0
        acc = acc + part
    return acc, match


def _payload(p):
    """(B, T, N) int32 tc payload lanes: len code << 8 | tf byte, 0 where
    the tf byte is 0."""
    tf = p["tf8"][p["slots"]].astype(np.int32)
    return np.where(tf > 0, (p["code"].astype(np.int32) << 8)[None, None]
                    | tf, 0)


def _block_keys(acc, match):
    """The sweep's block keys: each block's largest matched score and
    whether it has a matched lane."""
    B, N = acc.shape
    s = np.where(match, acc, NEG).reshape(B, N // 128, 128)
    return s.max(axis=2), match.reshape(B, N // 128, 128).any(axis=2)


def _model(acc, match, pay, sel, thr, kd, KV, listed):
    """The kernel's band word: (B,) int32 and the listed blocks a query."""
    cs, cl = (x.numpy() for x in sel)
    thr = thr.numpy()
    B, N = acc.shape
    lane = np.arange(N)[None, :]
    need = cs[:, KV] >= thr
    kvs, kvl = cs[:, KV - 1:KV], cl[:, KV - 1:KV]
    after = (kvl >= 0) & ((acc < kvs) | ((acc == kvs) & (lane > kvl)))
    flag = match & (acc >= thr[:, None]) & after
    if pay is not None:
        k = np.clip(kd.numpy().astype(np.int64), 0, N - 1)
        bad = lane < k[:, None]
        for t in range(pay.shape[1]):
            bad |= pay[:, t] != np.take_along_axis(pay[:, t], k[:, None], 1)
        flag &= bad
    ks, valid = _block_keys(acc, match)
    blocks = valid & (ks >= thr[:, None]) if listed else \
        np.ones_like(valid)
    flag &= np.repeat(blocks, 128, axis=1)
    return (need & flag.any(axis=1)).astype(np.int32), blocks.sum(axis=1)


def _thresholds(sel, N):
    """(name, thr, kth_doc) of the band: thr at each row's (KV+1)-th score,
    just under and over it, far under; the k-th doc at that lane, at doc 0
    and past the last doc."""
    cs, cl = sel
    unseen = cs[:, -1]
    fin = torch.isfinite(unseen)
    at = torch.where(fin, unseen, 1.0)
    thrs = {"at": at,
            "under": torch.nextafter(at, torch.zeros_like(at)),
            "over": torch.nextafter(at, torch.full_like(at, np.inf)),
            "far": torch.full_like(at, 1e-3)}
    kds = {"kv1": cl[:, -1].clamp(min=0), "doc0": torch.zeros_like(cl[:, 0]),
           "past": torch.full_like(cl[:, 0], N + 5)}
    return [(f"{t}/{k}", thr.contiguous(), kd.contiguous())
            for t, thr in thrs.items() for k, kd in kds.items()]


@pytest.mark.parametrize("mode", ["raw", "tc"])
@pytest.mark.parametrize("NB,KV", [(16, 8), (24, 16), (4, 8)])
def test_listed_band_model_equals_the_plain_band(mode, NB, KV):
    """NB >= KV + 1: the threshold-first path, the tc band listed; (4, 8):
    one pass, the band over every block; raw over every block (a raw row
    that needs the band flags at its (KV+1)-th lane)."""
    p = _planes(NB + KV, NB, 8, 3 if NB == 24 else 2)
    args, kw = _args(p, mode)
    acc, match = _lanes(p, mode)
    rows_f32, _ = TK._phrase_rows(*args, len_code=kw.get("len_code"),
                                  avg32=kw.get("avg32"))
    plain_score = TK._phrase_score(rows_f32, kw["T"]).numpy()
    np.testing.assert_array_equal(np.where(match, acc, NEG), plain_score)
    *sel, _ = TK.full_phrase_select(*args, KV=KV, **kw)
    two = D.select_path(8, NB, KV) == "two"
    assert two == (NB >= KV + 1)
    listed = two and mode == "tc"  # a raw row flags at its (KV+1)-th lane
    pay = _payload(p) if mode == "tc" else None
    need = hit = cut = 0
    for name, thr, kd in _thresholds(sel, kw["N_pad"]):
        want = TK.full_phrase_band(*args, *sel, thr, KV=KV,
                                   kth_doc=kd if mode == "tc" else None,
                                   **kw).numpy()
        got, n_blocks = _model(acc, match, pay, sel, thr, kd, KV, listed)
        np.testing.assert_array_equal(got, want, err_msg=name)
        rows = sel[0][:, -1].numpy() >= thr.numpy()
        need += int(rows.sum())
        hit += int(got.sum())
        cut += int((rows & (n_blocks < NB)).sum())
    assert need and hit and (cut or not listed)


def test_a_band_lane_outside_the_selected_blocks():
    """tc, 64 blocks, KV 8: tf 5 at the first doc of blocks 0-19 (the
    selection keeps blocks 0-8, its K listed blocks too), tf 4 at one
    lane of block 50, tf 2 elsewhere; the k-th doc at the (KV+1)-th lane,
    a payload tie of every tf-5 lane. At thr = the tf-4 lane's score it
    alone flags, from block 50, with 21 blocks listed; just above it
    nothing does, with 20."""
    NB, KV = 64, 8
    tf8 = np.full((1, NB * 128), 2, np.uint8)
    tf8[0, np.arange(20) * 128] = 5
    x = 50 * 128 + 77
    tf8[0, x] = 4
    p = {"tf8": tf8, "sc": tf8.astype(F32), "code": np.full(NB * 128, 40,
                                                            np.uint8),
         "avg32": F32(57.25), "slots": np.zeros((1, 1), np.int32),
         "use": np.ones((1, 1), F32), "idf": np.full((1, 1), 1.7, F32)}
    args, kw = _args(p, "tc")
    acc, match = _lanes(p, "tc")
    *sel, _ = TK.full_phrase_select(*args, KV=KV, **kw)
    assert sorted(set(sel[1][0].numpy() // 128)) == list(range(KV + 1))
    kd = sel[1][:, -1].contiguous()
    sx = torch.tensor([acc[0, x]])
    for thr, hit, blocks in ((sx, 1, 21), (torch.nextafter(
            sx, torch.tensor([np.inf])), 0, 20)):
        want = TK.full_phrase_band(*args, *sel, thr, KV=KV, kth_doc=kd,
                                   **kw).numpy()
        got, n = _model(acc, match, _payload(p), sel, thr, kd, KV, True)
        assert want[0] == got[0] == hit and n[0] == blocks


# -- inside the full-scan phrase, against JAX -----------------------------------


def _jref(fn, *args):
    args = [None if a is None else jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(NO_FMA)(*args)


@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_full_phrase_band_inside_the_route_equals_jax(mode, monkeypatch):
    """The full-scan phrase (_full_phrase_body) over dense rows of
    synth_columns's heads, B 8 (two rows batch padding), KV 96 over 128
    blocks (the threshold-first path): the JAX _full_phrase_body's docs
    and flags bit for bit, and the band call's word equal to the
    model's."""
    cols = PB.synth_columns(5, 16384, (2000, 12000, 10000, 9000), tie=True,
                            sorted_bags=True)
    ts, dfs = cols["term_starts"], cols["dfs"]
    pairs = [(1, 2), (2, 1), (1, 3), (3, 2), (2, 3), (3, 1)]
    B, T, KV, M = 8, 2, 96, 4
    starts = np.zeros((B, T), np.int32)
    ends = np.zeros((B, T), np.int32)
    slots = np.zeros((B, T), np.int32)
    w = np.zeros((B, T), F32)
    rng = np.random.default_rng(6)
    for b, pr in enumerate(pairs):
        for t, term in enumerate(pr):
            starts[b, t] = ts[term]
            ends[b, t] = ts[term] + dfs[term]
            slots[b, t] = term - 1
            w[b, t] = 1.0 if mode == "raw" else rng.uniform(0.5, 4.0)
    anchor = np.zeros(B, np.int32)
    ks = np.full(B, 4, np.int32)
    N = cols["dense_sc"].shape[1]
    code = rng.choice(np.uint8([10, 40, 90]), size=N)
    common = (cols["doc"], cols["positions"], cols["pos_starts"], starts,
              ends, anchor, ks)
    kw = dict(T=T, N_pad=N, KV=KV, PP=8, PW=8, M=M,
              n_bs_iters=PB._iters(12000), eps3=3e-5 if mode == "tc"
              else 3e-6)
    tf8 = cols["dense_tf8"]
    pay = np.where(tf8 > 0, (code.astype(np.int32) << 8)[None, :]
                   | tf8.astype(np.int32), 0).astype(np.int32)
    avg32 = F32(cols["avg32"][0])
    if mode == "tc":
        w_docs, w_flags = _jref(
            lambda pay_, idf, a32, sl, *c: JK._full_phrase_body(
                lambda t: JK.tc_score(pay_[sl[:, t]], idf[:, t:t + 1], a32),
                lambda t: pay_[sl[:, t]], *c, payload_tie_exact=True, **kw),
            pay, w, avg32, slots, *common)
    else:
        w_docs, w_flags = _jref(
            lambda sc, use, sl, *c: JK._full_phrase_body(
                lambda t: sc[sl[:, t]] * use[:, t:t + 1], None, *c,
                payload_tie_exact=False, **kw),
            cols["dense_sc"], w, slots, *common)
    seen = []
    band = TK.full_phrase_band_torch

    def spy(*a, **k):
        seen.append((a, k))
        return band(*a, **k)

    monkeypatch.setattr(TK, "full_phrase_band_torch", spy)
    tsl = torch.from_numpy(slots).long()
    tw = torch.from_numpy(w)
    if mode == "tc":
        tpay = torch.from_numpy(pay)
        rows = (lambda t: TK.tc_score(tpay[tsl[:, t]], tw[:, t:t + 1],
                                      torch.tensor(avg32)))
        payload = lambda t: tpay[tsl[:, t]]
    else:
        sc = torch.from_numpy(cols["dense_sc"])
        rows = lambda t: sc[tsl[:, t]] * tw[:, t:t + 1]
        payload = None
    g_docs, g_flags = TK._full_phrase_body(
        rows, *(PB.to_torch(a, "cpu") for a in common), rows_payload=payload,
        **kw)
    np.testing.assert_array_equal(g_flags.numpy(), np.asarray(w_flags))
    np.testing.assert_array_equal(g_docs.numpy(), np.asarray(w_docs))
    assert (g_flags.numpy() & TK.FLAG_PRUNE_MISS).any()
    # each band call against the model on the same selection
    p = {"sc": cols["dense_sc"], "tf8": tf8, "code": code, "avg32": avg32,
         "slots": slots, "use": w, "idf": w}
    acc, match = _lanes(p, mode)
    (_, top_cl, thr), k = seen[0]
    score = TK._phrase_score(rows, T)
    top_cs = torch.gather(score, 1, top_cl.clamp(min=0).long())
    top_cs = torch.where(top_cl >= 0, top_cs, NEG)
    want = band(*seen[0][0], **seen[0][1]).numpy()
    got, _ = _model(acc, match, _payload(p) if mode == "tc" else None,
                    (top_cs, top_cl), thr, k.get("kth_doc"), KV,
                    mode == "tc" and D.select_path(B, N // 128, KV) == "two")
    np.testing.assert_array_equal(got, want)
    if mode == "raw":  # rows need the band: their (KV+1)-th lane flags
        assert want.any()


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_listed_band_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wiser_tpu_torch.tools import dense_bench as DB

    out = DB.check_phrase_cases(torch.device("cuda", 0))
    assert out["max_abs_err"] == 0.0
    assert any(r.get("listed_band_cases") for r in out["rows"])
    assert any(r["kind"] == "band_listed" for r in out["rows"])
