"""wiser_tpu_torch.entry against the repository's __graft_entry__.entry, the
bs step (engine/kernels.search_body) against the JAX search_body on the
synthetic columns of tools/search_bench, the kernel wrapper's argument
checks, and the port's copy of wiser.proto.

Tolerances: none. Flags are bit-equal on every row. Kept lanes are
compared after the (score desc, doc asc) canon (tools/search_bench.canon)
as docs, f32 score bits and tfs, on every row without FLAG_TRUNC; on a
flagged row the choice among tied boundary lanes is free for torch.topk,
so there the sorted top-M scores are compared. The JAX tc programs run
without XLA's FMA contraction (test_torch_tc_kernels.jref); the raw JAX
step sums its slots with jnp.sum, which XLA's CPU backend adds in slot
order, as the port's plain version does.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from wiser_tpu.engine import kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.entry import entry
from wiser_tpu_torch.ops import search as S
from wiser_tpu_torch.tools import search_bench as SB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_FMA = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = GE.entry()
    return args, [np.asarray(o) for o in jax.jit(fn)(*args)]


@pytest.fixture(scope="module")
def torch_entry():
    fn, args = entry(device="cpu")
    return fn, args, [o.numpy() for o in fn(*args)]


def assert_same_step(got, want, M: int, what: str):
    """got / want: (docs, score, tfs, pidx, flags) as numpy arrays."""
    np.testing.assert_array_equal(got[4], want[4], err_msg=f"{what} flags")
    gd, gs, gt, _, _ = SB.canon(*got[:4], M)
    wd, ws, wt, _, _ = SB.canon(*want[:4], M)
    clean = (got[4] & TK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(gd[clean], wd[clean], err_msg=f"{what} docs")
    np.testing.assert_array_equal(
        gs[clean].astype(np.float32).view(np.int32),
        ws[clean].astype(np.float32).view(np.int32),
        err_msg=f"{what} score bits")
    np.testing.assert_array_equal(gt[clean], wt[clean], err_msg=f"{what} tfs")
    np.testing.assert_array_equal(
        np.sort(got[1], axis=1).view(np.int32),
        np.sort(want[1], axis=1).view(np.int32),
        err_msg=f"{what} top-M scores")


# -- entry() ------------------------------------------------------------------


def test_entry_example_args_equal(jax_entry, torch_entry):
    jargs, _ = jax_entry
    _, targs, _ = torch_entry
    assert len(jargs) == len(targs) == 6
    for j, t in zip(jargs, targs):
        assert t.device.type == "cpu" and t.is_contiguous()
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_entry_outputs_equal(jax_entry, torch_entry):
    _, want = jax_entry
    _, _, got = torch_entry
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (16, 16), (16, 16), (16, 4, 16), (16, 4, 16), (16,)]
    assert_same_step(got, want, 16, "entry")


@pytest.mark.parametrize("T", [1, 2])
def test_entry_rows_at_fewer_slots(jax_entry, T):
    """The entry's four random terms a row share no doc at 240 docs; its
    index and rows cut to their first T slots do match, and go through
    both steps at the entry's L, M and iterations."""
    jargs, _ = jax_entry
    cols = [np.asarray(a) for a in jargs[:3]]
    bounds = [np.ascontiguousarray(np.asarray(a)[:, :T]) for a in jargs[3:]]
    kw = dict(T=T, L=128, M=16, n_bs_iters=TK.n_iters_for(len(cols[0])))
    want = [np.asarray(o) for o in jax.jit(partial(JK.search_body, **kw))(
        *(jnp.asarray(a) for a in cols + bounds))]
    got = [o.numpy() for o in TK.search_body(
        *(torch.from_numpy(a) for a in cols + bounds), **kw)]
    assert (got[0] >= 0).sum() > 16
    assert_same_step(got, want, 16, f"entry rows T={T}")


def test_entry_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        entry()


# -- search_body (plain) against the JAX search_body --------------------------


@pytest.fixture(scope="module")
def synth():
    """tools/search_bench's columns at L = 128: empty, 1-long, short, about
    L and up to 2L runs, half the terms with tie-prone payloads."""
    cols = SB.synth_columns(128, 5)
    assert 0 in cols["t_len"] and cols["t_len"].max() > 128
    return cols


def jax_step(cols, batch, mode: str, kw: dict):
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


@pytest.mark.parametrize("M", [16, 128])  # L > M and L == M
@pytest.mark.parametrize("T", [1, 2, 4, 9])
@pytest.mark.parametrize("mode", ["raw", "tc"])
def test_plain_search_body_matches_jax(synth, mode, T, M):
    L = 128
    batch = SB.synth_batch(synth, 40, T, seed=T * 10 + M)
    kw = dict(T=T, L=L, M=M, n_bs_iters=TK.n_iters_for(
        int(synth["t_len"].max())))
    want = jax_step(synth, batch, mode, kw)
    t = SB.to_device(synth, batch, torch.device("cpu"))
    got = SB._np(SB.call(TK.search_body, t, mode, T, L, M, kw["n_bs_iters"]))
    assert_same_step(got, want, M, f"{mode} T={T} M={M}")
    flags = got[4]
    assert (got[0] >= 0).sum() > 40
    if M == L:
        assert not (flags & TK.FLAG_TRUNC).any()
    elif T <= 2:  # the planted ties are cut at the boundary
        assert (flags & TK.FLAG_TRUNC).any()
    if mode == "tc" and T == 1:
        assert (flags & TK.FLAG_TF_SAT).any()


# -- tools/search_bench's comparison and bytes bound ---------------------------


@pytest.fixture(scope="module")
def step_planes(synth):
    """The plain step at M = 16 and at M = L (the whole plane) on raw
    columns, and a kernel's expected outputs made from the whole plane:
    sorted by (score desc, doc asc), cut at M, the plain version's
    flags."""
    T, L, M = 2, 128, 16
    batch = SB.synth_batch(synth, 40, T, seed=11)
    t = SB.to_device(synth, batch, torch.device("cpu"))
    n = TK.n_iters_for(int(synth["t_len"].max()))
    plain = SB.call(TK.search_body_torch, t, "raw", T, L, M, n)
    full = SB.call(TK.search_body_torch, t, "raw", T, L, L, n)
    d, s, tf, pi, _ = SB.canon(*SB._np(full)[:4], M)
    kern = [d.astype(np.int32), s.astype(np.float32), tf.astype(np.int32),
            pi.astype(np.int32), plain[4].numpy().copy()]
    flags = kern[4]
    assert (flags & TK.FLAG_TRUNC).any() and not (flags & TK.FLAG_TRUNC).all()
    return plain, full, kern, M


def _mutate(case: str, kern: list, full, M: int) -> list:
    d, s, tf, pi, fl = (a.copy() for a in kern)
    clean = np.nonzero(((fl & TK.FLAG_TRUNC) == 0) & (s[:, 1] > -np.inf)
                       & (s[:, 0] > s[:, 1]))[0][0]
    if case == "doc":
        d[clean, 0] += 1
    elif case == "score_bit":
        s[clean, 0] = np.nextafter(s[clean, 0], np.float32(np.inf))
    elif case == "tf":
        tf[clean, 1, 0] += 1
    elif case == "pidx":
        pi[clean, 0, 0] += 1
    elif case == "flag":
        fl[clean] ^= TK.FLAG_TRUNC
    elif case == "order":
        for a in (d, s):
            a[clean, [0, 1]] = a[clean, [1, 0]]
        for a in (tf, pi):
            a[clean, :, [0, 1]] = a[clean, :, [1, 0]]
    elif case == "boundary_choice":
        # a flagged row keeps a higher doc of its boundary class
        fd, fs = SB._np(full)[:2]
        for b in np.nonzero(fl & TK.FLAG_TRUNC)[0]:
            out = fd[b][(fs[b] == s[b, M - 1]) & (fd[b] > d[b, M - 1])]
            if len(out):
                d[b, M - 1] = out.max()
                break
        else:
            raise AssertionError("no flagged row with a spare boundary doc")
    return [torch.from_numpy(a) for a in (d, s, tf, pi, fl)]


@pytest.mark.parametrize("with_full", [True, False])
def test_check_accepts_the_sorted_plane(step_planes, with_full):
    plain, full, kern, M = step_planes
    out = SB.check([torch.from_numpy(a) for a in kern], plain,
                   full if with_full else None, M, "plain")
    assert out["flagged"] > 0 and out["max_abs_err"] == 0.0


@pytest.mark.parametrize("case", ["doc", "score_bit", "tf", "pidx", "flag",
                                  "order"])
@pytest.mark.parametrize("with_full", [True, False])
def test_check_finds_a_changed_lane(step_planes, case, with_full):
    plain, full, kern, M = step_planes
    with pytest.raises(AssertionError):
        SB.check(_mutate(case, kern, full, M), plain,
                 full if with_full else None, M, case)


def test_check_boundary_choice_needs_the_whole_plane(step_planes):
    """Which boundary lanes a flagged row keeps is checked against the
    whole plane only; without it that row is held above its boundary."""
    plain, full, kern, M = step_planes
    got = _mutate("boundary_choice", kern, full, M)
    with pytest.raises(AssertionError, match="docs differ"):
        SB.check(got, plain, full, M, "boundary")
    SB.check(got, plain, None, M, "boundary")


def test_bound_bytes_counts_each_byte_once():
    L, M = 128, 16
    # runs: candidate 100 (valid 100), 0 | candidate 300 (valid 128),
    # others 7 (read whole: 7 < 128 * 3) and 1,000,000 (one id a probe:
    # 128 * 20 < 1e6)
    starts = np.array([[0, 500, 0], [1000, 2000, 3000]])
    ends = starts + np.array([[100, 0, 0], [300, 7, 1_000_000]])
    for mode, lane_b, tf_b in (("raw", 8, 4), ("tc", 6, 2)):
        want = (100 + 128) * lane_b + (0 + 0 + 7 + 128 * 20) * 4
        want += 2 * 3 * M * tf_b + 2 * ((2 * 3 + 2) * M + 1) * 4 + 2 * 3 * 12
        assert SB.bound_bytes(starts, ends, mode, L, M) == want


# -- the wrapper ----------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version(synth):
    batch = SB.synth_batch(synth, 8, 2, seed=3)
    t = SB.to_device(synth, batch, torch.device("cpu"))
    S.reset_launch_counts()
    for mode in ("raw", "tc"):
        got = SB.call(TK.search_body, t, mode, 2, 128, 16, 9)
        want = SB.call(TK.search_body_torch, t, mode, 2, 128, 16, 9)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert S.launch_counts == {"bs_search": 0, "bs_search_plane": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        SB.call(S.bs_search, t, "raw", 2, 128, 16, 9)
    assert S.launch_counts == {"bs_search": 0, "bs_search_plane": 0}


def _bad(case: str, t: dict) -> dict:
    t = dict(t)
    if case == "doc_int64":
        t["doc"] = t["doc"].to(torch.int64)
    elif case == "score_f64":
        t["score"] = t["score"].to(torch.float64)
    elif case == "tc_uint8":
        t["tc"] = t["tc"].to(torch.uint8)
    elif case == "doc_strided":
        t["doc"] = torch.stack([t["doc"], t["doc"]], dim=1)[:, 0]
    elif case == "tf_strided":
        t["tf"] = torch.stack([t["tf"], t["tf"]], dim=1)[:, 0]
    elif case == "starts_t":
        t["starts"] = t["starts"].t().contiguous().t()
    elif case == "ends_shape":
        t["ends"] = t["ends"][:, :1].contiguous()
    elif case == "use_f64":
        t["use"] = t["use"].to(torch.float64)
    elif case == "avg_f64":
        t["avg32"] = t["avg32"].to(torch.float64)
    return t


@pytest.mark.parametrize("case,mode", [
    ("doc_int64", "raw"), ("score_f64", "raw"), ("tc_uint8", "tc"),
    ("doc_strided", "raw"), ("tf_strided", "raw"), ("starts_t", "raw"),
    ("ends_shape", "tc"), ("use_f64", "raw"), ("avg_f64", "tc"),
    ("M_over_L", "raw"), ("L_over_column", "raw")])
def test_bad_arguments_raise_before_any_launch(synth, monkeypatch, case,
                                               mode):
    batch = SB.synth_batch(synth, 8, 2, seed=4)
    t = _bad(case, SB.to_device(synth, batch, torch.device("cpu")))
    L, M = 128, 16
    if case == "M_over_L":
        M = L + 1
    elif case == "L_over_column":
        L = synth["doc"].shape[0] + 1

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(TK, "search_body_torch", no_plain)
    with pytest.raises(ValueError):
        SB.call(TK.search_body, t, mode, 2, L, M, 9)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    out = SB.check_cases(cuda_card, Ls=(128, 2048))
    assert out["flagged_rows"] > 0 and out["max_abs_err"] == 0.0


# -- the port's copy of wiser.proto --------------------------------------------


def test_proto_copy_matches_and_describes_wiser_pb2():
    pb2 = pytest.importorskip("wiser_tpu_torch.serve.wiser_pb2")
    port = os.path.join(ROOT, "wiser_tpu_torch", "serve", "wiser.proto")
    with open(port) as f:
        text = f.read()
    with open(os.path.join(ROOT, "wiser_tpu", "serve", "wiser.proto")) as f:
        assert text == f.read()
    import re

    messages = re.findall(r"^message (\w+) \{(.*?)^\}", text, re.M | re.S)
    assert len(messages) >= 8
    for name, body in messages:
        desc = pb2.DESCRIPTOR.message_types_by_name[name]
        fields = re.findall(r"^\s*(?:repeated\s+)?\w+\s+(\w+)\s*=\s*(\d+);",
                            body, re.M)
        assert fields
        assert {(f.name, f.number) for f in desc.fields} == {
            (n, int(k)) for n, k in fields}
    service = pb2.DESCRIPTOR.services_by_name["WiserEngine"]
    rpcs = re.findall(r"^\s*rpc (\w+)\(", text, re.M)
    assert sorted(m.name for m in service.methods) == sorted(rpcs)
