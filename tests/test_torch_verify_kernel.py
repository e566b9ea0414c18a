"""The phrase position verification on the CPU (the reference
engine/kernels._verify_pos_windows_torch, and the kernel's entry in
ops/phrase.py with its dispatcher _verify_docs).

The plain window verification against the JAX package's
_verify_pos_windows on tools/semidense_bench's position bags (planted
phrases among noise, empty bags, bags past the window) at the edges: a
window clamped at n - PW (the column ends at its last bag), anchors
other than 0, PP < PW, T at the engine's MAX_T, unsorted bags, and the
65535 pad (an int16 column of uint16 bits holding 65535 among its
positions), plus an int32 column. Then the checks (the dispatcher, the
argument check and the kernel's entry refuse the same bad arguments; the
entry raises ValueError on any CPU call before a launch), the dispatch
(CPU tensors take the plain versions and launch nothing), the launch
plans at the engine's shapes and a hand count of the bytes bound.

Tolerances: none (integer counts, equal on every row). The card's check
(the kernels against the plain versions) is marked cuda and skips here.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.kernels as JK
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.host import PP_BUCKETS
from wiser_tpu_torch.ops import phrase as PH
from wiser_tpu_torch.tools import semidense_bench as SDB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (pytest -n 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_counts(v, T, NL, PP, PW):
    """JAX's verification of the bags v: an int16 column travels as its
    uint16 values, as the JAX engine holds it."""
    pos = v["positions"]
    if pos.dtype == np.int16:
        pos = pos.view(np.uint16)
    fn = jax.jit(partial(JK._verify_pos_windows, T=T, NL=NL, PP=PP, PW=PW))
    return np.asarray(fn(jnp.asarray(pos), jnp.asarray(v["ps"]),
                         jnp.asarray(v["pe"]), jnp.asarray(v["anchor"])))


MAX_T = TorchEngine.MAX_T
EDGES = [  # (B, T, NL, PP, PW, semidense_bench.verify_inputs options)
    pytest.param(3, 3, 24, 8, 32, {"tail": True}, id="clamped-at-n-PW"),
    pytest.param(4, 3, 24, 8, 8, {"anchor": 2}, id="anchor-2"),
    pytest.param(4, 2, 24, 32, 32, {}, id="random-anchors"),
    pytest.param(3, 2, 30, 8, 128, {"max_tf": 40}, id="PP<PW"),
    pytest.param(2, 2, 40, 8, 8, {"max_tf": 1}, id="empty-bags"),
    pytest.param(2, MAX_T, 12, 32, 32, {}, id="T-at-MAX_T"),
    pytest.param(3, 3, 20, 8, 32, {"sort": False}, id="unsorted-bags"),
    pytest.param(3, 2, 24, 32, 32, {"wide": True}, id="int32-column"),
]


@pytest.mark.parametrize("B,T,NL,PP,PW,opt", EDGES)
def test_plain_matches_jax(B, T, NL, PP, PW, opt):
    v = SDB.verify_inputs(B, T, NL, PP, PW, 5 + NL + T, **opt)
    t = SDB.verify_tensors(v, torch.device("cpu"))
    got = TK._verify_pos_windows_torch(t["positions"], t["ps"], t["pe"],
                                       t["anchor"], T=T, NL=NL, PP=PP, PW=PW)
    want = _jax_counts(v, T, NL, PP, PW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want == 0).any()


def test_the_65535_pad_is_a_position():
    """An int16 column reads 65535 (the pad's bits) as 65535: a base at
    65534 whose next term holds 65535 counts, as in the reference's uint16
    column; a base at 65533 whose next term holds 7 does not."""
    col = np.array([65534, 65535, 65533, 7], dtype=np.uint16)
    v = {"positions": np.concatenate([col, np.full(40, 65535, np.uint16)]
                                     ).view(np.int16),
         "ps": np.array([[[0, 2]], [[1, 3]]], dtype=np.int32).transpose(
             1, 0, 2).copy(),
         "pe": np.array([[[1, 3]], [[2, 4]]], dtype=np.int32).transpose(
             1, 0, 2).copy(),
         "anchor": np.zeros(1, dtype=np.int32)}
    t = SDB.verify_tensors(v, torch.device("cpu"))
    got = TK._verify_pos_windows_torch(t["positions"], t["ps"], t["pe"],
                                       t["anchor"], T=2, NL=2, PP=8,
                                       PW=8).numpy()
    np.testing.assert_array_equal(got, [[1, 0]])
    np.testing.assert_array_equal(got, _jax_counts(v, 2, 2, 8, 8))


_DOCS = ("postings_doc", "positions", "pos_starts", "docs", "starts",
         "ends", "anchor")


def _good():
    v = SDB.docs_inputs(2, 3, 10, 8, 32, 3)
    it = v.pop("n_iters")
    t = SDB.verify_tensors(v, torch.device("cpu"))
    return [t[k] for k in _DOCS], dict(T=3, NL=10, PP=8, PW=32, n_iters=it)


def _bad():
    args, kw = _good()
    out = []

    def arg(k, v, what):
        a = list(args)
        a[_DOCS.index(k)] = v
        out.append((what, a, dict(kw)))

    def key(k, v, what):
        out.append((what, list(args), dict(kw, **{k: v})))

    pos, docs = args[1], args[3]
    arg("positions", pos.to(torch.int64), "positions int64")
    arg("positions", pos[:0], "empty positions")
    arg("positions", pos.reshape(-1, 1), "positions 2-D")
    arg("postings_doc", args[0].to(torch.int64), "postings_doc int64")
    arg("pos_starts", args[2][:0], "empty pos_starts")
    arg("docs", docs.to(torch.int64), "docs int64")
    arg("docs", docs[:, :2].contiguous(), "docs of the wrong shape")
    arg("starts", args[4].t().contiguous().t(), "starts not contiguous")
    arg("ends", args[5][:, :2].contiguous(), "ends of the wrong shape")
    arg("anchor", args[6].to(torch.int64), "anchor int64")
    arg("anchor", args[6][:1], "anchor of the wrong shape")
    key("T", 0, "T 0")
    key("T", PH.MAX_T + 1, "T past MAX_T")
    key("PP", 0, "PP 0")
    key("PW", 0, "PW 0")
    key("NL", 11, "NL against docs")
    key("n_iters", -1, "n_iters -1")
    return out


def test_args_ok_refuses_what_check_inputs_refuses():
    """The dispatcher, check_docs_inputs and the kernel's entry refuse
    the same bad arguments (ValueError) and launch nothing."""
    args, kw = _good()
    PH.check_docs_inputs(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        PH.phrase_verify_docs(*args, **kw)
    for what, a, k in _bad():
        with pytest.raises(ValueError):
            PH.check_docs_inputs(*a, **k)
        with pytest.raises(ValueError):
            TK._verify_docs(*a, **k)
        with pytest.raises(ValueError):
            PH.phrase_verify_docs(*a, **k)
    assert PH.launch_counts == {"phrase_verify_docs": 0}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel's entry ran on CPU tensors")

    monkeypatch.setattr(PH, "phrase_verify_docs", no_kernel)
    args, kw = _good()
    np.testing.assert_array_equal(
        TK._verify_docs(*args, **kw).numpy(),
        TK._verify_docs_torch(*args, **kw).numpy())
    assert PH.launch_counts == {"phrase_verify_docs": 0}


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8])
def test_launch_plans_at_engine_shapes(T):
    """Every PW the engine verifies with (a PP bucket up to its POS_PAD):
    a group of 8 threads an item up to PW 32, a warp past it; as many
    warps a CTA as fit VERIFY_SMEM (at least one), their windows within
    the card's shared memory, every (query, lane) an item."""
    for PW in (b for b in PP_BUCKETS if b <= TorchEngine.POS_PAD):
        for B, NL in ((128, 1024), (128, 4096), (8, 2048), (1, 1)):
            p = PH.group_plan(B, T, NL, PW)
            per = PH.warp_bytes(T, PW) * (32 // p.G)
            assert p.G == (8 if PW <= 32 else 32)
            assert 1 <= p.W <= PH.MAX_WARPS
            assert p.smem == p.W * per <= PH.MAX_SMEM
            assert p.W == 1 or p.smem <= PH.VERIFY_SMEM
            assert p.W == PH.MAX_WARPS or (p.W + 1) * per > PH.VERIFY_SMEM
            items = p.W * 32 // p.G
            assert p.ctas * items >= B * NL > (p.ctas - 1) * items
    assert PH.group_plan(128, 2, 1024, 128).W == 8


def test_bound_bytes_hand_count():
    """One query, T 2, NL 2 from kept docs over an int16 column, with no
    search halving (n_iters 0: each term's index is its run's start, 0
    and 3, so no posting-id sector is read): term 0's window [0, 3) lies
    in sector 0 and term 1's [20, 22) in sector 1 (2 B a position, 16 a
    sector); the pos_starts pairs (indices 0, 1, 3, 4) lie in one sector;
    then the 2 kept docs, the (1, 2) runs' starts and ends, the anchor
    and the 2 counts (4 B each)."""
    t = {"postings_doc": torch.arange(8, dtype=torch.int32),
         "positions": torch.zeros(64, dtype=torch.int16),
         "pos_starts": torch.tensor([0, 3, 5, 20, 22, 40, 40, 40],
                                    dtype=torch.int32),
         "docs": torch.tensor([[1, 2]], dtype=torch.int32),
         "starts": torch.tensor([[0, 3]], dtype=torch.int32),
         "ends": torch.tensor([[3, 6]], dtype=torch.int32)}
    want = (0 + 1 + 2) * 32 + 2 * 4 + 2 * 8 + 4 + 2 * 4
    assert SDB.docs_bound_bytes(t, 2, 2, 8, 0) == want


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = SDB.docs_cases(torch.device("cuda", 0))
    assert out["cases"] > 0
