"""wiser_tpu_torch.ops.unpack (plain torch version of the packed-block
decode, and the CPU path of its kernel wrappers) against the JAX package:
unpack_blocks_xla, the Pallas kernel in interpret mode, the native codec,
delta_decode_docs, the staged engine's _make_doc_combine and
unpack_doc_blocks (the mixed-width block table of one launch). All
comparisons are bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.staged as JS
from wiser_tpu.native import lib as native
from wiser_tpu.ops import unpack as JU
from wiser_tpu_torch.ops import unpack as U


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(width: int, G: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**width, size=(G, 128), dtype=np.uint64).astype(np.uint32)
    words = native.pack_blocks(vals.reshape(-1), np.full(G, width, dtype=np.uint8))
    return vals, words.reshape(G, 4 * width)


@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_bit_exact_every_width(width):
    G = 16  # a multiple of the Pallas tile (8)
    vals, words = _packed(width, G, seed=width)
    t_words = torch.from_numpy(words.view(np.int32))
    got = U.unpack_blocks_torch(t_words, width).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(
        got, np.asarray(JU.unpack_blocks_xla(jnp.asarray(words), width)))
    np.testing.assert_array_equal(got, np.asarray(JU.unpack_blocks_pallas(
        jnp.asarray(words), width, interpret=True)))
    np.testing.assert_array_equal(got.reshape(-1), native.unpack_blocks(
        words.reshape(-1), np.full(G, width, dtype=np.uint8)))

    # delta decode (int32 wraparound at wide widths) and the wrapper's CPU
    # path, with and without first ids
    first = np.random.default_rng(width + 100).integers(
        0, 2**31 - 1, size=G).astype(np.int32)
    want = np.asarray(JU.delta_decode_docs(jnp.asarray(vals), jnp.asarray(first)))
    t_first = torch.from_numpy(first)
    dec = U.delta_decode_docs(torch.from_numpy(got.view(np.int32)), t_first)
    np.testing.assert_array_equal(dec.numpy(), want)
    np.testing.assert_array_equal(
        U.unpack_delta_blocks(t_words, t_first, width).numpy(), want.reshape(-1))
    np.testing.assert_array_equal(
        U.unpack_delta_blocks(t_words, None, width).numpy().view(np.uint32),
        vals.reshape(-1))


def test_delta_decode_example():
    # lane deltas store delta-1: decoded = 100, 103, 104, 110
    d = torch.tensor([[0, 2, 0, 5]], dtype=torch.int32)
    out = U.delta_decode_docs(d, torch.tensor([100], dtype=torch.int32))
    assert out.tolist() == [[100, 103, 104, 110]]


def test_wrapper_validates_shapes():
    _, words = _packed(5, 4, seed=1)
    t = torch.from_numpy(words.view(np.int32))
    with pytest.raises(ValueError):
        U.unpack_delta_blocks(t, None, 6)  # words are (G, 20), not (G, 24)
    with pytest.raises(ValueError):
        U.unpack_delta_blocks(t, torch.zeros(3, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        U.unpack_delta_blocks(t, None, 5, out=torch.empty(10, dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    U.reset_launch_counts()
    _, words = _packed(16, 8, seed=2)
    U.unpack_delta_blocks(torch.from_numpy(words.view(np.int32)), None, 16)
    assert U.launch_counts["unpack_delta_blocks"] == 0


def _scratch_inputs(width: int, seed: int):
    """A staged-scratch-shaped input: G real delta blocks of ascending
    docs (padded to a G16 bucket), plus a raw segment."""
    rng = np.random.default_rng(seed)
    G, G16b, Graw = 37, 64, 8
    docs = np.cumsum(rng.integers(1, 2**width, size=G * 128)).astype(np.int64)
    docs = (docs % (2**31 - 2)).astype(np.int32)
    docs.reshape(G, 128).sort(axis=1)
    deltas, first = JU.doc_block_deltas(docs)
    words = np.zeros((G16b, 4 * width), dtype=np.uint32)
    words[:G] = native.pack_blocks(
        deltas.reshape(-1), np.full(G, width, dtype=np.uint8)).reshape(G, 4 * width)
    f16 = np.zeros(G16b, dtype=np.int32)
    f16[:G] = first
    rawf = rng.integers(0, 2**31 - 1, size=Graw * 128).astype(np.int32)
    return words, f16, rawf, G * 128, Graw


@pytest.mark.parametrize("width", [4, 16])
def test_combine_matches_make_doc_combine(width):
    words, f16, rawf, A_total, Graw = _scratch_inputs(width, seed=width)
    cap = 1 << 15
    want = np.asarray(JS._make_doc_combine(words.shape[0], Graw, cap, width)(
        jnp.asarray(words), jnp.asarray(f16), jnp.asarray(rawf),
        np.int32(A_total)))
    got = U.combine_doc_column(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(f16),
        torch.from_numpy(rawf), A_total, cap, width, Graw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_combine_refuses_what_jax_would_clamp():
    words, f16, rawf, A_total, Graw = _scratch_inputs(16, seed=3)
    cap = A_total + Graw * 128 - 1  # raw segment would overrun by one id
    with pytest.raises(ValueError):
        U.combine_doc_column(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(f16),
            torch.from_numpy(rawf), A_total, cap, 16, Graw)


def test_block_deltas_and_widths_match():
    from wiser_tpu.data.synth import synth_docinfos
    from wiser_tpu.index.builder import build_index

    packed, _ = build_index(synth_docinfos(300, 80, 25, seed=9))
    d_t, f_t = U.doc_block_deltas(packed.postings_doc)
    d_j, f_j = JU.doc_block_deltas(packed.postings_doc)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(U.doc_block_widths(packed.postings_doc),
                                  JU.doc_block_widths(packed.postings_doc))


# -- the mixed-width block table (unpack_mixed_blocks) -------------------------


def _mixed_packed(widths, first, seed: int) -> dict:
    """A pack_doc_blocks-shaped dict of random delta blocks at the given
    per-block widths (each block's deltas fill its width) and first ids."""
    rng = np.random.default_rng(seed)
    widths = np.asarray(widths, dtype=np.uint8)
    deltas = np.zeros((len(widths), 128), dtype=np.uint32)
    for g, w in enumerate(widths):
        deltas[g] = rng.integers(0, 2**int(w), size=128, dtype=np.uint64)
        deltas[g, 0] = 0  # lane 0 stores 0
        deltas[g, 1 + g % 127] = 2**int(w) - 1  # the width is needed
    groups = {}
    for w in np.unique(widths):
        sel = np.nonzero(widths == w)[0].astype(np.int32)
        words = native.pack_blocks(deltas[sel].reshape(-1),
                                   np.full(len(sel), w, dtype=np.uint8))
        groups[int(w)] = (sel, words.reshape(len(sel), 4 * int(w)))
    return {"groups": groups, "block_first": np.asarray(first, np.int32),
            "widths": widths}


def _adversarial(name: str) -> dict:
    rng = np.random.default_rng(7)
    if name == "w1_w32_side_by_side":
        widths = [1, 32, 1, 32, 32, 1, 17, 1]
        return _mixed_packed(widths, rng.integers(0, 2**31 - 1, size=8), 1)
    if name == "single_block":
        return _mixed_packed([9], [12345], 2)
    if name == "first_near_int32_max":
        widths = [1, 3, 8, 16, 24, 31, 32, 5]
        return _mixed_packed(widths, 2**31 - 1 - np.arange(8) * 1000, 3)
    if name == "random_widths":
        return _mixed_packed(rng.integers(1, 33, size=64),
                             rng.integers(-2**31, 2**31 - 1, size=64), 4)
    assert name == "empty"
    return U.pack_doc_blocks(np.zeros(0, dtype=np.int32))


ADVERSARIAL = ("w1_w32_side_by_side", "single_block", "first_near_int32_max",
               "random_widths", "empty")


@pytest.fixture(scope="module")
def adversarial_columns():
    return {name: _adversarial(name) for name in ADVERSARIAL}


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_mixed_plain_equals_jax_unpack_doc_blocks(name, adversarial_columns):
    """The mixed-width plain version (unpack_doc_blocks on the CPU) equals
    the JAX unpack_doc_blocks through the Pallas kernel in interpret mode
    and through its XLA path, int32 wraparound included."""
    packed = adversarial_columns[name]
    G = len(packed["block_first"])
    U.reset_launch_counts()
    got = U.unpack_doc_blocks(packed, device="cpu")
    assert got.dtype == np.int32 and got.shape == (G * 128,)
    pallas = np.asarray(JU.unpack_doc_blocks(packed, use_pallas=True,
                                             interpret=True))
    xla = np.asarray(JU.unpack_doc_blocks(packed))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    assert U.launch_counts == {"unpack_delta_blocks": 0,
                               "unpack_mixed_blocks": 0}


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_doc_block_table_from_groups(name, adversarial_columns):
    """The stream is the groups' words concatenated, the offsets the
    running sum of 4*width (16-byte multiples), the destinations the
    groups' sel, the first ids block_first at them; upload_table hands
    them over as 16-byte aligned tensors of the wrapper's types."""
    packed = adversarial_columns[name]
    stream, widths, offsets, dest, first = U.doc_block_table(packed)
    groups = list(packed["groups"].items())
    want_stream = np.concatenate(
        [words.reshape(-1) for _, (_, words) in groups] or [np.zeros(0)])
    np.testing.assert_array_equal(stream, want_stream.astype(np.uint32))
    np.testing.assert_array_equal(dest, np.concatenate(
        [sel for _, (sel, _) in groups] or [np.zeros(0)]).astype(np.int32))
    np.testing.assert_array_equal(widths, packed["widths"][dest])
    np.testing.assert_array_equal(
        offsets, np.cumsum(4 * widths.astype(np.int64)) - 4 * widths)
    assert not (offsets * 4 % 16).any()
    np.testing.assert_array_equal(first, packed["block_first"][dest])
    up = U.upload_table((stream, widths, offsets, dest, first), "cpu")
    assert [t.dtype for t in up] == [torch.int32, torch.uint8, torch.int64,
                                     torch.int32, torch.int32]
    for t, a in zip(up, (stream.view(np.int32), widths, offsets, dest, first)):
        assert t.data_ptr() % 16 == 0
        np.testing.assert_array_equal(t.numpy(), a)


def test_mixed_blocks_write_in_place():
    """Blocks land at their destinations, in any table order; blocks no
    entry names keep what out held."""
    packed = _adversarial("random_widths")
    stream, widths, offsets, dest, first = U.doc_block_table(packed)
    want = np.asarray(JU.unpack_doc_blocks(packed)).reshape(-1, 128)
    perm = np.random.default_rng(5).permutation(len(dest))[:40]
    out = torch.full((80 * 128,), -7, dtype=torch.int32)
    shifted = (dest[perm] + 16).astype(np.int32)  # into blocks 16..79
    U.unpack_mixed_blocks(
        torch.from_numpy(stream.view(np.int32)), torch.from_numpy(widths[perm]),
        torch.from_numpy(offsets[perm]), torch.from_numpy(shifted),
        torch.from_numpy(first[perm]), out)
    got = out.numpy().reshape(-1, 128)
    np.testing.assert_array_equal(got[shifted], want[dest[perm]])
    untouched = np.setdiff1d(np.arange(80), shifted)
    assert (got[untouched] == -7).all()


def _table_tensors(name="w1_w32_side_by_side"):
    stream, widths, offsets, dest, first = U.doc_block_table(_adversarial(name))
    out = torch.empty(len(dest) * 128, dtype=torch.int32)
    return [torch.from_numpy(stream.view(np.int32)), torch.from_numpy(widths),
            torch.from_numpy(offsets), torch.from_numpy(dest),
            torch.from_numpy(first), out]


def test_mixed_wrapper_raises_on_misaligned_stream():
    args = _table_tensors()
    base = torch.zeros(args[0].shape[0] + 4, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    base[1 : 1 + args[0].shape[0]] = args[0]
    args[0] = base[1 : 1 + args[0].shape[0]]  # 4 bytes past a 16-byte line
    with pytest.raises(ValueError, match="16-byte aligned"):
        U.unpack_mixed_blocks(*args)


@pytest.mark.parametrize("bad", [0, 33])
def test_mixed_wrapper_raises_on_width_outside_1_32(bad):
    args = _table_tensors()
    args[1] = args[1].clone()
    args[1][2] = bad
    with pytest.raises(ValueError, match="outside 1..32"):
        U.unpack_mixed_blocks(*args)


@pytest.mark.parametrize("which", [2, 3, 4])
def test_mixed_wrapper_raises_on_mismatched_table_lengths(which):
    args = _table_tensors()
    args[which] = args[which][:-1]
    with pytest.raises(ValueError, match="table lengths differ"):
        U.unpack_mixed_blocks(*args)


def test_mixed_wrapper_raises_on_offsets_and_dest_out_of_range():
    args = _table_tensors()
    off = args[2].clone()
    off[1] += 2  # not a multiple of 4 words
    with pytest.raises(ValueError, match="offset"):
        U.unpack_mixed_blocks(args[0], args[1], off, *args[3:])
    dest = args[3].clone()
    dest[0] = args[5].shape[0] // 128
    with pytest.raises(ValueError, match="destination"):
        U.unpack_mixed_blocks(*args[:3], dest, *args[4:])


def test_mixed_cpu_path_launches_no_kernel():
    U.reset_launch_counts()
    U.unpack_mixed_blocks(*_table_tensors())
    U.unpack_doc_blocks(_adversarial("single_block"), device="cpu")
    assert U.launch_counts == {"unpack_delta_blocks": 0,
                               "unpack_mixed_blocks": 0}


def test_bench_column_forms_agree_on_the_cpu():
    """tools/unpack_bench's two decode forms of a column, the per-width
    loop of unpack_delta_blocks and the one unpack_mixed_blocks call, give
    the JAX unpack_doc_blocks; its bytes bound counts every word, first
    id and decoded id once, and the single call's table rows."""
    from wiser_tpu_torch.tools import unpack_bench as UB

    packed = _adversarial("random_widths")
    forms = UB.column_forms(U, packed, torch.device("cpu"))
    assert sorted(forms) == ["loop", "single"]
    want = np.asarray(JU.unpack_doc_blocks(packed))
    for fn, result in forms.values():
        fn()
        np.testing.assert_array_equal(result().numpy(), want)
    G = len(packed["block_first"])
    words = 16 * int(packed["widths"].astype(np.int64).sum())
    assert UB.column_bytes(packed, False) == words + 4 * G + 512 * G
    assert UB.column_bytes(packed, True) == words + 4 * G + 512 * G + 13 * G
