"""wiser_tpu_torch.ops.unpack (plain torch version of the packed-block
decode, and the CPU path of its kernel wrapper) against the JAX package:
unpack_blocks_xla, the Pallas kernel in interpret mode, the native codec,
delta_decode_docs and the staged engine's _make_doc_combine. All
comparisons are bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wiser_tpu.engine.staged as JS
from wiser_tpu.native import lib as native
from wiser_tpu.ops import unpack as JU
from wiser_tpu_torch.ops import unpack as U


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
