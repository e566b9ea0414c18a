"""wiser_tpu_torch.engine.kernels (plain torch bs search step) against the
JAX package's search_body / make_search_kernel on the same numpy inputs.

Tolerances: flag words must be equal (boundary_truncated counts lanes
over the full plane, so it does not depend on which tied lanes top-k
kept). Top scores may differ by <= 1e-6 relative: f32 sums of the
per-slot partial scores may round differently in another summation
order, the slop the engine's guard rel_eps = 1e-6 covers. Kept doc sets
(and each kept doc's per-slot tfs) must be equal on rows without
FLAG_TRUNC; with FLAG_TRUNC the choice among tied boundary lanes is
free, since torch.topk has no index tie-break.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.engine import kernels as JK
from wiser_tpu.index.builder import build_index
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine import kernels as TK
from wiser_tpu_torch.engine.host import padded_host_columns
from wiser_tpu_torch.scoring import Bm25Similarity

L, B = 4096, 48


@pytest.fixture(scope="module")
def columns():
    jp, _ = build_index(synth_docinfos(n_docs=3000, vocab_size=60,
                                       mean_len=20, seed=11))
    packed = packed_from_arrays({f.name: getattr(jp, f.name)
                                 for f in dataclasses.fields(jp)})
    scores64 = packed.partial_scores(Bm25Similarity(packed.avg_len).cache)
    return packed, padded_host_columns(packed, scores64)


def _batch(packed, T: int, seed: int):
    """Random (B, T) slot rows, candidate (min df) first; a few rows are
    padding (starts = ends = 0) and some queries repeat slot 0 in padded
    slots with use_score 0, as the engine assembles them."""
    rng = np.random.default_rng(seed)
    df = packed.df
    starts = np.zeros((B, T), dtype=np.int32)
    ends = np.zeros((B, T), dtype=np.int32)
    use = np.zeros((B, T), dtype=np.float32)
    for b in range(B - 4):
        n_real = int(rng.integers(1, T + 1))
        rows = rng.choice(packed.n_terms, size=n_real, replace=False)
        rows = sorted(rows, key=lambda r: df[r])
        for t in range(T):
            r = rows[t] if t < n_real else rows[0]
            starts[b, t] = packed.term_starts[r]
            ends[b, t] = packed.term_starts[r] + df[r]
            use[b, t] = 1.0 if t < n_real else 0.0
    return starts, ends, use


@pytest.mark.parametrize("M", [16, 64])  # two-level and flat top-M
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8])
def test_search_body_matches_jax(columns, T, M):
    packed, (h_doc, h_score, h_tf) = columns
    assert int(packed.df.max()) <= L
    starts, ends, use = _batch(packed, T, seed=T * 100 + M)
    n_iters = TK.n_iters_for(int(packed.df.max()))
    j = jax.jit(partial(JK.search_body, T=T, L=L, M=M, n_bs_iters=n_iters))(
        jnp.asarray(h_doc), jnp.asarray(h_score), jnp.asarray(h_tf),
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(use))
    jd, js, jt, _, jf = (np.asarray(a) for a in j)
    t = TK.search_body(
        torch.from_numpy(h_doc), torch.from_numpy(h_score),
        torch.from_numpy(h_tf), torch.from_numpy(starts),
        torch.from_numpy(ends), torch.from_numpy(use),
        T=T, L=L, M=M, n_bs_iters=n_iters)
    td, ts, tt, _, tf = (a.numpy() for a in t)

    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(np.sort(ts, axis=1), np.sort(js, axis=1),
                               rtol=1e-6)
    for b in range(B):
        if tf[b] & TK.FLAG_TRUNC:
            continue
        keep_t, keep_j = td[b] >= 0, jd[b] >= 0
        got = {int(d): tuple(tt[b, :, m]) for m, d in enumerate(td[b]) if keep_t[m]}
        want = {int(d): tuple(jt[b, :, m]) for m, d in enumerate(jd[b]) if keep_j[m]}
        assert got == want, f"row {b}"
    # the test must reach both flag states and real intersections
    assert (tf & TK.FLAG_TRUNC).any() or M == 64
    assert (td >= 0).sum() > B


def test_packed_kernel_layout_matches_jax(columns):
    packed, (h_doc, h_score, h_tf) = columns
    T, M = 3, 64
    starts, ends, use = _batch(packed, T, seed=5)
    n_iters = TK.n_iters_for(int(packed.df.max()))
    want = np.asarray(JK.make_search_kernel(T, L, M, n_iters)(
        jnp.asarray(h_doc), jnp.asarray(h_score), jnp.asarray(h_tf),
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(use)))
    got = TK.make_search_kernel(T, L, M, n_iters)(
        torch.from_numpy(h_doc), torch.from_numpy(h_score),
        torch.from_numpy(h_tf), torch.from_numpy(starts),
        torch.from_numpy(ends), torch.from_numpy(use)).numpy()
    assert got.shape == want.shape == (B, T + 2, M)
    np.testing.assert_array_equal(got[:, T + 1], want[:, T + 1])  # flags
    clean = (got[:, T + 1, 0] & TK.FLAG_TRUNC) == 0
    np.testing.assert_array_equal(np.sort(got[clean, 0], axis=1),
                                  np.sort(want[clean, 0], axis=1))


def test_slice_rows_and_gather_clamp_like_jax():
    arr = np.arange(1000, dtype=np.int32) * 3
    starts = np.array([-5, 0, 500, 990, 2000], dtype=np.int32)
    want = np.asarray(JK._slice_rows(jnp.asarray(arr), jnp.asarray(starts), 64))
    got = TK._slice_rows(torch.from_numpy(arr), torch.from_numpy(starts), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.array([[-3, 0, 999, 1000, 5000]], dtype=np.int32)
    np.testing.assert_array_equal(
        TK._gather1d(torch.from_numpy(arr), torch.from_numpy(idx)).numpy(),
        np.asarray(JK._gather1d(jnp.asarray(arr), jnp.asarray(idx))))


@pytest.mark.parametrize("max_len", [0, 1, 127, 128, 4096, 2**21])
def test_n_iters_for(max_len):
    assert TK.n_iters_for(max_len) == JK.n_iters_for(max_len)
