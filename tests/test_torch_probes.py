"""The port's device probes against wiser_tpu's: tools/gather_probe's four
variants (on the CPU, at a small N) and tools/prune_probe's classes and
guard readings on a few-thousand-doc corpus; and the one departure, the
prune probe's dense set, which is the engine's own (admit_dense_rows).

Tolerances: element, rowgather_onehot and rowgather_local equal the JAX
forms bit for bit; blocksum_gather within rel 1e-6 (XLA and torch sum the
128 lanes of a block in different orders, f32); the prune probe's
classes, per-query guard results and stats are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiser_tpu.index.format import PackedIndex as JPackedIndex
from wiser_tpu.tools import prune_probe as j_prune
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.data.scale_corpus import generate_linedoc
from wiser_tpu_torch.engine.device import admit_dense_rows
from wiser_tpu_torch.index.fast_builder import build_packed_fast
from wiser_tpu_torch.tools import gather_probe, prune_probe


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- gather_probe ------------------------------------------------------------

# The JAX probe's variants are closures inside its main(); these are their
# bodies, unchanged, as functions of (dense, docs).


def j_element(dense, docs):
    return jnp.take(dense, docs, axis=0)


def j_rowgather_onehot(dense, docs):
    blocks = dense.reshape(-1, 128)
    w = jnp.take(blocks, docs >> 7, axis=0)
    oh = ((docs & 127)[..., None] == jnp.arange(128, dtype=jnp.int32)
          ).astype(jnp.float32)
    return jnp.einsum("blk,blk->bl", w, oh,
                      preferred_element_type=jnp.float32)


def j_rowgather_local(dense, docs):
    blocks = dense.reshape(-1, 128)
    w = jnp.take(blocks, docs >> 7, axis=0)
    return jnp.take_along_axis(w, (docs & 127)[..., None], axis=2)[..., 0]


def j_blocksum_gather(dense, docs):
    s = jnp.sum(dense.reshape(-1, 128), axis=1)
    return jnp.take(s, docs >> 7, axis=0)


J_VARIANTS = {"element": j_element, "rowgather_onehot": j_rowgather_onehot,
              "rowgather_local": j_rowgather_local,
              "blocksum_gather": j_blocksum_gather}


@pytest.mark.parametrize("name", sorted(gather_probe.VARIANTS))
def test_gather_variants_equal_jax(name):
    dense_np, docs_np = gather_probe.make_inputs(4096, 4, 64)
    assert docs_np.dtype == np.int32 and (np.diff(docs_np, axis=1) >= 0).all()
    got = gather_probe.VARIANTS[name](torch.from_numpy(dense_np),
                                      torch.from_numpy(docs_np)).numpy()
    want = np.asarray(jax.jit(J_VARIANTS[name])(jnp.asarray(dense_np),
                                                jnp.asarray(docs_np)))
    assert got.shape == want.shape == (4, 64) and got.dtype == np.float32
    if name == "blocksum_gather":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.array_equal(got, dense_np[docs_np])


def test_gather_probe_main(capsys):
    out = gather_probe.main(["--n-pad", "4096", "--B", "4", "--L", "64",
                             "--reps", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and out["clock"] == "host"
    assert out["bit_exact"] and set(out["variants"]) == set(
        gather_probe.VARIANTS)
    bound = (4 * 4096 + 8 * 256) / 3.35e12 * 1e3
    for row in out["variants"].values():
        assert row["ms"] > 0 and row["G_lanes_per_s"] > 0
        assert row["bound_ms"] == pytest.approx(bound, rel=1e-12)
    assert '"variants"' in capsys.readouterr().out
    with pytest.raises(ValueError):
        gather_probe.make_inputs(4000, 2, 8)


# -- prune_probe --------------------------------------------------------------

N_DOCS, N_PAD = 8000, 8064


def small_budget(columns):
    """Three rows by the JAX probe's accounting: the dense tier is capped,
    so most of the 11 terms of df >= 4,096 stay out of it and the zipf
    semidense classes fill."""
    return 3 * N_PAD * (2 if columns == "tc" else 8) + 100


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("prune")
    path = str(d / "c.linedoc")
    generate_linedoc(path, N_DOCS, vocab_size=3000, mean_len=60, seed=13,
                     verbose=False)
    packed = build_packed_fast(path)
    packed.save(str(d / "idx"))
    return packed, JPackedIndex.load(str(d / "idx"))


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_prune_probe_equals_jax_on_its_mask(index, columns):
    packed, j_packed = index
    j_probe = j_prune.Probe(j_packed, columns=columns,
                            dense_budget_bytes=small_budget(columns))
    probe = prune_probe.Probe(packed, columns=columns, dense=j_probe.dense)
    assert np.array_equal(probe.dense, j_probe.dense) and probe.dense.any()
    assert np.array_equal(probe.score32, j_probe.score32)
    assert np.array_equal(probe.term_max, j_probe.term_max)
    classes = prune_probe.build_classes(packed, probe, 24, 10)
    j_classes = j_prune.build_classes(j_packed, j_probe, 24, 10)
    assert list(classes) == list(j_classes)
    assert {"tail_x_head_t2", "zipf_t3_semidense_bigL",
            "zipf_t4_semidense_bigL"} <= set(classes)
    Cs = [1, 2, 4]
    for name, queries in classes.items():
        assert [list(map(int, q)) for q in queries] == \
            [list(map(int, q)) for q in j_classes[name]], name
        for rows in queries:
            assert probe.run_query(rows, 10, Cs) == \
                j_probe.run_query(rows, 10, Cs)
    report = prune_probe.report_classes(probe, classes, 10, Cs)
    assert set(report) == set(classes)
    for name, r in report.items():
        assert r["n"] == len(classes[name])
        assert set(r["pass_rate"]) == {"oracle", "g128", "coarse"}
        assert all(0.0 <= x <= 1.0 for v in r["pass_rate"].values()
                   for x in v.values())


@pytest.mark.parametrize("budget", ["small", 7 << 29])
@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_prune_probe_dense_set_is_the_engines(index, columns, budget):
    packed = index[0]
    if budget == "small":
        budget = small_budget(columns)
    engine = TorchEngine(packed, device="cpu", columns=columns,
                         dense_budget_bytes=budget, single_term_depth=0)
    probe = prune_probe.Probe(packed, columns=columns,
                              dense_budget_bytes=budget)
    assert np.array_equal(probe.dense, engine._dense_slot >= 0)
    assert engine._dense_H == int(probe.dense.sum()) > 0
    rows = admit_dense_rows(packed, budget, columns)
    assert np.array_equal(engine._dense_slot[rows], np.arange(len(rows)))


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_jax_probe_copy_admits_other_rows(index, columns):
    """The JAX probe's hand copy of the admission charges 2 B per doc for
    a tc row (the engine 1 B) and leaves out the 9 B per block of bound
    planes: at a budget of ten of its own rows it admits a different set
    from the engine's."""
    packed, j_packed = index
    assert (packed.n_docs + 127) // 128 * 128 == N_PAD
    budget = 10 * N_PAD * (2 if columns == "tc" else 8)
    j_mask = j_prune.Probe(j_packed, columns=columns,
                           dense_budget_bytes=budget).dense
    mask = prune_probe.Probe(packed, columns=columns,
                             dense_budget_bytes=budget).dense
    assert int(j_mask.sum()) == 10
    assert int(mask.sum()) == (18 if columns == "tc" else 9)
    assert not np.array_equal(mask, j_mask)
