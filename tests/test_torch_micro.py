"""The port's library gaps against wiser_tpu: the python codecs
(varint, pack_block / unpack_block, bits_needed, delta), the f64 scoring
spec, rescore_topk / rescore_topk_batch, BloomConfig.check /
words_from_bytes, PackedIndex.lookup / postinglist_size, the whole-column
pack_doc_blocks / unpack_doc_blocks (one block table; against the JAX
function's Pallas kernel in interpret mode and its XLA path), the corpus
generator's CLI, and
tools/micro_bench (its rows, the engine rows on the CPU and the gRPC echo
over a loopback server).

Tolerance: none. Bytes, words, f64 bits, doc columns and row names are
exact; micro_bench's timings are only checked to exist."""

import socket

import numpy as np
import pytest
import torch

from wiser_tpu import codecs as j_codecs
from wiser_tpu import scoring as j_scoring
from wiser_tpu.data import scale_corpus as j_scale_corpus
from wiser_tpu.engine import topk as j_topk
from wiser_tpu.index.bloom import BloomConfig as JBloomConfig
from wiser_tpu.index.format import PackedIndex as JPackedIndex
from wiser_tpu.ops import unpack as j_unpack
from wiser_tpu.tools import micro_bench as j_micro
from wiser_tpu_torch import TorchEngine, codecs, scoring
from wiser_tpu_torch.data import scale_corpus
from wiser_tpu_torch.data.synth import synth_docinfos
from wiser_tpu_torch.engine import topk
from wiser_tpu_torch.index.bloom import BloomConfig
from wiser_tpu_torch.index.builder import build_index
from wiser_tpu_torch.index.format import SENTINEL_DOC
from wiser_tpu_torch.native import lib as native
from wiser_tpu_torch.ops import unpack as U
from wiser_tpu_torch.tools import micro_bench
from wiser_tpu_torch.utils import ResultTable


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f64_bits(x):
    return np.asarray(x, dtype=np.float64).view(np.uint64)


# -- codecs ------------------------------------------------------------------


VARINTS = [0, 1, 127, 128, 300, 2**14, 2**21 - 1, 2**32 - 1, 2**40 + 5]


def test_varint_scalar_and_stream():
    mine, ref = bytearray(), bytearray()
    for v in VARINTS:
        one, j_one = bytearray(), bytearray()
        codecs.varint_encode(v, one)
        j_codecs.varint_encode(v, j_one)
        assert one == j_one
        codecs.varint_encode(v, mine)
        j_codecs.varint_encode(v, ref)
    assert mine == ref
    off = 0
    for v in VARINTS:
        got = codecs.varint_decode(bytes(mine), off)
        assert got == j_codecs.varint_decode(bytes(ref), off) and got[0] == v
        off += got[1]
    assert off == len(mine)
    small = np.array([v for v in VARINTS if v < 2**32], dtype=np.uint32)
    stream = bytearray()
    for v in small.tolist():
        codecs.varint_encode(v, stream)
    assert native.varint_encode_array(small) == bytes(stream)
    with pytest.raises(ValueError):
        codecs.varint_encode(-1, bytearray())


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_block_equals_jax_and_native(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 2**width, size=codecs.BLOCK, dtype=np.uint64
                        ).astype(np.uint32)
    vals[0] = 2**width - 1  # the widest value packs too
    words = codecs.pack_block(vals, width)
    assert words.dtype == np.uint32 and len(words) == 4 * width
    assert np.array_equal(words, j_codecs.pack_block(vals, width))
    assert np.array_equal(
        words, native.pack_blocks(vals, np.array([width], dtype=np.uint8)))
    back = codecs.unpack_block(words, width)
    assert np.array_equal(back, vals)
    assert np.array_equal(back, j_codecs.unpack_block(words, width))
    assert codecs.bits_needed(vals) == j_codecs.bits_needed(vals) == width


def test_pack_block_rejects_what_does_not_fit():
    with pytest.raises(ValueError):
        codecs.pack_block(np.full(128, 4, dtype=np.uint32), 2)
    with pytest.raises(ValueError):
        codecs.pack_block(np.zeros(127, dtype=np.uint32), 2)


def test_bits_needed_and_delta_roundtrip():
    for vals in (np.zeros(5, np.uint32), np.array([], np.uint32),
                 np.array([1, 2, 3], np.uint32), np.array([2**31], np.uint64)):
        assert codecs.bits_needed(vals) == j_codecs.bits_needed(vals)
    rng = np.random.default_rng(3)
    docs = np.unique(rng.integers(0, 10**7, size=5000))
    for base in (0, int(docs[0]) - 3):
        d = codecs.delta_encode(docs, base)
        assert d.dtype == np.int64
        assert np.array_equal(d, j_codecs.delta_encode(docs, base))
        assert np.array_equal(codecs.delta_decode(d, base), docs)
        assert np.array_equal(j_codecs.delta_decode(d, base), docs)
    assert len(codecs.delta_encode(np.array([], np.int64))) == 0


# -- scoring -----------------------------------------------------------------


def test_scoring_equals_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    freq = rng.integers(1, 300, size=4000)
    flen = rng.integers(1, 5000, size=4000)
    codes = rng.integers(0, 256, size=4000)
    for avg in (1.0, 37.25, 123.456789):
        sim, j_sim = scoring.Bm25Similarity(avg), j_scoring.Bm25Similarity(avg)
        assert np.array_equal(f64_bits(sim.cache), f64_bits(j_sim.cache))
        assert np.array_equal(f64_bits(sim.tf_norm_lossy(freq, codes)),
                              f64_bits(j_sim.tf_norm_lossy(freq, codes)))
        assert np.array_equal(f64_bits(sim.tf_norm(freq, flen)),
                              f64_bits(j_sim.tf_norm(freq, flen)))
        assert np.array_equal(
            f64_bits(scoring.calc_es_tfnorm(freq, flen, avg)),
            f64_bits(j_scoring.calc_es_tfnorm(freq, flen, avg)))
        assert np.array_equal(
            f64_bits(scoring.Bm25Similarity.idf(10**6, freq)),
            f64_bits(j_scoring.Bm25Similarity.idf(10**6, freq)))
        tfs = rng.integers(0, 40, size=(300, 4))
        idfs = scoring.calc_es_idf(5000, rng.integers(1, 5000, size=4))
        c300 = codes[:300]
        batch = scoring.calc_doc_scores_lossy_batch(tfs, idfs, c300, sim)
        assert np.array_equal(f64_bits(batch), f64_bits(
            j_scoring.calc_doc_scores_lossy_batch(tfs, idfs, c300, j_sim)))
        one = [scoring.calc_doc_score_lossy(tfs[i], idfs, c300[i], sim)
               for i in range(300)]
        assert np.array_equal(f64_bits(one), f64_bits(batch))
        assert one == [j_scoring.calc_doc_score_lossy(tfs[i], idfs, c300[i],
                                                      j_sim)
                       for i in range(300)]
    lengths = rng.integers(1, 1000, size=777)
    assert (scoring.RunningAvgLength.of(lengths)
            == j_scoring.RunningAvgLength.of(lengths))


def test_rescore_topk_equals_jax():
    rng = np.random.default_rng(9)
    N, B, T, M = 500, 12, 4, 40
    codes = rng.integers(0, 256, size=N).astype(np.uint8)
    cache = scoring.Bm25Similarity(41.5).cache
    docs = rng.integers(-1, N, size=(B, M)).astype(np.int32)
    docs[3] = -1  # a row with no candidate
    docs[4, :] = 7  # one doc repeated: ties on the doc id
    tfs = rng.integers(0, 6, size=(B, T, M)).astype(np.int32)
    idf = scoring.calc_es_idf(N, rng.integers(1, N, size=(B, T)))
    idf[:, 3] = 0.0  # a padded slot
    ks = rng.integers(1, M + 5, size=B)
    got = topk.rescore_topk_batch(docs, tfs, idf, codes, cache, ks)
    assert got == j_topk.rescore_topk_batch(docs, tfs, idf, codes, cache, ks)
    assert got[3] == [] and len(got[0]) <= ks[0]
    for b in range(B):
        one = topk.rescore_topk(docs[b], tfs[b], 3, idf[b, :3], codes, cache,
                                int(ks[b]))
        assert one == j_topk.rescore_topk(docs[b], tfs[b], 3, idf[b, :3],
                                          codes, cache, int(ks[b]))
        assert one == got[b]  # the padded slot adds exactly +0.0


# -- bloom rows and the term dictionary ---------------------------------------


def test_bloom_check_and_words_from_bytes():
    rng = np.random.default_rng(2)
    for cfg, j_cfg in ((BloomConfig(), JBloomConfig()),
                       (BloomConfig(5, 0.0009), JBloomConfig(5, 0.0009)),
                       (BloomConfig(20, 0.01), JBloomConfig(20, 0.01))):
        keys = [f"k{i}" for i in range(6)]
        row = cfg.build_filter_words(keys)
        probes = keys + [f"x{i}" for i in range(200)] + ["", "naïve"]
        for words in (row, np.zeros(cfg.n_words, np.uint32)):
            got = [cfg.check(words, k) for k in probes]
            assert got == [j_cfg.check(words, k) for k in probes]
        assert all(cfg.check(row, k) for k in keys)
        assert not any(cfg.check(np.zeros(cfg.n_words, np.uint32), k)
                       for k in keys)
        for n in (0, 3, cfg.n_bytes, cfg.n_words * 4):
            raw = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            w = cfg.words_from_bytes(raw)
            assert w.dtype == np.dtype("<u4") and len(w) == cfg.n_words
            assert np.array_equal(w, j_cfg.words_from_bytes(raw))


def test_lookup_and_postinglist_size(tmp_path):
    packed, _ = build_index(synth_docinfos(300, 80, 20, seed=4))
    packed.save(str(tmp_path))
    j = JPackedIndex.load(str(tmp_path))
    for t in packed.terms[:40] + ["zzz", "", "t99999"]:
        assert packed.lookup(t) == j.lookup(t)
        assert packed.postinglist_size(t) == j.postinglist_size(t)
    assert packed.lookup("zzz") == -1 and packed.postinglist_size("zzz") == 0
    r = packed.lookup(packed.terms[5])
    assert r == 5 and packed.postinglist_size(packed.terms[5]) == packed.df[5]


# -- the whole-column unpack --------------------------------------------------


def doc_column(seed=0):
    """A sentinel-padded, 128-aligned doc column whose runs span many pack
    widths: dense runs (width 1), gaps up to ~2^20, a one-doc run and a
    run of exactly one block."""
    rng = np.random.default_rng(seed)
    runs = []
    for gap in (1, 2, 5, 30, 300, 5000, 90_000, 1_500_000):
        n = int(rng.integers(1, 700))
        runs.append(np.cumsum(rng.integers(1, gap + 1, size=n)) - 1)
    runs.append(np.array([2**30 + 5]))
    runs.append(np.arange(128) * 3)
    cols = []
    for r in runs:
        pad = (-len(r)) % 128
        cols.append(np.concatenate([r, np.full(pad, SENTINEL_DOC)]))
    return np.concatenate(cols).astype(np.int32)


def test_unpack_doc_blocks_equals_jax():
    col = doc_column()
    packed = U.pack_doc_blocks(col)
    j_packed = j_unpack.pack_doc_blocks(col)
    assert np.array_equal(packed["widths"], j_packed["widths"])
    assert np.array_equal(packed["block_first"], j_packed["block_first"])
    assert sorted(packed["groups"]) == sorted(j_packed["groups"])
    assert len(packed["groups"]) >= 8  # several widths present
    for w, (sel, words) in packed["groups"].items():
        j_sel, j_words = j_packed["groups"][w]
        assert np.array_equal(sel, j_sel) and np.array_equal(words, j_words)
    got = U.unpack_doc_blocks(packed, device="cpu")
    want = np.asarray(j_unpack.unpack_doc_blocks(j_packed))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # sentinel lanes carry the previous id; real lanes are the column
    real = col != SENTINEL_DOC
    assert np.array_equal(got[real], col[real])
    assert SENTINEL_DOC not in got
    widths = U.doc_block_widths(col)
    assert np.array_equal(widths, packed["widths"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_doc_blocks_one_table_equals_jax_pallas(seed):
    """The whole column through one block table (the plain version of the
    single launch) equals the JAX unpack_doc_blocks through the Pallas
    kernel in interpret mode and through its XLA path, and launches
    nothing on the CPU."""
    col = doc_column(seed)
    packed = U.pack_doc_blocks(col)
    j_packed = j_unpack.pack_doc_blocks(col)
    assert len(packed["groups"]) >= 8
    stream, widths, offsets, dest, first = U.doc_block_table(packed)
    assert len(dest) == len(packed["block_first"])
    U.reset_launch_counts()
    got = U.unpack_doc_blocks(packed, device="cpu")
    assert sum(U.launch_counts.values()) == 0
    pallas = np.asarray(j_unpack.unpack_doc_blocks(j_packed, use_pallas=True,
                                                   interpret=True))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, np.asarray(j_unpack.unpack_doc_blocks(j_packed)))


def test_unpack_doc_blocks_default_device_is_the_card():
    """The default device is "cuda": the kernel's answer where there is a
    card (equal to the plain version's), a RuntimeError where there is
    none."""
    packed = U.pack_doc_blocks(doc_column(1))
    if torch.cuda.is_available():
        assert np.array_equal(U.unpack_doc_blocks(packed),
                              U.unpack_doc_blocks(packed, device="cpu"))
    else:
        with pytest.raises(RuntimeError):
            U.unpack_doc_blocks(packed)


# -- the corpus generator's CLI ------------------------------------------------


def test_scale_corpus_main(tmp_path, capsys):
    mine, ref = str(tmp_path / "p.linedoc"), str(tmp_path / "j.linedoc")
    args = ["--n-docs", "60", "--vocab", "400", "--mean-len", "20",
            "--seed", "3", "--with-blooms"]
    scale_corpus.main(["--out", mine] + args)
    j_scale_corpus.main(["--out", ref] + args)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert "wrote 60 docs" in capsys.readouterr().err


# -- micro_bench -------------------------------------------------------------

HOST_ROWS = ["pack128_native", "unpack128_native", "pack128_python",
             "varint_encode", "varint_decode", "lz4_compress",
             "lz4_decompress", "host_intersect_1M", "snippet_200x"]


def test_micro_bench_rows(capsys):
    table = micro_bench.main(["--device", "--device-name", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    names = [r["bench"] for r in table.rows]
    assert names == HOST_ROWS + ["device_1k_single_term",
                                 "device_1k_two_term"]
    assert out[0].split("\t")[0] == "bench" and len(out) == 1 + len(names)
    assert [line.split("\t")[0] for line in out[1:]] == names
    j_micro.main([])
    j_names = [line.split("\t")[0]
               for line in capsys.readouterr().out.strip().splitlines()[1:]]
    assert j_names == HOST_ROWS
    rows = {r["bench"]: r for r in table.rows}
    assert rows["device_1k_two_term"]["qps"] > 0
    assert rows["host_intersect_1M"]["matches"] > 0


def test_bench_echo_over_loopback():
    pytest.importorskip("grpc")
    from wiser_tpu_torch.serve.server import create_server

    packed, _ = build_index(synth_docinfos(50, 20, 10, seed=1))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    server, executor = create_server(TorchEngine(packed, device="cpu"), port,
                                     n_threads=4)
    server.start()
    try:
        table = ResultTable()
        micro_bench.bench_echo(table, f"localhost:{port}")
    finally:
        executor.stop()
        server.stop(grace=1)
    (row,) = table.rows
    assert row["bench"] == "grpc_echo" and row["rtts"] == 500
    assert row["per_call_us"] > 0
