"""Device selection, independence and carry-across of wiser_tpu_torch.

CUDA requested where there is none raises (no silent CPU fallback), and
"cuda" is the engines' default device. The port imports nothing of the
JAX package: an AST scan of its sources, and a subprocess that builds
an index with the port's own generator and builder, searches it (both
engines, raw and tc columns), imports the serving entry points
(bench.headline, the factory, the server and the client) and the
harnesses and tools (bench.run_exp, data.synth_log, utils, tools/), and
then finds neither wiser_tpu, jax, grpc nor protobuf in sys.modules. Its
copies of the
host modules agree with the JAX package's (the generated linedoc file
byte for byte, with and without the bi-bloom columns; the built index
array for array, bloom rows included; murmur2 and the folded probe
masks; the native codec word for word), and an index carries across
both ways: packed_from_arrays of the JAX object, PackedIndex.load of a
directory the JAX package saved, and the JAX load of a directory the
port saved. chip_smoke.py refuses
to run without a card.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from wiser_tpu.data.scale_corpus import generate_linedoc as j_generate
from wiser_tpu.index import bloom as j_bloom
from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu.index.fast_builder import build_packed_fast as j_build
from wiser_tpu.index.format import PackedIndex as JPackedIndex
from wiser_tpu.native import lib as j_native
from wiser_tpu_torch import StagedEngine, TorchEngine, resolve_device
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
from wiser_tpu_torch.engine.staged_shard import ShardedStagedEngine
from wiser_tpu_torch.data.scale_corpus import (
    generate_linedoc,
    mine_phrases_from_linedoc,
)
from wiser_tpu_torch.index import bloom
from wiser_tpu_torch.index.fast_builder import build_packed_fast
from wiser_tpu_torch.index.format import PackedIndex
from wiser_tpu_torch.native import lib as native
from wiser_tpu_torch.ops.unpack import pack_doc_blocks, unpack_doc_blocks
from wiser_tpu_torch.tools import gather_probe, micro_bench, wiki_pipeline
from wiser_tpu_torch.tools.dryrun_multichip import dryrun_multichip
from wiser_tpu_torch.utils import ResultTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every field the two PackedIndex classes store, derived ones included
FIELDS = ("terms", "term_starts", "df", "postings_doc", "postings_tf",
          "n_docs", "avg_len", "doc_len_code", "pos_starts", "positions",
          "off_starts", "off_begin", "off_end", "bloom_ends", "bloom_begins",
          "term_to_row", "idf64", "max_tf")


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def assert_same_index(mine, ref):
    for name in FIELDS:
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert (mine.bloom_cfg.expected_entries, mine.bloom_cfg.error_ratio) == (
        ref.bloom_cfg.expected_entries, ref.bloom_cfg.error_ratio)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jp, _ = build_index(synth_docinfos(50, 20, 10, seed=1))
    packed = to_port(jp)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    sharded = ShardedIndex.from_packed(packed, 2)
    for make in (lambda: TorchEngine(packed, device="cuda"),
                 lambda: TorchEngine(packed),  # "cuda" by default
                 lambda: StagedEngine(packed, 0, device="cuda"),
                 lambda: StagedEngine(packed, 0),
                 lambda: ShardedEngine(sharded),
                 lambda: ShardedEngine(sharded, devices=["cuda:0"] * 2),
                 lambda: ShardedStagedEngine(packed, 2, 0),
                 lambda: dryrun_multichip(2),
                 lambda: unpack_doc_blocks(pack_doc_blocks(jp.postings_doc)),
                 lambda: gather_probe.probe(1024, 2, 16, 1),
                 lambda: micro_bench.bench_device(ResultTable()),
                 # raises before it writes anything
                 lambda: wiki_pipeline.run_pipeline("/nonexistent/x", 10)):
        with pytest.raises(RuntimeError):
            make()


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def _port_sources():
    pkg = os.path.join(ROOT, "wiser_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "ab_serve.py")


def test_no_source_imports_the_jax_package():
    """Every import (top level or inside a function) of every .py file
    under wiser_tpu_torch/ and of chip_smoke.py / ab_serve.py names
    neither wiser_tpu (wiser_tpu_torch is the port) nor jax."""
    bad, n_files = [], 0
    for path in _port_sources():
        n_files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("wiser_tpu", "jax", "jaxlib"):
                    bad.append((os.path.relpath(path, ROOT), node.lineno, name))
    assert n_files > 15
    assert not bad, bad


_STANDALONE = """
import sys
sys.path.insert(0, {root!r})
from wiser_tpu_torch import StagedEngine, TorchEngine
from wiser_tpu_torch.data.scale_corpus import (generate_linedoc,
                                               mine_phrases_from_linedoc)
from wiser_tpu_torch.engine.host import host_exact_search
from wiser_tpu_torch.index.fast_builder import build_packed_fast
from wiser_tpu_torch.types import SearchQuery
# the serving entry points: none of them needs grpc or protobuf to import
import wiser_tpu_torch.bench.headline
import wiser_tpu_torch.engine.factory
import wiser_tpu_torch.serve.client
import wiser_tpu_torch.serve.server
# the measurement harnesses and the index tools
import wiser_tpu_torch.bench.run_exp
import wiser_tpu_torch.data.synth_log
import wiser_tpu_torch.utils
from wiser_tpu_torch.tools import (check_posting_list, engine_bench,
                                   index_stats, indexer, make_query_log,
                                   parity_audit, route_bench,
                                   run_client_server, scale_bench,
                                   stage_probe)
# the mesh
from wiser_tpu_torch.engine.shard import ShardedEngine, ShardedIndex
from wiser_tpu_torch.engine.staged_shard import ShardedStagedEngine
from wiser_tpu_torch.tools import dryrun_multichip, shard_ladder
# the raw-text pipeline, micro_bench and the probes
from wiser_tpu_torch.data import corpus
from wiser_tpu_torch.tools import (gather_probe, micro_bench, prune_probe,
                                   wiki_pipeline)

generate_linedoc({path!r}, 1500, vocab_size=300, mean_len=30, seed=5,
                 with_blooms=True, verbose=False)
packed = build_packed_fast({path!r}, with_blooms=True)
assert packed.bloom_ends is not None
by_df = sorted(range(packed.n_terms), key=lambda r: -packed.df[r])
qs = [SearchQuery([packed.terms[by_df[i]], packed.terms[by_df[j]]],
                  n_results=10) for i, j in ((0, 1), (0, 40), (3, 120))]
qs.append(SearchQuery([packed.terms[by_df[7]]], n_results=5))
pairs = mine_phrases_from_linedoc({path!r}, packed.term_to_row, 40)
phrases = [SearchQuery(list(p), n_results=10, is_phrase=True) for p in pairs]
runs = []
for columns in ("raw", "tc"):
    staged = StagedEngine(packed, 0, device="cpu", columns=columns)
    staged.COLD_COMPUTE = "device"
    runs += [(TorchEngine(packed, device="cpu", columns=columns),
              qs + phrases), (staged, qs),
             (ShardedEngine(ShardedIndex.from_packed(packed, 4),
                            devices=["cpu"] * 4, columns=columns),
              qs + phrases)]
runs.append((ShardedStagedEngine(packed, 4, 1 << 20, devices=["cpu"] * 4),
             qs + phrases))
for e, batch in runs:
    for q, r in zip(batch, e.search_batch(batch)):
        rows = [packed.term_to_row[t] for t in q.terms]
        d, s = host_exact_search(packed, e.cache64, rows, q.n_results,
                                 is_phrase=q.is_phrase)
        got = [(x.doc_id, x.doc_score) for x in r.entries]
        assert got == list(zip(d.tolist(), s.tolist())), (q.terms, got)
        assert got
rec = wiki_pipeline.run_pipeline({work!r}, 200, n_queries=64, parity_n=32,
                                 device="cpu")
assert rec["check_posting_list_errors"] == 0
assert rec["engine"]["parity_mismatches"] == 0
probe = prune_probe.Probe(packed, columns="raw", dense_budget_bytes=1 << 20)
assert (probe.dense == (TorchEngine(packed, device="cpu",
        dense_budget_bytes=1 << 20)._dense_slot >= 0)).all()
assert gather_probe.probe(1024, 2, 16, 1, device="cpu")["bit_exact"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("wiser_tpu", "jax", "jaxlib", "grpc")
             or m.startswith("google.protobuf"))
assert not bad, bad
print("OK")
"""


def test_port_runs_without_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    src = _STANDALONE.format(root=ROOT, path=str(tmp_path / "c.linedoc"),
                             work=str(tmp_path / "wikipipe"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "blooms"])
def linedocs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    mine, ref = str(d / "port.linedoc"), str(d / "jax.linedoc")
    kw = dict(vocab_size=2000, mean_len=40, seed=9, chunk_docs=700,
              with_blooms=request.param, verbose=False)
    generate_linedoc(mine, 2000, **kw)
    j_generate(ref, 2000, **kw)
    return mine, ref, request.param


def test_generator_and_builder_match_the_jax_package(linedocs):
    """The file byte for byte; the index (bloom_ends / bloom_begins too,
    built with the reference indexer's BloomConfig(5, 0.0009)) array for
    array."""
    mine, ref, blooms = linedocs
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    cfg = bloom.BloomConfig(5, 0.0009)
    got = build_packed_fast(mine, chunk_docs=700, with_blooms=blooms,
                            bloom_cfg=cfg)
    want = j_build(ref, "WITH_BI_BLOOM" if blooms else "WITH_POSITIONS",
                   chunk_docs=700, with_blooms=blooms,
                   bloom_cfg=j_bloom.BloomConfig(5, 0.0009))
    assert_same_index(got, want)
    assert (got.bloom_ends is not None) == blooms
    if blooms:
        assert got.bloom_ends.any() and got.bloom_begins.any()


def test_bloom_rows_need_the_bloom_columns(linedocs):
    """with_blooms needs the WITH_BI_BLOOM columns; without it a bloom
    file builds the same index with no bloom rows."""
    mine, ref, blooms = linedocs
    if not blooms:
        with pytest.raises(ValueError):
            build_packed_fast(mine, with_blooms=True)
        return
    plain = build_packed_fast(mine, chunk_docs=700)
    assert plain.bloom_ends is None
    assert_same_index(plain, j_build(ref, "WITH_BI_BLOOM", chunk_docs=700))


def test_murmur2_and_probe_masks_match_the_jax_package():
    """murmur2 (Python, native and batched) over keys of every tail
    length, multi-byte UTF-8 and the seeds the filters use, and every
    probe of BloomConfig, against the JAX package's."""
    assert bloom.murmur2(b"", 0) == 0
    for key in (b"", b"a", b"ab", b"abc", b"abcd", b"abcde", b"hello world",
                "naïve".encode()):
        for seed in (0, 1, bloom.MURMUR_SEED, 0xFFFFFFFF):
            h = j_bloom.murmur2(key, seed)
            assert bloom.murmur2(key, seed) == h
            assert native.murmur2_batch_seeded(
                key, [0], [len(key)], np.array([seed], dtype=np.uint32))[0] == h
    assert bloom.MURMUR_SEED == j_bloom.MURMUR_SEED
    rng = np.random.default_rng(2)
    keys = ["".join(chr(97 + c) for c in rng.integers(0, 26, n))
            for n in rng.integers(0, 15, 300)] + ["naïve", "日本"]
    blob = "\x00".join(keys).encode("utf-8")
    lens = np.array([len(k.encode("utf-8")) for k in keys])
    starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)])
    a = native.murmur2_batch_seeded(blob, starts, starts + lens, None)
    b = native.murmur2_batch_seeded(blob, starts, starts + lens, a)
    np.testing.assert_array_equal(
        a, j_native.murmur2_batch_seeded(blob, starts, starts + lens, None))
    np.testing.assert_array_equal(
        b, j_native.murmur2_batch_seeded(blob, starts, starts + lens, a))
    for cfg, jcfg in ((bloom.BloomConfig(), j_bloom.BloomConfig()),
                      (bloom.BloomConfig(9, 0.01), j_bloom.BloomConfig(9, 0.01))):
        for prop in ("bpe", "bits", "n_bytes", "n_hashes", "n_words"):
            assert getattr(cfg, prop) == getattr(jcfg, prop)
        for k in keys:
            np.testing.assert_array_equal(cfg.probe_bits(k), jcfg.probe_bits(k))
            for x, y in zip(cfg.probe_word_masks(k), jcfg.probe_word_masks(k)):
                np.testing.assert_array_equal(x, y)
            assert cfg.probe_mask_folded(k) == jcfg.probe_mask_folded(k)


def test_bloom_column_hashing_parses_like_str_split():
    """The native neighbor-column parser keeps Python's str.split(" ")
    keys (empty keys between double spaces, empty groups, a last group
    without its '!') and counts the groups."""
    col = "ab cd!!x  y!z!tail"
    keys, entry = [], []
    groups = col.split("!")
    for g, text in enumerate(groups):
        if text:
            keys += text.split(" ")
            entry += [g + 7] * len(text.split(" "))
    a, b, e = native.bloom_col_hash(col.encode(), len(groups), entry_base=7)
    assert e.tolist() == entry
    assert a.tolist() == [bloom.murmur2(k.encode(), bloom.MURMUR_SEED)
                          for k in keys]
    assert b.tolist() == [bloom.murmur2(k.encode(), int(x))
                          for k, x in zip(keys, a)]
    with pytest.raises(ValueError):
        native.bloom_col_hash(col.encode(), len(groups) + 1)


def test_mined_phrases_match_the_jax_package(linedocs):
    from wiser_tpu.tools.scale_bench import mine_phrases_from_linedoc as j_mine

    mine, ref, _ = linedocs
    jp = j_build(ref, chunk_docs=700)
    got = mine_phrases_from_linedoc(mine, jp.term_to_row, max_pairs=300,
                                    max_rows=150)
    assert got == j_mine(ref, jp, max_pairs=300, max_rows=150)
    assert len(got) == 300


@pytest.mark.parametrize("blooms", [False, True])
def test_carry_across_both_ways(tmp_path, blooms):
    jp, _ = build_index(synth_docinfos(300, 80, 25, seed=4),
                        with_blooms=blooms)
    assert (jp.bloom_ends is not None) == blooms
    assert_same_index(to_port(jp), jp)
    jp.save(str(tmp_path / "from_jax"))
    loaded = PackedIndex.load(str(tmp_path / "from_jax"))
    assert_same_index(loaded, jp)
    loaded.save(str(tmp_path / "from_port"))
    assert_same_index(JPackedIndex.load(str(tmp_path / "from_port")), jp)


@pytest.mark.parametrize("width", [1, 7, 16, 31, 32])
def test_native_codec_matches_the_jax_package(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 2**width, size=5 * 128, dtype=np.uint64).astype(np.uint32)
    widths = np.full(5, width, dtype=np.uint8)
    words = native.pack_blocks(vals, widths)
    np.testing.assert_array_equal(words, j_native.pack_blocks(vals, widths))
    np.testing.assert_array_equal(native.unpack_blocks(words, widths), vals)
    with pytest.raises(ValueError):
        native.pack_blocks(vals[:-1], widths)


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # chip_smoke.py alone, without the program
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = _smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
