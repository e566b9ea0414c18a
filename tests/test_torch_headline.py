"""The port's headline entry (wiser_tpu_torch.bench.headline), the
counterpart of the root bench.py, at a few hundred docs and queries on
the CPU: its JSON line carries bench.py's keys (compile_cache dropped)
plus backend, columns and card; its corpus is bench.py's, built by the
port's builder and cached under a directory name of its own; its query
generator equals bench.py's on the same index; and its timed pass
answers as the exact host search does."""

import ast
import dataclasses
import json
import os

import pytest
import torch

import bench
from wiser_tpu.data.synth import synth_docinfos as j_synth
from wiser_tpu.index.builder import build_index as j_build
from wiser_tpu_torch.bench import headline
from wiser_tpu_torch.engine.host import host_exact_search
from wiser_tpu_torch.scoring import Bm25Similarity
from test_torch_runtime import assert_same_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_docs=300, vocab=400, mean_len=30)


def bench_py_keys():
    """The keys of the JSON object bench.py prints."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                return set(keys)
    raise AssertionError("bench.py prints no metric object")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("bench_cache"))
    out = {}
    for columns in ("raw", "tc"):
        out[columns] = headline.run(n_queries=600, columns=columns, batch=256,
                                    pipeline=2, n_passes=2, device="cpu",
                                    cache_dir=cache, **SMALL)
    return cache, out


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_json_line(runs, columns):
    cache, out = runs
    line = out[columns]["line"]
    assert set(line) == (bench_py_keys() - {"compile_cache"}) | {
        "backend", "columns", "card"}
    assert (line["backend"], line["columns"], line["card"]) == (
        "torch", columns, "cpu")
    queries = out[columns]["queries"]
    uniq = len({(tuple(q.terms), q.n_results) for q in queries})
    assert line["replayed_queries"] == 600 and line["unique_queries"] == uniq
    assert len(line["pass_qps"]) == 2 and line["value"] == max(line["pass_qps"])
    assert line["vs_baseline"] == round(line["value"] / 10_000, 3)
    assert line["unique_qps"] == pytest.approx(line["value"] * uniq / 600,
                                               rel=1e-3)
    json.dumps(line)
    assert os.listdir(cache) == ["torch_idx_300_400_30"]


def test_pass_split(runs):
    """Each timed pass's wall beside its host time in submit_batch and in
    run_pending (the split the chip smoke writes to its report)."""
    _, out = runs
    passes = out["raw"]["passes"]
    assert [round(p["qps"], 1) for p in passes] == out["raw"]["line"]["pass_qps"]
    for p in passes:
        assert p["batches"] == 3  # 600 queries in batches of 256
        assert 0 < p["submit_s"] and 0 < p["run_pending_s"]
        assert p["submit_s"] + p["run_pending_s"] <= p["wall_s"]


def test_printed_line(tmp_path, capsys):
    headline.run(n_queries=50, batch=16, n_passes=1, device="cpu",
                 cache_dir=str(tmp_path), **SMALL)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(printed) == 1 and printed[0]["metric"] == "aggregate_qps_aol_mix"


def test_corpus_and_queries_equal_bench_py(runs):
    """bench.py's corpus (through the JAX builder) and its query generator
    over it equal the port's."""
    _, out = runs
    packed = out["raw"]["packed"]
    jp, _ = j_build(j_synth(SMALL["n_docs"], SMALL["vocab"],
                            SMALL["mean_len"], zipf_a=1.25, seed=42,
                            with_blooms=False))
    assert_same_index(packed, jp)
    mine = headline.aol_mixed_queries(packed, 600)
    ref = bench.aol_mixed_queries(jp, 600)
    assert [dataclasses.astuple(q) for q in mine] == \
        [dataclasses.astuple(q) for q in ref]
    assert [dataclasses.astuple(q) for q in out["raw"]["queries"]] == \
        [dataclasses.astuple(q) for q in mine]


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_timed_pass_answers_exactly(runs, columns):
    _, out = runs
    packed, queries, results = (out[columns][k]
                                for k in ("packed", "queries", "results"))
    assert len(results) == len(queries)
    cache64 = Bm25Similarity(packed.avg_len).cache
    for q, r in list(zip(queries, results))[::3]:
        rows = [packed.term_to_row[t] for t in q.terms]
        d, s = host_exact_search(packed, cache64, rows, q.n_results)
        assert [(e.doc_id, e.doc_score) for e in r.entries] == \
            list(zip(d.tolist(), s.tolist()))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        headline.run(n_queries=10, device="cuda", cache_dir=str(tmp_path),
                     **SMALL)
    assert not os.listdir(tmp_path)  # it raised before building anything
