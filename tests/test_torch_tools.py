"""The port's index tools and harness entry points against the JAX
package's: the indexer's output array for array (the oracle build, and
the fast builder with and without a disk spill) with a doc store that
reads back the bodies; index_stats' dict; check_posting_list passing,
and failing on a corrupted index; make_query_log's file byte for byte;
then each harness CLI run on --device cpu (scale_bench, route_bench with
a trace, parity_audit, stage_probe, run_exp, engine_bench local and
locallog) and raising on --device cuda without a card; and
run_client_server spawning the port's server on the CPU for a 2 s
closed-loop run (nonzero QPS, 0 errors)."""

import json
import os
import shutil
import socket

import numpy as np
import pytest
import torch

import wiser_tpu.tools.index_stats as j_stats
import wiser_tpu.tools.indexer as j_indexer
import wiser_tpu.tools.make_query_log as j_mql
from wiser_tpu.data.scale_corpus import generate_linedoc
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.index.doc_store import ChunkedDocStoreReader
from wiser_tpu_torch.index.format import PackedIndex
from wiser_tpu_torch.linedoc import parse_linedoc
from wiser_tpu_torch.tools import (check_posting_list, engine_bench,
                                   index_stats, indexer, make_query_log,
                                   parity_audit, route_bench, scale_bench,
                                   stage_probe)
from wiser_tpu_torch.bench import run_exp

FIELDS = ("terms", "term_starts", "df", "postings_doc", "postings_tf",
          "n_docs", "avg_len", "doc_len_code", "pos_starts", "positions",
          "off_starts", "off_begin", "off_end", "bloom_ends", "bloom_begins")


def assert_same_dirs(a: str, b: str):
    from wiser_tpu.index.format import PackedIndex as JPackedIndex

    mine, ref = PackedIndex.load(a), JPackedIndex.load(b)
    for name in FIELDS:
        x, y = getattr(mine, name), getattr(ref, name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name
    return mine


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    path = str(d / "c.linedoc")
    generate_linedoc(path, 500, vocab_size=300, mean_len=30, seed=11,
                     with_blooms=True, verbose=False)
    out = str(d / "idx")
    indexer.main(["--linedoc", path, "--format", "WITH_BI_BLOOM", "--out",
                  out, "--with-blooms", "--fast"])
    return d, path, out


@pytest.mark.parametrize("mode", ["oracle", "fast", "fast_spill"])
def test_indexer_matches_the_jax_indexer(corpus, mode):
    d, path, _ = corpus
    kw = dict(n_rows=420, with_blooms=True, fast=mode != "oracle")
    mine, ref = str(d / f"m_{mode}"), str(d / f"r_{mode}")
    spill = str(d / f"spill_{mode}") if mode == "fast_spill" else None
    indexer.build(path, "WITH_BI_BLOOM", mine, spill_dir=spill, **kw)
    j_indexer.build(path, "WITH_BI_BLOOM", ref,
                    spill_dir=spill and spill + "_j", **kw)
    packed = assert_same_dirs(mine, ref)
    assert packed.n_docs == 420 and packed.bloom_ends is not None
    assert spill is None or not os.path.exists(spill)
    bodies = [doc.body for doc in parse_linedoc(path, "WITH_BI_BLOOM", 420)]
    r = ChunkedDocStoreReader(os.path.join(mine, "docs"))
    try:
        assert [r.get(i) for i in range(len(bodies))] == bodies
    finally:
        r.close()


def test_load_skip_offsets(corpus):
    _, _, idx = corpus
    full, lean = PackedIndex.load(idx), PackedIndex.load(idx, skip_offsets=True)
    assert len(lean.off_begin) == len(lean.off_end) == 0
    assert len(lean.off_starts) == lean.n_postings + 1
    assert not lean.off_starts.any()
    for name in FIELDS:
        if not name.startswith("off_"):
            x, y = getattr(full, name), getattr(lean, name)
            assert (np.array_equal(x, y) if isinstance(x, np.ndarray)
                    else x == y), name


def test_index_stats_equal(corpus):
    _, _, idx = corpus
    packed = PackedIndex.load(idx)
    terms = [packed.terms[0], packed.terms[-1], "no-such-term"]
    got = index_stats.stats(idx, terms)
    assert got == j_stats.stats(idx, terms)
    assert got["has_blooms"] and got["postinglist_sizes"]["no-such-term"] == 0


def test_check_posting_list(corpus, tmp_path, capsys):
    _, path, idx = corpus
    assert check_posting_list.check(idx, path, "WITH_BI_BLOOM") == 0
    assert "OK:" in capsys.readouterr().out
    bad = str(tmp_path / "bad")
    shutil.copytree(idx, bad)
    packed = PackedIndex.load(bad)
    packed.postings_tf[int(packed.term_starts[3])] += 1
    packed.df[5] += 1
    packed.save(bad)
    assert check_posting_list.check(bad, path, "WITH_BI_BLOOM") == 2
    out = capsys.readouterr().out
    assert "tf mismatch" in out and "df" in out
    with pytest.raises(SystemExit) as e:
        check_posting_list.main(["--index", bad, "--linedoc", path,
                                 "--format", "WITH_BI_BLOOM"])
    assert e.value.code == 1


def test_make_query_log_byte_equal(corpus):
    d, _, idx = corpus
    mine, ref = str(d / "q_mine.txt"), str(d / "q_ref.txt")
    make_query_log.main(["--index", idx, "--out", mine, "--n", "700",
                         "--seed", "3"])
    j_mql.main(["--index", idx, "--out", ref, "--n", "700", "--seed", "3"])
    with open(mine, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.count(b"\n") == 700


# -- the harness CLIs on the CPU ---------------------------------------------------


@pytest.fixture(scope="module")
def query_log(corpus):
    d, _, idx = corpus
    path = str(d / "q.txt")
    make_query_log.main(["--index", idx, "--out", path, "--n", "400"])
    return path


@pytest.fixture
def low_floor(monkeypatch):
    """A dense tier on a corpus of hundreds of docs."""
    monkeypatch.setattr(TorchEngine, "DENSE_MIN_DF_FLOOR", 48)


def _cli_runs(corpus, query_log, tmp_path):
    d, path, idx = corpus
    return {
        "scale_bench": (scale_bench.main, [
            "--index", idx, "--linedoc", path, "--n-queries", "200",
            "--batch", "64", "--parity-sample", "20",
            "--out", str(tmp_path / "s.json")]),
        "scale_bench_staged": (scale_bench.main, [
            "--index", idx, "--n-queries", "100", "--batch", "64",
            "--parity-sample", "10", "--engine", "staged",
            "--budget-bytes", "200000", "--configs", "3_aol_mix"]),
        "route_bench": (route_bench.main, [
            "--index", idx, "--linedoc", path, "--n-queries", "48",
            "--batch", "32", "--routes", "zipf_t2,zipf_t3,phrase_list",
            "--trace", str(tmp_path / "trace")]),
        "parity_audit": (parity_audit.main, [
            "--index", idx, "--linedoc", path, "--n-queries", "64",
            "--batch", "32", "--compare-default"]),
        "stage_probe": (stage_probe.main, [
            "--index", idx, "--B", "16", "--T", "2", "--C", "2", "--M", "4",
            "--SB", "2", "--reps", "1"]),
        "run_exp": (run_exp.main, [
            "--memory", "--index", idx, "--fracs", "0.1", "--n-queries",
            "128", "--batch", "64", "--cold-compute", "device",
            "--out", str(tmp_path / "exp.jsonl")]),
        "engine_bench_local": (engine_bench.main, [
            "--mode", "local", "--index", idx, "--n-queries", "200",
            "--batch", "64"]),
        "engine_bench_locallog": (engine_bench.main, [
            "--mode", "locallog", "--index", idx, "--query-log", query_log,
            "--batch", "64"]),
    }


CLIS = ["scale_bench", "scale_bench_staged", "route_bench", "parity_audit",
        "stage_probe", "run_exp", "engine_bench_local",
        "engine_bench_locallog"]


@pytest.mark.parametrize("name", CLIS)
def test_harness_cli_runs_on_cpu(corpus, query_log, tmp_path, low_floor,
                                 capsys, name):
    fn, argv = _cli_runs(corpus, query_log, tmp_path)[name]
    fn(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    if name == "run_exp":
        rows = [json.loads(x) for x in open(tmp_path / "exp.jsonl")]
        assert len(rows) == 1 and rows[0]["qps"] > 0
        assert rows[0]["device_mem_bytes"] is None
        assert rows[0]["treatment"]["cold_compute"] == "device"
        return
    res = json.loads(out.strip().splitlines()[-1])
    if name.startswith("scale_bench"):
        cfgs = res["configs"]
        assert cfgs and all(r["parity_mismatches"] == 0 and r["qps"] > 0
                            for r in cfgs.values())
        if name == "scale_bench":
            assert set(cfgs) == {"1_single_term", "2_two_term_and",
                                 "3_aol_mix", "4_phrase"}
            assert json.load(open(tmp_path / "s.json"))["configs"] == cfgs
    elif name == "route_bench":
        routes = res["routes"]
        assert set(routes) == {"zipf_t2", "zipf_t3", "phrase_list"}
        assert "traced" in routes["zipf_t3"]
        assert "traced" not in routes["zipf_t2"]
    elif name == "parity_audit":
        rows = res["configs"].values()
        assert all(r["mismatches"] == 0 and r["default_qps"] > 0
                   for r in rows)
        assert sum(r["flags"]["total"] for r in rows) > 0
    elif name == "stage_probe":
        for k in ("s1_ub_only_ms", "s1_select_ms", "s2_payload_ms",
                  "full_ms", "full_two_level_ms", "topk_blocks_ms"):
            assert res[k] > 0, k
        assert 0 <= res["flag_rate_two_level"] <= 1
    else:
        assert res["qps"] > 0 and res["queries"] > 0
        assert res["device"] == "cpu"


@pytest.mark.parametrize("name", CLIS)
def test_harness_cli_raises_on_cuda_without_a_card(corpus, query_log,
                                                   tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fn, argv = _cli_runs(corpus, query_log, tmp_path)[name]
    with pytest.raises(RuntimeError):
        fn(argv + ["--device", "cuda"])


def test_scale_bench_staged_needs_a_budget(corpus):
    _, _, idx = corpus
    with pytest.raises(SystemExit):
        scale_bench.main(["--index", idx, "--engine", "staged",
                          "--device", "cpu"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_run_client_server_on_cpu(corpus, query_log, tmp_path, capsys):
    pytest.importorskip("grpc")
    from wiser_tpu_torch.tools import run_client_server

    _, _, idx = corpus
    out = str(tmp_path / "stats.json")
    run_client_server.main([
        "--index", idx, "--query-log", query_log, "--device", "cpu",
        "--port", str(_free_port()), "--n-threads", "4", "--duration", "2",
        "--max-wait-ms", "2", "--ready-timeout", "120", "--out", out])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == json.load(open(out))
    assert stats["qps"] > 0 and stats["total"] > 0
    assert stats["errors"] == 0 and stats["device"] == "cpu"
    assert stats["latency_us"]["p50"] > 0
