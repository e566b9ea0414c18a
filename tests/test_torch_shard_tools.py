"""The mesh's tools: tools/dryrun_multichip (every mesh route, raw and tc,
host-verified, at 8 shards on the CPU) and tools/shard_ladder (configs
1-4 through ShardedEngine, in process and from the command line, 0
mismatches), and the default shard placement."""

import json

import pytest
import torch

from wiser_tpu_torch.data.scale_corpus import (generate_linedoc,
                                               mine_phrases_from_linedoc)
from wiser_tpu_torch.data.synth import synth_docinfos
from wiser_tpu_torch.engine.shard import (ShardedEngine, ShardedIndex,
                                          default_placement)
from wiser_tpu_torch.index.builder import build_index
from wiser_tpu_torch.index.fast_builder import build_packed_fast
from wiser_tpu_torch.tools import scale_bench, shard_ladder
from wiser_tpu_torch.tools.dryrun_multichip import ROUTES, dryrun_multichip


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores, and these
    small-tensor steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_every_route():
    out = dryrun_multichip(8, device="cpu")
    assert out["placement"] == ["cpu"] * 8 and out["dense_H"] > 0
    assert set(out["runs"]) == {"raw_pruned", "raw_full", "tc_pruned",
                                "tc_full"}
    seen = {k for run in out["runs"].values() for k in run}
    assert seen == set(ROUTES)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder")
    path = str(d / "c.linedoc")
    generate_linedoc(path, 1200, vocab_size=300, mean_len=30, seed=5,
                     with_blooms=True, verbose=False)
    packed = build_packed_fast(path, with_blooms=True)
    packed.save(str(d / "idx"))
    return path, str(d / "idx"), packed


def test_shard_ladder_run(corpus):
    path, _, packed = corpus
    pairs = mine_phrases_from_linedoc(path, packed.term_to_row, 200)
    configs = scale_bench.build_configs(packed, None, 96, 10, pairs=pairs)
    engine = ShardedEngine(ShardedIndex.from_packed(packed, 4),
                           devices=["cpu"] * 4)
    out = shard_ladder.run(packed, engine, configs, 32, 20)
    assert sorted(out) == sorted(configs) and len(out) == 4
    for row in out.values():
        assert row["parity_mismatches"] == 0 and row["parity_sample"] == 20
        assert row["n_queries"] == 96 and row["wall_ms"] > 0
        assert row["qps"] > 0


def test_shard_ladder_main(corpus, tmp_path, capsys):
    path, idx, _ = corpus
    out = str(tmp_path / "ladder.json")
    shard_ladder.main(["--index", idx, "--linedoc", path, "--n-shards", "8",
                       "--n-queries", "64", "--batch", "32",
                       "--parity-sample", "16", "--columns", "tc",
                       "--device", "cpu", "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == summary
    assert summary["placement"] == ["cpu"] * 8
    assert summary["columns"] == "tc" and len(summary["configs"]) == 4
    assert all(r["parity_mismatches"] == 0
               for r in summary["configs"].values())


def test_default_placement(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert default_placement(4) == [f"cuda:{s}" for s in range(4)]
    assert default_placement(2) == ["cuda:0", "cuda:1"]
    assert default_placement(8) == ["cuda:0"] * 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_placement(3) == ["cuda:0"] * 3
    packed, _ = build_index(synth_docinfos(40, vocab_size=20, mean_len=8))
    with pytest.raises(RuntimeError):  # no card: the default raises
        ShardedEngine(ShardedIndex.from_packed(packed, 2))
