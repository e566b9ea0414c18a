"""The port's measurement harnesses against the JAX package's, on the same
seeded inputs: synth_log's query lists, scale_bench.build_configs,
route_bench.build_route_sets / build_phrase_route_sets and
run_exp.build_workload (equal query sets for the same seed); the staged
engine's term_weights admission (equal hot / phrase-hot masks, hot bytes
and results), full_device_bytes and dense_tier_bytes; a staged
run_exp.run_treatment (equal budget and residency fields); and
parity_audit's flag counts and mismatch count (0), the JAX engine
counted by a test-local wrapper of the same rule (the JAX FlagCounter
takes no rescue= argument). Also the torch.profiler trace and its
summary, and that each harness raises on "cuda" without a card."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import wiser_tpu.bench.run_exp as JX
import wiser_tpu.data.synth_log as JL
import wiser_tpu.engine.staged as JS
import wiser_tpu.tools.route_bench as JR
import wiser_tpu.tools.scale_bench as JB
import wiser_tpu_torch.bench.run_exp as TX
import wiser_tpu_torch.data.synth_log as TL
import wiser_tpu_torch.engine.staged as TS
import wiser_tpu_torch.tools.route_bench as TR
import wiser_tpu_torch.tools.scale_bench as TB
from wiser_tpu.data.scale_corpus import generate_linedoc
from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.engine import kernels as JK
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.index.fast_builder import build_packed_fast as j_build
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays
from wiser_tpu_torch.data.synth import synth_docinfos as t_synth
from wiser_tpu_torch.index.builder import build_index as t_build_index
from wiser_tpu_torch.index.fast_builder import build_packed_fast
from wiser_tpu_torch.tools import parity_audit as TP
from wiser_tpu_torch.utils import ResultTable, PhaseTimer, summarize, trace


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def qkey(qs):
    return [(list(q.terms), q.n_results, q.is_phrase) for q in qs]


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.fixture(scope="module")
def corpus():
    """A bloom corpus through the JAX builder, its port copy, and both
    oracles (the port's built from the port's own synth of the seed)."""
    docs = synth_docinfos(n_docs=400, vocab_size=150, mean_len=35, seed=33,
                          with_blooms=True)
    jp, joracle = build_index(docs, with_blooms=True)
    _, toracle = t_build_index(t_synth(400, 150, 35, seed=33,
                                       with_blooms=True), with_blooms=True)
    return jp, to_port(jp), joracle, toracle


@pytest.fixture(scope="module")
def linedoc_index(tmp_path_factory):
    """A wiki-shaped bi-bloom linedoc and its index by both fast builders."""
    path = str(tmp_path_factory.mktemp("ld") / "c.linedoc")
    generate_linedoc(path, 600, vocab_size=400, mean_len=30, seed=5,
                     with_blooms=True, verbose=False)
    return path, j_build(path, "WITH_BI_BLOOM", with_blooms=True), \
        build_packed_fast(path, "WITH_BI_BLOOM", with_blooms=True)


# -- synth_log ------------------------------------------------------------------


def test_synth_log_functions_equal(corpus):
    jp, _, joracle, toracle = corpus
    terms, dfs = jp.terms, jp.df
    low_j, high_j = JL.split_df_groups(terms, dfs, threshold=40)
    assert (low_j, high_j) == TL.split_df_groups(terms, dfs, threshold=40)
    assert low_j and high_j
    pairs = [("a", "b"), ("c", "c"), ("d", "e", "f"), ("g",)]
    cases = [
        (JL.gen_single_term_log(terms, 300, working_set=50, seed=3),
         TL.gen_single_term_log(terms, 300, working_set=50, seed=3)),
        (JL.gen_single_term_log(terms, 100), TL.gen_single_term_log(terms, 100)),
        (JL.gen_two_term_log(low_j, high_j, 200),
         TL.gen_two_term_log(low_j, high_j, 200)),
        (JL.gen_phrase_log(pairs, 50), TL.gen_phrase_log(pairs, 50)),
        (JL.aol_shape_mixed_log(terms, dfs, 400, n_results=7),
         TL.aol_shape_mixed_log(terms, dfs, 400, n_results=7)),
    ]
    base = JL.aol_shape_mixed_log(terms, dfs, 300)
    cases.append((JL.gen_locality_log(base, 250, window=40),
                  TL.gen_locality_log(base, 250, window=40)))
    for want, got in cases:
        assert qkey(got) == qkey(want) and len(got) > 0
    mined = JL.mine_phrases_from_index(joracle, max_phrases=100)
    assert mined == TL.mine_phrases_from_index(toracle, max_phrases=100)
    assert len(mined) == 100
    assert TL.gen_phrase_log([("a", "a")], 5) == []


# -- query sets of the harnesses --------------------------------------------------


def test_build_configs_equal(linedoc_index):
    path, jp, tp = linedoc_index
    want = JB.build_configs(jp, path, 500, 10)
    got = TB.build_configs(tp, path, 500, 10)
    assert list(got) == list(want) == ["1_single_term", "2_two_term_and",
                                       "3_aol_mix", "4_phrase"]
    for name in want:
        assert qkey(got[name]) == qkey(want[name]), name
    # already-mined pairs give the same sets as mining the linedoc
    pairs = JB.mine_phrases_from_linedoc(path, jp, max_pairs=2000)
    cached = TB.build_configs(tp, None, 500, 10, pairs=pairs)
    assert {n: qkey(q) for n, q in cached.items()} == \
        {n: qkey(q) for n, q in want.items()}
    assert "4_phrase" not in TB.build_configs(tp, None, 50, 10)


@pytest.fixture
def low_floors(monkeypatch):
    """Dense rows and windowed lists on a corpus of hundreds of docs."""
    for cls in (TpuEngine, TorchEngine):
        monkeypatch.setattr(cls, "DENSE_MIN_DF_FLOOR", 48)


def test_route_sets_equal(linedoc_index, low_floors):
    path, jp, tp = linedoc_index
    je, te = TpuEngine(jp), TorchEngine(tp, device="cpu")
    for e in (je, te):
        e.WINDOWED_MIN_L, e.WINDOWED_MAX_L = 16, 40
    np.testing.assert_array_equal(je._dense_slot, te._dense_slot)
    assert te._dense_H > 3
    want = JR.build_route_sets(jp, je, 64, 10)
    got = TR.build_route_sets(tp, te, 64, 10)
    assert list(got) == list(want)
    assert {"dense_all_head_pair", "semidense_tail_x_head",
            "windowed_mid_pair", "bsearch_tail_pair", "single_term_table",
            "zipf_t3", "dense_t3", "semidense_t3",
            "midcand_x_2head_t3"} <= set(got)
    for name in want:
        assert qkey(got[name]) == qkey(want[name]), name
    pw = JR.build_phrase_route_sets(jp, je, path, 40, 10)
    pt = TR.build_phrase_route_sets(tp, te, path, 40, 10)
    assert list(pt) == list(pw) and len(pt) >= 2
    for name in pw:
        assert qkey(pt[name]) == qkey(pw[name]), name


def test_run_set_counts_routes(linedoc_index, low_floors, tmp_path):
    """run_set's stats and the named-route share; the traced pass adds a
    profiler summary beside the untraced wall."""
    _, _, tp = linedoc_index
    te = TorchEngine(tp, device="cpu")
    sets = TR.build_route_sets(tp, te, 48, 10)
    row = TR.run_set(te, sets["semidense_tail_x_head"], 32)
    named, routed = TR.route_share("semidense_tail_x_head", row["stats"])
    assert 2 * named > routed > 0  # a majority of the set
    assert TR.route_share("zipf_t2", row["stats"]) is None
    traced = TR.run_set(te, sets["zipf_t3"], 32, trace_dir=str(tmp_path))
    tr = traced["traced"]
    assert tr["device"] == "cpu" and tr["busy_share"] is None
    assert tr["top_ops"] and tr["untraced_wall_s"] == traced["wall_s"]
    assert os.path.getsize(tmp_path / "trace.json") > 0


@pytest.mark.parametrize("workload", ["single", "two_term", "phrase",
                                      "aol_mix", "worklocal_mix"])
def test_build_workload_equal(corpus, workload):
    jp, tp, joracle, toracle = corpus
    kw = dict(name="w", workload=workload, n_queries=300, n_results=7)
    want = JX.build_workload(jp, joracle, JX.Treatment(**kw))
    got = TX.build_workload(tp, toracle, TX.Treatment(**kw))
    assert qkey(got) == qkey(want) and len(got) == 300


# -- the staged engine's admission knobs --------------------------------------------


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_full_device_bytes_equal(corpus, low_floors, columns):
    jp, tp, _, _ = corpus
    assert TS.full_device_bytes(tp, columns) == JS.full_device_bytes(jp, columns)
    for budget in (None, 0, 40_000, 1 << 40):
        assert TS.dense_tier_bytes(tp, columns, budget) == \
            JS.dense_tier_bytes(jp, columns, budget)
    assert TS.dense_tier_bytes(tp, columns) > 0
    # the dense tier an engine builds at the default budget, beside the
    # computed one
    te = TorchEngine(tp, device="cpu", columns=columns)
    assert te.device_bytes()["dense_tier"] == TS.dense_tier_bytes(tp, columns)


@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_staged_term_weights_equal(corpus, low_floors, frac):
    jp, tp, joracle, _ = corpus
    t = TX.Treatment("w", workload="worklocal_mix", n_queries=400, batch=64,
                     n_results=10)
    qs = TX.build_workload(tp, None, t)
    w = TX.qfreq_weights(tp, qs[:200], 64)
    np.testing.assert_array_equal(
        w, _jax_qfreq(jp, JX.build_workload(jp, None, JX.Treatment(
            "w", workload="worklocal_mix", n_queries=400, batch=64))[:200], 64))
    budget = int(TS.full_device_bytes(tp) * frac)
    te = TS.StagedEngine(tp, budget, device="cpu", term_weights=w)
    je = JS.StagedEngine(jp, budget, term_weights=w)
    np.testing.assert_array_equal(te.hot_mask, je.hot_mask)
    np.testing.assert_array_equal(te.phrase_hot_mask, je.phrase_hot_mask)
    np.testing.assert_array_equal(te.dense_mask, je.dense_mask)
    assert te.hot_bytes_used == je.hot_bytes_used
    assert te.phrase_hot_fraction == je.phrase_hot_fraction
    assert 0 < te.hot_fraction < 1
    # weighted admission differs from df order here
    unweighted = TS.StagedEngine(tp, budget, device="cpu")
    assert not np.array_equal(unweighted.hot_mask, te.hot_mask)
    evalq = qs[200:]
    got = lists(te.search_batch(evalq))
    assert got == lists(je.search_batch(evalq))
    assert got == lists(joracle.search(q) for q in evalq)


def _jax_qfreq(jp, train, batch):
    """run_exp.run_treatment's inline qfreq weights (the JAX code)."""
    w = np.zeros(jp.n_terms, dtype=np.int64)
    win = min(batch, 1024)
    for b0 in range(0, len(train), win):
        rows = {jp.term_to_row.get(t, -1)
                for q in train[b0 : b0 + win] for t in q.terms}
        rows.discard(-1)
        for r in rows:
            w[r] += 1
    return w


def test_term_weights_none_keeps_df_order(corpus, low_floors):
    """term_weights=None and weights equal to df admit the same terms."""
    _, tp, _, _ = corpus
    budget = int(TS.full_device_bytes(tp) * 0.2)
    a = TS.StagedEngine(tp, budget, device="cpu")
    b = TS.StagedEngine(tp, budget, device="cpu", term_weights=tp.df.copy())
    np.testing.assert_array_equal(a.hot_mask, b.hot_mask)
    np.testing.assert_array_equal(a.phrase_hot_mask, b.phrase_hot_mask)


@pytest.mark.parametrize("residency", ["df", "qfreq"])
def test_run_treatment_staged_fields_equal(low_floors, residency):
    kw = dict(name="m", n_docs=300, vocab=200, mean_len=30,
              workload="worklocal_mix", engine="staged", hbm_budget_frac=0.2,
              n_queries=256, batch=128, residency=residency)
    want = JX.run_treatment(JX.Treatment(**{**kw, "engine": "staged"}))
    got = TX.run_treatment(TX.Treatment(**kw), device="cpu")
    for f in ("budget_bytes", "hot_fraction", "phrase_hot_fraction",
              "dense_fraction", "hot_bytes_used"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.device_mem_bytes is None  # no device memory on the CPU
    assert got.qps > 0 and got.resident_bytes["total"] > 0
    assert got.treatment["n_docs"] == 300


def test_memory_matrix_device_cold_path(corpus, low_floors, monkeypatch):
    """A memory-grid row with the device cold path stages chunks and
    decodes their doc columns through the unpack wrapper (its plain
    version on the CPU)."""
    _, tp, _, toracle = corpus
    calls = []
    combine = TS.combine_doc_column
    monkeypatch.setattr(TS, "combine_doc_column",
                        lambda *a, **k: calls.append(1) or combine(*a, **k))
    rows = TX.memory_matrix(n_queries=256, batch=128, fracs=(0.05,),
                            cold_compute="device")
    assert [t.hbm_budget_frac for t in rows] == [0.05]
    r = TX.run_treatment(rows[0], device="cpu", packed=tp, oracle=toracle)
    assert r.budget_bytes == int(TS.full_device_bytes(tp) * 0.05)
    assert r.treatment["cold_compute"] == "device" and r.qps > 0
    assert r.treatment["n_docs"] == tp.n_docs and calls


# -- parity audit --------------------------------------------------------------


class _JaxCounter:
    """The port FlagCounter's rule around the JAX engine (every call
    counted, rescue= forwarded)."""

    def __init__(self, engine):
        self.engine, self._orig = engine, engine._flags_to_force
        self.counts = dict.fromkeys(("trunc", "overflow", "tf_sat",
                                     "prune_miss", "forced", "total"), 0)

    def __enter__(self):
        c = self.counts

        def counted(flags, rescue=False):
            flags = np.asarray(flags)
            c["total"] += len(flags)
            for k, bit in (("trunc", JK.FLAG_TRUNC),
                           ("overflow", JK.FLAG_OVERFLOW),
                           ("tf_sat", JK.FLAG_TF_SAT),
                           ("prune_miss", JK.FLAG_PRUNE_MISS)):
                c[k] += int(((flags & bit) != 0).sum())
            force = self._orig(flags, rescue=rescue)
            c["forced"] += int(np.asarray(force).sum())
            return force

        self.engine._flags_to_force = counted
        return self

    def __exit__(self, *exc):
        self.engine._flags_to_force = self._orig


def test_parity_audit_flag_counts_equal(linedoc_index, low_floors):
    path, jp, tp = linedoc_index
    te = TorchEngine(tp, device="cpu", strict_parity=True)
    je = TpuEngine(jp, strict_parity=True)
    for e in (je, te):
        e.PRUNED_DENSE_MIN_NB, e.PRUNED_DENSE_C = 2, 1  # pruned + rescue
    configs = TB.build_configs(tp, path, 96, 10)
    seen = dict.fromkeys(("forced", "trunc", "prune_miss"), 0)
    for name, qs in configs.items():
        row = TP.audit_config(te, tp, qs, 64)
        assert row["mismatches"] == 0, (name, row.get("examples"))
        for i in range(0, len(qs), 64):  # the JAX side's warm pass
            je.search_batch(qs[i : i + 64])
        with _JaxCounter(je) as jc:
            bad, _, _ = JX_verify(je, jp, qs, 64)
        assert bad == 0
        # the JAX bs / windowed finalize passes its bucket-padded flag
        # words (zero rows past the group) to _flags_to_force, so its
        # total also counts padding; every class count is equal
        got, want = dict(row["flags"]), dict(jc.counts)
        assert got.pop("total") <= want.pop("total")
        assert got == want, name
        for k in seen:
            seen[k] += row["flags"][k]
    assert all(v > 0 for v in seen.values()), seen
    assert te._flags_to_force.__func__ is TorchEngine._flags_to_force


def JX_verify(engine, packed, queries, batch):
    from wiser_tpu.tools.parity_audit import verify_config

    return verify_config(engine, packed, queries, batch)


# -- utils -----------------------------------------------------------------------


def test_trace_summary_and_tables(tmp_path):
    with pytest.raises(RuntimeError):  # the card by default
        with trace(str(tmp_path / "c")):
            pass
    with trace(str(tmp_path / "t"), device="cpu") as prof:
        x = torch.randn(256, 256)
        for _ in range(3):
            x = x @ x
    s = summarize(prof, top=3)
    assert s["device"] == "cpu" and len(s["top_ops"]) <= 3
    assert any("mm" in r["name"] for r in s["top_ops"])
    assert s["wall_s"] > 0 and s["busy_share"] is None
    assert os.path.exists(tmp_path / "t" / "trace.json")
    t = PhaseTimer()
    with t.phase("a"):
        pass
    assert t.report().splitlines()[1].startswith("a\t")
    rt = ResultTable()
    rt.add_row(a=1)
    rt.add_row(b=2)
    assert rt.to_str() == "a\tb\n1\tNA\nNA\t2"


def test_harnesses_raise_on_cuda_without_a_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tp, _, _ = corpus
    with pytest.raises(RuntimeError):
        TX.run_treatment(TX.Treatment("x", n_docs=50, vocab=40, mean_len=10))


@pytest.mark.parametrize("depth", [1, 64, 300])
def test_single_term_table_equals_the_jax_table(corpus, depth):
    """The per-run sort of the impact table against the JAX package's one
    lexsort, on a full index and on a staged hot view (cold terms on
    zero-length runs)."""
    from wiser_tpu.engine.device import build_single_term_table as j_table
    from wiser_tpu_torch.engine.host import build_single_term_table

    _, tp, _, _ = corpus
    hot = np.arange(tp.n_terms) % 3 == 0
    view = TS._hot_view(tp, hot, hot)
    for pk in (tp, view):
        sc = pk.partial_scores(TS.Bm25Similarity(pk.avg_len).cache)
        got = build_single_term_table(pk, sc, depth)
        want = j_table(pk, sc, depth)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[1]) > 0
