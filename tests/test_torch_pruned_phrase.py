"""The block-pruned mega phrase (FULL_PHRASE_SCAN = False) of
TorchEngine against TpuEngine and OracleEngine, raw and tc columns.

tests/test_pruned_dense.py's corpora with the mega route forced on a
13-block doc space (PRUNED_DENSE_MIN_NB 8, PRUNED_PHRASE_C 4,
PHRASE_MAX_L 64): on the flat corpus the C-block bound cannot certify,
so misses retry at PRUNED_PHRASE_RETRY_C blocks in the batch's rescue
and what still flags takes the exact host phrase search; on the skewed
corpus the top blocks prove the top-k on the device. Identical (doc, f64
score) lists in both outcomes, the zero-match phrase included. The step
itself is held against the JAX kernels in test_torch_phrase_kernels.py
and test_torch_tc_kernels.py.
"""

import dataclasses

import numpy as np
import pytest

import wiser_tpu_torch.engine.kernels as TK
from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.convert import packed_from_arrays


def to_port(jp):
    return packed_from_arrays({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})


def lists(results):
    return [[(e.doc_id, e.doc_score) for e in r.entries] for r in results]


@pytest.fixture(scope="module")
def flat_corpus():
    rng = np.random.default_rng(23)
    docs = []
    for _ in range(1600):
        toks = [t for t, p in (("h0", 0.9), ("h1", 0.8), ("h2", 0.7))
                if rng.random() < p]
        toks += [f"r{rng.integers(200)}" for _ in range(rng.integers(3, 10))]
        rng.shuffle(toks)
        docs.append(make_docinfo(toks, with_blooms=False))
    return build_index(docs)


@pytest.fixture(scope="module")
def skewed_corpus():
    docs = []
    for i in range(1600):
        if i < 256:
            toks = ["h0"] * 4 + ["h1"] * 4 + [f"f{j}" for j in range(i % 5)]
        else:
            toks = ["h0", "h1"] + [f"g{i}_{j}" for j in range(28 + i % 7)]
        docs.append(make_docinfo(toks, with_blooms=False))
    return build_index(docs)


def pruned_pair(jp, columns, **over):
    te = TorchEngine(to_port(jp), device="cpu", columns=columns)
    je = TpuEngine(jp, columns=columns)
    for e in (te, je):
        e.PRUNED_DENSE_MIN_NB = 8
        e.PRUNED_DENSE_C = 4
        e.PRUNED_PHRASE_C = 4
        e.PHRASE_MAX_L = 64
        e.FULL_PHRASE_SCAN = False
        for k, v in over.items():
            setattr(e, k, v)
    return te, je


def spy(monkeypatch, columns):
    calls = []
    name = "make_pruned_phrase_kernel" + ("_tc" if columns == "tc" else "")
    orig = getattr(TK, name)

    def wrapped(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(TK, name, wrapped)
    return calls


def three_way(te, je, oracle, qs):
    got = lists(te.search_batch(qs))
    assert got == lists(je.search_batch(qs))
    assert got == lists(oracle.search(q) for q in qs)
    return got


MEGA = (["h0", "h1"], ["h1", "h2"], ["h1", "h0"], ["h0", "h1", "h2"],
        ["h2", "h1", "h0"])


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_pruned_phrase_flat_with_rescue(flat_corpus, monkeypatch, columns):
    """Flat block bounds: the C = 4 scan misses; the rescue retries at
    min(PRUNED_PHRASE_RETRY_C, NB - 1) = 12 blocks and KV 12 * 128 - 1."""
    jp, oracle = flat_corpus
    te, je = pruned_pair(jp, columns)
    calls = spy(monkeypatch, columns)
    qs = [SearchQuery(t, n_results=k, is_phrase=True)
          for t in MEGA for k in (1, 10, 37)]
    three_way(te, je, oracle, qs)
    st = te.stats_take()
    assert st["route_phrase_pruned"] == len(qs) and "route_phrase_full" not in st
    assert st["flag_prune_miss"] > 0 and st["prune_rescued"] > 0
    NB = te._n_pad_docs // 128
    assert {(a[2], a[3]) for a in calls} == {(4, 511), (NB - 1, (NB - 1) * 128 - 1)}


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_pruned_phrase_skewed_proves_on_device(skewed_corpus, monkeypatch,
                                               columns):
    jp, oracle = skewed_corpus
    te, je = pruned_pair(jp, columns)
    calls = spy(monkeypatch, columns)
    host = []
    orig = te._host_exact
    monkeypatch.setattr(te, "_host_exact", lambda rows, k, p=False: (
        host.append(p), orig(rows, k, p))[1])
    three_way(te, je, oracle,
              [SearchQuery(["h0", "h1"], n_results=10, is_phrase=True)])
    assert calls and not host
    assert te.stats_take().get("flag_prune_miss", 0) == 0


@pytest.mark.parametrize("columns", ["raw", "tc"])
def test_pruned_phrase_zero_matches_and_mixed_batch(skewed_corpus,
                                                    flat_corpus, columns):
    """h1 h0 never occurs adjacently in the skewed corpus: no matches, the
    guard flags, the rescue and the host confirm empty; and pruned
    phrases beside AND and tail queries in one batch on the flat one."""
    jp, oracle = skewed_corpus
    te, je = pruned_pair(jp, columns)
    got = three_way(te, je, oracle,
                    [SearchQuery(["h1", "h0"], n_results=10, is_phrase=True)])
    assert got == [[]]
    jp, oracle = flat_corpus
    te, je = pruned_pair(jp, columns, PRUNED_PHRASE_RETRY_C=6)
    qs = [SearchQuery(["h0", "h1"], n_results=10, is_phrase=True),
          SearchQuery(["h1", "h2"], n_results=3, is_phrase=True),
          SearchQuery(["h0", "h2"], n_results=10),
          SearchQuery(["h0", "r7"], n_results=10),
          SearchQuery(["r7", "h0"], n_results=10, is_phrase=True)]
    three_way(te, je, oracle, qs + qs[:2])
    st = te.stats_take()
    assert st["route_phrase_pruned"] == 2 and st["q_coalesced"] == 2


def test_full_phrase_scan_stays_the_default():
    assert TorchEngine.FULL_PHRASE_SCAN is True
    assert TorchEngine.PRUNED_PHRASE_RETRY_C == TpuEngine.PRUNED_PHRASE_RETRY_C
