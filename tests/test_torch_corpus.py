"""The raw-text pipeline of the port against wiser_tpu's: the analyzer
(data/corpus.tokenize, doc_to_linedoc_cols), the wiki abstract XML reader
and writer, tools/wiki_pipeline end to end on the CPU, and the README's
quick start on TorchEngine against the OracleEngine.

Tolerance: none. Tokens, linedoc rows and files, the synthesized XML, the
fast-built index arrays and every (doc, f64 score) answer are exact."""

import os

import numpy as np
import pytest
import torch

from wiser_tpu.data import corpus as j_corpus
from wiser_tpu.index.format import PackedIndex as JPackedIndex
from wiser_tpu.tools import wiki_pipeline as j_pipe
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.data import corpus
from wiser_tpu_torch.index.builder import build_index_from_linedoc
from wiser_tpu_torch.index.format import COLUMNS, PackedIndex
from wiser_tpu_torch.tools import wiki_pipeline
from wiser_tpu_torch.types import SearchQuery


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under `pytest -n 6`
    every worker's OpenMP pool spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEXTS = [
    "Hello, World! It's great.",
    "naïve café 北京 123abc Ünïcödé ÅNGSTRÖM straße",
    "don't rock'n'roll 'quoted' foo''bar x_y __init__ o'",
    "tab\there\nnew line\r\nend 1,000.50 2024-01-02 v2.0",
    "the cat and the hat and the CAT. The end; the END",
    "",
    "   ...   !!! ",
]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenize_equals_jax(text):
    assert corpus.tokenize(text) == j_corpus.tokenize(text)


@pytest.mark.parametrize("with_blooms", [True, False])
@pytest.mark.parametrize("text", TEXTS)
def test_linedoc_cols_equal_jax(text, with_blooms):
    title = "A\ttitle\nwith breaks"
    got = corpus.doc_to_linedoc_cols(title, text, with_blooms)
    assert got == j_corpus.doc_to_linedoc_cols(title, text, with_blooms)
    assert all("\t" not in c and "\n" not in c for c in got)


def test_repeated_token_groups():
    row = corpus.doc_to_linedoc_cols("T", "b a b c b a", with_blooms=True)
    assert row[2:] == ["b a c", "0,0;4,4;8,8;.2,2;10,10;.6,6;.",
                       "0;2;4;.1;5;.3;.", "a c!b!b!", "a c!b!b!"]


_XML = """<feed>
<doc>
<title>Wikipedia: Alpha &amp; Omega</title>
<abstract>Alpha's first; ALPHA again &amp; the 1999 Omega.</abstract>
</doc>
<doc>
<title>Wikipedia: Empty</title>
<abstract>   </abstract>
</doc>
<doc>
<title>Wikipedia: Missing</title>
</doc>
<doc>
<title>Wikipedia: Café</title>
<abstract>Un café au lait, s'il vous plaît.
Second line.</abstract>
</doc>
</feed>
"""


@pytest.mark.parametrize("n_docs", [None, 2])
def test_wiki_xml_to_linedoc_bytes(tmp_path, n_docs):
    xml = tmp_path / "a.xml"
    xml.write_text(_XML, encoding="utf-8")
    mine, ref = str(tmp_path / "p.linedoc"), str(tmp_path / "j.linedoc")
    n = corpus.wiki_xml_to_linedoc(str(xml), mine, n_docs=n_docs)
    assert n == j_corpus.wiki_xml_to_linedoc(str(xml), ref, n_docs=n_docs)
    assert n == (2 if n_docs is None else 1)  # empty abstracts skipped
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert (list(corpus.parse_wiki_abstract_xml(str(xml)))
            == list(j_corpus.parse_wiki_abstract_xml(str(xml))))


def test_synth_wiki_xml_bytes(tmp_path):
    mine, ref = str(tmp_path / "p.xml"), str(tmp_path / "j.xml")
    assert wiki_pipeline.synth_wiki_xml(mine, 300, vocab_size=2000) == 300
    j_pipe.synth_wiki_xml(ref, 300, vocab_size=2000)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The port's pipeline at 300 docs with its engine half on the CPU,
    and the JAX pipeline's analyzer, build and check (its engine half is
    not run: it would only compile XLA programs)."""
    d = tmp_path_factory.mktemp("pipe")
    mine, ref = str(d / "port"), str(d / "jax")
    rec = wiki_pipeline.run_pipeline(mine, 300, n_queries=512, parity_n=200,
                                     device="cpu")
    j_rec = j_pipe.run_pipeline(ref, 300, with_engine=False)
    return mine, ref, rec, j_rec


def test_pipeline_record(pipelines):
    _, _, rec, j_rec = pipelines
    for key in ("n_docs_requested", "n_docs", "n_terms", "n_postings",
                "check_posting_list_errors"):
        assert rec[key] == j_rec[key], key
    assert rec["n_docs"] == 300 and rec["check_posting_list_errors"] == 0
    assert set(rec) == set(j_rec) | {"engine"}
    eng = rec["engine"]
    assert eng["n_queries"] == 512 and eng["qps"] > 0
    assert eng["parity_sample"] == 200 and eng["parity_mismatches"] == 0


def test_pipeline_files_equal_jax(pipelines):
    mine, ref = pipelines[:2]
    for name in ("abstracts.xml", "wiki.linedoc"):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_pipeline_index_equals_jax_fast_builder(pipelines):
    mine, ref = pipelines[:2]
    p = PackedIndex.load(os.path.join(mine, "idx"))
    j = JPackedIndex.load(os.path.join(ref, "idx"))
    assert p.terms == j.terms and p.n_docs == j.n_docs
    assert p.avg_len == j.avg_len and p.bloom_cfg.bits == j.bloom_cfg.bits
    for name in COLUMNS + ("bloom_ends", "bloom_begins"):
        a, b = getattr(p, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_readme_quick_start(tmp_path):
    path = str(tmp_path / "corpus.linedoc")
    docs = [("Doc one", "the quick brown fox"), ("Doc two", "the lazy dog"),
            ("Doc three", "Quick, quick: the brown fox's den!")]
    assert corpus.text_corpus_to_linedoc(docs, path) == 3
    ref = str(tmp_path / "j.linedoc")
    j_corpus.text_corpus_to_linedoc(docs, ref)
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    packed, oracle = build_index_from_linedoc(path, "WITH_BI_BLOOM",
                                              with_blooms=True)
    engine = TorchEngine(packed, device="cpu", doc_bodies=oracle.doc_bodies)
    queries = [SearchQuery(["quick", "fox"], n_results=10),
               SearchQuery(["quick", "brown"], is_phrase=True),
               SearchQuery(["brown", "quick"], is_phrase=True),
               SearchQuery(["fox"]), SearchQuery(["dog"]),
               SearchQuery(["the", "fox"], n_results=10, return_snippets=True)]
    got = engine.search_batch(queries)
    hits = 0
    for q, r in zip(queries, got):
        want = oracle.search(q)
        assert ([(e.doc_id, e.doc_score, e.snippet) for e in r.entries]
                == [(e.doc_id, e.doc_score, e.snippet) for e in want.entries])
        hits += len(r.entries)
    assert hits > 0
    assert engine.search(queries[1]).entries  # a phrase match exists
