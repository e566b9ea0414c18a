"""The port's doc-built index against the JAX package's: synth_docinfos
and build_index (array for array, with and without bloom rows), the
linedoc writer and reader (byte for byte), the OracleEngine (the same
(doc, f64 score, snippet) lists on AND and phrase queries) and the oracle
dump (each package loads the other's)."""

import dataclasses

import numpy as np
import pytest
from test_torch_runtime import assert_same_index

from wiser_tpu.data import synth as j_synth
from wiser_tpu.index import builder as j_builder
from wiser_tpu.index import oracle_dump as j_dump
from wiser_tpu import linedoc as j_linedoc
from wiser_tpu.types import SearchQuery as JQuery
from wiser_tpu_torch import linedoc
from wiser_tpu_torch.data import synth
from wiser_tpu_torch.index import builder, oracle_dump
from wiser_tpu_torch.types import SearchQuery


def entries(result):
    return [(e.doc_id, e.doc_score, e.snippet) for e in result.entries]


@pytest.fixture(scope="module")
def both():
    """The same 300 documents built by each package, bloom rows included."""
    mine = synth.synth_docinfos(300, 80, 25, seed=4)
    ref = j_synth.synth_docinfos(300, 80, 25, seed=4)
    return (builder.build_index(mine, with_blooms=True),
            j_builder.build_index(ref, with_blooms=True))


@pytest.mark.parametrize("blooms", [False, True])
def test_synth_docs_equal_the_jax_package(blooms):
    kw = dict(zipf_a=1.25, seed=42, with_blooms=blooms)
    mine = synth.synth_docinfos(120, 500, 40, **kw)
    ref = j_synth.synth_docinfos(120, 500, 40, **kw)
    assert [dataclasses.asdict(d) for d in mine] == \
        [dataclasses.asdict(d) for d in ref]
    assert synth.synth_query_terms(30, 80, n_terms=3, seed=2) == \
        j_synth.synth_query_terms(30, 80, n_terms=3, seed=2)


@pytest.mark.parametrize("blooms", [False, True])
def test_build_index_equals_the_jax_package(both, blooms):
    if blooms:
        (mine, _), (ref, _) = both
    else:
        kw = dict(zipf_a=1.25, seed=42, with_blooms=False)
        mine, _ = builder.build_index(synth.synth_docinfos(200, 300, 30, **kw))
        ref, _ = j_builder.build_index(j_synth.synth_docinfos(200, 300, 30,
                                                              **kw))
    assert_same_index(mine, ref)
    assert (mine.bloom_ends is not None) == blooms
    if blooms:
        assert mine.bloom_ends.any() and mine.bloom_begins.any()


def test_linedoc_round_trip_equals_the_jax_package(tmp_path, toy_linedoc_rows):
    docs = synth.synth_docinfos(40, 30, 12, seed=6)
    rows = [[f"doc_{i}", d.body, d.tokens, d.token_offsets, d.token_positions,
             d.phrase_ends, d.phrase_begins] for i, d in enumerate(docs)]
    rows += toy_linedoc_rows
    mine, ref = tmp_path / "port.linedoc", tmp_path / "jax.linedoc"
    linedoc.write_linedoc(str(mine), rows, with_bloom=True)
    j_linedoc.write_linedoc(str(ref), rows, with_bloom=True)
    assert mine.read_bytes() == ref.read_bytes()
    for fmt in linedoc.FORMATS:
        got = [dataclasses.asdict(d)
               for d in linedoc.parse_linedoc(str(mine), fmt, n_rows=30)]
        want = [dataclasses.asdict(d)
                for d in j_linedoc.parse_linedoc(str(ref), fmt, n_rows=30)]
        assert got == want and len(got) == 30
    with pytest.raises(ValueError):
        list(linedoc.parse_linedoc(str(mine), "NOPE"))
    p2, o2 = builder.build_index_from_linedoc(str(mine), "WITH_BI_BLOOM",
                                              with_blooms=True)
    jp2, _ = j_builder.build_index_from_linedoc(str(ref), "WITH_BI_BLOOM",
                                                with_blooms=True)
    assert_same_index(p2, jp2)
    assert o2.n_docs == len(rows)


def _queries(packed, n, seed):
    """AND queries of 1-3 of the 30 most frequent terms, k 1..20, snippets
    on every other one."""
    rng = np.random.default_rng(seed)
    by_df = np.argsort(-packed.df, kind="stable")
    out = []
    for i in range(n):
        nt = int(rng.integers(1, 4))
        rows = by_df[rng.integers(0, 30, size=nt)]
        out.append(([packed.terms[r] for r in rows], int(rng.integers(1, 21)),
                    False, i % 2 == 0))
    return out


def test_oracle_equals_the_jax_oracle(both):
    (packed, oracle), (_, j_or) = both
    qs = _queries(packed, 60, seed=3)
    bodies = oracle.doc_bodies
    for d in range(0, 40, 2):
        words = bodies[d].split(" ")
        qs.append((words[3:5], 10, True, d % 4 == 0))
        qs.append((words[5:8], 5, True, True))
    n_phr = n_hit = 0
    for terms, k, phrase, snip in qs:
        kw = dict(n_results=k, is_phrase=phrase, return_snippets=snip,
                  n_snippet_passages=2)
        got = entries(oracle.search(SearchQuery(list(terms), **kw)))
        assert got == entries(j_or.search(JQuery(list(terms), **kw))), terms
        n_phr += phrase and bool(got)
        n_hit += bool(got) and snip and all("<b>" in e[2] for e in got)
    assert n_phr >= 30 and n_hit >= 30
    assert (oracle.n_docs, oracle.avg_length, oracle.term_count()) == \
        (j_or.n_docs, j_or.avg_length, j_or.term_count())
    assert oracle.doc_len_codes == j_or.doc_len_codes
    assert oracle.phrase_ends == j_or.phrase_ends


def test_oracle_dump_loads_in_the_other_package(both, tmp_path):
    (packed, oracle), (_, j_or) = both
    oracle_dump.serialize(oracle, str(tmp_path / "port"))
    j_dump.serialize(j_or, str(tmp_path / "jax"))
    for name in ("engine_meta.json", "doc_lengths.dump",
                 "inverted_index.dump", "term_index.json", "phrase_sets.json",
                 "doc_store/docs.fdt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    from_jax = oracle_dump.deserialize(str(tmp_path / "jax"))
    from_port = j_dump.deserialize(str(tmp_path / "port"))
    assert_same_index(builder.pack_oracle(from_jax, with_blooms=True), packed)
    for terms, k, phrase, snip in _queries(packed, 20, seed=5):
        kw = dict(n_results=k, is_phrase=phrase, return_snippets=snip)
        want = entries(oracle.search(SearchQuery(list(terms), **kw)))
        assert entries(from_jax.search(SearchQuery(list(terms), **kw))) == want
        assert entries(from_port.search(JQuery(list(terms), **kw))) == want
    assert from_jax.doc_bodies == oracle.doc_bodies
