"""Corpus preparation from raw text (the port's copy of
wiser_tpu/data/corpus.py; the reference's scripts/generate_linedoc.py and
tokenize_wiki_linedoc.py).

The reference tokenizes through an Elasticsearch analyzer over REST
(scripts/tokenize_wiki_linedoc.py:10-26). This module is a self-contained
approximation of ES's `standard` analyzer (Unicode word runs, inner
apostrophes, lowercase) that writes the full linedoc columns: the unique
tokens, offsets, positions and the bi-bloom phrase-ends / begins columns
the reference precomputes for its bloom store (bloom_filter.h:277-322).
Its output is byte-identical to the JAX package's for the same input.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Iterable, Iterator, List, Optional, Tuple

from wiser_tpu_torch.linedoc import write_linedoc

# maximal runs of Unicode letters / digits, joined by inner apostrophes
_TOKEN_RE = re.compile(r"[^\W_]+(?:'[^\W_]+)*", re.UNICODE)


def tokenize(text: str) -> List[Tuple[str, int, int]]:
    """[(term lowercased, start offset, end offset inclusive)] in order."""
    return [(m.group(0).lower(), m.start(), m.end() - 1)
            for m in _TOKEN_RE.finditer(text)]


def doc_to_linedoc_cols(title: str, body: str, with_blooms: bool = True) -> List[str]:
    """One linedoc row: doctitle, body, tokenized, offsets, positions[,
    bloom (following words), bloom_before (preceding words)]. The
    tokenized column holds each term once, in order of first appearance;
    the offsets / positions columns hold one group per unique term
    (engine_loader.h's format). Tabs and newlines fold to spaces."""
    body = body.replace("\t", " ").replace("\n", " ")
    title = title.replace("\t", " ").replace("\n", " ")
    toks = tokenize(body)
    offsets: dict = {}
    positions: dict = {}
    ends: dict = {}
    begins: dict = {}
    for i, (term, s, e) in enumerate(toks):
        if term not in offsets:  # dicts keep first-appearance order
            offsets[term], positions[term] = [], []
            ends[term], begins[term] = set(), set()
        offsets[term].append((s, e))
        positions[term].append(i)
        if i + 1 < len(toks):
            ends[term].add(toks[i + 1][0])
        if i > 0:
            begins[term].add(toks[i - 1][0])

    uniq = list(offsets)
    row = [title, body, " ".join(uniq),
           "".join(";".join(f"{a},{b}" for a, b in offsets[t]) + ";."
                   for t in uniq),
           "".join(";".join(str(p) for p in positions[t]) + ";."
                   for t in uniq)]
    if with_blooms:
        row.append("".join(" ".join(sorted(ends[t])) + "!" for t in uniq))
        row.append("".join(" ".join(sorted(begins[t])) + "!" for t in uniq))
    return row


def parse_wiki_abstract_xml(path: str) -> Iterator[Tuple[str, str]]:
    """(title, abstract) of each <doc> of an enwiki abstract dump
    (<feed><doc><title/><abstract/>...</doc>...</feed>), the input of
    scripts/generate_linedoc.py."""
    for _event, elem in ET.iterparse(path, events=("end",)):
        if elem.tag == "doc":
            yield elem.findtext("title") or "", elem.findtext("abstract") or ""
            elem.clear()


def wiki_xml_to_linedoc(xml_path: str, out_path: str,
                        n_docs: Optional[int] = None,
                        with_blooms: bool = True) -> int:
    """Wiki abstract XML -> tokenized linedoc in one pass (the
    generate_linedoc.py + tokenize_wiki_linedoc.py pipeline); docs with
    an empty abstract are skipped. Returns the rows written."""
    rows = []
    for i, (title, abstract) in enumerate(parse_wiki_abstract_xml(xml_path)):
        if n_docs is not None and i >= n_docs:
            break
        if abstract.strip():
            rows.append(doc_to_linedoc_cols(title, abstract, with_blooms))
    write_linedoc(out_path, rows, with_bloom=with_blooms)
    return len(rows)


def text_corpus_to_linedoc(docs: Iterable[Tuple[str, str]], out_path: str,
                           with_blooms: bool = True) -> int:
    """(title, body) pairs -> linedoc; returns the rows written."""
    rows = [doc_to_linedoc_cols(t, b, with_blooms) for t, b in docs]
    write_linedoc(out_path, rows, with_bloom=with_blooms)
    return len(rows)
