"""The end-to-end raw-data pipeline (the port's copy of
wiser_tpu/tools/wiki_pipeline.py): wiki abstract XML -> analyzer ->
linedoc -> fast builder -> integrity check -> engine QPS + parity.

The reference prepares its corpus with scripts/generate_linedoc.py (wiki
abstract XML in) and scripts/tokenize_wiki_linedoc.py (an ES analyzer);
this drives the same pipeline through data/corpus.py. With no network,
the dump is synthesized in the enwiki abstract schema
(<feed><doc><title/><abstract/></doc></feed>) from raw prose the
analyzer must work on: mixed case, punctuation, digits, possessives.
Nothing here bypasses tokenization. The XML is byte-identical to the JAX
package's for the same seed.

Run: python -m wiser_tpu_torch.tools.wiki_pipeline --n-docs 100000 \
       --workdir .scale_cache/wikipipe [--no-engine] [--device cpu] \
       [--out pipeline.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_PUNCT = [". ", ", ", "; ", " - ", ": "]


def synth_wiki_xml(path: str, n_docs: int, vocab_size: int = 120_000,
                   mean_len: int = 60, seed: int = 9) -> int:
    """Write an enwiki-abstract-shaped XML dump of pseudo-English prose.

    Sentence case, acronyms, possessives, years and punctuation are mixed
    in, so the analyzer (corpus.tokenize) does real work: the linedoc
    tokens come out lowercased and punctuation-stripped, with char
    offsets into the raw abstract."""
    from xml.sax.saxutils import escape

    from wiser_tpu_torch.data.scale_corpus import pseudo_vocab

    rng = np.random.default_rng(seed)
    vocab = pseudo_vocab(vocab_size, seed=seed + 1)
    t0 = time.perf_counter()
    with open(path, "w", encoding="utf-8") as f:
        f.write('<feed>\n')
        written = 0
        chunk = 20_000
        while written < n_docs:
            nd = min(chunk, n_docs - written)
            lens = np.maximum(3, rng.poisson(mean_len, size=nd))
            total = int(lens.sum())
            ids = np.minimum(rng.zipf(1.25, size=total) - 1,
                             vocab_size - 1)
            styles = rng.random(total)
            bounds = np.zeros(nd + 1, dtype=np.int64)
            np.cumsum(lens, out=bounds[1:])
            parts = []
            for d in range(nd):
                words = []
                for k, i in enumerate(ids[bounds[d]:bounds[d + 1]].tolist()):
                    w = vocab[i]
                    s = styles[bounds[d] + k]
                    if s < 0.05:
                        w = w.capitalize()       # sentence / proper case
                    elif s < 0.07:
                        w = w.upper()            # acronym
                    elif s < 0.09:
                        w = w + "'s"             # possessive clitic
                    elif s < 0.11:
                        w = str(1900 + (i % 126))  # a year
                    sep = (" " if s >= 0.2
                           else _PUNCT[int(s * 1e4) % len(_PUNCT)])
                    words.append(w + sep)
                title = vocab[int(ids[bounds[d]])].capitalize()
                abstract = "".join(words).rstrip() + "."
                parts.append(
                    f"<doc>\n<title>Wikipedia: {escape(title)}</title>\n"
                    f"<abstract>{escape(abstract)}</abstract>\n</doc>\n")
            f.write("".join(parts))
            written += nd
            log(f"  xml: {written}/{n_docs} docs "
                f"({time.perf_counter() - t0:.0f}s)")
        f.write('</feed>\n')
    return n_docs


def run_pipeline(workdir: str, n_docs: int, with_engine: bool = True,
                 n_queries: int = 4096, parity_n: int = 200,
                 device="cuda") -> dict:
    """Synthesize the XML, analyze it into a WITH_BI_BLOOM linedoc, build
    and save the index (workdir/idx, BloomConfig(5, 0.0009)), check it
    against the linedoc and, with_engine, serve n_queries 1-3-term
    df-Zipf queries through TorchEngine on `device` with parity_n of
    them re-searched exactly on the host. Returns the record (the keys
    of the JAX pipeline's PIPELINE_WIKI.json)."""
    from wiser_tpu_torch.data.corpus import wiki_xml_to_linedoc
    from wiser_tpu_torch.index.bloom import BloomConfig
    from wiser_tpu_torch.index.fast_builder import build_packed_fast
    from wiser_tpu_torch.runtime import resolve_device
    from wiser_tpu_torch.tools.check_posting_list import check

    if with_engine:
        resolve_device(device)  # before the build, not after it
    os.makedirs(workdir, exist_ok=True)
    xml_path = os.path.join(workdir, "abstracts.xml")
    linedoc = os.path.join(workdir, "wiki.linedoc")
    index_dir = os.path.join(workdir, "idx")
    rec = {"n_docs_requested": n_docs}

    t0 = time.perf_counter()
    synth_wiki_xml(xml_path, n_docs)
    rec["xml_synth_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n = wiki_xml_to_linedoc(xml_path, linedoc, with_blooms=True)
    rec["n_docs"] = n
    rec["xml_to_linedoc_s"] = time.perf_counter() - t0
    log(f"linedoc: {n} docs in {rec['xml_to_linedoc_s']:.1f}s")

    t0 = time.perf_counter()
    packed = build_packed_fast(linedoc, "WITH_BI_BLOOM", with_blooms=True,
                               bloom_cfg=BloomConfig(5, 0.0009),
                               verbose=True)
    packed.save(index_dir)
    rec["index_s"] = time.perf_counter() - t0
    rec["n_terms"] = int(packed.n_terms)
    rec["n_postings"] = int(packed.df.sum())

    t0 = time.perf_counter()
    rec["check_posting_list_errors"] = int(
        check(index_dir, linedoc, "WITH_BI_BLOOM"))
    rec["check_s"] = time.perf_counter() - t0

    if with_engine:
        from wiser_tpu_torch.engine.device import TorchEngine
        from wiser_tpu_torch.engine.host import host_exact_search
        from wiser_tpu_torch.tools.scale_bench import run_config, zipf_rows
        from wiser_tpu_torch.types import SearchQuery

        engine = TorchEngine(packed, device=device)
        rng = np.random.default_rng(3)
        nt = rng.choice([1, 2, 3], size=n_queries, p=[0.45, 0.35, 0.20])
        queries = []
        for t in nt:
            rr = zipf_rows(packed, rng, 1, int(t))[0]
            queries.append(SearchQuery([packed.terms[r] for r in rr],
                                       n_results=10))
        r = run_config(engine, queries, batch=min(4096, n_queries))
        bad = 0
        idx = rng.choice(n_queries, size=min(parity_n, n_queries),
                         replace=False)
        for i in idx:
            q = queries[int(i)]
            rows = [packed.lookup(t) for t in q.terms]
            got = engine.search(q)
            d, s = host_exact_search(packed, engine.cache64, rows,
                                     q.n_results)
            want = list(zip(d.tolist(), s.tolist()))
            have = [(e.doc_id, e.doc_score) for e in got.entries]
            if want != have:
                bad += 1
                log(f"PARITY MISMATCH {q.terms}")
        r["parity_mismatches"] = bad
        r["parity_sample"] = len(idx)
        rec["engine"] = r
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--workdir", default=".scale_cache/wikipipe")
    ap.add_argument("--no-engine", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rec = run_pipeline(args.workdir, args.n_docs,
                       with_engine=not args.no_engine, device=args.device)
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
