"""OracleEngine serialization (the port's copy of wiser_tpu/index/
oracle_dump.py; the reference's QqMemEngineDelta::Serialize /
Deserialize, qq_mem_engine.h:410-434). The directory is the JAX
package's, so each package loads the other's dumps.

Files: engine_meta.json, a chunked doc store (doc_store/), the 1-byte
length codes (doc_lengths.dump), the inverted index as one varint stream
of per-term records (inverted_index.dump: the posting count, then per
posting the doc-id delta, tf, the offset pairs as deltas and the
positions as deltas, posting.h:130-151) with each term's (byte offset,
value count) in term_index.json, and the phrase end / begin sets
(phrase_sets.json). This is stage 1's dump; index/builder.pack_oracle is
stage 2.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from wiser_tpu_torch.index.doc_store import ChunkedDocStoreReader, ChunkedDocStoreWriter
from wiser_tpu_torch.native import lib as native
from wiser_tpu_torch.oracle import OracleEngine, Posting


def serialize(eng: OracleEngine, dirpath: str) -> None:
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "engine_meta.json"), "w") as f:
        json.dump({"n_docs": eng.n_docs, "avg_length": eng.avg_length,
                   "n_terms": eng.term_count()}, f)

    w = ChunkedDocStoreWriter(os.path.join(dirpath, "doc_store"))
    for body in eng.doc_bodies:
        w.add(body)
    w.close()

    # DocLengthCharStore::Serialize (doc_length_store.h:141-163)
    np.array(eng.doc_len_codes, dtype=np.uint8).tofile(
        os.path.join(dirpath, "doc_lengths.dump"))

    terms = sorted(eng.index.keys())
    stream = bytearray()
    offsets = []
    for t in terms:
        postings = eng.index[t]
        vals: List[int] = [len(postings)]
        prev_doc = 0
        for p in postings:
            vals += [p.doc_id - prev_doc, p.term_freq, len(p.offsets)]
            prev_doc = p.doc_id
            prev = 0
            for a, b in p.offsets:
                vals += [a - prev, b - a]
                prev = b
            vals.append(len(p.positions))
            prev = 0
            for pos in p.positions:
                vals.append(pos - prev)
                prev = pos
        offsets.append((len(stream), len(vals)))
        stream.extend(native.varint_encode_array(np.array(vals, dtype=np.uint32)))
    with open(os.path.join(dirpath, "inverted_index.dump"), "wb") as f:
        f.write(bytes(stream))
    with open(os.path.join(dirpath, "term_index.json"), "w") as f:
        json.dump({"terms": terms, "offsets": offsets}, f)

    with open(os.path.join(dirpath, "phrase_sets.json"), "w") as f:
        json.dump({
            "ends": [[t, d, sorted(s)] for (t, d), s in eng.phrase_ends.items()],
            "begins": [[t, d, sorted(s)]
                       for (t, d), s in eng.phrase_begins.items()],
        }, f)


def deserialize(dirpath: str) -> OracleEngine:
    with open(os.path.join(dirpath, "engine_meta.json")) as f:
        meta = json.load(f)
    eng = OracleEngine()

    r = ChunkedDocStoreReader(os.path.join(dirpath, "doc_store"))
    eng.doc_bodies = [r.get(i) for i in range(r.n_docs)]
    r.close()
    codes = np.fromfile(os.path.join(dirpath, "doc_lengths.dump"),
                        dtype=np.uint8)
    eng.doc_len_codes = [int(c) for c in codes]

    with open(os.path.join(dirpath, "term_index.json")) as f:
        tindex = json.load(f)
    with open(os.path.join(dirpath, "inverted_index.dump"), "rb") as f:
        stream = f.read()
    for t, (off, n_vals) in zip(tindex["terms"], tindex["offsets"]):
        vals = native.varint_decode_array(stream[off:], n_vals).tolist()
        i = 1
        postings = []
        doc = 0
        for _ in range(vals[0]):
            doc += vals[i]
            tf, n_off = vals[i + 1], vals[i + 2]
            i += 3
            offs, prev = [], 0
            for _ in range(n_off):
                a = prev + vals[i]
                b = a + vals[i + 1]
                i += 2
                offs.append((a, b))
                prev = b
            n_pos = vals[i]
            i += 1
            poss, prev = [], 0
            for _ in range(n_pos):
                prev += vals[i]
                i += 1
                poss.append(prev)
            postings.append(Posting(doc, tf, offs, poss))
        eng.index[t] = postings

    with open(os.path.join(dirpath, "phrase_sets.json")) as f:
        phr = json.load(f)
    eng.phrase_ends = {(t, d): set(s) for t, d, s in phr["ends"]}
    eng.phrase_begins = {(t, d): set(s) for t, d, s in phr["begins"]}

    # the running average as dumped (insertion order is not replayed)
    eng._avg.avg = np.float64(meta["avg_length"])
    eng._avg.n = meta["n_docs"]
    eng.similarity.reset(meta["avg_length"])
    return eng
