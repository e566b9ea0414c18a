"""Engine factory by URL (the port's copy of wiser_tpu/engine/factory.py;
the reference's engine_factory.h:21-50).

  "oracle:"                     an empty in-memory OracleEngine
  "oracle:<dump_dir>"           an OracleEngine loaded from an oracle dump
  "oracle_linedoc:<path>:<fmt>" an OracleEngine built from a linedoc file
  "torch:<index_dir>"           TorchEngine over a saved PackedIndex, with
                                snippets from <index_dir>/docs when it holds
                                a chunked doc store
  "torch_tc:<index_dir>"        the same on compressed (tc) columns

(The JAX package's "tpu:" / "tpu_tc:" URLs.) The TorchEngine URLs take a
device, "cuda" by default. "sharded:" is not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

import os


def create_search_engine(url: str, device="cuda"):
    scheme, _, rest = url.partition(":")
    if scheme == "oracle":
        from wiser_tpu_torch.oracle import OracleEngine

        if not rest:
            return OracleEngine()
        from wiser_tpu_torch.index.oracle_dump import deserialize

        return deserialize(rest)
    if scheme == "oracle_linedoc":
        from wiser_tpu_torch.linedoc import parse_linedoc
        from wiser_tpu_torch.oracle import OracleEngine

        path, _, fmt = rest.partition(":")
        eng = OracleEngine()
        eng.load_linedocs(parse_linedoc(path, fmt or "WITH_POSITIONS"))
        return eng
    if scheme in ("torch", "torch_tc"):
        from wiser_tpu_torch.engine.device import TorchEngine
        from wiser_tpu_torch.index.format import PackedIndex

        bodies = None
        docs_dir = os.path.join(rest, "docs")
        if os.path.isdir(docs_dir):
            from wiser_tpu_torch.index.doc_store import (ChunkedDocStoreReader,
                                                         LazyDocBodies)

            # bodies decompress on demand through the reader's chunk pool
            bodies = LazyDocBodies(ChunkedDocStoreReader(docs_dir))
        return TorchEngine(PackedIndex.load(rest), device=device,
                           doc_bodies=bodies,
                           columns="tc" if scheme == "torch_tc" else "raw")
    if scheme == "sharded":
        raise NotImplementedError(
            "sharded engines are not ported yet (ROADMAP A.11, the mesh)")
    raise ValueError(f"unknown engine url: {url!r}")
