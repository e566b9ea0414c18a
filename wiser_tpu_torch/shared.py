"""The host modules the port shares with wiser_tpu, in one place.

None of them imports jax: the index format and builders, the value types,
BM25 scoring, the exact re-rank (engine/topk), the corpus generator and
the native codec library. The PackedIndex is the state both packages
serve. Importing through this module keeps the port's borrowed surface
listed in one file; anything jax-bound in wiser_tpu is re-implemented in
this package instead.
"""

from wiser_tpu.data.scale_corpus import generate_linedoc
from wiser_tpu.engine.topk import rescore_sorted_arrays, truncation_suspects
from wiser_tpu.index.fast_builder import build_packed_fast
from wiser_tpu.index.format import BLOCK, SENTINEL_DOC, PackedIndex
from wiser_tpu.native import lib as native
from wiser_tpu.scoring import K1, Bm25Similarity
from wiser_tpu.types import SearchQuery, SearchResult

__all__ = [
    "BLOCK", "SENTINEL_DOC", "K1", "Bm25Similarity", "PackedIndex",
    "SearchQuery", "SearchResult", "build_packed_fast", "generate_linedoc",
    "native", "rescore_sorted_arrays", "truncation_suspects",
]
