"""Carry an index across from the JAX package.

The PackedIndex is the state both packages serve (what weights are to a
model). `packed_from_arrays` takes the fields of a wiser_tpu PackedIndex
as plain values, for example
`{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}`, and
returns the port's PackedIndex. A directory written by either package's
`PackedIndex.save` loads with `wiser_tpu_torch.index.format.PackedIndex
.load` unchanged.
"""

from __future__ import annotations

import numpy as np

from wiser_tpu_torch.index.bloom import BloomConfig
from wiser_tpu_torch.index.format import COLUMNS, PackedIndex


def packed_from_arrays(fields: dict) -> PackedIndex:
    """fields: the stored fields of a PackedIndex by name — `terms`,
    `n_docs`, `avg_len`, the column arrays of `columns.npz`, optional
    `bloom_ends` / `bloom_begins` arrays and `bloom_cfg` (any object or
    dict with expected_entries and error_ratio). The derived fields
    (term_to_row, idf64, max_tf) are rebuilt, not copied."""
    cfg = fields.get("bloom_cfg")
    if cfg is None:
        cfg = BloomConfig()
    elif isinstance(cfg, dict):
        cfg = BloomConfig(cfg["expected_entries"], cfg["error_ratio"])
    else:
        cfg = BloomConfig(cfg.expected_entries, cfg.error_ratio)
    blooms = {k: None if fields.get(k) is None else np.asarray(fields[k])
              for k in ("bloom_ends", "bloom_begins")}
    return PackedIndex(
        terms=[str(t) for t in fields["terms"]],
        n_docs=int(fields["n_docs"]),
        avg_len=float(fields["avg_len"]),
        bloom_cfg=cfg,
        **blooms,
        **{name: np.asarray(fields[name]) for name in COLUMNS},
    )
