"""Linedoc (TSV corpus) reader and writer (the port's copy of
wiser_tpu/linedoc.py; the reference's engine_loader.h:10-133).

A linedoc file starts with a header line
``FIELDS_HEADER_INDICATOR###\tdoctitle\tbody\ttokenized\toffsets\tpositions...``
followed by one TSV row per document: 0 doctitle, 1 body, 2 tokenized
(unique terms), 3 offsets, 4 positions, 5 bloom (phrase ends), 6
bloom_before (phrase begins). The format names which columns a row uses:
TOKEN_ONLY (body = tokens = column 2), WITH_OFFSETS (1..3),
WITH_POSITIONS (1..4), WITH_PHRASE_END (1..5), WITH_BI_BLOOM (1..6).
"""

from __future__ import annotations

from typing import Iterator, Optional

from wiser_tpu_torch.types import DocInfo

FORMATS = (
    "TOKEN_ONLY",
    "WITH_OFFSETS",
    "WITH_POSITIONS",
    "WITH_PHRASE_END",
    "WITH_BI_BLOOM",
)


def _parse_row(items: list, fmt: str) -> DocInfo:
    if fmt == "TOKEN_ONLY":
        return DocInfo(body=items[2], tokens=items[2], format=fmt)
    if fmt == "WITH_OFFSETS":
        return DocInfo(body=items[1], tokens=items[2], token_offsets=items[3],
                       format=fmt)
    if fmt == "WITH_POSITIONS":
        return DocInfo(body=items[1], tokens=items[2], token_offsets=items[3],
                       token_positions=items[4], format=fmt)
    if fmt == "WITH_PHRASE_END":
        return DocInfo(body=items[1], tokens=items[2], token_offsets=items[3],
                       token_positions=items[4], phrase_ends=items[5],
                       format=fmt)
    if fmt == "WITH_BI_BLOOM":
        # column 6 holds the begins, column 5 the ends
        return DocInfo(body=items[1], tokens=items[2], token_offsets=items[3],
                       token_positions=items[4], phrase_begins=items[6],
                       phrase_ends=items[5], format=fmt)
    raise ValueError(f"Format {fmt} is not supported")


def parse_linedoc(path: str, fmt: str,
                  n_rows: Optional[int] = None) -> Iterator[DocInfo]:
    """One DocInfo per row after the header. Rows split strictly on tabs,
    so empty columns are kept; empty lines are skipped."""
    if fmt not in FORMATS:
        raise ValueError(f"Format {fmt} is not supported")
    count = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        f.readline()  # header
        for line in f:
            if n_rows is not None and count >= n_rows:
                return
            line = line.rstrip("\n")
            if not line:
                continue
            yield _parse_row(line.split("\t"), fmt)
            count += 1


def write_linedoc(path: str, rows: list, with_bloom: bool = False) -> None:
    """Write a linedoc file; each row is its full TSV column list from
    doctitle on."""
    header_cols = ["doctitle", "body", "tokenized", "offsets", "positions"]
    if with_bloom:
        header_cols += ["bloom", "bloom_before"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("FIELDS_HEADER_INDICATOR###\t" + "\t".join(header_cols) + "\n")
        for row in rows:
            f.write("\t".join(row) + "\n")
