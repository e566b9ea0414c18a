"""Compare the machine code of kernel libraries built from two trees, and
read each kernel's registers and spills from ptxas.

    python -m wiser_tpu_torch.tools.sass_compare --old OLD_TREE \
        [--new .] [--libs search,dense] [--spills semidense,phrase_route] \
        [--kernels REGEX,...] [--out report.json]

Each library `csrc/<name>.cu` is built from both trees with this tree's
flags (wiser_tpu_torch/build.py: NVCC_FLAGS and the library's
EXTRA_NVCC_FLAGS) into a temporary directory, and `cuobjdump -sass` of
the two is compared line for line (identical or not, with the line
counts and the first differing line); with `--kernels`, only the
functions whose (mangled) names match one of the regular expressions,
each compared alone (`cuobjdump`'s "Function :" sections), so a kernel
whose source did not change can be held equal while others in its
library changed. `--spills` builds those libraries
of the new tree and reports ptxas's lines per kernel: registers, shared
bytes, spill stores and loads (every spill count must read 0 bytes).
Needs nvcc and cuobjdump: run it on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found")
    return os.path.join(CUDA_HOME, "bin", name)


def build(tree: str, name: str, out_dir: str) -> tuple:
    """(library path, compiler output) of tree's csrc/<name>.cu."""
    from wiser_tpu_torch import build as B

    flags = B.NVCC_FLAGS + B.EXTRA_NVCC_FLAGS.get(name, ())
    src = os.path.join(os.path.abspath(tree), "wiser_tpu_torch", "csrc",
                       f"{name}.cu")
    out = os.path.join(out_dir, f"lib{name}_{abs(hash(tree))}.so")
    proc = subprocess.run([_tool("nvcc"), *flags, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"build failed on {src}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def sass(lib: str) -> list:
    """cuobjdump -sass of lib, without the lines that name the file."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    # whitespace collapsed: the column padding follows the file's widest
    # line, not the instruction
    return [" ".join(ln.split()) for ln in text.splitlines()
            if lib not in ln and not ln.startswith("Fatbin")]


def functions(lines: list) -> dict:
    """A library's SASS lines by function (each "Function : name"
    section, its header line included)."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
        if name is not None:
            out[name].append(ln)
    return out


def _diff(a: list, b: list) -> dict:
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
    return {"identical": a == b, "lines_old": len(a), "lines_new": len(b),
            "first_diff": first,
            "old_line": a[first] if first is not None
            and first < len(a) else None,
            "new_line": b[first] if first is not None
            and first < len(b) else None}


def compare(old: str, new: str, names, kernels=()) -> dict:
    """Each library's SASS, old against new: whole, or with `kernels`
    (regular expressions) each matching function alone."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            a = sass(build(old, name, tmp)[0])
            b = sass(build(new, name, tmp)[0])
            if not kernels:
                out[name] = _diff(a, b)
                continue
            fa, fb = functions(a), functions(b)
            for fn in sorted(set(fa) | set(fb)):
                if any(re.search(k, fn) for k in kernels):
                    out[f"{name}:{fn}"] = _diff(fa.get(fn, []),
                                                fb.get(fn, []))
    return out


_FN = re.compile(r"Compiling entry function '([^']+)'")
_RES = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def spills(tree: str, names) -> dict:
    """Per library, per kernel: registers and spill bytes from ptxas -v."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            log = build(tree, name, tmp)[1]
            rows, fn = {}, None
            for ln in log.splitlines():
                m = _FN.search(ln)
                if m:
                    fn = m.group(1)
                    rows[fn] = {}
                    continue
                if fn is None:
                    continue
                m = _SPILL.search(ln)
                if m:
                    rows[fn]["spill_stores"] = int(m.group(1))
                    rows[fn]["spill_loads"] = int(m.group(2))
                m = _RES.search(ln)
                if m:
                    rows[fn]["registers"] = int(m.group(1))
            out[name] = {"kernels": rows, "spill_bytes": sum(
                r.get("spill_stores", 0) + r.get("spill_loads", 0)
                for r in rows.values())}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="the tree to compare against")
    ap.add_argument("--new", default=".")
    ap.add_argument("--libs", default="search,dense")
    ap.add_argument("--spills", default="")
    ap.add_argument("--kernels", default="",
                    help="comma-separated regular expressions of the "
                    "functions to compare alone")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.new))
    res = {}
    if args.old:
        res["sass"] = compare(args.old, args.new,
                              [n for n in args.libs.split(",") if n],
                              [k for k in args.kernels.split(",") if k])
    if args.spills:
        res["ptxas"] = spills(args.new,
                              [n for n in args.spills.split(",") if n])
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
