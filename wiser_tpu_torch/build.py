"""Build the package's native sources into shared libraries at first use.

Each CUDA library is one `nvcc` call over one `csrc/*.cu` file with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds), with NVCC_FLAGS and the library's own EXTRA_NVCC_FLAGS;
the host codec library (native/wiser_native.cpp) is one `g++` call.
Each library has its own lock, so it is built once however many threads
ask for it, and different libraries build at the same time
(`load_libraries` starts one nvcc each). Output goes to `.kernel_build/`
at the repository root (listed in .gitignore) under a name that hashes
the source, every header of its directory (`*.cuh`, which the sources
include) and the flags, so a changed source or header is never served by
a stale library.

The CUDA build needs `nvcc` (found through PyTorch's CUDA_HOME); there
is no fallback, since a CUDA tensor must run its kernel or fail.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".kernel_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# search.cu's, dense.cu's, semidense.cu's and phrase_route.cu's f32 scores
# and bounds must equal the plain versions' bit for bit: no multiply-add
# contracted into an FMA (phrase.cu's verification is integer work)
EXTRA_NVCC_FLAGS = {"search": ("-fmad=false",), "dense": ("-fmad=false",),
                    "semidense": ("-fmad=false",),
                    "phrase_route": ("-fmad=false",)}
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # a library's build and load
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, compiler output); 0 s when cached
build_log: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found: cannot build the kernels")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    flags = NVCC_FLAGS + EXTRA_NVCC_FLAGS.get(name, ())
    return _load(name, os.path.join(CSRC, f"{name}.cu"), flags,
                 lambda s, out: [_nvcc(), *flags, "-o", out, s])


def load_libraries(names) -> Dict[str, ctypes.CDLL]:
    """load_library for each name, the builds running at the same time
    (one thread, and so one nvcc, a library). Raises the first build
    error."""
    names = list(names)
    out: Dict[str, ctypes.CDLL] = {}
    errors = []

    def one(name):
        try:
            out[name] = load_library(name)
        except Exception as e:  # re-raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def source_digest(src: str, flags) -> str:
    """The hash a library's file name carries: the source, every `*.cuh`
    header beside it (sorted by name) and the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    d = os.path.dirname(src)
    if src.endswith(".cu"):
        for name in sorted(os.listdir(d)):
            if name.endswith(".cuh"):
                with open(os.path.join(d, name), "rb") as f:
                    h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load_host_library(name: str, src: str) -> ctypes.CDLL:
    """Compile the C++ source `src` with g++ if needed and return the
    loaded library."""
    return _load(name, src, GXX_FLAGS,
                 lambda s, out: ["g++", *GXX_FLAGS, s, "-o", out])


def _load(name: str, src: str, flags, command) -> ctypes.CDLL:
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = os.path.join(BUILD_DIR,
                           f"lib{name}_{source_digest(src, flags)}.so")
        if os.path.exists(out):
            build_log[name] = (0.0, "cached")
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(command(src, tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"build failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = (time.perf_counter() - t0,
                               proc.stdout + proc.stderr)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
