"""Build the package's native sources into shared libraries at first use.

Each CUDA library is one `nvcc` call over one `csrc/*.cu` file with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds), with NVCC_FLAGS and the library's own EXTRA_NVCC_FLAGS;
the host codec library (native/wiser_native.cpp) is one `g++` call.
One lock guards every build, so a library is built once however many
threads ask for it. Output goes to `.kernel_build/` at the repository
root (listed in .gitignore) under a name that hashes the source and the
flags, so a changed source is never served by a stale library.

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
# search.cu's f32 scores must equal the plain version's bit for bit: no
# multiply-add contracted into an FMA
EXTRA_NVCC_FLAGS = {"search": ("-fmad=false",)}
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()  # guards the builds and _libs
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


def load_host_library(name: str, src: str) -> ctypes.CDLL:
    """Compile the C++ source `src` with g++ if needed and return the
    loaded library."""
    return _load(name, src, GXX_FLAGS,
                 lambda s, out: ["g++", *GXX_FLAGS, s, "-o", out])


def _load(name: str, src: str, flags, command) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode())
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
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
