"""Build the package's CUDA sources into shared libraries at first use.

Each library is one `nvcc` call over one `csrc/*.cu` file with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). Output goes to `.kernel_build/` at the repository root (listed
in .gitignore) under a name that hashes the source and the flags, so a
changed source is never served by a stale library.

The build needs `nvcc` (found through PyTorch's CUDA_HOME); there is no
fallback, since a CUDA tensor must run its kernel or fail.
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

_lock = threading.Lock()
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


def nvcc_command(src: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, src]


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
        if os.path.exists(out):
            build_log[name] = (0.0, "cached")
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(nvcc_command(src, tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = (time.perf_counter() - t0,
                               proc.stdout + proc.stderr)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
