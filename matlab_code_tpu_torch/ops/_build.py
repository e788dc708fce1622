"""Build a CUDA source of this package into a shared library and load it.

nvcc compiles the sources into a plain-C shared library (no PyTorch
headers, so a build takes seconds; kernel D's 72 instances ~85 s on 8
cores), which is loaded with ctypes.  The library goes into
matlab_code_tpu_torch/_build/ (git-ignored), named by a hash of the
sources and the flags, so a stale library is never loaded.  Nothing here
runs at import time: the first CUDA call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -split-compile=0: nvcc runs its optimizer on the device functions of a
# source in parallel, one thread a core (kernel D's one source holds 72
# kernel instances)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-split-compile=0")

# compiler output (ptxas register / shared-memory report) of each library
# built by this process, keyed by library path
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of matlab_code_tpu_torch cannot be built")


def library_path(name: str, sources: list[str]) -> Path:
    """Where the library built from `sources` (file names under csrc/) lives."""
    h = hashlib.sha256()
    for s in sorted(sources):
        h.update(s.encode())
        h.update((CSRC_DIR / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (if its hash is new) and load the library of `sources`."""
    so = library_path(name, sources)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC_DIR / s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_LOGS[str(so)] = proc.stdout + proc.stderr
    return ctypes.CDLL(str(so))
