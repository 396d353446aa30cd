"""Build a ``csrc/*.cu`` file into a shared library and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``<package>/build/`` (a ``build/`` directory, which
``.gitignore`` lists), or into ``$APVT_TORCH_BUILD_DIR``. The library name
carries a hash of the source, so an edited kernel is never served from a
stale build. ptxas' per-kernel report (registers, spills) is kept in
``BUILD_LOG``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # source name -> nvcc wall seconds
BUILD_LOG: dict[str, str] = {}  # source name -> nvcc/ptxas report


def build_dir() -> str:
    return os.environ.get("APVT_TORCH_BUILD_DIR", os.path.join(_PKG, "build"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once per process (and per source hash)."""
    if source in _LOADED:
        return _LOADED[source]
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{os.path.splitext(source)[0]}_{digest}.so")
    if not os.path.exists(lib):
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
            BUILD_LOG[source] = proc.stderr
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_SECONDS[source] = time.perf_counter() - t0
    _LOADED[source] = ctypes.CDLL(lib)
    return _LOADED[source]
