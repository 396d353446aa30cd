"""Build a ``csrc/*.cu`` file into a shared library and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``<package>/build/`` (a ``build/`` directory, which
``.gitignore`` lists), or into ``$APVT_TORCH_BUILD_DIR``. The library name
carries a hash of the source and of the ``csrc`` headers it includes, so an
edited kernel is never served from a stale build. ptxas' per-kernel report (registers, spills) is kept in
``BUILD_LOG``. :func:`load_all` builds several sources in parallel;
:func:`load_text` builds an edited copy of a source for a measurement.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def _compile(name: str, src: str, digest: str) -> ctypes.CDLL:
    """nvcc ``src`` into ``<build dir>/<stem>_<digest>.so`` unless it is there; load it."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{os.path.splitext(name)[0]}_{digest}.so")
    if not os.path.exists(lib):
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
            BUILD_LOG[name] = proc.stderr
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(lib)


def _digest(text: bytes) -> str:
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


_INCLUDE = re.compile(r'^#include "([^"]+)"$', re.M)


def inlined(source: str, _seen: set | None = None) -> str:
    """The text of ``csrc/<source>`` with its ``#include "..."`` lines (the
    headers of ``csrc``) replaced by their text, each header once, as its
    ``#pragma once`` has the compiler read it: what the compiler sees, and a
    source that compiles on its own."""
    seen = set() if _seen is None else _seen
    with open(os.path.join(CSRC, source)) as f:
        text = f.read().replace("#pragma once\n", "")

    def header(m):
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        return inlined(m.group(1), seen)

    return _INCLUDE.sub(header, text)


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once per process (and per source hash)."""
    if source not in _LOADED:
        digest = _digest(inlined(source).encode())
        _LOADED[source] = _compile(source, os.path.join(CSRC, source), digest)
    return _LOADED[source]


def load_text(name: str, text: str) -> ctypes.CDLL:
    """Compile CUDA source given as text (an edited copy of a ``csrc`` file,
    for a measurement): written into the build directory as ``name``."""
    key = f"{name}:{_digest(text.encode())}"
    if key not in _LOADED:
        os.makedirs(build_dir(), exist_ok=True)
        src = os.path.join(build_dir(), f"{os.path.splitext(name)[0]}_{key.split(':')[1]}.cu")
        with open(src, "w") as f:
            f.write(text)
        _LOADED[key] = _compile(name, src, key.split(":")[1])
    return _LOADED[key]


def load_all(sources) -> list[ctypes.CDLL]:
    """:func:`load` for several sources at once: one nvcc each, started together.

    A run that needs every kernel (``chip_smoke.py``) then waits for the
    slowest nvcc instead of their sum, which keeps its time bounded as
    sources are added.
    """
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(load, sources))
