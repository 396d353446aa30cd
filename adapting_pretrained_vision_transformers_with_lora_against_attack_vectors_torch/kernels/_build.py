"""Build a ``csrc/*.cu`` file into a shared library and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``<package>/build/`` (a ``build/`` directory, which
``.gitignore`` lists), or into ``$APVT_TORCH_BUILD_DIR``. The library name
carries a hash of the source and of the ``csrc`` headers it includes, so an
edited kernel is never served from a stale build. ptxas' per-kernel report (registers, spills) is kept in
``BUILD_LOG``. :func:`load_all` builds several sources in parallel;
:func:`load_text` builds an edited copy of a source for a measurement;
:func:`load_host` builds host C++ sources with ``g++`` into the same
directory, named by the same kind of hash. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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


def _nvcc_command(src: str):
    return lambda out: [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", out, src]


def _compile(name: str, digest: str, command) -> ctypes.CDLL:
    """Run the compiler, ``command(out_path)``, into
    ``<build dir>/<stem>_<digest>.so`` unless it is there; load it. The
    library is written under a temporary name and renamed, so processes that
    build it at the same time never load a partial file."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{os.path.splitext(name)[0]}_{digest}.so")
    if not os.path.exists(lib):
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        t0 = time.perf_counter()
        try:
            argv = command(tmp)
            proc = subprocess.run(argv, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(argv[0])} failed on {name}:\n"
                                   f"{proc.stderr}")
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
        _LOADED[source] = _compile(source, digest, _nvcc_command(os.path.join(CSRC, source)))
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
        _LOADED[key] = _compile(name, key.split(":")[1], _nvcc_command(src))
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


# host C++ (native/Makefile's flags without -march=native, so that a build
# dir another host loads holds no instruction it may lack)
CXX_FLAGS = ["-O3", "-fno-math-errno", "-std=c++17", "-fPIC", "-Wall", "-shared"]
CXX_LIBS = ["-lpthread", "-lz", "-ldl"]


def host_cxx_flags() -> list[str]:
    """:data:`CXX_FLAGS`, and ``-mfma`` on an x86-64 CPU that has FMA.

    The JAX package builds the same sources with ``-march=native``; on such a
    CPU g++ then contracts the resampler's ``acc += w * p`` into FMAs, which
    rounds about one output byte in 10^5 differently. ``-mfma`` gives the same
    contraction, hence the same bytes, and nothing else of the host's ISA. The
    flags are part of the library's hash."""
    flags = list(CXX_FLAGS)
    try:
        with open("/proc/cpuinfo") as f:
            cpu = f.read()
    except OSError:
        cpu = ""
    if platform.machine() in ("x86_64", "AMD64") and re.search(r"^flags\s*:.*\bfma\b", cpu, re.M):
        flags.append("-mfma")
    return flags


def load_host(name: str, sources) -> ctypes.CDLL:
    """``g++`` the C++ ``sources`` (paths) into one shared library
    ``<build dir>/<name>_<hash>.so`` once per process, and per hash of the
    sources' text, the flags and the compiler's version; a failed build raises
    with the compiler's stderr."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {name} is built from C++ sources")
    flags = host_cxx_flags()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    text = b"".join(open(src, "rb").read() for src in sources)
    digest = hashlib.sha256(text + " ".join([*flags, *CXX_LIBS, version]).encode()).hexdigest()[:16]
    key = f"{name}:{digest}"
    if key not in _LOADED:
        _LOADED[key] = _compile(name, digest,
                                lambda out: [cxx, *flags, "-o", out, *sources, *CXX_LIBS])
    return _LOADED[key]
