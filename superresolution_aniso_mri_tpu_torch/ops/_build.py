"""Build the port's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface. It is compiled with
``nvcc -shared`` for ``sm_90a`` into ``<package>/_build/`` (ignored by
git), named by a hash of the source and the compiler's arguments, so an
edited source rebuilds and an unchanged one loads at once. Nothing
here includes PyTorch's headers, so a build takes seconds. A host
source ``csrc/<name>.cc`` (the data loader) is compiled the same way by
the host's C++ compiler with the flags of the JAX package's
``native/Makefile``. A build or load failure raises here; the data
loader (``data/native_loader.py``) raises it on, naming
``SRL_DISABLE_NATIVE``, its switch to the numpy paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# host sources: ``native/Makefile``'s flags and libraries
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
CXX_LIBS = ("-lz", "-pthread")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or the standard toolkit location."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else ``g++`` on $PATH."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH); "
                           "the port's data loader is built from source")
    return cxx


def _source(name: str) -> Path:
    cu = SRC_DIR / f"{name}.cu"
    return cu if cu.exists() else SRC_DIR / f"{name}.cc"


def _arguments(src: Path, extra_flags: Sequence[str]) -> list:
    """The compiler's arguments for ``src`` but ``-o <library>``: nvcc's
    for a ``.cu``; the host compiler's for a ``.cc``, its libraries
    after the source."""
    if src.suffix == ".cu":
        return [*ARCH_FLAGS, *BASE_FLAGS, *extra_flags, str(src)]
    return [*CXX_FLAGS, *extra_flags, str(src), *CXX_LIBS]


_COMPILERS = {".cu": find_nvcc, ".cc": find_cxx}


def library_path(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` (or ``.cc``) builds to with these flags."""
    src = _source(name)
    args = "\0".join(_arguments(src, extra_flags))
    digest = hashlib.sha256(src.read_bytes() + args.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``.cc``) unless its hashed library
    exists. The compiler's output (for CUDA ``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library as ``<lib>.log``."""
    out = library_path(name, extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _source(name)
    compiler = _COMPILERS[src.suffix]()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *_arguments(src, extra_flags), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed to build "
                           f"{src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    Path(str(out) + ".log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                       + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_library(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` (or ``.cc``); cached
    per process."""
    key = name + "\0" + "\0".join(extra_flags)
    if key not in _LOADED:
        with span("build.kernel"):
            _LOADED[key] = ctypes.CDLL(str(build(name, extra_flags)))
    return _LOADED[key]


def build_log(name: str, extra_flags: Sequence[str] = ()) -> str:
    """The compiler output saved by :func:`build`, or '' before a build."""
    log = Path(str(library_path(name, extra_flags)) + ".log")
    return log.read_text() if log.exists() else ""
