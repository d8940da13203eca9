"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface. It is compiled with
``nvcc -shared`` for ``sm_90a`` into ``<package>/_build/`` (ignored by
git), named by a hash of the source, the flags and the compiler, so an
edited source rebuilds and an unchanged one loads at once. Nothing
here includes PyTorch's headers, so a build takes seconds. A build or
load failure raises; there is no fallback.
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

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def library_path(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to with these flags."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    flags = ARCH_FLAGS + BASE_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(src + "\0".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<lib>.log``."""
    out = library_path(name, extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ([nvcc] + list(ARCH_FLAGS) + list(BASE_FLAGS) + list(extra_flags)
           + ["-o", tmp, str(SRC_DIR / f"{name}.cu")])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    Path(str(out) + ".log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                       + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_library(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    key = name + "\0" + "\0".join(extra_flags)
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(str(build(name, extra_flags)))
    return _LOADED[key]


def build_log(name: str, extra_flags: Sequence[str] = ()) -> str:
    """The compiler output saved by :func:`build`, or '' before a build."""
    log = Path(str(library_path(name, extra_flags)) + ".log")
    return log.read_text() if log.exists() else ""
