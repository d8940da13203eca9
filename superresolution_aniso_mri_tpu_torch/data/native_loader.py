"""ctypes binding of the native host data loader (``csrc/srloader.cc``).

Port of ``superresolution_aniso_mri_tpu/data/native_loader.py``: zlib
NIfTI decode, a thread-pool directory ingest and a threaded
channel-interleaving gather for triplet batch assembly. The numpy
implementations (``utils/nifti.py``, ``data/pairs.py``) stay the
behavioural reference; these give the same bits. The sampler
(``data/pairs.py``) assembles its batches with the gather; the dataset
loaders decode with their Python thread pool, which measured faster
than the native ingest (``data/datasets.py``).

The library is built at first use by ``ops/_build.py`` (``g++ … -lz
-pthread`` into the package's ``_build/``). ``SRL_DISABLE_NATIVE=1``
(read at every ``available()`` call) makes the callers take the numpy
paths. A failed build raises, naming that switch: unlike JAX's loader,
the port does not fall back to numpy on its own.
"""
from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_lib = None


class _SrlImage(ctypes.Structure):
    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("sform", ctypes.c_int32),
        ("dims", ctypes.c_int64 * 8),
        ("spacing", ctypes.c_double * 3),
        ("affine", ctypes.c_double * 12),
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("count", ctypes.c_int64),
        ("err", ctypes.c_char * 256),
    ]


def _load():
    """Build and load the library; RuntimeError on failure."""
    from ..ops._build import load_library

    try:
        lib = load_library("srloader")
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the native loader did not build or load (set "
                           f"SRL_DISABLE_NATIVE=1 for the numpy paths): "
                           f"{e}") from e
    lib.srl_version.restype = ctypes.c_int
    lib.srl_version.argtypes = []
    lib.srl_read_nifti.restype = ctypes.POINTER(_SrlImage)
    lib.srl_read_nifti.argtypes = [ctypes.c_char_p]
    lib.srl_free_image.restype = None
    lib.srl_free_image.argtypes = [ctypes.POINTER(_SrlImage)]
    lib.srl_read_nifti_many.restype = ctypes.c_int
    lib.srl_read_nifti_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(_SrlImage)), ctypes.c_int]
    lib.srl_gather.restype = None
    lib.srl_gather.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.c_int,
        ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    return lib


def _get_lib():
    global _lib
    if os.environ.get("SRL_DISABLE_NATIVE"):
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def available() -> bool:
    """False when ``SRL_DISABLE_NATIVE`` is set, else True once the
    library is built and loaded (RuntimeError when it does not build)."""
    return _get_lib() is not None


def _require():
    lib = _get_lib()
    if lib is None:
        raise IOError("the native loader is disabled (SRL_DISABLE_NATIVE)")
    return lib


def _image_to_numpy(im) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
    if not im:
        # NULL only when the error struct itself could not be allocated
        raise IOError("native decode failed (out of memory)")
    c = im.contents
    if c.err:
        raise IOError(c.err.decode())
    shape = tuple(int(c.dims[i]) for i in range(c.ndim))
    arr = np.ctypeslib.as_array(c.data, shape=shape).copy()
    spacing = np.array([c.spacing[0], c.spacing[1], c.spacing[2]],
                       np.float64)
    affine = None
    if c.sform:
        affine = np.vstack([np.array(c.affine, np.float64).reshape(3, 4),
                            [0.0, 0.0, 0.0, 1.0]])
    return arr, spacing, affine


def read_nifti_native(path: str):
    """The native ``utils.nifti.read_nifti``: (float32 array [z,y,x] or
    [t,z,y,x], spacing (z,y,x), affine or None). Raises IOError when the
    file does not decode or the library is unavailable."""
    lib = _require()
    im = lib.srl_read_nifti(path.encode())
    try:
        return _image_to_numpy(im)
    finally:
        lib.srl_free_image(im)


def read_nifti_many(paths: Sequence[str], nthreads: int = 0,
                    strict: bool = True) -> List:
    """Decode many NIfTI files in parallel on the native thread pool:
    (array, spacing, affine) in input order. ``strict=False`` keeps the
    good decodes and gives None for a file that failed (with a warning)
    instead of raising the first error."""
    lib = _require()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_out = (ctypes.POINTER(_SrlImage) * n)()
    lib.srl_read_nifti_many(c_paths, n, c_out, int(nthreads))
    results, first_err = [], None
    # every native buffer is freed, whatever raises in the loop
    freed = 0
    try:
        for i in range(n):
            try:
                results.append(_image_to_numpy(c_out[i]))
            except IOError as e:
                first_err = first_err or e
                results.append(None)
            finally:
                lib.srl_free_image(c_out[i])
                freed = i + 1
    finally:
        for i in range(freed, n):
            lib.srl_free_image(c_out[i])
    if first_err is not None:
        if strict:
            raise first_err
        n_bad = sum(1 for r in results if r is None)
        warnings.warn(f"native ingest: {n_bad}/{n} file(s) failed "
                      f"({first_err})")
    return results


def gather_triplets(slices: Sequence[Sequence[np.ndarray]],
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """[B, H, W, C] from B lists of C [H, W] float32 planes: the native
    per-item ``np.stack(chans, axis=-1)`` and batch stack, threaded over
    items."""
    lib = _require()
    b = len(slices)
    c = len(slices[0])
    h, w = slices[0][0].shape
    if out is None:
        out = np.empty((b, h, w, c), np.float32)
    elif (out.shape != (b, h, w, c) or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"gather_triplets: out must be C-contiguous float32 "
            f"{(b, h, w, c)}, got {out.dtype} {out.shape}")
    ptrs = (ctypes.POINTER(ctypes.c_float) * (b * c))()
    keepalive = []
    for i, chans in enumerate(slices):
        if len(chans) != c:
            raise ValueError(
                f"gather_triplets: item {i} has {len(chans)} channel "
                f"planes, expected {c}")
        for j, plane in enumerate(chans):
            if plane.shape != (h, w):
                raise ValueError(
                    f"gather_triplets: plane [{i}][{j}] has shape "
                    f"{plane.shape}, expected {(h, w)}")
            if (plane.dtype != np.float32
                    or not plane.flags["C_CONTIGUOUS"]):
                plane = np.ascontiguousarray(plane, np.float32)
            keepalive.append(plane)
            ptrs[i * c + j] = plane.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
    lib.srl_gather(ptrs, b, c, h * w,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 0)
    return out
