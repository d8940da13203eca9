"""Self-contained NIfTI-1 and MetaImage (.mha/.mhd) I/O.

A copy of ``superresolution_aniso_mri_tpu/utils/nifti.py``: a minimal,
dependency-free (numpy, gzip, struct) reader/writer for the formats the
reference consumes and emits
(reference: datasets/common.py:209-241 read_nifty/sitk_save,
generate_hr_volumes.py:136-156 — *.nii, *.nii.gz, *.mha, *.mhd).

Conventions match SimpleITK's numpy bridge: arrays are returned as
[z, y, x] (or [t, z, y, x]); ``spacing`` is (z, y, x) — i.e. the reverse
of the on-disk (x, y, z) pixdim, like ``img.GetSpacing()[::-1]``.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _open_maybe_gz(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str):
    """Read a .nii / .nii.gz file → (array [z,y,x] or [t,z,y,x],
    spacing (z,y,x), affine 4x4 or None)."""
    with _open_maybe_gz(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        byteorder = "<"
        if sizeof_hdr != 348:
            byteorder = ">"
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        dim = struct.unpack_from(byteorder + "8h", hdr, 40)
        datatype = struct.unpack_from(byteorder + "h", hdr, 70)[0]
        pixdim = struct.unpack_from(byteorder + "8f", hdr, 76)
        vox_offset = struct.unpack_from(byteorder + "f", hdr, 108)[0]
        scl_slope = struct.unpack_from(byteorder + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(byteorder + "f", hdr, 116)[0]
        sform_code = struct.unpack_from(byteorder + "h", hdr, 254)[0]
        srow = np.array([
            struct.unpack_from(byteorder + "4f", hdr, 280),
            struct.unpack_from(byteorder + "4f", hdr, 296),
            struct.unpack_from(byteorder + "4f", hdr, 312),
        ], np.float64)

        ndim = dim[0]
        shape_xyz = [max(1, dim[i + 1]) for i in range(ndim)]
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(byteorder)

        offset = int(round(vox_offset)) if vox_offset >= 348 else 352
        f.seek(offset)
        count = int(np.prod(shape_xyz))
        raw = f.read(count * dtype.itemsize)
        arr = np.frombuffer(raw, dtype=dtype, count=count)
        # on-disk order is Fortran (x fastest): reshape reversed → [.., z, y, x]
        arr = arr.reshape(shape_xyz[::-1])

    # big-endian payloads must come back in NATIVE byte order — a '>f4'
    # array breaks torch.from_numpy and the writers' dtype tables
    if arr.dtype != arr.dtype.newbyteorder("="):
        arr = arr.astype(arr.dtype.newbyteorder("="))

    # non-finite slope/inter mean "no scaling" (nibabel convention;
    # uninitialized headers commonly carry NaN here — multiplying would
    # silently NaN the whole volume)
    if not np.isfinite(scl_slope):
        scl_slope = 1.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    # NIfTI-1 rule: scl_slope == 0 means NO scaling at all — applying a
    # stale nonzero scl_inter would silently shift every voxel
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        arr = arr.astype(np.float32) * scl_slope + scl_inter
    elif not arr.flags.writeable:
        # frombuffer views are read-only; the native reader always
        # returns writable copies — keep the 'exact drop-in' parity
        arr = arr.copy()

    spacing_xyz = [pixdim[i + 1] if pixdim[i + 1] > 0 else 1.0
                   for i in range(min(3, ndim))]
    while len(spacing_xyz) < 3:
        spacing_xyz.append(1.0)
    spacing_zyx = np.array(spacing_xyz[::-1], np.float64)

    affine = None
    if sform_code > 0:
        affine = np.vstack([srow, [0.0, 0.0, 0.0, 1.0]])
    return np.ascontiguousarray(arr), spacing_zyx, affine


def write_nifti(path: str, arr: np.ndarray, spacing=None,
                affine: Optional[np.ndarray] = None,
                dtype=np.float32) -> None:
    """Write [z,y,x] (or [t,z,y,x]) array as .nii / .nii.gz.

    ``spacing`` is (z, y, x); mirrors the reference's save conventions
    (datasets/common.py:219-241 sitk_save flips spacing before save)."""
    arr = np.asarray(arr).astype(dtype)
    if spacing is None:
        spacing = np.ones(min(arr.ndim, 3))
    spacing = np.asarray(spacing, np.float64)
    if spacing.shape[0] > 3:
        spacing = spacing[-3:]
    spacing_xyz = spacing[::-1]

    ndim = arr.ndim
    shape_xyz = arr.shape[::-1]
    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)
    pixdim = [1.0] + list(spacing_xyz) + [1.0] * (7 - len(spacing_xyz))

    code = _NIFTI_CODES[np.dtype(dtype)]
    bitpix = np.dtype(dtype).itemsize * 8

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    if affine is None:
        sp3 = list(spacing_xyz) + [1.0] * (3 - len(spacing_xyz))
        affine = np.diag(sp3[:3] + [1.0])  # always 4x4 (2-D saves too)
    # qform_code stays 0: we never fill the quaternion fields, so a
    # nonzero code would advertise an identity-rotation qform that
    # CONTRADICTS the sform for rotated/translated affines (strict
    # readers and some ITK/FSL configurations prefer or validate qform)
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    with _open_maybe_gz(path, "wb") as f:
        f.write(bytes(hdr))
        # stream the voxel payload without materializing extra copies
        f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))


_MET_TYPES = {
    "MET_UCHAR": np.uint8, "MET_CHAR": np.int8, "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16, "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read_metaimage(path: str):
    """Read .mha (local data) or .mhd (+ separate .raw/.zraw) →
    (array [z,y,x], spacing (z,y,x), affine 4x4 or None — built from
    TransformMatrix/Offset when the header carries them)."""
    with open(path, "rb") as f:
        header = {}
        data_file = None
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("ascii", errors="replace").strip()
            if "=" not in text:
                continue
            key, val = (t.strip() for t in text.split("=", 1))
            header[key] = val
            if key == "ElementDataFile":
                data_file = val
                break
        ndims = int(header.get("NDims", 3))
        dim_size = [int(v) for v in header["DimSize"].split()]
        spacing_xyz = [float(v) for v in header.get(
            "ElementSpacing", " ".join(["1"] * ndims)).split()]
        nchan = int(header.get("ElementNumberOfChannels", 1))
        if nchan != 1:
            # interleaved channel data would be silently misread as a
            # garbled single-channel volume — refuse loudly
            raise ValueError(
                f"{path}: ElementNumberOfChannels={nchan} is not "
                f"supported (single-channel volumes only)")
        met_type = header.get("ElementType", "MET_FLOAT")
        if met_type not in _MET_TYPES:
            raise ValueError(f"{path}: unsupported ElementType {met_type}")
        dtype = np.dtype(_MET_TYPES[met_type])
        if header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
            dtype = dtype.newbyteorder(">")
        count = int(np.prod(dim_size))
        compressed = header.get("CompressedData", "False").lower() == "true"
        if data_file == "LOCAL":
            raw = f.read()
        else:
            with open(os.path.join(os.path.dirname(path), data_file), "rb") as df:
                raw = df.read()
    # HeaderSize counts bytes in the ON-DISK data file — skip them
    # BEFORE decompression (a compressed payload with a prefix would
    # otherwise feed junk-prefixed bytes to zlib). -1 = the payload is
    # the last N bytes of the file (N = compressed length is unknowable,
    # so -1 only applies to uncompressed data).
    hs = int(header.get("HeaderSize", 0))
    if hs > 0:
        raw = raw[hs:]
    elif hs == -1 and not compressed:
        raw = raw[len(raw) - count * dtype.itemsize:]
    if compressed:
        import zlib
        raw = zlib.decompress(raw)
    arr = np.frombuffer(raw, dtype=dtype, count=count).reshape(dim_size[::-1])
    if arr.dtype != arr.dtype.newbyteorder("="):
        arr = arr.astype(arr.dtype.newbyteorder("="))  # native order out
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    affine = None
    tm = header.get("TransformMatrix") or header.get("Rotation")
    if tm is not None and ndims == 3:
        try:
            d = np.array([float(v) for v in tm.split()],
                         np.float64).reshape(3, 3)
            off = np.array([float(v) for v in header.get(
                "Offset", "0 0 0").split()], np.float64)
            affine = np.eye(4)
            # MetaIO rows are the per-axis direction cosines (x,y,z
            # order); NIfTI-style columns scale by the axis spacing
            for i in range(3):
                affine[:3, i] = d[i] * spacing_xyz[i]
            affine[:3, 3] = off
        except Exception:
            affine = None
    return arr, np.array(spacing_xyz[::-1], np.float64), affine


def write_metaimage(path: str, arr: np.ndarray, spacing=None,
                    affine: Optional[np.ndarray] = None) -> None:
    """Write a [z,y,x] array as an .mha with LOCAL binary data.
    A 3D ``affine`` is encoded as TransformMatrix/Offset (direction
    cosines + origin) so orientation survives the round trip."""
    arr = np.asarray(arr)
    if arr.dtype not in _MET_NAMES:
        raise ValueError(
            f"write_metaimage: unsupported dtype {arr.dtype} — convert "
            f"to one of {sorted(str(d) for d in _MET_NAMES)} first")
    if spacing is None:
        spacing = np.ones(arr.ndim)
    spacing_xyz = np.asarray(spacing, np.float64)[::-1]
    lines = [
        "ObjectType = Image",
        f"NDims = {arr.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = False",
        f"DimSize = {' '.join(str(s) for s in arr.shape[::-1])}",
        f"ElementSpacing = {' '.join(f'{s:g}' for s in spacing_xyz)}",
    ]
    if affine is not None:
        if arr.ndim != 3:
            import warnings
            warnings.warn("write_metaimage: affine is only encoded for "
                          "3D volumes — dropping it")
        else:
            a = np.asarray(affine, np.float64)
            rows = []
            for i in range(3):
                col = a[:3, i]
                n = np.linalg.norm(col)
                rows.extend((col / n) if n else
                            np.eye(3)[i])  # degenerate column: identity
            lines.append("TransformMatrix = "
                         + " ".join(f"{v:.10g}" for v in rows))
            lines.append("Offset = "
                         + " ".join(f"{v:.10g}" for v in a[:3, 3]))
    lines += [
        f"ElementType = {_MET_NAMES[arr.dtype]}",
        "ElementDataFile = LOCAL",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(arr).tobytes(order="C"))


def read_image(path: str):
    """Dispatch on extension like the reference's load_images
    (generate_hr_volumes.py:136-148)."""
    if path.endswith((".nii", ".nii.gz")):
        return read_nifti(path)
    if path.endswith((".mha", ".mhd")):
        return read_metaimage(path)
    raise ValueError(f"unsupported image format: {path}")


def write_image(path: str, arr: np.ndarray, spacing=None,
                affine: Optional[np.ndarray] = None,
                dtype=None) -> None:
    """``dtype=None`` keeps write_nifti's float32 default for images;
    pass an integer dtype for label maps so the on-disk header declares
    integers (segmentation tooling validates that)."""
    if path.endswith((".nii", ".nii.gz")):
        if dtype is None:
            write_nifti(path, arr, spacing=spacing, affine=affine)
        else:
            write_nifti(path, arr, spacing=spacing, affine=affine,
                        dtype=dtype)
    elif path.endswith(".mha"):
        write_metaimage(path, arr if dtype is None
                        else np.asarray(arr, dtype),
                        spacing=spacing, affine=affine)
    else:
        raise ValueError(f"unsupported image format: {path}")
