"""Self-contained minimal DICOM reader (no pydicom dependency).

A copy of ``superresolution_aniso_mri_tpu/utils/dicom.py``.

Covers what the reference's DICOM→NIfTI converter needs
(kwatsch/create_nifti_from_dicom.py:13-284): Part-10 files in implicit
or explicit VR little endian with uncompressed PixelData, extracting the
pixel array plus the geometry/ordering attributes (PixelSpacing,
ImagePositionPatient, InstanceNumber, SliceThickness, RescaleSlope/
Intercept, SeriesInstanceUID). Compressed transfer syntaxes raise a
clear error — convert those externally or install pydicom (the series
converter prefers pydicom when it is importable).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional

import numpy as np

# transfer syntaxes we can decode
_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"

# VRs with a 2-byte reserved field + 4-byte length in explicit mode
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}

_TAGS = {
    (0x0008, 0x0060): "Modality",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0018, 0x0050): "SliceThickness",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
}


class DicomError(ValueError):
    pass


def _skip_undefined_sequence(buf: bytes, pos: int, explicit: bool) -> int:
    """Advance past an undefined-length (0xFFFFFFFF) sequence by walking
    its item structure with a nesting depth counter — a plain scan for
    the first (FFFE,E0DD) delimiter would stop at a NESTED sequence's
    delimiter and resume parsing mid-sequence. ``explicit`` selects the
    element layout inside undefined-length items: VR-sniffing an
    implicit file would misparse any element whose length field's low
    bytes happen to be uppercase ASCII."""
    n = len(buf)
    depth = 1
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if (group, elem) == (0xFFFE, 0xE0DD):      # sequence delimiter
            depth -= 1
            pos += 8
            if depth == 0:
                return pos
            continue
        if (group, elem) in ((0xFFFE, 0xE000),      # item start
                             (0xFFFE, 0xE00D)):     # item delimiter
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8
            # defined-length items are skipped wholesale (any nested
            # sequences live inside the skipped bytes); undefined-length
            # items' contents are walked element-wise below
            if (group, elem) == (0xFFFE, 0xE000) and length != 0xFFFFFFFF:
                pos += length
            continue
        # a data element inside an undefined-length item
        if explicit:
            vr = buf[pos + 4:pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                pos += 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                pos += 8
        else:
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8
        if length == 0xFFFFFFFF:
            depth += 1
        else:
            pos += length
    raise DicomError("unterminated undefined-length sequence")


def _parse_elements(buf: bytes, pos: int, explicit: bool,
                    stop_group: Optional[int] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_group is not None and group != stop_group:
            out["_pos"] = pos
            return out
        pos += 4
        if explicit:
            vr = buf[pos:pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                vr_known = vr.isalpha() and vr.isupper()
                if not vr_known:
                    raise DicomError(
                        f"bad VR {vr!r} at tag "
                        f"({group:04x},{elem:04x}) — corrupt or "
                        f"unsupported encoding")
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                raise DicomError(
                    "encapsulated (compressed) PixelData is not "
                    "supported by the built-in reader — install pydicom "
                    "or transcode the series to little-endian raw")
            pos = _skip_undefined_sequence(buf, pos, explicit)
            continue
        value = buf[pos:pos + length]
        pos += length
        name = _TAGS.get((group, elem))
        if name:
            out[name] = (vr, value)
    out["_pos"] = pos
    return out


def _text(raw) -> str:
    return raw[1].decode("ascii", errors="replace").strip("\x00 ").strip()


def _multi_float(raw):
    return [float(v) for v in _text(raw).split("\\") if v]


def _us(raw) -> int:
    vr, val = raw
    if vr in (b"US", b"UN") and len(val) >= 2:
        return struct.unpack_from("<H", val, 0)[0]
    return int(_text(raw) or 0)


def read_dicom(path: str) -> Dict[str, Any]:
    """Parse one DICOM file → attribute dict with a ``pixel_array``.

    Raises DicomError for non-DICOM, truncated, or corrupt files,
    compressed transfer syntaxes, or missing PixelData — parsing
    failures never leak struct/Value/Key errors, so series scans can
    rely on catching DicomError alone.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 132 + 8 or buf[128:132] != b"DICM":
        raise DicomError(f"{path}: not a Part-10 DICOM file")
    try:
        return _read_dicom_body(path, buf)
    except DicomError:
        raise
    except (struct.error, ValueError, KeyError, IndexError) as e:
        raise DicomError(f"{path}: corrupt DICOM ({e!r})") from e


def _read_dicom_body(path: str, buf: bytes) -> Dict[str, Any]:
    # file meta (group 0002) is ALWAYS explicit VR little endian
    meta = _parse_elements(buf, 132, explicit=True, stop_group=0x0002)
    ts_raw = None
    # transfer syntax lives at (0002,0010); re-scan meta region for it
    pos = 132
    end_meta = meta["_pos"]
    while pos + 8 <= end_meta:
        group, elem = struct.unpack_from("<HH", buf, pos)
        vr = buf[pos + 4:pos + 6]
        if vr in _LONG_VRS:
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            hdr = 12
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            hdr = 8
        if (group, elem) == (0x0002, 0x0010):
            ts_raw = buf[pos + hdr:pos + hdr + length]
        pos += hdr + length
    ts = (ts_raw or b"").decode("ascii",
                                errors="replace").strip("\x00 ").strip()
    if ts and ts not in (_IMPLICIT_LE, _EXPLICIT_LE):
        raise DicomError(
            f"{path}: transfer syntax {ts} not supported by the "
            f"built-in reader (only implicit/explicit little endian)")
    explicit = ts != _IMPLICIT_LE  # default (missing ts) → explicit LE

    ds = _parse_elements(buf, end_meta, explicit=explicit)
    attrs: Dict[str, Any] = {}
    for name in ("SeriesInstanceUID", "Modality"):
        if name in ds:
            attrs[name] = _text(ds[name])
    if "InstanceNumber" in ds:
        try:
            attrs["InstanceNumber"] = int(_text(ds["InstanceNumber"]) or 0)
        except ValueError:
            pass
    if "ImagePositionPatient" in ds:
        attrs["ImagePositionPatient"] = _multi_float(
            ds["ImagePositionPatient"])
    if "PixelSpacing" in ds:
        attrs["PixelSpacing"] = _multi_float(ds["PixelSpacing"])
    for name in ("SliceThickness", "RescaleSlope", "RescaleIntercept"):
        if name in ds:
            try:
                attrs[name] = float(_text(ds[name]))
            except ValueError:
                pass

    if "PixelData" not in ds:
        raise DicomError(f"{path}: no PixelData")
    rows, cols = _us(ds["Rows"]), _us(ds["Columns"])
    bits = _us(ds.get("BitsAllocated", (b"US", b"\x10\x00")))
    signed = _us(ds.get("PixelRepresentation", (b"US", b"\x00\x00"))) == 1
    samples = _us(ds.get("SamplesPerPixel", (b"US", b"\x01\x00")))
    if samples != 1:
        raise DicomError(f"{path}: only single-sample (grayscale) "
                         f"images are supported")
    if bits == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits == 16:
        dtype = np.int16 if signed else np.uint16
    else:
        raise DicomError(f"{path}: BitsAllocated={bits} not supported")
    raw = ds["PixelData"][1]
    count = rows * cols
    arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"),
                        count=count).reshape(rows, cols)
    arr = arr.astype(np.float32)
    slope = attrs.get("RescaleSlope")
    inter = attrs.get("RescaleIntercept")
    if (slope is not None and slope != 1.0) or (inter or 0.0) != 0.0:
        arr = arr * (slope if slope is not None else 1.0) + (inter or 0.0)
    attrs["pixel_array"] = arr
    attrs["Rows"], attrs["Columns"] = rows, cols
    return attrs


def read_dicom_series(dicom_dir: str):
    """Read every parsable DICOM in a directory → (volume [z,y,x],
    spacing (z,y,x)) ordered by z-position (InstanceNumber fallback,
    same rule as the pydicom path in image_misc)."""
    slices = []
    for f in sorted(os.listdir(dicom_dir)):
        if f.startswith("."):
            continue
        path = os.path.join(dicom_dir, f)
        if not os.path.isfile(path):
            continue
        try:
            slices.append(read_dicom(path))
        except DicomError:
            continue
    if not slices:
        raise DicomError(f"no readable DICOM images in {dicom_dir}")

    def _order(d):
        pos = d.get("ImagePositionPatient")
        if pos is not None and len(pos) >= 3:
            return (0, float(pos[2]))
        return (1, float(d.get("InstanceNumber", 0)))

    slices.sort(key=_order)
    vol = np.stack([s["pixel_array"] for s in slices])
    ps = slices[0].get("PixelSpacing", [1.0, 1.0])
    if len(slices) > 1 and all(
            len(s.get("ImagePositionPatient") or []) >= 3
            for s in slices[:2]):
        dz = abs(slices[1]["ImagePositionPatient"][2]
                 - slices[0]["ImagePositionPatient"][2]) or 1.0
    else:
        dz = slices[0].get("SliceThickness", 1.0) or 1.0
    spacing = np.array([dz, ps[0], ps[1]], np.float64)
    return vol, spacing
