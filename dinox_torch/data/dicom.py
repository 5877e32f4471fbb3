"""Minimal DICOM reader and writer on numpy and ``struct`` (no pydicom):
the port's copy of ``dinox_tpu.data.dicom``.

Covers exactly what CT slice preprocessing needs
(``python -m dinox_torch.preprocessing.preprocess_dicom`` and
``extract_dicom_spacing``): Part-10 files, Explicit/Implicit VR Little
Endian transfer syntaxes, uncompressed pixel data, the geometry/rescale
tags, and a ``stop_before_pixels`` fast path for spacing backfill.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

# (group, element) tags
TAG_SPECIFIC_CHARSET = (0x0008, 0x0005)
TAG_PATIENT_ID = (0x0010, 0x0020)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_IMAGE_POSITION = (0x0020, 0x0032)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_IMPLICIT_LE = "1.2.840.10008.1.2"

# Known-but-unsupported transfer syntaxes, for actionable error messages.
# LIDC/TCIA CT archives ship uncompressed LE, which is why only the two
# syntaxes above are implemented; anything else needs an external decode
# step (e.g. pydicom+pylibjpeg offline, or `gdcmconv --raw`).
_KNOWN_UNSUPPORTED = {
    "1.2.840.10008.1.2.2": "Explicit VR Big Endian",
    "1.2.840.10008.1.2.1.99": "Deflated Explicit VR Little Endian",
    "1.2.840.10008.1.2.4.50": "JPEG Baseline (Process 1)",
    "1.2.840.10008.1.2.4.51": "JPEG Extended (Process 2&4)",
    "1.2.840.10008.1.2.4.57": "JPEG Lossless",
    "1.2.840.10008.1.2.4.70": "JPEG Lossless SV1",
    "1.2.840.10008.1.2.4.80": "JPEG-LS Lossless",
    "1.2.840.10008.1.2.4.81": "JPEG-LS Near-Lossless",
    "1.2.840.10008.1.2.4.90": "JPEG 2000 Lossless",
    "1.2.840.10008.1.2.4.91": "JPEG 2000",
    "1.2.840.10008.1.2.5": "RLE Lossless",
}


class UnsupportedTransferSyntaxError(ValueError):
    """Raised for DICOM transfer syntaxes this reader does not decode."""

# VRs whose explicit-form length field is 4 bytes after 2 reserved bytes
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}


@dataclass
class DicomSlice:
    elements: dict[tuple[int, int], bytes] = field(default_factory=dict)
    pixel_array: Optional[np.ndarray] = None

    def _text(self, tag) -> Optional[str]:
        raw = self.elements.get(tag)
        return raw.decode("ascii", "replace").strip("\x00 ").strip() if raw is not None else None

    def _floats(self, tag) -> Optional[list[float]]:
        s = self._text(tag)
        if not s:
            return None
        try:
            return [float(x) for x in s.split("\\")]
        except ValueError:
            return None

    @property
    def series_uid(self) -> Optional[str]:
        return self._text(TAG_SERIES_UID)

    @property
    def patient_id(self) -> Optional[str]:
        return self._text(TAG_PATIENT_ID)

    @property
    def pixel_spacing(self) -> tuple[float, float]:
        v = self._floats(TAG_PIXEL_SPACING)
        return (v[1], v[0]) if v and len(v) >= 2 else (1.0, 1.0)  # row\col -> (x, y)

    @property
    def slice_thickness(self) -> float:
        v = self._floats(TAG_SLICE_THICKNESS)
        return v[0] if v else 1.0

    @property
    def image_position_z(self) -> float:
        v = self._floats(TAG_IMAGE_POSITION)
        return v[2] if v and len(v) >= 3 else 0.0

    @property
    def rescale(self) -> tuple[float, float]:
        slope = self._floats(TAG_RESCALE_SLOPE)
        inter = self._floats(TAG_RESCALE_INTERCEPT)
        return (slope[0] if slope else 1.0, inter[0] if inter else 0.0)

    def hu(self) -> np.ndarray:
        """Pixel data rescaled to Hounsfield units (float32)."""
        if self.pixel_array is None:
            raise ValueError("pixel data not read (stop_before_pixels?)")
        slope, inter = self.rescale
        return self.pixel_array.astype(np.float32) * slope + inter


def _parse_meta(raw: bytes) -> tuple[str, int]:
    """File-meta group (always explicit LE). Returns (transfer_syntax, offset)."""
    if raw[128:132] != b"DICM":
        # Some files omit the preamble; treat as raw dataset, guess implicit LE.
        return _IMPLICIT_LE, 0
    pos = 132
    ts = _EXPLICIT_LE
    # (0002,0000) UL group length tells us where meta ends
    end = None
    while pos + 8 <= len(raw):
        group, elem = struct.unpack_from("<HH", raw, pos)
        if group != 0x0002:
            break
        vr = raw[pos + 4 : pos + 6]
        if vr in _LONG_VRS:
            length = struct.unpack_from("<I", raw, pos + 8)[0]
            vpos = pos + 12
        else:
            length = struct.unpack_from("<H", raw, pos + 6)[0]
            vpos = pos + 8
        value = raw[vpos : vpos + length]
        if (group, elem) == (0x0002, 0x0000):
            end = vpos + length + struct.unpack("<I", value)[0]
        if (group, elem) == (0x0002, 0x0010):
            ts = value.decode("ascii").strip("\x00 ")
        pos = vpos + length
        if end is not None and pos >= end:
            break
    return ts, pos


def read_dicom(path: str | Path, stop_before_pixels: bool = False) -> DicomSlice:
    raw = Path(path).read_bytes()
    ts, pos = _parse_meta(raw)
    if ts not in (_EXPLICIT_LE, _IMPLICIT_LE):
        name = _KNOWN_UNSUPPORTED.get(ts, "unrecognized")
        raise UnsupportedTransferSyntaxError(
            f"{path}: unsupported DICOM transfer syntax {ts} ({name}). This "
            "reader decodes uncompressed Little-Endian only (Explicit "
            f"{_EXPLICIT_LE} / Implicit {_IMPLICIT_LE}) — the format LIDC/TCIA "
            "CT archives use. Convert compressed files first, e.g. "
            "`gdcmconv --raw in.dcm out.dcm` or pydicom+pylibjpeg offline."
        )
    explicit = ts == _EXPLICIT_LE

    ds = DicomSlice()
    n = len(raw)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", raw, pos)
        tag = (group, elem)
        if explicit:
            vr = raw[pos + 4 : pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", raw, pos + 8)[0]
                vpos = pos + 12
            else:
                length = struct.unpack_from("<H", raw, pos + 6)[0]
                vpos = pos + 8
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", raw, pos + 4)[0]
            vpos = pos + 8
        if length == 0xFFFFFFFF:
            raise ValueError(f"{path}: undefined-length element {tag} (sequences unsupported)")

        if tag == TAG_PIXEL_DATA:
            if stop_before_pixels:
                break
            rows = struct.unpack("<H", ds.elements[TAG_ROWS])[0]
            cols = struct.unpack("<H", ds.elements[TAG_COLS])[0]
            bits = struct.unpack("<H", ds.elements.get(TAG_BITS_ALLOCATED, b"\x10\x00"))[0]
            signed = struct.unpack("<H", ds.elements.get(TAG_PIXEL_REPRESENTATION, b"\x00\x00"))[0]
            dt = {(8, 0): np.uint8, (8, 1): np.int8,
                  (16, 0): np.uint16, (16, 1): np.int16}[(bits, signed)]
            ds.pixel_array = np.frombuffer(
                raw, dtype=np.dtype(dt).newbyteorder("<"),
                count=rows * cols, offset=vpos,
            ).reshape(rows, cols)
            break
        ds.elements[tag] = raw[vpos : vpos + length]
        pos = vpos + length
    return ds


# -- writer (tests, synthetic data and the on-card smoke test) --------------


def write_dicom(
    path: str | Path,
    pixels: np.ndarray,
    *,
    series_uid: str = "1.2.3.4",
    patient_id: str = "PAT0",
    pixel_spacing: tuple[float, float] = (0.7, 0.7),
    slice_thickness: float = 1.0,
    position_z: float = 0.0,
    rescale_slope: float = 1.0,
    rescale_intercept: float = -1024.0,
) -> None:
    """Minimal Explicit-VR-LE Part-10 writer for test fixtures."""
    pixels = np.asarray(pixels, np.int16)

    def elem(tag, vr: bytes, value: bytes) -> bytes:
        if len(value) % 2:
            # UI and binary VRs pad with NUL; text VRs pad with space
            value += b"\x00" if vr in (b"UI", b"OB", b"OW", b"UN") else b" "
        head = struct.pack("<HH", *tag) + vr
        if vr in _LONG_VRS:
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    def txt(s: str) -> bytes:
        return s.encode("ascii")

    meta_body = elem((0x0002, 0x0010), b"UI", txt(_EXPLICIT_LE))
    meta = elem((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta_body))) + meta_body

    body = b"".join([
        elem(TAG_PATIENT_ID, b"LO", txt(patient_id)),
        elem(TAG_SLICE_THICKNESS, b"DS", txt(f"{slice_thickness}")),
        elem(TAG_SERIES_UID, b"UI", txt(series_uid)),
        elem(TAG_IMAGE_POSITION, b"DS", txt(f"0\\0\\{position_z}")),
        elem(TAG_ROWS, b"US", struct.pack("<H", pixels.shape[0])),
        elem(TAG_COLS, b"US", struct.pack("<H", pixels.shape[1])),
        elem(TAG_PIXEL_SPACING, b"DS", txt(f"{pixel_spacing[1]}\\{pixel_spacing[0]}")),
        elem(TAG_BITS_ALLOCATED, b"US", struct.pack("<H", 16)),
        elem(TAG_PIXEL_REPRESENTATION, b"US", struct.pack("<H", 1)),
        elem(TAG_RESCALE_INTERCEPT, b"DS", txt(f"{rescale_intercept}")),
        elem(TAG_RESCALE_SLOPE, b"DS", txt(f"{rescale_slope}")),
        elem(TAG_PIXEL_DATA, b"OW", pixels.astype("<i2").tobytes()),
    ])
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + body)
