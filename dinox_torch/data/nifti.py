"""Minimal NIfTI-1 reader and writer on numpy, ``struct`` and ``gzip`` (no
nibabel): the port's copy of ``dinox_tpu.data.nifti``.

Supports the subset the preprocessing pipeline needs (``python -m
dinox_torch.preprocessing.preprocess_nifti`` on MSD ``.nii.gz`` volumes):
single-file ``.nii``/``.nii.gz``, little- or big-endian, common scalar
dtypes, scl_slope/scl_inter rescaling, and voxel spacing from pixdim.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


@dataclass
class NiftiVolume:
    data: np.ndarray  # (nx, ny, nz[, nt]) after scl rescale, float32
    spacing: tuple[float, float, float]  # (sx, sy, sz) mm

    @property
    def n_slices(self) -> int:
        return self.data.shape[2] if self.data.ndim >= 3 else 1

    def slice_hu(self, z: int) -> np.ndarray:
        """Axial slice z as (y, x) float32 — the orientation used downstream."""
        vol = self.data if self.data.ndim == 3 else self.data[..., 0]
        return np.ascontiguousarray(vol[:, :, z].T)


def read_nifti(path: str | Path) -> NiftiVolume:
    path = Path(path)
    raw = path.read_bytes()
    if path.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if len(raw) < 352:
        raise ValueError(f"{path}: not a NIfTI-1 file (too short)")

    sizeof_hdr = struct.unpack("<i", raw[:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack(">i", raw[:4])[0] != 348:
            raise ValueError(f"{path}: bad sizeof_hdr {sizeof_hdr}")
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(endian + "8h", raw[40:56])
    ndim = max(1, min(dim[0], 7))
    shape = tuple(max(1, d) for d in dim[1 : 1 + ndim])
    datatype, bitpix = struct.unpack(endian + "2h", raw[70:74])
    pixdim = struct.unpack(endian + "8f", raw[76:108])
    vox_offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    scl_slope, scl_inter = struct.unpack(endian + "2f", raw[112:120])

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=count, offset=vox_offset or 352)
    data = data.reshape(shape, order="F").astype(np.float32)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter

    spacing = (abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0, abs(pixdim[3]) or 1.0)
    return NiftiVolume(data=data, spacing=spacing)


def write_nifti(path: str | Path, data: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    """Minimal NIfTI-1 writer (float32, LE) — used by tests and the synthetic
    data tools; round-trips through :func:`read_nifti`."""
    path = Path(path)
    data = np.asarray(data, np.float32)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<2h", hdr, 70, 16, 32)  # float32
    struct.pack_into("<8f", hdr, 76, 0.0, spacing[0], spacing[1], spacing[2], 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload))
    else:
        path.write_bytes(payload)
