"""A small reader and writer of the safetensors format, in numpy.

Layout: an unsigned 64-bit little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?}``,
then the raw little-endian tensor bytes, offsets relative to the end of the
header. bfloat16 tensors read as float32 (numpy has no bfloat16).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str | Path) -> dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(data[8:8 + n])
    buf = memoryview(data)[8 + n:]
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{path}: tensor {name} lies outside the data buffer")
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            raw = np.frombuffer(buf[begin:end], dtype="<u2").astype(np.uint32) << 16
            arr = raw.view(np.float32)
        else:
            arr = np.frombuffer(buf[begin:end], dtype=_DTYPES[info["dtype"]]).copy()
        out[name] = arr.reshape(shape)
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str | Path) -> None:
    header: dict[str, dict] = {}
    arrays: list[np.ndarray] = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        dtype = arr.dtype.newbyteorder("<")
        if dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors name here")
        arr = np.ascontiguousarray(arr.astype(dtype, copy=False).reshape(-1))  # 0-d keeps its shape below
        header[name] = {"dtype": _NAMES[dtype], "shape": list(np.shape(tensors[name])),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:  # written from the arrays' own memory, no copy to bytes
            f.write(arr.view(np.uint8))
