"""A small reader and writer of the safetensors format, in numpy.

Layout: an unsigned 64-bit little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?}``,
then the raw little-endian tensor bytes, offsets relative to the end of the
header. bfloat16 tensors read as float32 (numpy has no bfloat16; the
widening is exact) and are written from arrays of dtype :data:`BF16`, their
raw bits (``torch_to_numpy`` makes one from a bfloat16 tensor). A reader
may pass a filter on the tensor names: only the tensors it keeps are read
from disk, each at its own offset (a training state is several times the
size of the backbone a reader wants from it).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Callable, Mapping

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_NAMES = {v: k for k, v in _DTYPES.items()}
BF16 = np.dtype([("bf16", "<u2")])  # the raw bits of bfloat16 values


def torch_to_numpy(t) -> np.ndarray:
    """A CPU tensor as numpy for :func:`save_file`; bfloat16 as :data:`BF16`."""
    import torch

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _read(f, base: int, size: int, name: str, info: dict) -> np.ndarray:
    """Tensor *name* of an open file whose data buffer starts at *base* and
    holds *size* bytes, read at its header offsets."""
    begin, end = info["data_offsets"]
    if not 0 <= begin <= end <= size:
        raise ValueError(f"{f.name}: tensor {name} lies outside the data buffer")
    buf = bytearray(end - begin)
    f.seek(base + begin)
    if f.readinto(buf) != len(buf):
        raise ValueError(f"{f.name}: tensor {name} is cut short")
    if info["dtype"] == "BF16":
        arr = (np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=_DTYPES[info["dtype"]])
    return arr.reshape(tuple(info["shape"]))


def load_file(path: str | Path, keys: Callable[[str], bool] | None = None
              ) -> dict[str, np.ndarray]:
    """Every tensor of the file, or those whose name *keys* accepts: each
    read from disk at its own offset, so a filter reads only what it keeps."""
    with open(path, "rb") as f:
        total = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > total:
            raise ValueError(f"{path}: header length {n} runs past the end of the file")
        header = json.loads(f.read(n))
        return {name: _read(f, 8 + n, total - 8 - n, name, info) for name, info in header.items()
                if name != "__metadata__" and (keys is None or keys(name))}


def save_file(tensors: Mapping[str, np.ndarray], path: str | Path) -> None:
    header: dict[str, dict] = {}
    arrays: list[np.ndarray] = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if arr.dtype == BF16:
            kind, arr = "BF16", np.ascontiguousarray(arr).view("<u2").reshape(-1)
        else:
            dtype = arr.dtype.newbyteorder("<")
            if dtype not in _NAMES:
                raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors name here")
            kind = _NAMES[dtype]
            arr = np.ascontiguousarray(arr.astype(dtype, copy=False).reshape(-1))  # 0-d keeps its shape below
        header[name] = {"dtype": kind, "shape": list(np.shape(tensors[name])),
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
