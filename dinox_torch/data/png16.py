"""16-bit grey PNG codec of the port: a native decoder, a stdlib decoder and
an encoder.

* **Native.** A ctypes binding to ``native/png16.cc`` (inflate and unfilter
  in C++ with zlib). ctypes releases the GIL, so the loader's thread pool
  decodes in parallel. The library is compiled at first use with ``g++
  -O3 -shared -fPIC ... -lz`` into ``build/dinox_torch_native/`` (listed in
  ``.gitignore``), named by a hash of the source and the flags. One process
  builds while the others wait on an ``fcntl`` lock; the library is written
  under a temporary name and renamed into place, so no process ever loads a
  half-written file. Nothing runs ``make`` in ``native/``.
* **Stdlib.** ``zlib`` plus numpy, for non-interlaced grey PNGs at 8 or 16
  bits with any of the five filter types: what the JAX package's PIL
  fallback reads, on a machine without PIL.
* **Encoder.** :func:`write_png16` writes grey PNGs at 8 or 16 bits with a
  chosen filter type per row.

:func:`read_png16` tries the native decoder, then the stdlib one (the order
of the JAX package's reader); :func:`decoder_in_use` names the first.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

log = logging.getLogger(__name__)

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "png16.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dinox_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
PNG16_OK = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _target() -> Path:
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpng16-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile the decoder into *target* unless another process has: one
    process at a time under a file lock, the library renamed into place."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC), "-lz"],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native decoder's library, built first if needed; None where it
    cannot be built or loaded (no g++ or zlib headers)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            target = _target()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.SubprocessError) as e:
            log.info("native png decoder unavailable (%s); using the stdlib decoder", e)
            _lib_failed = True
            return None
        lib.png16_decode.restype = ctypes.c_int
        lib.png16_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]
        lib.png16_header.restype = ctypes.c_int
        lib.png16_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
                                     ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
    return _lib


def decoder_in_use() -> str:
    """The decoder :func:`read_png16` tries first."""
    if get_lib() is not None:
        return "native (native/png16.cc, g++ + zlib, ctypes)"
    return "stdlib (zlib + numpy)"


def decode_native(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W) uint16 by the native decoder, or None where it is
    absent or does not take this file."""
    lib = get_lib()
    if lib is None:
        return None
    w, h, depth = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    if lib.png16_header(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(depth)) != PNG16_OK:
        return None
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.png16_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                          out.size)
    return out if rc == PNG16_OK else None


def _chunks(data: bytes):
    pos = len(PNG_MAGIC)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError("PNG chunk runs past the end of the file")
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(kind: int, x: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return x
    if kind == 1:  # Sub: a running sum (mod 256) along each byte lane
        return np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:
        return x + prev
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    # Average and Paeth depend on the decoded byte to the left: one pass.
    xs, up, cur = x.tolist(), prev.tolist(), [0] * len(x)
    for i in range(len(xs)):
        left = cur[i - bpp] if i >= bpp else 0
        if kind == 3:
            cur[i] = (xs[i] + ((left + up[i]) >> 1)) & 255
        else:
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
            cur[i] = (xs[i] + pred) & 255
    return np.asarray(cur, np.uint8)


def decode_stdlib(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint16 with zlib and numpy: non-interlaced grey at
    8 or 16 bits (8-bit values widened). Raises ValueError otherwise."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR of the wrong length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"unsupported PNG: color type {color}, depth {depth}, interlace {interlace}")
    bpp, stride = depth // 8, w * (depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if len(raw) != (stride + 1) * h:
        raise ValueError("PNG data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    if depth == 8:
        return out.astype(np.uint16)
    return out.view(">u2").astype(np.uint16)


def read_png16(path: Union[str, Path]) -> np.ndarray:
    """Decode a grey PNG file to (H, W) uint16: native first, then stdlib."""
    data = Path(path).read_bytes()
    native = decode_native(data)
    return native if native is not None else decode_stdlib(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png16(path: Union[str, Path], arr: np.ndarray, filters: Union[int, Sequence[int]] = 0) -> None:
    """Write (H, W) *arr* as a grey PNG: 16-bit for uint16, 8-bit for uint8.
    *filters* is one filter type (0-4) for every row or one per row."""
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png16 takes a 2-D uint8 or uint16 array, got {arr.dtype} {arr.shape}")
    h, w = arr.shape
    depth = 8 * arr.dtype.itemsize
    bpp = depth // 8
    x = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).view(np.uint8)
    x = x.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    kinds = np.broadcast_to(np.asarray(filters, np.int16), (h,))
    if not np.isin(kinds, (0, 1, 2, 3, 4)).all():
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(kinds.tolist()))}")
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    filtered = (x - preds[kinds, np.arange(h)]) & 255
    payload = np.concatenate([kinds[:, None], filtered], axis=1).astype(np.uint8).tobytes()
    png = (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(payload, 6)) + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)
