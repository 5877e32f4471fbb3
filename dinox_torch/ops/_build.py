"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``ops/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and :func:`launch` calls its entry points on PyTorch's current
stream. Libraries land in ``build/dinox_torch_kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source, every
``csrc/*.cuh`` header and the flags, so an edited source or shared header
rebuilds and an unchanged one is reused. A failed build raises with nvcc's
stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dinox_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: Path) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for *src* unless its library is already built."""
    target = _target(src)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return target, tmp, proc


def _finish(target: Path, tmp: Path, proc: subprocess.Popen) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {target.stem} (exit {proc.returncode}):\n{err}{out}")
    target.with_suffix(".log").write_text(err + out)
    os.replace(tmp, target)  # atomic: a concurrent process sees the old library or the new, never half


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> dict[str, Path]:
    """Compile every kernel source, one nvcc per source, all started together.
    Returns {kernel name: library path}."""
    with _lock:
        pending = [p for p in (_start(src) for src in sources()) if p is not None]
        for target, tmp, proc in pending:
            _finish(target, tmp, proc)
    return {src.stem: _target(src) for src in sources()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    with _lock:
        if name not in _libs:
            started = _start(src)
            if started is not None:
                _finish(*started)
            _libs[name] = ctypes.CDLL(str(_target(src)))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's (ptxas -v) report from the build of ``csrc/<name>.cu``."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_operands(operands: dict, device: torch.device, align: int, kernel: str) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` of *operands* has
    that shape and dtype, lies on *device*, is contiguous and starts on an
    *align*-byte boundary: what a kernel taking raw pointers needs."""
    for name, (t, shape, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"the {kernel} kernel takes {dtype} {name}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def launch(name: str, symbol: str, argtypes: list, device: torch.device, *args) -> None:
    """Call the C entry point *symbol* of ``csrc/<name>.cu`` with *args* and
    the current CUDA stream of *device* (the last of *argtypes*). Every entry
    point returns its launch's cudaError_t; raise unless it is 0."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def query(name: str, symbol: str, args: tuple[int, ...], device) -> tuple[int, int, int]:
    """Call the C query *symbol* of ``csrc/<name>.cu``, which takes the int
    *args* and writes three ints (an occupancy or a grid), on *device*;
    raise unless it returns 0."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(*args, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    return tuple(v.value for v in vals)
