"""8-bit grayscale images for the training monitor, without PIL: a mode "L"
PNG writer and the two resizes the JAX package's monitor asks PIL for.

* :func:`write_png8` writes a (H, W) uint8 array as an 8-bit grayscale
  PNG (zlib, filter 0), the file PIL writes for a mode "L" image.
* :func:`resize_bicubic` is PIL's default ``Image.resize`` of a mode "L"
  image: the bicubic filter (a = -0.5) widened by the downscale factor
  (PIL's antialiasing support), coefficients normalised per output pixel
  and fixed to 22 fractional bits, a horizontal pass rounded and clipped to
  uint8, then a vertical pass on that, as Pillow's ``Resample.c`` computes
  it.
* :func:`resize_nearest` is ``Image.resize(..., Image.NEAREST)``: output
  pixel x reads input ``floor(x0)``, x0 stepping from half a scale by one
  scale in double precision, as Pillow's ``ImagingScaleAffine`` does.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Union

import numpy as np

from dinox_torch.data.png16 import write_png16

PRECISION_BITS = 32 - 8 - 2


def write_png8(path: Union[str, Path], arr: np.ndarray) -> None:
    """Write (H, W) uint8 *arr* as an 8-bit grayscale PNG."""
    if arr.ndim != 2 or arr.dtype != np.uint8:
        raise ValueError(f"write_png8 takes a 2-D uint8 array, got {arr.dtype} {arr.shape}")
    write_png16(path, arr)


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(input index (out, k), fixed-point weights (out, k)) of one axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            k = v / total if total != 0.0 else v
            weight[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << PRECISION_BITS))
            index[xx, x] = xmin + x
    return index, weight


def _pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample the last axis of uint8 *img* to *out_size*, rounded and
    clipped to uint8."""
    index, weight = _coeffs(img.shape[-1], out_size)
    acc = (img[..., index].astype(np.int64) * weight).sum(axis=-1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's default resize of a (H, W) uint8 image to *size* (width, height)."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pass(out, w)
    if h != img.shape[0]:
        out = _pass(out.T, h).T
    return np.ascontiguousarray(out)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    x0, index = step * 0.5, []
    for _ in range(out_size):
        index.append(min(int(x0), in_size - 1))
        x0 += step
    return np.asarray(index)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's NEAREST resize of a (H, W) image to *size* (width, height)."""
    w, h = size
    return np.ascontiguousarray(img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)])
