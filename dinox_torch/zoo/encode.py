"""Zero-preprocessing encode() API: raw HU array + spacing in, features out.

The same input formats ('hu_float', 'hu16_png', 'windowed_float'), default
L=40/W=400 window, channel handling for (H, W) / (H, W, 3) / (3, H, W),
bilinear resize, ImageNet normalisation and CLS-or-all-tokens output as
``dinox_tpu.zoo.encode``. The resize reproduces PIL's
``Image.resize(..., BILINEAR)`` on a mode-"F" image in numpy (PIL is not
needed).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Literal, Sequence

import numpy as np
import torch

from dinox_torch.data.hu import HU_SCALE, HU_SHIFT, IMAGENET_MEAN, IMAGENET_STD
from dinox_torch.zoo.hub import LoadedModel

InputFormat = Literal["hu_float", "hu16_png", "windowed_float"]


def _to_hu(arr: np.ndarray, input_format: str) -> np.ndarray:
    if input_format == "hu_float":
        return arr.astype(np.float32)
    if input_format == "hu16_png":
        return (arr.astype(np.float32) - HU_SHIFT) * HU_SCALE
    if input_format == "windowed_float":
        return arr.astype(np.float32)
    raise ValueError(
        f"Unknown input_format: '{input_format}'. "
        "Supported: 'hu_float', 'hu16_png', 'windowed_float'"
    )


def _window(arr: np.ndarray, level: float, width: float) -> np.ndarray:
    lo, hi = level - width / 2.0, level + width / 2.0
    return (np.clip(arr, lo, hi) - lo) / (hi - lo)


def _split_channels(arr: np.ndarray) -> list[np.ndarray]:
    if arr.ndim == 2:
        return [arr, arr, arr]
    if arr.ndim == 3 and arr.shape[2] == 3:
        return [arr[:, :, i] for i in range(3)]
    if arr.ndim == 3 and arr.shape[0] == 3:
        return [arr[i] for i in range(3)]
    raise ValueError(
        f"Unsupported image shape: {arr.shape}. Expected (H, W), (H, W, 3), or (3, H, W)."
    )


@lru_cache(maxsize=32)
def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """PIL's bilinear resampling matrix (out_size, in_size), float64: a
    triangle filter whose support stretches by the scale factor when
    downsampling, sampled at pixel centres (i + 0.5) * scale, each row
    normalised (PIL Resample.c, precompute_coeffs)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear support 1.0, stretched
    inv = 1.0 / filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        k = np.maximum(0.0, 1.0 - np.abs((np.arange(lo, hi) - center + 0.5) * inv))
        total = k.sum()
        w[i, lo:hi] = k / total if total != 0.0 else k
    w.setflags(write=False)
    return w


def _resize(arr: np.ndarray, size: int) -> np.ndarray:
    """(H, W) float plane -> (size, size) float32, as PIL's BILINEAR resize of
    a mode-"F" image: horizontal pass first, each pass accumulating in double
    and storing float32."""
    arr = np.asarray(arr, np.float32)
    wy = _bilinear_weights(arr.shape[0], size)
    wx = _bilinear_weights(arr.shape[1], size)
    tmp = (arr.astype(np.float64) @ wx.T).astype(np.float32)
    return (wy @ tmp.astype(np.float64)).astype(np.float32)


def _preprocess(
    image: np.ndarray,
    img_size: int,
    input_format: str,
    hu_level: float,
    hu_width: float,
) -> np.ndarray:
    """One image -> (img_size, img_size, 3) float32, ImageNet-normalized."""
    if input_format == "windowed_float":
        arr = image.astype(np.float32)
    else:
        arr = _window(_to_hu(image, input_format), hu_level, hu_width)
    planes = [_resize(ch, img_size) for ch in _split_channels(arr)]
    x = np.stack(planes, axis=-1).astype(np.float32)  # NHWC
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def encode(
    model: LoadedModel,
    image: np.ndarray,
    pixel_spacing: tuple[float, float] = (1.0, 1.0),
    slice_thickness: float = 1.0,
    *,
    input_format: InputFormat = "hu_float",
    hu_level: float = 40.0,
    hu_width: float = 400.0,
    return_all_tokens: bool = False,
) -> torch.Tensor:
    """Encode one slice (or 3-slice stack): (1, dim) CLS features, or
    (1, N, dim) all tokens when *return_all_tokens*."""
    x = _preprocess(image, model.img_size, input_format, hu_level, hu_width)[None]
    spacing = None
    if model.scale_aware:
        spacing = np.asarray([[pixel_spacing[0], pixel_spacing[1], slice_thickness]], np.float32)
    feats = model(x, spacing)
    return feats if return_all_tokens else feats[:, 0, :]


def encode_batch(
    model: LoadedModel,
    images: Sequence[np.ndarray],
    spacings: Sequence[tuple[float, float, float]],
    *,
    input_format: InputFormat = "hu_float",
    hu_level: float = 40.0,
    hu_width: float = 400.0,
    return_all_tokens: bool = False,
    batch_size: int = 64,
) -> torch.Tensor:
    """Batched encode: (B, dim) CLS features or (B, N, dim) all tokens, up to
    *batch_size* images per forward."""
    if len(images) != len(spacings):
        raise ValueError(
            f"images ({len(images)}) and spacings ({len(spacings)}) must have same length"
        )
    chunks = []
    for i in range(0, len(images), batch_size):
        xs = np.stack([
            _preprocess(img, model.img_size, input_format, hu_level, hu_width)
            for img in images[i: i + batch_size]
        ])
        spacing = None
        if model.scale_aware:
            spacing = np.asarray(spacings[i: i + batch_size], np.float32)
        feats = model(xs, spacing)
        chunks.append(feats if return_all_tokens else feats[:, 0, :])
    return torch.cat(chunks, dim=0)
