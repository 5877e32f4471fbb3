"""Two-view training augmentation and the deterministic eval transform on the
card: the counterpart of ``dinox_tpu.ops.augment`` (``augment_views``,
``eval_transform``).

Per sample and view: a random deci-HU window, a RandomResizedCrop box
(torchvision's rule: the first of 10 attempts that fits, else the
aspect-clamped centre crop), a cubic resample of the box to ``img_size``,
a horizontal flip, ImageNet normalisation. The resample is the JAX
package's ``jax.image.scale_and_translate(method="cubic", antialias=True)``:
the Keys kernel with a = -0.5, widened by ``max(1/scale, 1)`` when
downscaling, weights normalised per output pixel and zero where the sample
falls outside the image. It is written as explicit (views, S, H) row and
(views, S, W) column weight matrices applied with batched matmuls
(``F.interpolate(mode="bicubic")`` uses a = -0.75 and no antialias).

Randomness comes from an explicit ``torch.Generator`` (on the CPU; the few
numbers per sample are copied to the card). jax.random's streams cannot be
reproduced, so the tests compare the sampler by its statistics and the
resampling at given boxes.

:func:`eval_transform` is the fixed window, a resize of the short side to
``img_size`` with the same antialiased cubic (``jax.image.resize(...,
"cubic")``: the box is the whole image), a centre crop and the
normalisation. Only the rows and columns the crop keeps are computed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from dinox_torch.data.hu import (
    EVAL_LEVEL,
    EVAL_WIDTH,
    HU_SCALE,
    HU_SHIFT,
    IMAGENET_MEAN,
    IMAGENET_STD,
    RW_LEVEL_MAX,
    RW_LEVEL_MIN,
    RW_WIDTH_MAX,
    RW_WIDTH_MIN,
)
from dinox_torch.utils.tracing import span

_CROP_ATTEMPTS = 10


@dataclass(frozen=True)
class AugConfig:
    """Augmentation hyperparameters (the reference training recipe)."""

    img_size: int = 224
    level_min: float = RW_LEVEL_MIN
    level_max: float = RW_LEVEL_MAX
    width_min: float = RW_WIDTH_MIN
    width_max: float = RW_WIDTH_MAX
    crop_scale_min: float = 0.3
    crop_scale_max: float = 1.0
    aspect_min: float = 3.0 / 4.0
    aspect_max: float = 4.0 / 3.0
    hflip_prob: float = 0.5
    n_views: int = 2


def decode_window(pixels: torch.Tensor, level, width) -> torch.Tensor:
    """uint16 PNG values -> deci-HU -> windowed [0, 1], float32. *level* and
    *width* broadcast against the batch ((B, 1, 1, 1) for per-sample windows)."""
    hu = (pixels.to(torch.float32) - HU_SHIFT) * HU_SCALE
    level = torch.as_tensor(level, dtype=torch.float32, device=hu.device)
    width = torch.as_tensor(width, dtype=torch.float32, device=hu.device)
    lo = level - width / 2.0
    return torch.clamp((hu - lo) / torch.clamp_min(width, 1.0), 0.0, 1.0)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """Channel-last ImageNet normalisation."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + u * (hi - lo)


def _sample_crop_box(u_area: torch.Tensor, u_aspect: torch.Tensor, u_top: torch.Tensor,
                     u_left: torch.Tensor, h: int, w: int, cfg: AugConfig):
    """torchvision RandomResizedCrop.get_params over *count* samples, from
    uniforms in [0, 1): u_area and u_aspect (count, 10), u_top and u_left
    (count,). Returns float32 (top, left, ch, cw), each (count,)."""
    area = h * w * _uniform(u_area, cfg.crop_scale_min, cfg.crop_scale_max)
    aspect = torch.exp(_uniform(u_aspect, math.log(cfg.aspect_min), math.log(cfg.aspect_max)))
    cw = torch.sqrt(area * aspect)
    ch = torch.sqrt(area / aspect)
    ok = (cw <= w) & (ch <= h)
    pick = ok.to(torch.int32).argmax(dim=1, keepdim=True)  # first valid attempt
    any_ok = ok.any(dim=1)

    # Fallback (torchvision): clamp the aspect to the bounds, full-size centre crop.
    in_ratio = w / h
    if in_ratio < cfg.aspect_min:
        fb_w, fb_h = float(w), w / cfg.aspect_min
    elif in_ratio > cfg.aspect_max:
        fb_w, fb_h = h * cfg.aspect_max, float(h)
    else:
        fb_w, fb_h = float(w), float(h)
    cw = torch.where(any_ok, cw.gather(1, pick)[:, 0], torch.full_like(u_top, fb_w))
    ch = torch.where(any_ok, ch.gather(1, pick)[:, 0], torch.full_like(u_top, fb_h))
    top = torch.where(any_ok, u_top * (h - ch), (h - ch) / 2.0)
    left = torch.where(any_ok, u_left * (w - cw), (w - cw) / 2.0)
    return top, left, ch, cw


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(in_size: int, out_size: int, start: torch.Tensor, length: torch.Tensor
                ) -> torch.Tensor:
    """(count, out_size, in_size) resampling weights of the boxes
    [start, start + length), as ``jax.image``'s ``compute_weight_mat`` builds
    them (antialiased Keys cubic), transposed to output-major."""
    scale = out_size / length
    translation = -start * out_size / length
    inv_scale = 1.0 / scale
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)  # (count, out)
    return _keys_weights(in_size, sample_f, torch.clamp_min(inv_scale, 1.0))


def _keys_weights(in_size: int, sample_f: torch.Tensor, kernel_scale: torch.Tensor
                  ) -> torch.Tensor:
    """The weights of the (count, out) sample positions *sample_f* over
    ``in_size`` inputs, the kernel widened by *kernel_scale* (count,):
    normalised per output, zero for a sample outside the input."""
    dev = sample_f.device
    x = torch.abs(sample_f[:, :, None]
                  - torch.arange(in_size, dtype=torch.float32, device=dev)) / kernel_scale[:, None, None]
    weights = _keys_cubic(x)
    total = weights.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights))


def _crop_resize(img: torch.Tensor, top: torch.Tensor, left: torch.Tensor, ch: torch.Tensor,
                 cw: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resample the continuous boxes [top, top+ch) x [left, left+cw) of
    (V, H, W, C) float32 images to (V, out_size, out_size, C)."""
    v, h, w, c = img.shape
    rows = _weight_mat(h, out_size, top, ch)   # (V, S, H)
    cols = _weight_mat(w, out_size, left, cw)  # (V, S, W)
    t = torch.bmm(rows, img.reshape(v, h, w * c))  # (V, S, W*C)
    t = t.view(v, out_size, w, c).transpose(1, 2).reshape(v, w, out_size * c)
    o = torch.bmm(cols, t)  # (V, S_col, S_row*C)
    return o.view(v, out_size, out_size, c).transpose(1, 2)


def draw_rows(generator: torch.Generator, shape: tuple[int, int, int],
              rows: Optional[tuple[int, int, int]]) -> torch.Tensor:
    """Uniforms of *shape* ``(views, b, k)``: drawn for the global batch and
    rows [lo, hi) of axis 1 taken when *rows* = (lo, hi, global_batch)."""
    if rows is None:
        return torch.rand(shape, generator=generator)
    lo, hi, total = rows
    if hi - lo != shape[1]:
        raise ValueError(f"rows {rows} do not match a batch of {shape[1]}")
    return torch.rand((shape[0], total, shape[2]), generator=generator)[:, lo:hi]


# Uniforms drawn per (view, sample): level, width, 10 areas, 10 aspects, top, left, flip.
_DRAWS = 2 + 2 * _CROP_ATTEMPTS + 3


def augment_views(pixels: torch.Tensor, generator: torch.Generator,
                  cfg: AugConfig = AugConfig(),
                  rows: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """Batched multi-view augmentation.

    pixels: (B, H, W, 3) uint16 canvases, on the device the views are made
    on. generator: a CPU ``torch.Generator`` that all randomness comes from.
    *rows* ``(lo, hi, global_batch)``: *pixels* are rows [lo, hi) of a
    global batch (a data-parallel rank's), and the draws are made for the
    global batch and these rows taken, so the views are those of the
    one-process run. Returns (n_views, B, S, S, 3) float32,
    ImageNet-normalised."""
    b, h, w, _ = pixels.shape
    dev = pixels.device
    u = draw_rows(generator, (cfg.n_views, b, _DRAWS), rows).to(dev)
    views = []
    for uv in u:
        level = _uniform(uv[:, 0], cfg.level_min, cfg.level_max)
        width = _uniform(uv[:, 1], cfg.width_min, cfg.width_max)
        x = decode_window(pixels, level[:, None, None, None], width[:, None, None, None])
        a = 2 + _CROP_ATTEMPTS
        box = _sample_crop_box(uv[:, 2:a], uv[:, a:a + _CROP_ATTEMPTS], uv[:, -3], uv[:, -2],
                               h, w, cfg)
        x = _crop_resize(x, *box, cfg.img_size)
        flip = uv[:, -1] < cfg.hflip_prob
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        views.append(normalize_imagenet(x))
    return torch.stack(views)


def eval_transform(pixels: torch.Tensor, img_size: int = 224, level: float = EVAL_LEVEL,
                   width: float = EVAL_WIDTH) -> torch.Tensor:
    """Deterministic eval preprocessing: the fixed deci-HU window (L=40/W=400
    by default), the short side resized to *img_size* (antialiased Keys
    cubic, float32 products), the long side centre-cropped, ImageNet
    normalisation. (B, H, W, 3) uint16 -> (B, S, S, 3) float32, on pixels'
    device."""
    with span("dinox.embed.transform"):
        x = decode_window(pixels, level, width)
        b, h, w, c = x.shape
        scale = img_size / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        top, left = (nh - img_size) // 2, (nw - img_size) // 2

        def weights(size: int, out: int, first: int) -> torch.Tensor:
            # jax.image.resize takes 1 / scale in double precision on the host.
            inv = 1.0 / (out / size)
            sample_f = (torch.arange(first, first + img_size, dtype=torch.float32, device=x.device)
                        + 0.5) * inv - 0.5
            kernel_scale = torch.full((1,), max(inv, 1.0), dtype=torch.float32, device=x.device)
            return _keys_weights(size, sample_f[None], kernel_scale)[0]  # (S, size)

        rows, cols = weights(h, nh, top), weights(w, nw, left)
        t = torch.matmul(rows, x.reshape(b, h, w * c)).view(b, img_size, w, c)  # (B, S, W, C)
        o = torch.matmul(cols, t.transpose(1, 2).reshape(b, w, img_size * c))  # (B, S_col, S_row*C)
        return normalize_imagenet(o.view(b, img_size, img_size, c).transpose(1, 2))
