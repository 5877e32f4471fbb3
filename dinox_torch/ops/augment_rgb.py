"""RGB (CIFAR-style) two-view augmentation on the card: the counterpart of
``dinox_tpu.ops.augment_rgb``.

Per image and view: a RandomResizedCrop box (scale 0.5-1.0, the port's
:func:`dinox_torch.ops.augment._sample_crop_box`), the antialiased Keys
cubic resample of the box (:func:`dinox_torch.ops.augment._crop_resize`),
a clip to [0, 1], a horizontal flip (p 0.5), colour jitter (brightness,
contrast, saturation, hue) applied with p 0.8, grayscale with p 0.2 and
the CIFAR normalisation.

The colour arithmetic is the JAX package's: the contrast mean is the mean
luma of one image; the hue is a rotation of the (I, Q) plane with that
package's two YIQ matrices (which are not exact inverses of each other)
by ``uniform(-hue, hue) * 2 pi``. Each product with a 3-vector is a
weighted sum of the three channels, never a matmul, so that the card
rounds it as the CPU does.

Randomness: jax.random's streams cannot be reproduced, so each (view,
image) takes a fixed block of uniforms from an explicit ``torch.Generator``
(:data:`DRAWS` of them: 10 areas, 10 aspects, top, left, flip, jitter
apply, the four jitter factors, grayscale), and :func:`views_from_draws`
is the deterministic rest, so a test can feed it JAX's draws. A coin with
probability p is ``u < p``, as ``jax.random.bernoulli`` is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from dinox_torch.ops.augment import AugConfig, _crop_resize, _sample_crop_box

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
_LUMA = (0.299, 0.587, 0.114)
_TO_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_FROM_YIQ = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


@dataclass(frozen=True)
class RgbAugConfig:
    img_size: int = 32
    crop_scale_min: float = 0.5
    crop_scale_max: float = 1.0
    hflip_prob: float = 0.5
    jitter_prob: float = 0.8
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.2
    hue: float = 0.1
    grayscale_prob: float = 0.2
    n_views: int = 2

    @property
    def crop_cfg(self) -> AugConfig:
        return AugConfig(img_size=self.img_size, crop_scale_min=self.crop_scale_min,
                         crop_scale_max=self.crop_scale_max)


_ATTEMPTS = 10
# Offsets into one (view, image) block of uniforms.
AREA, ASPECT = 0, _ATTEMPTS
TOP, LEFT, FLIP, JITTER_APPLY = 2 * _ATTEMPTS, 2 * _ATTEMPTS + 1, 2 * _ATTEMPTS + 2, 2 * _ATTEMPTS + 3
JITTER = 2 * _ATTEMPTS + 4  # brightness, contrast, saturation, hue
GRAY = JITTER + 4
DRAWS = GRAY + 1


def _dot3(x: torch.Tensor, w: tuple[float, float, float]) -> torch.Tensor:
    """``x @ w`` over the last axis of length 3, as a weighted channel sum."""
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def _factor(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its [0, 1) draw *u*."""
    return u * (hi - lo) + lo


def _color_jitter(x: torch.Tensor, u: torch.Tensor, cfg: RgbAugConfig) -> torch.Tensor:
    """Colour jitter of (V, S, S, 3) images in [0, 1] with the uniforms *u*
    (V, 4): brightness, contrast and saturation as factors, hue as a
    rotation about the luma axis; clipped to [0, 1]."""
    b = _factor(u[:, 0], 1 - cfg.brightness, 1 + cfg.brightness)[:, None, None, None]
    c = _factor(u[:, 1], 1 - cfg.contrast, 1 + cfg.contrast)[:, None, None, None]
    s = _factor(u[:, 2], 1 - cfg.saturation, 1 + cfg.saturation)[:, None, None, None]
    h = _factor(u[:, 3], -cfg.hue, cfg.hue) * 2.0 * math.pi

    x = x * b
    gray_mean = _dot3(x, _LUMA).mean(dim=(1, 2))[:, None, None, None]  # per image
    x = gray_mean + (x - gray_mean) * c
    gray = _dot3(x, _LUMA)[..., None]
    x = gray + (x - gray) * s
    y, i, q = (_dot3(x, row) for row in _TO_YIQ)
    cos_h, sin_h = torch.cos(h)[:, None, None], torch.sin(h)[:, None, None]
    yiq = torch.stack([y, cos_h * i - sin_h * q, sin_h * i + cos_h * q], dim=-1)
    rgb = torch.stack([_dot3(yiq, row) for row in _FROM_YIQ], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def normalize_cifar(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CIFAR_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def views_from_draws(images: torch.Tensor, u: torch.Tensor, cfg: RgbAugConfig) -> torch.Tensor:
    """The deterministic view pipeline: (V, H, W, 3) images (uint8 or float)
    and their uniforms *u* (V, DRAWS) -> (V, S, S, 3) float32, normalised:
    crop -> clip -> flip -> jitter (computed for every image, then
    selected) -> grayscale -> CIFAR normalisation."""
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    box = _sample_crop_box(u[:, AREA:AREA + _ATTEMPTS], u[:, ASPECT:ASPECT + _ATTEMPTS],
                           u[:, TOP], u[:, LEFT], h, w, cfg.crop_cfg)
    x = torch.clamp(_crop_resize(x, *box, cfg.img_size), 0.0, 1.0)
    x = torch.where((u[:, FLIP] < cfg.hflip_prob)[:, None, None, None], x.flip(2), x)
    jittered = _color_jitter(x, u[:, JITTER:JITTER + 4], cfg)
    x = torch.where((u[:, JITTER_APPLY] < cfg.jitter_prob)[:, None, None, None], jittered, x)
    gray = _dot3(x, _LUMA)[..., None].expand_as(x)
    x = torch.where((u[:, GRAY] < cfg.grayscale_prob)[:, None, None, None], gray, x)
    return normalize_cifar(x)


def augment_rgb_views(pixels, generator: torch.Generator,
                      cfg: RgbAugConfig = RgbAugConfig()) -> torch.Tensor:
    """Batched multi-view augmentation: (B, H, W, 3) uint8 or float pixels
    (a tensor on the device the views are made on, or a numpy array, taken
    to the CPU) -> (n_views, B, S, S, 3) float32. *generator* is a CPU
    ``torch.Generator``; it gives (n_views, B, DRAWS) uniforms."""
    pixels = torch.as_tensor(pixels)
    b = pixels.shape[0]
    u = torch.rand((cfg.n_views, b, DRAWS), generator=generator).to(pixels.device)
    images = pixels.unsqueeze(0).expand(cfg.n_views, *pixels.shape).reshape(-1, *pixels.shape[1:])
    out = views_from_draws(images, u.reshape(-1, DRAWS), cfg)
    return out.view(cfg.n_views, b, *out.shape[1:])


def cifar_eval_transform(pixels) -> torch.Tensor:
    """uint8 (B, 32, 32, 3) -> normalised float32 (deterministic), on the
    pixels' device (a numpy array stays on the CPU)."""
    return normalize_cifar(torch.as_tensor(pixels).to(torch.float32) / 255.0)
