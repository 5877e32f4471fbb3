"""The training views and the evaluation transform, in float32.

The pixels are uint16 canvases of deci-HU shifted by 32768 (HU = (v -
32768) / 10). A training view, per sample: a random window (level uniform
in [-400, 400], width in [800, 2000] HU) mapped to [0, 1]; torchvision's
RandomResizedCrop box (area share uniform in [0.3, 1], log-aspect uniform
in [log 3/4, log 4/3], the first of 10 attempts that fits, else the whole
canvas); the box resampled to ``img_size`` by the antialiased Keys cubic
(a = -0.5, widened by the downscale factor, weights normalised per output
pixel, zero for a sample outside the image); a horizontal flip with
probability 1/2; ImageNet normalisation. Each view draws 25 uniforms per
sample in that order (level, width, 10 areas, 10 aspects, top, left, flip),
(views, batch, 25) at once, from a CPU ``torch.Generator`` seeded with the
64 bits of ``numpy.random.SeedSequence([train_seed, step, micro_batch, 0])``:
the stream rule that the program states for its augmentation.

The evaluation transform: the fixed window (level 40, width 400 HU), the
short side resized to ``img_size`` with the same cubic over the whole
image, a centre crop, ImageNet normalisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ATTEMPTS = 10


def stream(*words: int) -> torch.Generator:
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def window(pixels: torch.Tensor, level: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    hu = (pixels.float() - 32768.0) * 0.1
    return ((hu - (level - width / 2.0)) / width.clamp_min(1.0)).clamp(0.0, 1.0)


def normalise(x: torch.Tensor) -> torch.Tensor:
    return (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)


def cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' kernel, a = -0.5, of |x|."""
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def resample_weights(in_size: int, pos: torch.Tensor, widen: torch.Tensor) -> torch.Tensor:
    """(count, out, in) weights of the sample positions *pos* (count, out)."""
    grid = torch.arange(in_size, dtype=torch.float32, device=pos.device)
    w = cubic((pos[:, :, None] - grid).abs() / widen[:, None, None])
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total == 0, torch.ones_like(total), total), torch.zeros_like(w))
    inside = (pos >= -0.5) & (pos <= in_size - 0.5)
    return w * inside[:, :, None]


def box_weights(in_size: int, out_size: int, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Weights that resample [start, start + length) of *in_size* to *out_size*."""
    step = length / out_size
    pos = ((torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5) * step[:, None]
           + start[:, None] - 0.5)
    return resample_weights(in_size, pos, step.clamp_min(1.0))


def crop_boxes(u: torch.Tensor, h: int, w: int, scale: tuple[float, float]):
    """(top, left, height, width) from the (count, 25) uniforms."""
    area = h * w * (scale[0] + u[:, 2:2 + ATTEMPTS] * (scale[1] - scale[0]))
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    aspect = torch.exp(lo + u[:, 2 + ATTEMPTS:2 + 2 * ATTEMPTS] * (hi - lo))
    cw, ch = torch.sqrt(area * aspect), torch.sqrt(area / aspect)
    fits = (cw <= w) & (ch <= h)
    first = fits.int().argmax(1, keepdim=True)
    found = fits.any(1)
    ratio = w / h
    fw = float(w) if 3 / 4 <= ratio <= 4 / 3 else (w if ratio < 3 / 4 else h * 4 / 3)
    fh = float(h) if 3 / 4 <= ratio <= 4 / 3 else (w / (3 / 4) if ratio < 3 / 4 else h)
    cw = torch.where(found, cw.gather(1, first)[:, 0], torch.full_like(u[:, 0], fw))
    ch = torch.where(found, ch.gather(1, first)[:, 0], torch.full_like(u[:, 0], fh))
    top = torch.where(found, u[:, 22] * (h - ch), (h - ch) / 2.0)
    left = torch.where(found, u[:, 23] * (w - cw), (w - cw) / 2.0)
    return top, left, ch, cw


def training_views(pixels: torch.Tensor, u: torch.Tensor, img_size: int,
                   scale: tuple[float, float] = (0.3, 1.0)) -> torch.Tensor:
    """(B, H, W, 3) uint16 and (views, B, 25) uniforms -> (views * B, S, S, 3)."""
    b, h, w, c = pixels.shape
    out = []
    for uv in u.to(pixels.device):
        level = -400.0 + uv[:, 0] * 800.0
        width = 800.0 + uv[:, 1] * 1200.0
        x = window(pixels, level[:, None, None, None], width[:, None, None, None])
        top, left, ch, cw = crop_boxes(uv, h, w, scale)
        rows = box_weights(h, img_size, top, ch)   # (B, S, H)
        cols = box_weights(w, img_size, left, cw)  # (B, S, W)
        x = torch.einsum("bsh,bhwc->bswc", rows, x)
        x = torch.einsum("btw,bswc->bstc", cols, x)
        x = torch.where((uv[:, 24] < 0.5)[:, None, None, None], x.flip(2), x)
        out.append(normalise(x))
    return torch.cat(out)


def eval_view(pixels: torch.Tensor, img_size: int) -> torch.Tensor:
    """(B, H, W, 3) uint16 -> (B, S, S, 3): the fixed window, the short side
    resized to *img_size*, the centre crop."""
    x = window(pixels, torch.tensor(40.0), torch.tensor(400.0))
    b, h, w, c = x.shape
    scale = img_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)

    def weights(size: int, new: int) -> torch.Tensor:
        step = 1.0 / (new / size)
        first = (new - img_size) // 2
        pos = (torch.arange(first, first + img_size, dtype=torch.float32, device=x.device) + 0.5) * step - 0.5
        return resample_weights(size, pos[None], torch.tensor([max(step, 1.0)], device=x.device))[0]

    x = torch.einsum("sh,bhwc->bswc", weights(h, nh), x)
    x = torch.einsum("tw,bswc->bstc", weights(w, nw), x)
    return normalise(x)
