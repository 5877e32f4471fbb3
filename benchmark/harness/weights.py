"""Weights and inputs made from the seed, on the device, in a few large
calls: one normal draw for all the weights, then a scale per tensor by its
name and shape. Streams of one seed are told apart by a second word."""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

WEIGHTS, PIXELS, SPACING, ORDER, SAMPLE, TEACHER = range(6)


def generator(seed: int, stream: int, device: torch.device | str) -> torch.Generator:
    """A generator on *device* seeded with 64 bits of ``SeedSequence([seed, stream])``."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def scale(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """(mean, std) of the tensor *name*: a matrix or patch filter
    Glorot-normal over its fan-in and fan-out; the class token and the
    registers 0.02 and the positions 0.1 (the program's initial scales); a
    norm's gain 1 and every bias about 0, each with a spread of 0.02, as
    after some training."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("cls_token", "registers"):
        return 0.0, 0.02
    if leaf == "pos_embed":
        return 0.0, 0.1
    if len(shape) >= 2:
        fan_in, fan_out = math.prod(shape[1:]), shape[0]
        return 0.0, math.sqrt(2.0 / (fan_in + fan_out))
    return (1.0 if leaf == "weight" else 0.0), 0.02


def make(shapes: Mapping[str, tuple[int, ...]], seed: int, device: torch.device | str,
         stream: int = WEIGHTS) -> dict[str, torch.Tensor]:
    """float32 tensors of *shapes* (in their order) from *seed*'s *stream*."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=generator(seed, stream, device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = scale(name, tuple(shape))
        out[name] = (z[at:at + n].view(shape) * std + mean)
        at += n
    return out


def canvases(gen: torch.Generator, count: int, size: int, lo: int, hi: int,
             device: torch.device | str) -> torch.Tensor:
    """(count, size, size, 3) uint16 canvases, integers uniform in [lo, hi)."""
    x = torch.randint(lo, hi, (count, size, size, 3), generator=gen, device=device, dtype=torch.int32)
    return x.to(torch.int16).view(torch.uint16)


def spacings(gen: torch.Generator, count: int, pixel: tuple[float, float],
             thickness: tuple[float, float], device: torch.device | str) -> torch.Tensor:
    """(count, 3) float32: the in-plane spacing (x = y) and the slice thickness, mm."""
    u = torch.rand((count, 2), generator=gen, device=device)
    px = pixel[0] + u[:, 0] * (pixel[1] - pixel[0])
    th = thickness[0] + u[:, 1] * (thickness[1] - thickness[0])
    return torch.stack([px, px, th], dim=1)
