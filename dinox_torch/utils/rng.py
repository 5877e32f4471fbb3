"""Explicit random streams: a ``torch.Generator`` seeded from a tuple of
integers (a seed and the step, micro-batch, stream or batch it serves), so
every draw of the port is a pure function of those numbers."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(*words: int, device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on *device* seeded with 64 bits of ``SeedSequence(words)``."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))
