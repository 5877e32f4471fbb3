"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: no device
means ``cuda``, and with no CUDA device that raises instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if a CUDA device is asked for and absent.
    On CUDA, float32 matmuls and convolutions are set to full float32 (no TF32)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
