"""The embedding path in float32: the evaluation transform, the backbone
forward, CLS, L2-normalised."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from reference import augment, vit
from reference.vit import Mm


@torch.no_grad()
def embed(pixels: torch.Tensor, spacing: Optional[torch.Tensor], params: Mapping[str, torch.Tensor],
          model: Mapping[str, Any], mm: Mm = torch.matmul, rows: int = 64) -> torch.Tensor:
    """(L, H, W, 3) uint16 slices and their (L, 3) spacing -> (L, dim)
    unit CLS vectors, *rows* slices at a time (only to bound memory)."""
    out = []
    for s in range(0, len(pixels), rows):
        x = augment.eval_view(pixels[s:s + rows], model["img_size"])
        sp = None if spacing is None else spacing[s:s + rows].float()
        out.append(vit.tokens(x, sp, params, model, mm)[:, 0])
    cls = torch.cat(out)
    return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-12)
