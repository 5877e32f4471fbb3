"""A scale-aware ViT with registers and its DINO head, in float32, over a
dict of named float32 tensors (the timm-style names: ``patch_embed.*``,
``cls_token``, ``pos_embed``, ``registers``, ``scale_embed.mlp.{0,2,3}.*``,
``blocks.<i>.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}.*``,
``norm.*``; the head's ``head.0.*`` and ``head.2.*``).

The architecture (DINOv2 with registers, arXiv:2304.07193 and
arXiv:2309.16588, plus a scale token): NHWC images cut into non-overlapping
patches and projected; [CLS, patches] plus the learned positions; the scale
token, ``LN(W2 GELU(W1 spacing))``, added to CLS and the patches; the
registers appended; pre-norm blocks ``x + proj(attn(LN1 x))``,
``x + fc2(GELU(fc1(LN2 x)))`` with softmax(q k^T / sqrt(hd)) attention over
a packed [q | k | v] projection; a final LayerNorm. LayerNorms take
epsilon 1e-5. The MLP's GELU is the tanh form when ``gelu_approx`` is set,
the exact one otherwise; the scale token and the head use the exact one.
The head is ``dim -> dim -> GELU -> out_dim`` on CLS.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
EPS = 1e-5


def linear(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str, mm: Mm) -> torch.Tensor:
    return mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def layer_norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], EPS)


def attention(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str, heads: int,
              mm: Mm) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // heads
    q, k, v = linear(x, p, f"{name}.qkv", mm).view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    o = mm(torch.softmax(s, dim=-1), v)
    return linear(o.transpose(1, 2).reshape(b, n, d), p, f"{name}.proj", mm)


def block(x: torch.Tensor, p: Mapping[str, torch.Tensor], i: int, model: Mapping[str, Any],
          mm: Mm) -> torch.Tensor:
    pre = f"blocks.{i}"
    x = x + attention(layer_norm(x, p, f"{pre}.norm1"), p, f"{pre}.attn", model["heads"], mm)
    h = linear(layer_norm(x, p, f"{pre}.norm2"), p, f"{pre}.mlp.fc1", mm)
    h = F.gelu(h, approximate="tanh" if model.get("gelu_approx", True) else "none")
    return x + linear(h, p, f"{pre}.mlp.fc2", mm)


def scale_token(spacing: torch.Tensor, p: Mapping[str, torch.Tensor], mm: Mm) -> torch.Tensor:
    h = F.gelu(linear(spacing, p, "scale_embed.mlp.0", mm))
    return layer_norm(linear(h, p, "scale_embed.mlp.2", mm), p, "scale_embed.mlp.3")[:, None, :]


def tokens(x: torch.Tensor, spacing: Optional[torch.Tensor], p: Mapping[str, torch.Tensor],
           model: Mapping[str, Any], mm: Mm = torch.matmul, checkpoint: bool = False) -> torch.Tensor:
    """(B, H, W, 3) float32 images and (B, 3) spacing -> all tokens (B, N, dim)
    after the final norm, token order [CLS, patches, registers]."""
    b, h, w, c = x.shape
    pt, d = model["patch"], model["dim"]
    t = x.reshape(b, h // pt, pt, w // pt, pt, c).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, pt * pt * c)
    wpe = p["patch_embed.weight"].permute(0, 2, 3, 1).reshape(d, -1)
    t = mm(t, wpe.t()) + p["patch_embed.bias"]
    t = torch.cat([p["cls_token"].expand(b, -1, -1), t], dim=1) + p["pos_embed"]
    if model.get("scale_aware") and spacing is not None:
        t = t + scale_token(spacing, p, mm)
    if model.get("num_registers", 0) > 0:
        t = torch.cat([t, p["registers"].expand(b, -1, -1)], dim=1)
    for i in range(model["depth"]):
        if checkpoint and torch.is_grad_enabled():
            t = torch.utils.checkpoint.checkpoint(block, t, p, i, model, mm, use_reentrant=False)
        else:
            t = block(t, p, i, model, mm)
    return layer_norm(t, p, "norm")


def head(cls: torch.Tensor, p: Mapping[str, torch.Tensor], mm: Mm = torch.matmul) -> torch.Tensor:
    return linear(F.gelu(linear(cls, p, "head.0", mm)), p, "head.2", mm)


def strip(p: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The tensors under *prefix*, with it taken off their names."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
