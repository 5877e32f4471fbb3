"""DINOv3's ViT-7B block stack with the scale token and its DINO head, in
float32, over a dict of named float32 tensors: ``reference/vit.py``'s
architecture with DINOv3's block (arXiv:2508.10104, facebookresearch/dinov3
``vit_7b``) in place of DINOv2's. The names: ``patch_embed.*``,
``cls_token``, ``registers``, ``scale_embed.mlp.{0,2,3}.*``,
``blocks.<i>.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,mlp.w12,mlp.w3,
ls2.gamma}``, ``norm.*``; the head's ``head.0.*`` and ``head.2.*``.

Tokens [CLS, patches, registers]: the patches projected, CLS before them
and no learned positions; the scale token added to CLS and the patches; the
registers appended. Each block, pre-norm::

    h = LN1(x);  [q, k, v] = h W_qkv
    q, k <- q cos + rot(q) sin on the patch tokens, rot(q) = [-q_hi, q_lo]
    x <- x + gamma1 * (softmax(q k^T / sqrt(hd)) v W_o + b_o)
    h = LN2(x);  [u, g] = h W12 + b12
    x <- x + gamma2 * ((silu(u) * g) W3 + b3)

then the final LayerNorm. RoPE (DINOv3's ``RopePositionEmbedding``): the
patch at row r, column c of the G x G grid has ``y = 2 (r + 1/2) / G - 1``
and ``x = 2 (c + 1/2) / G - 1``, both times the rescale factor rho; periods
``100^(2j / (hd/2))``, j < hd/4; angles ``2 pi [y / p, x / p]`` tiled twice
to hd. Everything is float32; where the program rounds (the rotation and the
gate to bf16 once each, the residual update once), the reference does not
round at all.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from reference.vit import Mm, head, layer_norm, linear, scale_token, strip  # noqa: F401 (head, strip: re-exported)

BASE = 100.0  # DINOv3's RoPE base


def rope_tables(grid: int, hd: int, rescale: float = 1.0,
                device: Optional[torch.device] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (grid * grid, hd) float32, the angles tiled twice."""
    c = 2.0 * (torch.arange(0.5, grid, dtype=torch.float32, device=device) / grid) - 1.0
    coords = torch.stack(torch.meshgrid(c, c, indexing="ij"), dim=-1).reshape(-1, 2) * rescale
    periods = BASE ** (2.0 * torch.arange(hd // 4, dtype=torch.float32, device=device) / (hd // 2))
    angles = (2 * math.pi * coords[:, :, None] / periods[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    lo, hi = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-hi, lo], dim=-1) * sin


def attention(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str, heads: int,
              tables: tuple[torch.Tensor, torch.Tensor], mm: Mm) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // heads
    q, k, v = mm(x, p[f"{name}.qkv.weight"].t()).view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    cos, sin = tables
    patches = slice(1, 1 + cos.shape[0])
    q = torch.cat([q[:, :, :1], rotate(q[:, :, patches], cos, sin), q[:, :, patches.stop:]], dim=2)
    k = torch.cat([k[:, :, :1], rotate(k[:, :, patches], cos, sin), k[:, :, patches.stop:]], dim=2)
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    o = mm(torch.softmax(s, dim=-1), v)
    return linear(o.transpose(1, 2).reshape(b, n, d), p, f"{name}.proj", mm)


def mlp(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str, mm: Mm) -> torch.Tensor:
    u, g = linear(x, p, f"{name}.w12", mm).chunk(2, dim=-1)
    return linear(F.silu(u) * g, p, f"{name}.w3", mm)


def block(x: torch.Tensor, p: Mapping[str, torch.Tensor], i: int, model: Mapping[str, Any],
          tables: tuple[torch.Tensor, torch.Tensor], mm: Mm) -> torch.Tensor:
    pre = f"blocks.{i}"
    x = x + p[f"{pre}.ls1.gamma"] * attention(layer_norm(x, p, f"{pre}.norm1"), p, f"{pre}.attn",
                                              model["heads"], tables, mm)
    return x + p[f"{pre}.ls2.gamma"] * mlp(layer_norm(x, p, f"{pre}.norm2"), p, f"{pre}.mlp", mm)


def tokens(x: torch.Tensor, spacing: Optional[torch.Tensor], p: Mapping[str, torch.Tensor],
           model: Mapping[str, Any], mm: Mm = torch.matmul, checkpoint: bool = False,
           rescale: float = 1.0) -> torch.Tensor:
    """(B, H, W, 3) float32 images and (B, 3) spacing -> all tokens (B, N,
    dim) after the final norm, token order [CLS, patches, registers]; the
    RoPE coordinates times *rescale*. *checkpoint* recomputes each block in
    the backward."""
    b, h, w, c = x.shape
    pt, d = model["patch"], model["dim"]
    t = x.reshape(b, h // pt, pt, w // pt, pt, c).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, pt * pt * c)
    wpe = p["patch_embed.weight"].permute(0, 2, 3, 1).reshape(d, -1)
    t = torch.cat([p["cls_token"].expand(b, -1, -1), mm(t, wpe.t()) + p["patch_embed.bias"]], dim=1)
    if model.get("scale_aware") and spacing is not None:
        t = t + scale_token(spacing, p, mm)
    if model.get("num_registers", 0) > 0:
        t = torch.cat([t, p["registers"].expand(b, -1, -1)], dim=1)
    tables = rope_tables(h // pt, d // model["heads"], rescale, x.device)
    for i in range(model["depth"]):
        if checkpoint and torch.is_grad_enabled():
            t = torch.utils.checkpoint.checkpoint(block, t, p, i, model, tables, mm, use_reentrant=False)
        else:
            t = block(t, p, i, model, tables, mm)
    return layer_norm(t, p, "norm")
