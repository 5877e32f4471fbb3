"""Axial 2D rotary positions (DINOv3's RoPE) on the packed qkv of a block:
hand-written Hopper kernels and their plain PyTorch versions.

The function (DINOv3, arXiv:2508.10104, ``RopePositionEmbedding`` and
``rope_apply`` of facebookresearch/dinov3): the patch at row r, column c of
a G x G grid has the coordinates ``y = 2 (r + 1/2) / G - 1`` and ``x = 2 (c
+ 1/2) / G - 1``, both multiplied by a rescale factor rho; with the periods
``p_j = 100^(2j / (hd/2))``, j < hd/4 (DINOv3's base), its angles are ``2 pi [y / p_0 ..
y / p_{hd/4-1}, x / p_0 .. x / p_{hd/4-1}]``, tiled twice to hd. Each
head's q and k of the patch tokens become ``q cos + rot(q) sin`` with
``rot(q) = [-q_hi, q_lo]`` (the halves of hd); CLS and the registers are
not rotated, nor is v. Rounding points: the rotation is computed in float32
from the bf16 q and k (each product and the sum rounded on their own, no
fused multiply-add) and rounded once to the working dtype; the tables are
float32.

:func:`rope_tables` gives the ``(G*G, hd/2)`` cos and sin (the angles'
first half: the second repeats it). :func:`apply_rope` rotates a packed
``(B, N, 3*dim)`` qkv whose patch tokens are the rows ``[first, first +
G*G)``: in place in the forward (the qkv GEMM's fresh output, read by
attention alone; ``ctx.mark_dirty``), and out of place in the backward
(the rotation by -theta of the incoming gradient, the rest copied). For a
CPU tensor it runs the plain versions, :func:`rope_reference` and
:func:`rope_backward_reference`; for a CUDA tensor the kernels of
``csrc/rope.cu`` or raises: bf16, contiguous, 16-byte aligned, hd a
multiple of 16. Launch counts: ``rope_fwd.launches`` and
``rope_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dinox_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dinox_rope_fwd_bf16": [_P, _P, _P] + [_I] * 6 + [_P],
    "dinox_rope_bwd_bf16": [_P, _P, _P, _P] + [_I] * 6 + [_P],
}


def _launch(symbol: str, device: torch.device, *args) -> None:
    _build.launch("rope", symbol, _SIGNATURES[symbol], device, *args)


BASE = 100.0


def rope_tables(grid: int, hd: int, rescale: float = 1.0,
                device: torch.device | str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each ``(grid*grid, hd/2)`` float32, of the patches of a
    *grid* x *grid* image in row-major order, the coordinates multiplied by
    *rescale*."""
    c = 2.0 * (torch.arange(0.5, grid, dtype=torch.float32, device=device) / grid) - 1.0
    coords = torch.stack(torch.meshgrid(c, c, indexing="ij"), dim=-1).reshape(-1, 2) * rescale
    periods = BASE ** (2.0 * torch.arange(hd // 4, dtype=torch.float32, device=device) / (hd // 2))
    angles = (2 * math.pi * coords[:, :, None] / periods[None, None, :]).flatten(1, 2)
    return torch.cos(angles), torch.sin(angles)


def _patch_view(qkv: torch.Tensor, heads: int, first: int, patches: int) -> torch.Tensor:
    """The q and k columns of the patch rows, ``(B, P, 2, heads, 2, hd/2)``."""
    b, n, width = qkv.shape
    hd = width // 3 // heads
    return qkv[:, first:first + patches, :2 * heads * hd].unflatten(-1, (2, heads, 2, hd // 2))


def _rotated(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """float32 ``x cos + rot(x) sin`` of ``(B, P, 2, heads, 2, hd/2)`` pieces."""
    xf = x.float()
    lo, hi = xf[..., 0, :], xf[..., 1, :]
    c, s = cos[None, :, None, None, :], sin[None, :, None, None, :]
    return torch.stack([lo * c - hi * s, hi * c + lo * s], dim=-2)


def _rotate_(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, first: int) -> None:
    view = _patch_view(qkv, heads, first, cos.shape[0])
    view.copy_(_rotated(view, cos, sin).to(qkv.dtype))


def rope_reference(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
                   first: int) -> torch.Tensor:
    """Plain version: a new qkv with the patch rows' q and k rotated, in
    qkv's dtype."""
    out = qkv.clone()
    _rotate_(out, cos, sin, heads, first)
    return out


def rope_backward_reference(dqkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
                            first: int) -> torch.Tensor:
    """Plain backward: the incoming gradient rotated by -theta."""
    return rope_reference(dqkv, cos, -sin, heads, first)


def check(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, first: int) -> int:
    """Raise unless the kernels take these operands; returns hd."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be (B, N, 3*heads*hd), got {tuple(qkv.shape)} at {heads} heads")
    hd = qkv.shape[2] // 3 // heads
    if hd % 16:
        raise ValueError(f"head dim {hd} not taken by the RoPE kernels (a multiple of 16)")
    patches = cos.shape[0]
    if not 0 <= first <= qkv.shape[1] - patches:
        raise ValueError(f"patch rows [{first}, {first + patches}) outside {qkv.shape[1]} tokens")
    table = (patches, hd // 2)
    _build.check_operands({"qkv": (qkv, qkv.shape, torch.bfloat16)}, qkv.device, 16, "RoPE")
    _build.check_operands({"cos": (cos, table, torch.float32), "sin": (sin, table, torch.float32)},
                          qkv.device, 16, "RoPE")
    return hd


def rope_fwd(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, first: int) -> None:
    """Rotate the patch rows' q and k of *qkv* in place: the kernel for a
    CUDA tensor (operands checked here), the plain version for a CPU one."""
    if qkv.device.type == "cpu":
        return _rotate_(qkv, cos, sin, heads, first)
    hd = check(qkv, cos, sin, heads, first)
    b, n, _ = qkv.shape
    if b:
        _launch("dinox_rope_fwd_bf16", qkv.device, qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, n,
                first, cos.shape[0], heads, hd)
        rope_fwd.launches += 1


def rope_bwd(dqkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
             first: int) -> torch.Tensor:
    """The gradient of the rotation's input from that of its output, a new
    tensor."""
    if dqkv.device.type == "cpu":
        return rope_backward_reference(dqkv, cos, sin, heads, first)
    if not dqkv.is_contiguous() or dqkv.data_ptr() % 16:
        dqkv = dqkv.clone(memory_format=torch.contiguous_format)
    hd = check(dqkv, cos, sin, heads, first)
    out = torch.empty_like(dqkv)
    b, n, _ = dqkv.shape
    if b:
        _launch("dinox_rope_bwd_bf16", dqkv.device, dqkv.data_ptr(), out.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), b, n, first, cos.shape[0], heads, hd)
        rope_bwd.launches += 1
    return out


rope_fwd.launches = 0
rope_bwd.launches = 0


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cos, sin, heads, first):
        rope_fwd(qkv, cos, sin, heads, first)
        ctx.mark_dirty(qkv)
        ctx.save_for_backward(cos, sin)
        ctx.heads, ctx.first = heads, first
        return qkv

    @staticmethod
    def backward(ctx, dqkv):
        cos, sin = ctx.saved_tensors
        return rope_bwd(dqkv, cos, sin, ctx.heads, ctx.first), None, None, None, None


def apply_rope(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
               first: int = 1) -> torch.Tensor:
    """*qkv* ``(B, N, 3*dim)`` with the q and k of its patch rows ``[first,
    first + len(cos))`` rotated in place; differentiable in qkv."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _Rope.apply(qkv, cos, sin, heads, first)
    rope_fwd(qkv, cos, sin, heads, first)
    return qkv
