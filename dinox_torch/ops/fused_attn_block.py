"""Fused attention half-block, ``y = x + proj(attention(qkv(LN(x))))``: a
hand-written Hopper kernel and its plain PyTorch version.

Forward: replaces ``_fused_kernel`` (dinox_tpu/ops/fused_attn_block.py,
reached through ``_call_fused`` and ``fused_attn_block``). The kernel is
``csrc/fused_attn_block.cu``: one C entry point that makes three launches
in order on the current stream: LN + QKV over the flattened B*N rows and
then out-projection + bias + residual on the wgmma + TMA GEMM core
``csrc/gemm_sm90.cuh`` (a LayerNorm prologue run once per row block, bias
and residual epilogues leaving by TMA stores), and between them kernel 1's
attention core ``csrc/attention_fwd_sm90.cuh`` on the qkv just written, so
``attn`` has kernel 1's bits on that qkv. It writes y and, for the
backward, qkv and the attention output, as the TPU kernel does. Bound on an H100 SXM at the
ViT-S training shape (192 views, N=261, dim 384, 6 heads): 79.2 GFLOP
against 232 MB, so the tensor cores bound it (0.080 ms at 989 TFLOP/s).
The three launches read qkv and attn back from device memory, so their
own bounds sum to 0.127 ms (``utils.roofline.fused_attn_parts_work``).
The GEMM core holds a 64- or 128-row block of x whole along the width in
shared memory, so the kernel takes dim <= ``MAX_DIM`` (1408, ViT-G's, the
widest model of the repo).

Rounding points (the TPU kernel's, not the port's unfused blocks'): LN in
f32 with the fast variance E[x^2] - E[x]^2 clipped at 0, rounded once to the
working dtype; qkv = round(ln @ Wqkv + bqkv) with the f32 bias added to the
f32 accumulator; attention as kernel 1 (scale folded into q, f32 logits,
the unnormalised exp rounded before PV, division after PV);
y = round(x32 + attn @ Wproj + bproj), bias and residual in f32.

Backward: composed exactly as the JAX package's ``_bwd_rule``: the
out-projection's dgrad and wgrad, the packed attention backward
(``ops.flash_attention.packed_attention_backward``: the dq/dkv kernel pair
on the card), LN recomputed, the qkv dgrad and wgrad, and the f32 LayerNorm
backward. The products are plain matmuls, as XLA's were; ``dwproj``,
``dwqkv`` and ``dln`` keep an f32 result from the bf16 operands
(``torch.mm(..., out_dtype=torch.float32)`` on the card).

Weights are taken in the port's ``(out, in)`` layout: ``wqkv`` (3*dim, dim)
is the JAX argument ``wqkv`` (dim, 3*dim) transposed, ``wproj`` (dim, dim)
the JAX ``wproj`` transposed; ``gamma``, ``beta``, ``bqkv`` and ``bproj`` are
the same vectors. Launch count: ``fused_attn_block.launches``, one per
call (its attention launch does not count as ``flash_attention_packed``'s).
"""

from __future__ import annotations

import ctypes

import torch

from dinox_torch.ops import _build
from dinox_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    packed_attention_backward,
    packed_attention_reference,
)

LN_EPS = 1e-5
MAX_DIM = 1408  # the widest x row block the GEMM core holds in shared memory (gemm_sm90.cuh MAX_K)
GEMM_PARTS = ("qkv", "proj")  # the two GEMM launches of the kernel, in their order

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]


def _ln_stats(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row mean and 1/std with flax's fast variance, clipped at 0."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + LN_EPS)


def _ln_f32(x32: torch.Tensor, gamma32: torch.Tensor, beta32: torch.Tensor) -> torch.Tensor:
    mu, rstd = _ln_stats(x32)
    return (x32 - mu) * rstd * gamma32 + beta32


def fused_attn_block_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
                               bproj: torch.Tensor, heads: int
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version at the kernel's rounding points: returns
    ``(y, qkv, attn)`` in x's dtype. Weights in the ``(out, in)`` layout, cast
    to x's dtype here."""
    dt = x.dtype
    x32 = x.float()
    ln = _ln_f32(x32, gamma.float(), beta.float()).to(dt)
    qkv = (torch.matmul(ln.float(), wqkv.to(dt).float().t()) + bqkv.float()).to(dt)
    attn = packed_attention_reference(qkv, heads)
    y = torch.matmul(attn.float(), wproj.to(dt).float().t()) + bproj.float()
    return (x32 + y).to(dt), qkv, attn


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` (2-D) with f32 accumulation, rounded once to *out_dtype*. On
    the CPU the product is taken in f32 of the operands' values; on the card
    a bf16 product rounds once at the end, and an f32 result comes from
    ``torch.mm(..., out_dtype=torch.float32)``."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float()).to(out_dtype)
    if out_dtype == a.dtype:
        return torch.matmul(a, b)
    return torch.mm(a, b, out_dtype=out_dtype)


def _check(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads: int) -> int:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, dim), got {tuple(x.shape)}")
    dim = x.shape[2]
    if dim % heads:
        raise ValueError(f"dim {dim} is not divisible by heads {heads}")
    hd = dim // heads
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel (supported: {SUPPORTED_HEAD_DIMS})")
    if dim > MAX_DIM:
        raise ValueError(f"dim {dim} is wider than the kernel takes ({MAX_DIM})")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_operands({"x": (x, x.shape, bf16), "gamma": (gamma, (dim,), f32),
                           "beta": (beta, (dim,), f32), "wqkv": (wqkv, (3 * dim, dim), bf16),
                           "bqkv": (bqkv, (3 * dim,), f32), "wproj": (wproj, (dim, dim), bf16),
                           "bproj": (bproj, (dim,), f32)}, x.device, 16, "fused attention")
    return hd


def fused_attn_block_occupancy(part: str, dim: int, device: torch.device | str = "cuda"
                               ) -> dict[str, int]:
    """Registers per thread, dynamic shared memory per CTA (bytes) and
    resident CTAs per SM of the GEMM launch *part* (``"qkv"`` or ``"proj"``)
    at width *dim*, from the CUDA occupancy API on *device*. The attention
    launch is kernel 1's: ``flash_attention.forward_occupancy``."""
    vals = _build.query("fused_attn_block", "dinox_fused_attn_block_occupancy",
                        (GEMM_PARTS.index(part), dim), device)
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm"), vals))


def fused_attn_block_grid(part: str, rows: int, dim: int, device: torch.device | str = "cuda"
                          ) -> dict[str, int]:
    """The grid of the GEMM launch *part* over *rows* = B*N rows at width
    *dim*: row blocks, column groups (the split that fills every SM) and
    column tiles per CTA."""
    vals = _build.query("fused_attn_block", "dinox_fused_attn_block_grid",
                        (GEMM_PARTS.index(part), rows, dim), device)
    return dict(zip(("row_blocks", "column_groups", "tiles_per_cta"), vals))


def fused_attn_block_forward(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads: int):
    """(y, qkv, attn): the plain version for CPU tensors, kernel 6 for CUDA."""
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    if x.device.type != "cuda":
        raise ValueError(f"no fused attention half-block for device {x.device}")
    hd = _check(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    b, n, dim = x.shape
    y = torch.empty_like(x)
    qkv = torch.empty((b, n, 3 * dim), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    if x.numel() == 0:
        return y, qkv, attn
    _build.launch("fused_attn_block", "dinox_fused_attn_block_fwd_bf16", _SIGNATURE, x.device,
                  x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
                  bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), y.data_ptr(),
                  qkv.data_ptr(), attn.data_ptr(), b, n, heads, hd, 1.0 / hd ** 0.5)
    fused_attn_block.launches += 1
    return y, qkv, attn


class _FusedAttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, heads: int):
        dt = x.dtype
        y, qkv, attn = fused_attn_block_forward(x, gamma, beta, wqkv.to(dt).contiguous(), bqkv,
                                wproj.to(dt).contiguous(), bproj, heads)
        ctx.heads = heads
        ctx.bias_dtypes = (bqkv.dtype, bproj.dtype)
        ctx.save_for_backward(x, gamma, beta, wqkv, wproj, qkv, attn)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, wqkv, wproj, qkv, attn = ctx.saved_tensors
        b, n, dim = x.shape
        dt, f32 = x.dtype, torch.float32
        dyb = dy.to(dt).reshape(-1, dim)
        # out-projection
        d_attn = _mm(dyb, wproj.to(dt), dt).view(b, n, dim)
        dwproj = _mm(dyb.t(), attn.reshape(-1, dim), f32)
        dbproj = dy.reshape(-1, dim).float().sum(dim=0)
        # attention (the dq/dkv kernel pair on the card)
        dqkv = packed_attention_backward(qkv, d_attn.contiguous(), ctx.heads)
        # qkv projection, LN recomputed
        x32 = x.float()
        mu, rstd = _ln_stats(x32)
        xhat = (x32 - mu) * rstd
        g32 = gamma.float()
        ln = (xhat * g32 + beta.float()).to(dt).reshape(-1, dim)
        flat_dqkv = dqkv.reshape(-1, 3 * dim)
        dwqkv = _mm(flat_dqkv.t(), ln, f32)
        dbqkv = flat_dqkv.float().sum(dim=0)
        dln = _mm(flat_dqkv, wqkv.to(dt), f32).view(b, n, dim)
        # LayerNorm backward (f32)
        dgamma = (dln * xhat).sum(dim=(0, 1))
        dbeta = dln.sum(dim=(0, 1))
        dxhat = dln * g32
        dx_ln = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                        - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        dx = (dy.float() + dx_ln).to(dt)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dwqkv.to(wqkv.dtype),
                dbqkv.to(ctx.bias_dtypes[0]), dwproj.to(wproj.dtype),
                dbproj.to(ctx.bias_dtypes[1]), None)


def fused_attn_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
                     bproj: torch.Tensor, heads: int) -> torch.Tensor:
    """``y = x + proj(attention(qkv(LN(x))))``, differentiable in every
    tensor argument. x ``(B, N, dim)`` in the working dtype; ``gamma``,
    ``beta`` (dim,); ``wqkv`` (3*dim, dim) and ``wproj`` (dim, dim) in the
    ``(out, in)`` layout, cast to x's dtype; biases f32. Returns
    ``(B, N, dim)`` in x's dtype. Gradients come back in each argument's
    dtype."""
    return _FusedAttnBlock.apply(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)


fused_attn_block.launches = 0
