"""Packed-QKV multi-head attention, forward and backward: hand-written Hopper
kernels and their plain PyTorch versions.

Forward: replaces ``_packed_kernel`` (dinox_tpu/ops/flash_attention.py,
reached through ``_packed_fwd`` and ``flash_attention_packed``). The kernel
is ``csrc/packed_attention.cu``: a flash-style forward that reads q, k and v
as hd-wide column slices of the packed ``(B, N, 3*dim)`` row and writes the
token-major ``(B, N, dim)`` output, with no transposes on either side.
Bound on an H100 SXM at the ViT-S serving shape (B=32, N=261, dim 384,
6 heads): 25.7 MB of qkv in and output out against 3.35 GFLOP, so memory
bounds it (7.7 us at 3.35 TB/s). The design keeps the logits in shared
memory, uses an online softmax over 64-row key tiles so any N works, and
takes the tensor cores through ``nvcuda::wmma`` in bf16 with f32
accumulation.

Backward: replaces ``_packed_bwd_kernel`` (``_packed_bwd``) and its split
form ``_packed_bwd_dq_kernel`` + ``_packed_bwd_dkv_kernel``
(``_packed_bwd_split``). The kernels are ``csrc/packed_attention_bwd.cu``: a
dq kernel over query tiles, which also saves each row's softmax statistics,
then a dkv kernel over key tiles; together they write the packed
``(B, N, 3*dim)`` dqkv. Bound at the ViT-S training shape (192 views):
269 MB moved against 50.2 GFLOP, memory-bound (80 us at 3.35 TB/s).

:func:`flash_attention_packed` is differentiable through a
``torch.autograd.Function`` that saves only qkv, as the JAX package's VJP
rule does. For a CPU tensor it runs the plain versions; for a CUDA tensor it
launches the kernels or raises. Launch counts: ``flash_attention_packed
.launches`` (forward), ``packed_attention_bwd_dq.launches`` and
``packed_attention_bwd_dkv.launches`` (backward).
"""

from __future__ import annotations

import ctypes

import torch

from dinox_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 88)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dinox_packed_attention_fwd_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_packed_attention_bwd_dq_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_packed_attention_bwd_dkv_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _split_heads(t: torch.Tensor, parts: int, heads: int) -> tuple[torch.Tensor, ...]:
    """(B, N, parts*heads*hd) -> *parts* tensors (B, heads, N, hd)."""
    b, n, width = t.shape
    return t.view(b, n, parts, heads, width // parts // heads).permute(2, 0, 3, 1, 4).unbind(0)


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points:
    qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)`` in qkv's dtype.

    The scale is folded into q and rounded to the working dtype, logits are
    f32, the unnormalised exp is cast to the dtype before PV, and the
    division by the row sum comes after PV."""
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    hd = dim // heads
    q, k, v = _split_heads(qkv, 3, heads)
    q = (q.float() * (1.0 / hd ** 0.5)).to(qkv.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(qkv.dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, dim)


def packed_attention_backward_reference(qkv: torch.Tensor, do: torch.Tensor,
                                        heads: int) -> torch.Tensor:
    """Plain backward with the TPU kernel's rounding points: qkv
    ``(B, N, 3*dim)`` and the output gradient ``(B, N, dim)`` -> dqkv
    ``(B, N, 3*dim)`` in qkv's dtype.

    s = q k^T * scale in f32 (the scale is not folded into q here);
    P = softmax(s); dV = bf16(P)^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P));
    dQ = bf16(dS * scale) K; dK = bf16(dS * scale)^T Q."""
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    hd = dim // heads
    scale = 1.0 / hd ** 0.5
    q, k, v = (t.float() for t in _split_heads(qkv, 3, heads))
    (dob,) = (t.float() for t in _split_heads(do, 1, heads))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), dob)
    dp = torch.matmul(dob, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = (ds * scale).to(qkv.dtype).float()
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).to(qkv.dtype)  # (3, b, heads, n, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, three_dim)


def _check(qkv: torch.Tensor, heads: int) -> int:
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3*dim), got {tuple(qkv.shape)}")
    dim = qkv.shape[2] // 3
    if dim % heads:
        raise ValueError(f"dim {dim} is not divisible by heads {heads}")
    hd = dim // heads
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel (supported: {SUPPORTED_HEAD_DIMS})")
    _check_operand(qkv, "qkv")
    return hd


def _check_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the packed attention kernels take bfloat16 {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    hd = _check(qkv, heads)
    b, n, three_dim = qkv.shape
    out = torch.empty((b, n, three_dim // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    symbol = "dinox_packed_attention_fwd_bf16"
    _build.launch("packed_attention", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  out.data_ptr(), b, n, heads, hd, 1.0 / hd ** 0.5)
    flash_attention_packed.launches += 1
    return out


def packed_attention_bwd_dq(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                            dqkv: torch.Tensor, stats: torch.Tensor) -> None:
    """Launch the dq kernel: writes the dq slots of *dqkv* and each row's
    softmax max, sum and rowsum(dP*P) to *stats* ``(B*heads, 3, N)`` f32.
    Operands are checked by :func:`packed_attention_backward`."""
    b, n, three_dim = qkv.shape
    hd = three_dim // 3 // heads
    symbol = "dinox_packed_attention_bwd_dq_bf16"
    _build.launch("packed_attention_bwd", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, n, heads, hd,
                  1.0 / hd ** 0.5)
    packed_attention_bwd_dq.launches += 1


def packed_attention_bwd_dkv(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                             stats: torch.Tensor, dqkv: torch.Tensor) -> None:
    """Launch the dkv kernel: reads *stats* from the dq kernel and writes the
    dk and dv slots of *dqkv*."""
    b, n, three_dim = qkv.shape
    hd = three_dim // 3 // heads
    symbol = "dinox_packed_attention_bwd_dkv_bf16"
    _build.launch("packed_attention_bwd", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  do.data_ptr(), stats.data_ptr(), dqkv.data_ptr(), b, n, heads, hd,
                  1.0 / hd ** 0.5)
    packed_attention_bwd_dkv.launches += 1


packed_attention_bwd_dq.launches = 0
packed_attention_bwd_dkv.launches = 0


def packed_attention_backward(qkv: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """dqkv ``(B, N, 3*dim)`` from qkv and the output gradient ``(B, N, dim)``:
    the plain version for CPU tensors, the dq + dkv kernel pair for CUDA."""
    if qkv.device.type == "cpu":
        return packed_attention_backward_reference(qkv, do, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention backward for device {qkv.device}")
    _check(qkv, heads)
    b, n, three_dim = qkv.shape
    if do.shape != (b, n, three_dim // 3) or do.device != qkv.device:
        raise ValueError(f"output gradient {tuple(do.shape)} on {do.device} does not match "
                         f"qkv {tuple(qkv.shape)} on {qkv.device}")
    _check_operand(do, "the output gradient")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    stats = torch.empty((b * heads, 3, n), dtype=torch.float32, device=qkv.device)
    packed_attention_bwd_dq(qkv, do, heads, dqkv, stats)
    packed_attention_bwd_dkv(qkv, do, heads, stats, dqkv)
    return dqkv


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _forward(qkv, heads)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return packed_attention_backward(qkv, do.contiguous(), ctx.heads), None


def flash_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Layout-native fused MHA: qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)``,
    differentiable in qkv."""
    return _PackedAttention.apply(qkv, heads)


flash_attention_packed.launches = 0
