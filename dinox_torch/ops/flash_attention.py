"""Packed-QKV multi-head attention forward: a hand-written Hopper kernel and
its plain PyTorch version.

Replaces ``_packed_kernel`` (dinox_tpu/ops/flash_attention.py, reached
through ``_packed_fwd`` and ``flash_attention_packed``). The kernel is
``csrc/packed_attention.cu``: a flash-style forward that reads q, k and v as
hd-wide column slices of the packed ``(B, N, 3*dim)`` row and writes the
token-major ``(B, N, dim)`` output, with no transposes on either side.

Bound on an H100 SXM at the ViT-S serving shape (B=32, N=261, dim 384,
6 heads): 25.7 MB of qkv in and output out against 3.35 GFLOP, so memory
bounds it (7.7 us at 3.35 TB/s). The design keeps the logits in shared
memory, uses an online softmax over 64-row key tiles so any N works, and
takes the tensor cores through ``nvcuda::wmma`` in bf16 with f32
accumulation. See the source for the tile layout.

For a CPU tensor :func:`flash_attention_packed` runs
:func:`packed_attention_reference`; for a CUDA tensor it launches the kernel
or raises. ``flash_attention_packed.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dinox_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 88)


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points:
    qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)`` in qkv's dtype.

    The scale is folded into q and rounded to the working dtype, logits are
    f32, the unnormalised exp is cast to the dtype before PV, and the
    division by the row sum comes after PV."""
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    hd = dim // heads
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)  # (b, h, n, hd)
    q = (q.float() * (1.0 / hd ** 0.5)).to(qkv.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(qkv.dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, dim)


def _check(qkv: torch.Tensor, heads: int) -> int:
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3*dim), got {tuple(qkv.shape)}")
    dim = qkv.shape[2] // 3
    if dim % heads:
        raise ValueError(f"dim {dim} is not divisible by heads {heads}")
    hd = dim // heads
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel (supported: {SUPPORTED_HEAD_DIMS})")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the packed attention kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("the packed attention kernel has no backward yet")
    return hd


def flash_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Layout-native fused MHA: qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)``."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    hd = _check(qkv, heads)
    b, n, three_dim = qkv.shape
    out = torch.empty((b, n, three_dim // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _build.load("packed_attention")
    fn = lib.dinox_packed_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), out.data_ptr(), b, n, heads, hd, 1.0 / hd ** 0.5,
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed attention kernel launch failed: cudaError {err}")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
