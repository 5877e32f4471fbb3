"""The SwiGLU gate of DINOv3's feed-forward, forward and backward:
hand-written Hopper kernels and their plain PyTorch versions.

The function, on the fused W1/W2 product's output ``h = [u | g]`` (rows of
``2H``): ``z = silu(u) * g``; backward ``du = dz * g * silu'(u)`` and ``dg =
dz * silu(u)``, with ``silu'(u) = sigma (1 + u (1 - sigma))``. Rounding
points: each is computed in float32 from the bf16 inputs and rounded once to
the working dtype.

:func:`swiglu` is differentiable through a ``torch.autograd.Function`` that
saves h. For a CPU tensor it runs the plain versions,
:func:`swiglu_reference` and :func:`swiglu_backward_reference`; for a CUDA
tensor the kernels of ``csrc/swiglu.cu`` or raises: bf16, contiguous,
16-byte aligned, H a multiple of 8. Launch counts: ``swiglu_fwd.launches``
and ``swiglu_bwd.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dinox_torch.ops import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "dinox_swiglu_fwd_bf16": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "dinox_swiglu_bwd_bf16": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
}


def _launch(symbol: str, device: torch.device, *args) -> None:
    _build.launch("swiglu", symbol, _SIGNATURES[symbol], device, *args)


def swiglu_reference(h: torch.Tensor) -> torch.Tensor:
    """Plain version: ``silu(u) * g`` in float32, in h's dtype."""
    u, g = h.float().chunk(2, dim=-1)
    return (F.silu(u) * g).to(h.dtype)


def swiglu_backward_reference(h: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Plain backward: ``[du | dg]`` in h's dtype."""
    u, g = h.float().chunk(2, dim=-1)
    d = dz.float()
    s = torch.sigmoid(u)
    du = d * g * (s * (1.0 + u * (1.0 - s)))
    return torch.cat([du, d * (u * s)], dim=-1).to(h.dtype)


def _check(h: torch.Tensor) -> int:
    if h.shape[-1] % 16:
        raise ValueError(f"SwiGLU width {h.shape[-1]} not taken by the kernels (2H, H a multiple of 8)")
    _build.check_operands({"h": (h, h.shape, torch.bfloat16)}, h.device, 16, "SwiGLU")
    return h.shape[-1] // 2


def swiglu_fwd(h: torch.Tensor) -> torch.Tensor:
    """z from h: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if h.device.type == "cpu":
        return swiglu_reference(h)
    hidden = _check(h)
    z = h.new_empty((*h.shape[:-1], hidden))
    _launch("dinox_swiglu_fwd_bf16", h.device, h.data_ptr(), z.data_ptr(), h.numel() // (2 * hidden), hidden)
    swiglu_fwd.launches += 1
    return z


def swiglu_bwd(h: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """dh from h and dz."""
    if h.device.type == "cpu":
        return swiglu_backward_reference(h, dz)
    hidden = _check(h)
    if not dz.is_contiguous() or dz.data_ptr() % 16:
        dz = dz.clone(memory_format=torch.contiguous_format)
    _build.check_operands({"dz": (dz, (*h.shape[:-1], hidden), torch.bfloat16)}, h.device, 16, "SwiGLU")
    dh = torch.empty_like(h)
    _launch("dinox_swiglu_bwd_bf16", h.device, h.data_ptr(), dz.data_ptr(), dh.data_ptr(),
            h.numel() // (2 * hidden), hidden)
    swiglu_bwd.launches += 1
    return dh


swiglu_fwd.launches = 0
swiglu_bwd.launches = 0


class _SwiGlu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return swiglu_fwd(h)

    @staticmethod
    def backward(ctx, dz):
        (h,) = ctx.saved_tensors
        return swiglu_bwd(h, dz)


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """``silu(u) * g`` of ``h = [u | g]`` over the last axis; differentiable in h."""
    if torch.is_grad_enabled() and h.requires_grad:
        return _SwiGlu.apply(h)
    return swiglu_fwd(h)
