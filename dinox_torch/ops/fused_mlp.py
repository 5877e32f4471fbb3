"""Fused MLP half-block, ``y = x + fc2(GELU_erf(fc1(LN(x))))``: hand-written
Hopper kernels for the forward and the backward, and their plain PyTorch
versions.

Forward: replaces the fused-MLP ``_fwd_kernel`` (dinox_tpu/ops/fused_mlp.py,
reached through ``_fwd`` and ``fused_mlp_block``). The kernel is
``csrc/fused_mlp.cu``: one CTA per block of rows keeps the LN output, one
hidden chunk of fc1/GELU and the f32 fc2 accumulator on chip, so device
memory sees x in, y out and the weights. Bound on an H100 SXM at the ViT-S
training shape (50,112 rows, 384 -> 1536 -> 384): 118.2 GFLOP, the tensor
cores bound it (0.120 ms at 989 TFLOP/s).

Backward: replaces the fused-MLP ``_bwd_kernel`` (``_bwd``). The TPU kernel
adds dW1, db1, dW2, db2, dgamma and dbeta into constant-index blocks across
a grid that runs in order; on the GPU the CTAs run at once, so
``csrc/fused_mlp_bwd.cu`` computes the same function in three launches, with
no float atomics and a fixed order of summation (the same bits run to run):

* ``rows`` (per block of rows): LN, fc1 and GELU recomputed, da, dh, dx, the
  block's partial sums of dgamma, dbeta, db1 and db2, and the bf16 values
  ``lnb``, ``ab`` and ``dhb`` that the TPU kernel feeds its matrix unit;
* ``weights``: dW2 = ab^T dyb and dW1 = lnb^T dhb over row chunks, one f32
  partial per chunk;
* ``reduce``: the chunks' and the row blocks' partials added in order.

Bound at the training shape: 295.6 GFLOP (0.299 ms at 989 TFLOP/s).

Rounding points (the TPU kernel's): LN in f32 with the two-pass variance
(not the fast variance of the unfused blocks and kernel 6), rounded to the
working dtype before fc1; the f32 b1 added to the f32 fc1 accumulator;
exact GELU in f32; ``a`` rounded before fc2; ``y = round(x32 + acc + b2)``.
:func:`mlp_block_reference` is the JAX package's oracle, which rounds fc1's
product before ``+ b1``; the tests hold both against JAX.

Weights are taken in the port's ``(out, in)`` layout: ``w1`` (hidden, C) is
the JAX ``w1`` (C, hidden) transposed, ``w2`` (C, hidden) the JAX ``w2``
transposed. Launch counts: ``fused_mlp_forward.launches``,
``fused_mlp_bwd_rows.launches``, ``fused_mlp_bwd_weights.launches`` and
``fused_mlp_bwd_reduce.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dinox_torch.ops import _build

LN_EPS = 1e-5
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
# Widths the kernels are compiled for (the hidden width is any multiple of 128).
SUPPORTED_DIMS = (384, 768, 1024, 1408)
WEIGHT_CHUNKS = 8  # row chunks of the weight-gradient launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dinox_fused_mlp_fwd_bf16": [_P] * 8 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_rows_bf16": [_P] * 12 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_weights_bf16": [_P] * 5 + [_I, _I, _I, _I, _P],
    "dinox_fused_mlp_bwd_reduce": [_P] * 3 + [_I, _I, _I, _I, _P],
}


def _launch(lib_name: str, symbol: str, device: torch.device, *args) -> None:
    _build.launch(lib_name, symbol, _SIGNATURES[symbol], device, *args)


def _ln_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Two-pass f32 LayerNorm: (ln, xhat, rstd)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x - mu) * rstd
    return xhat * gamma + beta, xhat, rstd


def _gelu_f32(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * _SQRT_HALF))


def _dgelu_f32(x: torch.Tensor) -> torch.Tensor:
    # d/dx [x * Phi(x)] = Phi(x) + x * phi(x)
    return 0.5 * (1.0 + torch.erf(x * _SQRT_HALF)) + x * torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of two operands' values (the matrix unit's f32 accumulation)."""
    return torch.matmul(a.float(), b.float())


def fused_mlp_forward_reference(x2, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Plain forward at the kernel's rounding points: rows ``(M, C)`` ->
    ``(M, C)`` in x2's dtype; ``w1`` (hidden, C), ``w2`` (C, hidden)."""
    dt = x2.dtype
    x = x2.float()
    ln, _, _ = _ln_f32(x, gamma.float(), beta.float())
    h = _dot(ln.to(dt), w1.to(dt).t()) + b1.float()
    y = _dot(_gelu_f32(h).to(dt), w2.to(dt).t()) + b2.float()
    return (x + y).to(dt)


def fused_mlp_backward_reference(x2, gamma, beta, w1, b1, w2, dy2):
    """Plain backward at the kernel's rounding points: ``(dx, dgamma, dbeta,
    dw1, db1, dw2, db2)``, dx in x2's dtype and the rest f32, weight
    gradients in the ``(out, in)`` layout."""
    dt = x2.dtype
    x = x2.float()
    g32 = gamma.float()
    ln, xhat, rstd = _ln_f32(x, g32, beta.float())
    lnb = ln.to(dt)
    w1b, w2b = w1.to(dt), w2.to(dt)
    h = _dot(lnb, w1b.t()) + b1.float()
    ab = _gelu_f32(h).to(dt)
    dy = dy2.float()
    dyb = dy2.to(dt)
    dw2 = _dot(dyb.t(), ab)
    db2 = dy.sum(dim=0)
    da = _dot(dyb, w2b)
    dh = da * _dgelu_f32(h)
    dhb = dh.to(dt)
    dw1 = _dot(dhb.t(), lnb)
    db1 = dh.sum(dim=0)
    dln = _dot(dhb, w1b)
    dgamma = (dln * xhat).sum(dim=0)
    dbeta = dln.sum(dim=0)
    dxh = dln * g32
    dx_ln = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                    - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    return (dy + dx_ln).to(dt), dgamma, dbeta, dw1, db1, dw2, db2


def mlp_block_reference(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """The JAX package's oracle (``mlp_block_reference``): the same math with
    fc1's and fc2's products rounded to x's dtype before the f32 bias. For
    the tests; weights in the ``(out, in)`` layout."""
    dt = x.dtype
    xf = x.float()
    ln, _, _ = _ln_f32(xf, gamma.float(), beta.float())
    h = torch.matmul(ln.to(dt), w1.to(dt).t()).float() + b1.float()
    y = torch.matmul(_gelu_f32(h).to(dt), w2.to(dt).t()).float() + b2.float()
    return (xf + y).to(dt)


def _check(x2, gamma, beta, w1, b1, w2, extra: dict) -> tuple[int, int, int]:
    if x2.dim() != 2:
        raise ValueError(f"rows must be (M, C), got {tuple(x2.shape)}")
    m, c = x2.shape
    hidden = w1.shape[0]
    if c not in SUPPORTED_DIMS:
        raise ValueError(f"width {c} not supported by the fused MLP kernels (supported: {SUPPORTED_DIMS})")
    if hidden % 128:
        raise ValueError(f"hidden width {hidden} is not a multiple of 128")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_operands({"x": (x2, (m, c), bf16), "gamma": (gamma, (c,), f32),
                           "beta": (beta, (c,), f32), "w1": (w1, (hidden, c), bf16),
                           "b1": (b1, (hidden,), f32), "w2": (w2, (c, hidden), bf16), **extra},
                          x2.device, 32, "fused MLP")
    return m, c, hidden


def fused_mlp_forward(x2, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Rows ``(M, C)`` -> ``(M, C)``: the plain version for CPU tensors,
    kernel 7 for CUDA."""
    if x2.device.type == "cpu":
        return fused_mlp_forward_reference(x2, gamma, beta, w1, b1, w2, b2)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {x2.device}")
    m, c, hidden = _check(x2, gamma, beta, w1, b1, w2, {"b2": (b2, (x2.shape[1],), torch.float32)})
    y = torch.empty_like(x2)
    if m == 0:
        return y
    _launch("fused_mlp", "dinox_fused_mlp_fwd_bf16", x2.device, x2.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), m, c, hidden)
    fused_mlp_forward.launches += 1
    return y


def row_block(c: int) -> int:
    """Rows per CTA of the forward and of the backward's row launch."""
    return 32 if c <= 768 else 16


def fused_mlp_bwd_rows(x2, gamma, beta, w1, b1, w2, dy2, dx, lnb, ab, dhb, part) -> None:
    """Launch the backward's row kernel: writes dx, lnb, ab, dhb and each row
    block's partial sums ``part`` ``(blocks, 3*C + hidden)`` f32 (dgamma,
    dbeta, db2, db1). Operands are checked by :func:`fused_mlp_backward`."""
    m, c = x2.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_rows_bf16", x2.device, x2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), lnb.data_ptr(), ab.data_ptr(), dhb.data_ptr(),
            part.data_ptr(), m, c, w1.shape[0])
    fused_mlp_bwd_rows.launches += 1


def fused_mlp_bwd_weights(dy2, ab, dhb, lnb, wpart, chunks: int) -> None:
    """Launch the weight-gradient kernel: ``wpart`` ``(chunks, 2*C*hidden)``
    f32 receives each row chunk's dW2 ``(C, hidden)`` then dW1 ``(hidden, C)``."""
    m, c = dy2.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_weights_bf16", dy2.device, dy2.data_ptr(),
            ab.data_ptr(), dhb.data_ptr(), lnb.data_ptr(), wpart.data_ptr(), m, c, ab.shape[1],
            chunks)
    fused_mlp_bwd_weights.launches += 1


def fused_mlp_bwd_reduce(wpart, part, out, c: int, hidden: int, chunks: int) -> None:
    """Launch the reduction: ``out`` f32 ``[dW2 | dW1 | dgamma | dbeta | db2 |
    db1]`` from the chunk partials and the row-block partials, in order."""
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_reduce", out.device, wpart.data_ptr(),
            part.data_ptr(), out.data_ptr(), chunks, part.shape[0], c, hidden)
    fused_mlp_bwd_reduce.launches += 1


fused_mlp_forward.launches = 0
fused_mlp_bwd_rows.launches = 0
fused_mlp_bwd_weights.launches = 0
fused_mlp_bwd_reduce.launches = 0


def fused_mlp_backward(x2, gamma, beta, w1, b1, w2, dy2):
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)``: the plain backward for CPU
    tensors, kernel 8's three launches for CUDA (dx bf16, the rest f32)."""
    if x2.device.type == "cpu":
        return fused_mlp_backward_reference(x2, gamma, beta, w1, b1, w2, dy2)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused MLP backward for device {x2.device}")
    m, c, hidden = _check(x2, gamma, beta, w1, b1, w2, {"dy": (dy2, tuple(x2.shape), torch.bfloat16)})
    dev = x2.device
    bf16, f32 = torch.bfloat16, torch.float32
    dx = torch.empty_like(x2)
    size = 2 * c * hidden + 3 * c + hidden
    if m == 0:
        out = torch.zeros(size, dtype=f32, device=dev)
    else:
        out = torch.empty(size, dtype=f32, device=dev)  # the reduce writes every element
        blocks = math.ceil(m / row_block(c))
        chunks = min(WEIGHT_CHUNKS, blocks)
        lnb = torch.empty((m, c), dtype=bf16, device=dev)
        ab = torch.empty((m, hidden), dtype=bf16, device=dev)
        dhb = torch.empty((m, hidden), dtype=bf16, device=dev)
        part = torch.empty((blocks, 3 * c + hidden), dtype=f32, device=dev)
        wpart = torch.empty((chunks, 2 * c * hidden), dtype=f32, device=dev)
        fused_mlp_bwd_rows(x2, gamma, beta, w1, b1, w2, dy2, dx, lnb, ab, dhb, part)
        fused_mlp_bwd_weights(dy2, ab, dhb, lnb, wpart, chunks)
        fused_mlp_bwd_reduce(wpart, part, out, c, hidden, chunks)
    ch = c * hidden
    dw2 = out[:ch].view(c, hidden)
    dw1 = out[ch:2 * ch].view(hidden, c)
    dgamma, dbeta, db2 = out[2 * ch:2 * ch + 3 * c].view(3, c).unbind(0)
    db1 = out[2 * ch + 3 * c:]
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


class _FusedMlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        b, n, c = x.shape
        dt = x.dtype
        y = fused_mlp_forward(x.reshape(b * n, c), gamma, beta, w1.to(dt).contiguous(), b1,
                              w2.to(dt).contiguous(), b2)
        return y.view(b, n, c)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        b, n, c = x.shape
        dt = x.dtype
        dx, dg, db, dw1, db1, dw2, db2 = fused_mlp_backward(
            x.reshape(b * n, c), gamma, beta, w1.to(dt).contiguous(), b1,
            w2.to(dt).contiguous(), dy.to(dt).reshape(b * n, c).contiguous())
        return (dx.view(b, n, c), dg.to(gamma.dtype), db.to(beta.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def fused_mlp_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x ``(B, N, C)`` + LN/fc1/fc2 parameters -> ``x + fc2(gelu(fc1(LN(x))))``
    with exact GELU, differentiable in every argument. ``w1`` (hidden, C) and
    ``w2`` (C, hidden) in the ``(out, in)`` layout, cast to x's dtype; LN
    parameters and biases f32. Saves only the inputs; each gradient comes
    back in its argument's dtype."""
    return _FusedMlpBlock.apply(x, gamma, beta, w1, b1, w2, b2)
