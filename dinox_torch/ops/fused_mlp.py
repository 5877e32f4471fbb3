"""Fused MLP half-block, ``y = x + fc2(GELU_erf(fc1(LN(x))))``: hand-written
Hopper kernels for the forward and the backward, and their plain PyTorch
versions.

Forward: replaces the fused-MLP ``_fwd_kernel`` (dinox_tpu/ops/fused_mlp.py,
reached through ``_fwd`` and ``fused_mlp_block``). The kernel is
``csrc/fused_mlp.cu``, two launches on the wgmma + TMA GEMM core
``csrc/gemm_sm90.cuh``: ``fc1`` (the row-block core with a two-pass
LayerNorm prologue and a bias + exact-GELU epilogue, writing the bf16
activation ``a``) and ``fc2`` (the streaming core, A tiles of ``a`` in the
ring beside the W2 tiles, with a bias + residual epilogue). Bound on an H100
SXM at the ViT-S training shape (50,112 rows, 384 -> 1536 -> 384): 118.2
GFLOP, the tensor cores bound it (0.120 ms at 989 TFLOP/s); ``a`` is written
and read back, so the launches' own bounds sum to 0.129 ms
(``utils.roofline.fused_mlp_fwd_parts_work``).

Backward: replaces the fused-MLP ``_bwd_kernel`` (``_bwd``). The TPU kernel
adds dW1, db1, dW2, db2, dgamma and dbeta into constant-index blocks across
a grid that runs in order; on the GPU the CTAs run at once, so
``csrc/fused_mlp_bwd.cu`` computes the same function in six launches, with
no float atomics and a fixed order of summation (the same bits run to run):

* ``norm``: the two-pass LayerNorm, ``lnb``;
* ``hidden`` (streaming core, two products per hidden tile): h = lnb W1^T
  and da = dyb W2 (W2 read as stored), ``ab``, ``dhb`` and each 64-row
  block's sums of dh (db1);
* ``dln``: dln = dhb W1 in f32 (streaming core, W1 read as stored);
* ``dx``: the LayerNorm backward and each 64-row block's sums of dgamma,
  dbeta and db2;
* ``weights``: dW2 = dyb^T ab and dW1 = dhb^T lnb over row chunks (both
  operands transposed in shared memory), one f32 partial per chunk;
* ``reduce``: the chunks' and the row blocks' partials added in order.

Bound at the training shape: 295.6 GFLOP (0.299 ms at 989 TFLOP/s); the
launches' own bounds (``fused_mlp_bwd_parts_work``) sum to more, since
lnb, ab, dhb and dln go through device memory.

Rounding points (the TPU kernel's): LN in f32 with the two-pass variance
(not the fast variance of the unfused blocks and kernel 6), rounded to the
working dtype before fc1; the f32 b1 added to the f32 fc1 accumulator;
exact GELU in f32 (the kernels take erf from the TPU kernel's polynomial,
within 1.5e-7; the plain versions from ``torch.erf``); ``a`` rounded before
fc2; ``y = round(x32 + acc + b2)``.
:func:`mlp_block_reference` is the JAX package's oracle, which rounds fc1's
product before ``+ b1``; the tests hold both against JAX.

Weights are taken in the port's ``(out, in)`` layout: ``w1`` (hidden, C) is
the JAX ``w1`` (C, hidden) transposed, ``w2`` (C, hidden) the JAX ``w2``
transposed. Widths: C a multiple of 8 up to 1408 (fc1 holds an x row block
whole), hidden a multiple of 8. Launch counts: one per launch, on each
wrapper of :data:`FWD_LAUNCHES` and :data:`BWD_LAUNCHES`
(``fused_mlp_fwd_fc1.launches``, ``fused_mlp_bwd_hidden.launches``, ...).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dinox_torch.ops import _build

LN_EPS = 1e-5
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
MAX_DIM = 1408  # the widest x row block fc1 holds in shared memory (gemm_sm90.cuh MAX_K)
ROW_BLOCK = 64  # rows of a partial-sum block of the backward (its hidden launch's row block)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dinox_fused_mlp_fwd_fc1_bf16": [_P] * 6 + [_I, _I, _I, _P],
    "dinox_fused_mlp_fwd_fc2_bf16": [_P] * 5 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_norm_bf16": [_P] * 4 + [_I, _I, _P],
    "dinox_fused_mlp_bwd_hidden_bf16": [_P] * 8 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_dln_bf16": [_P] * 3 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_dx_bf16": [_P] * 6 + [_I, _I, _I, _P],
    "dinox_fused_mlp_bwd_weights_bf16": [_P] * 5 + [_I] * 5 + [_P],
    "dinox_fused_mlp_bwd_reduce": [_P] * 3 + [_I] * 4 + [_P],
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
    if c % 8 or not 0 < c <= MAX_DIM:
        raise ValueError(f"width {c} not taken by the fused MLP kernels (a multiple of 8, at most "
                         f"{MAX_DIM})")
    if hidden % 8 or hidden < 8:
        raise ValueError(f"hidden width {hidden} is not a positive multiple of 8")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_operands({"x": (x2, (m, c), bf16), "gamma": (gamma, (c,), f32),
                           "beta": (beta, (c,), f32), "w1": (w1, (hidden, c), bf16),
                           "b1": (b1, (hidden,), f32), "w2": (w2, (c, hidden), bf16), **extra},
                          x2.device, 32, "fused MLP")
    return m, c, hidden


def _ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


# -- kernel 7: two launches ------------------------------------------------------

def fused_mlp_fwd_fc1(x2, gamma, beta, w1, b1, a) -> None:
    """Launch fc1: ``a`` (M, hidden) bf16 = gelu(LN(x) W1^T + b1). Operands
    are checked by :func:`fused_mlp_forward`."""
    m, c = x2.shape
    _launch("fused_mlp", "dinox_fused_mlp_fwd_fc1_bf16", x2.device,
            *_ptrs(x2, gamma, beta, w1, b1, a), m, c, w1.shape[0])
    fused_mlp_fwd_fc1.launches += 1


def fused_mlp_fwd_fc2(a, x2, w2, b2, y) -> None:
    """Launch fc2: ``y`` = x + (a W2^T + b2)."""
    m, c = x2.shape
    _launch("fused_mlp", "dinox_fused_mlp_fwd_fc2_bf16", x2.device, *_ptrs(a, x2, w2, b2, y),
            m, c, a.shape[1])
    fused_mlp_fwd_fc2.launches += 1


def fused_mlp_forward(x2, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Rows ``(M, C)`` -> ``(M, C)``: the plain version for CPU tensors,
    kernel 7's two launches for CUDA."""
    if x2.device.type == "cpu":
        return fused_mlp_forward_reference(x2, gamma, beta, w1, b1, w2, b2)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {x2.device}")
    m, c, hidden = _check(x2, gamma, beta, w1, b1, w2, {"b2": (b2, (x2.shape[1],), torch.float32)})
    y = torch.empty_like(x2)
    if m == 0:
        return y
    a = torch.empty((m, hidden), dtype=x2.dtype, device=x2.device)
    fused_mlp_fwd_fc1(x2, gamma, beta, w1, b1, a)
    fused_mlp_fwd_fc2(a, x2, w2, b2, y)
    return y


# -- kernel 8: six launches ------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _chunks(m: int, c: int, hidden: int, device: torch.device) -> tuple[int, int]:
    chunks, rows, _ = _build.query("fused_mlp_bwd", "dinox_fused_mlp_bwd_chunks", (m, c, hidden),
                                   device)
    return chunks, rows


def weight_chunks(m: int, c: int, hidden: int, device: torch.device | str = "cuda"
                  ) -> tuple[int, int]:
    """(chunks, rows per chunk) of the weights launch over *m* rows on
    *device*: the fewest row chunks (a multiple of 64 rows each) whose
    tiles fill the SMs' resident CTA slots (``dinox_fused_mlp_bwd_chunks``),
    asked once per shape and device."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return _chunks(m, c, hidden, device)


def _workspace(m: int, c: int, hidden: int, device) -> dict[str, torch.Tensor]:
    """The backward's buffers between its launches."""
    bf16, f32 = torch.bfloat16, torch.float32
    chunks, rows = weight_chunks(m, c, hidden, device)
    return {"lnb": torch.empty((m, c), dtype=bf16, device=device),
            "ab": torch.empty((m, hidden), dtype=bf16, device=device),
            "dhb": torch.empty((m, hidden), dtype=bf16, device=device),
            "dln": torch.empty((m, c), dtype=f32, device=device),
            "part": torch.empty((math.ceil(m / ROW_BLOCK), 3 * c + hidden), dtype=f32, device=device),
            "wpart": torch.empty((chunks, 2 * c * hidden), dtype=f32, device=device),
            "chunks": chunks, "rows_per_chunk": rows}


def fused_mlp_bwd_norm(x2, gamma, beta, lnb) -> None:
    """Launch norm: ``lnb`` = bf16(LN(x)), the two-pass statistics."""
    m, c = x2.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_norm_bf16", x2.device,
            *_ptrs(x2, gamma, beta, lnb), m, c)
    fused_mlp_bwd_norm.launches += 1


def fused_mlp_bwd_hidden(lnb, dy2, w1, b1, w2, ab, dhb, part) -> None:
    """Launch hidden: ``ab``, ``dhb`` and the 64-row blocks' sums of dh into
    the last ``hidden`` columns of ``part``."""
    m, c = lnb.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_hidden_bf16", lnb.device,
            *_ptrs(lnb, dy2, w1, b1, w2, ab, dhb, part), m, c, w1.shape[0])
    fused_mlp_bwd_hidden.launches += 1


def fused_mlp_bwd_dln(dhb, w1, dln) -> None:
    """Launch dln: ``dln`` (M, C) f32 = dhb W1."""
    m, c = dln.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_dln_bf16", dhb.device, *_ptrs(dhb, w1, dln),
            m, c, w1.shape[0])
    fused_mlp_bwd_dln.launches += 1


def fused_mlp_bwd_dx(x2, gamma, dln, dy2, dx, part) -> None:
    """Launch dx: ``dx`` and the 64-row blocks' sums of dgamma, dbeta and
    db2 into the first ``3 C`` columns of ``part``."""
    m, c = x2.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_dx_bf16", x2.device,
            *_ptrs(x2, gamma, dln, dy2, dx, part), m, c, part.shape[1] - 3 * c)
    fused_mlp_bwd_dx.launches += 1


def fused_mlp_bwd_weights(dy2, ab, dhb, lnb, wpart, rows_per_chunk: int) -> None:
    """Launch weights: ``wpart`` ``(chunks, 2*C*hidden)`` f32 receives each
    row chunk's dW2 ``(C, hidden)`` then dW1 ``(hidden, C)``."""
    m, c = dy2.shape
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_weights_bf16", dy2.device,
            *_ptrs(dy2, ab, dhb, lnb, wpart), m, c, ab.shape[1], wpart.shape[0], rows_per_chunk)
    fused_mlp_bwd_weights.launches += 1


def fused_mlp_bwd_reduce(wpart, part, out, c: int, hidden: int) -> None:
    """Launch reduce: ``out`` f32 ``[dW2 | dW1 | dgamma | dbeta | db2 | db1]``
    from the chunk partials and the row-block partials, in order."""
    _launch("fused_mlp_bwd", "dinox_fused_mlp_bwd_reduce", out.device, *_ptrs(wpart, part, out),
            wpart.shape[0], part.shape[0], c, hidden)
    fused_mlp_bwd_reduce.launches += 1


# Each launch's wrapper by part name, in the order of the C entry points'
# part indices (the occupancy queries); each counts its own launches.
FWD_LAUNCHES = {"fc1": fused_mlp_fwd_fc1, "fc2": fused_mlp_fwd_fc2}
BWD_LAUNCHES = {"norm": fused_mlp_bwd_norm, "hidden": fused_mlp_bwd_hidden,
                "dln": fused_mlp_bwd_dln, "dx": fused_mlp_bwd_dx,
                "weights": fused_mlp_bwd_weights, "reduce": fused_mlp_bwd_reduce}
FWD_PARTS, BWD_PARTS = tuple(FWD_LAUNCHES), tuple(BWD_LAUNCHES)
for _fn in (*FWD_LAUNCHES.values(), *BWD_LAUNCHES.values()):
    _fn.launches = 0


def fused_mlp_backward(x2, gamma, beta, w1, b1, w2, dy2):
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)``: the plain backward for CPU
    tensors, kernel 8's six launches for CUDA (dx bf16, the rest f32)."""
    if x2.device.type == "cpu":
        return fused_mlp_backward_reference(x2, gamma, beta, w1, b1, w2, dy2)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused MLP backward for device {x2.device}")
    m, c, hidden = _check(x2, gamma, beta, w1, b1, w2, {"dy": (dy2, tuple(x2.shape), torch.bfloat16)})
    dev = x2.device
    dx = torch.empty_like(x2)
    size = 2 * c * hidden + 3 * c + hidden
    if m == 0:
        out = torch.zeros(size, dtype=torch.float32, device=dev)
    else:
        out = torch.empty(size, dtype=torch.float32, device=dev)  # the reduce writes every element
        ws = _workspace(m, c, hidden, dev)
        fused_mlp_bwd_norm(x2, gamma, beta, ws["lnb"])
        fused_mlp_bwd_hidden(ws["lnb"], dy2, w1, b1, w2, ws["ab"], ws["dhb"], ws["part"])
        fused_mlp_bwd_dln(ws["dhb"], w1, ws["dln"])
        fused_mlp_bwd_dx(x2, gamma, ws["dln"], dy2, dx, ws["part"])
        fused_mlp_bwd_weights(dy2, ws["ab"], ws["dhb"], ws["lnb"], ws["wpart"], ws["rows_per_chunk"])
        fused_mlp_bwd_reduce(ws["wpart"], ws["part"], out, c, hidden)
    ch = c * hidden
    dw2 = out[:ch].view(c, hidden)
    dw1 = out[ch:2 * ch].view(hidden, c)
    dgamma, dbeta, db2 = out[2 * ch:2 * ch + 3 * c].view(3, c).unbind(0)
    db1 = out[2 * ch + 3 * c:]
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


def fused_mlp_occupancy(part: str, c: int = 384, device: torch.device | str = "cuda"
                        ) -> dict[str, int]:
    """Registers per thread, dynamic shared memory per CTA (bytes) and
    resident CTAs per SM of launch *part* (one of :data:`FWD_PARTS` or
    :data:`BWD_PARTS`; fc1's instantiation depends on the width *c*), from
    the CUDA occupancy API on *device*."""
    if part in FWD_PARTS:
        vals = _build.query("fused_mlp", "dinox_fused_mlp_fwd_occupancy",
                            (FWD_PARTS.index(part), c), device)
    else:
        vals = _build.query("fused_mlp_bwd", "dinox_fused_mlp_bwd_occupancy",
                            (BWD_PARTS.index(part), c), device)
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm"), vals))


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
