"""LayerNorm of the port's blocks, forward and backward: hand-written Hopper
kernels and their plain PyTorch versions.

The function is flax's LayerNorm as ``models/vit.LayerNorm`` computes it:
float32 statistics with the fast variance ``E[x^2] - E[x]^2`` clipped at 0,
``y = (x - mean) * (rsqrt(var + eps) * gamma) + beta`` rounded once to the
output dtype (bf16 for the block and ScaleEmbedding norms, float32 for the
final and the MAE decoder norm, which take the bf16 rows as they are). It replaces no TPU kernel: the JAX package
leaves the norm to XLA, which fuses it. Run eagerly it is ~14 float32
launches forward and ~35 backward; ``csrc/layer_norm.cu`` computes it in
one launch forward (x read once, y written once; per-row mean and rstd
only when a backward follows) and two backward (dx with per-CTA partial
sums of dgamma and dbeta, then their fixed-order sum: no atomics, equal
bits run to run). Memory bounds it: 103 MB forward and 154 MB backward at
the ViT-S training shape (66,816 rows of 384, bf16), 31 and 46 us at
3.35 TB/s.

:func:`layer_norm` takes the plain version, :func:`layer_norm_reference`
(the eager formula; autograd differentiates it), for a CPU tensor. For a
CUDA tensor it launches the kernels or raises: x bf16 or float32 with a
width C that is a multiple of 8 up to :data:`MAX_DIM`, float32 gamma and
beta, a bf16 or float32 output (float32 rows to float32 only: no caller
rounds them to bf16). Where a gradient is wanted it goes through
a ``torch.autograd.Function`` that saves x and the row statistics; else
the forward kernel alone runs. :func:`layer_norm_backward_reference` is
the plain backward. Launch counts: ``layer_norm_fwd.launches``,
``layer_norm_bwd.launches`` and ``layer_norm_bwd_params.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dinox_torch.ops import _build

LN_EPS = 1e-5
MAX_DIM = 8192  # 256 threads a row x 4 vectors of 8 columns (csrc/layer_norm.cu MAX_C)
# (x, y) dtypes: the block and ScaleEmbedding norms, the final and the MAE
# decoder norm, a float32 model's norms.
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
         (torch.float32, torch.float32))

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dinox_layer_norm_fwd": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    "dinox_layer_norm_bwd": [_P] * 7 + [_I] * 5 + [_P],
    "dinox_layer_norm_bwd_params": [_P] * 3 + [_I, _I, _P],
    "dinox_layer_norm_bwd_grid": [_I] * 4 + [ctypes.POINTER(_I)],
}
_fns: dict = {}


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         out_dtype: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """Plain version: float32 fast-variance statistics, output in *out_dtype*."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(out_dtype)


def layer_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                                  eps: float = LN_EPS) -> tuple[torch.Tensor, ...]:
    """Plain backward of :func:`layer_norm_reference`: ``(dx, dweight,
    dbias)``, dx in x's dtype and the others float32. ``dx = rstd (dxh -
    mean(dxh) - xhat mean(dxh xhat))`` with ``dxh = dy gamma``; a row whose
    fast variance was clamped drops the last term, as ``clamp_min``'s
    gradient does."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    xhat = (xf - mean) * rstd
    d = dy.float()
    dxh = d * weight
    a2 = torch.where(var < 0, 0.0, (dxh * xhat).mean(dim=-1, keepdim=True))
    dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True) - xhat * a2)
    rows, xhat_rows = d.reshape(-1, x.shape[-1]), xhat.reshape(-1, x.shape[-1])
    return dx.to(x.dtype), (rows * xhat_rows).sum(dim=0), rows.sum(dim=0)


def check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype) -> int:
    """Raise unless the kernels take *x*'s rows with these parameters and
    output dtype; returns the width C. Launches nothing."""
    c = x.shape[-1] if x.dim() else 0
    if c % 8 or not 8 <= c <= MAX_DIM:
        raise ValueError(f"width {c} not taken by the LayerNorm kernels (a multiple of 8 from 8 to "
                         f"{MAX_DIM})")
    if (x.dtype, out_dtype) not in PAIRS:
        raise TypeError(f"the LayerNorm kernels take bfloat16 rows to bfloat16 or float32 and float32 "
                        f"rows to float32, got {x.dtype} to {out_dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32:
            raise TypeError(f"the LayerNorm kernels take a float32 {name}, got {p.dtype}")
        if p.dim() != 1 or p.shape[0] != c:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, expected ({c},)")
        if p.get_device() != x.get_device():
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return c


def _dense(t: torch.Tensor) -> torch.Tensor:
    """*t* contiguous and 16-byte aligned, so its rows are the kernels'
    (copied only where it is neither: a rank's token chunk, an expanded
    gradient)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _fn(symbol: str):
    """The C entry point, its argtypes bound once."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load("layer_norm"), symbol)
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _launch(symbol: str, index: int, *args) -> None:
    """Call *symbol* with *args* and the current stream of CUDA device
    *index*, on that device."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(symbol, index, *args)
    err = _fn(symbol)(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, y: torch.Tensor,
                   stats: torch.Tensor | None = None, eps: float = LN_EPS) -> None:
    """Launch the forward: *y* from the m rows of width C of *x* (its last
    axis), and where *stats* ``(2, m)`` float32 is given, each row's mean
    and rstd (negated where the fast variance was clamped). Operands are
    checked by :func:`layer_norm`."""
    c = x.shape[-1]
    m = x.numel() // c
    f32 = torch.float32
    mean = None if stats is None else stats.data_ptr()
    rstd = None if stats is None else mean + 4 * m
    _launch("dinox_layer_norm_fwd", x.get_device(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean, rstd, m, c, int(x.dtype == f32), int(y.dtype == f32), eps)
    layer_norm_fwd.launches += 1


@functools.lru_cache(maxsize=256)
def _bwd_grid(m: int, c: int, x_f32: bool, dy_f32: bool, index: int) -> int:
    grid = _I()
    with torch.cuda.device(index):
        err = _fn("dinox_layer_norm_bwd_grid")(m, c, int(x_f32), int(dy_f32), ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"dinox_layer_norm_bwd_grid failed: cudaError {err}")
    return grid.value


def backward_grid(m: int, c: int, x_dtype: torch.dtype, dy_dtype: torch.dtype,
                  device: torch.device | str = "cuda") -> int:
    """CTAs of the backward launch for *m* rows of *c* on *device*: the SMs'
    resident CTAs, or fewer where the rows need fewer; one partial row of
    dgamma and dbeta each. Asked once per shape."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _bwd_grid(m, c, x_dtype == torch.float32, dy_dtype == torch.float32, index)


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                   dx: torch.Tensor, part: torch.Tensor | None, grid: int) -> None:
    """Launch the backward's row kernel over *grid* CTAs: *dx* and, where
    *part* ``(grid, 2C)`` float32 is given, each CTA's partial sums of
    dgamma and dbeta."""
    c = x.shape[-1]
    m = x.numel() // c
    f32 = torch.float32
    _launch("dinox_layer_norm_bwd", x.get_device(), x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
            stats.data_ptr(), stats.data_ptr() + 4 * m, dx.data_ptr(),
            None if part is None else part.data_ptr(), m, c, int(x.dtype == f32),
            int(dy.dtype == f32), grid)
    layer_norm_bwd.launches += 1


def layer_norm_bwd_params(part: torch.Tensor, dweight: torch.Tensor, dbias: torch.Tensor) -> None:
    """Launch the sum of the partial rows *part* ``(parts, 2C)`` into
    *dweight* and *dbias*."""
    parts, two_c = part.shape
    _launch("dinox_layer_norm_bwd_params", part.get_device(), part.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), parts, two_c // 2)
    layer_norm_bwd_params.launches += 1


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0
layer_norm_bwd_params.launches = 0


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
             eps: float, c: int, stats: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    x = _dense(x)
    m = x.numel() // c
    y = x.new_empty(x.shape, dtype=out_dtype)
    st = x.new_empty((2, m), dtype=torch.float32) if stats else None
    if m:
        layer_norm_fwd(x, weight, bias, y, st, eps)
    return y, x, st


def _backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
              params: bool) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    c = x.shape[-1]
    m = x.numel() // c
    dx = torch.empty_like(x)
    f32 = torch.float32
    new = x.new_empty if m else x.new_zeros
    dw, db = (new(c, dtype=f32), new(c, dtype=f32)) if params else (None, None)
    if m == 0:
        return dx, dw, db
    grid = _bwd_grid(m, c, x.dtype == f32, dy.dtype == f32, x.get_device())
    part = x.new_empty((grid, 2 * c), dtype=f32) if params else None
    layer_norm_bwd(x, weight, dy, stats, dx, part, grid)
    if params:
        layer_norm_bwd_params(part, dw, db)
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, out_dtype, eps, c):
        y, x, stats = _forward(x, weight, bias, out_dtype, eps, c, stats=True)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        _, wants_w, wants_b = ctx.needs_input_grad[:3]
        dx, dw, db = _backward(x, weight, _dense(dy), stats, wants_w or wants_b)
        return dx, dw if wants_w else None, db if wants_b else None, None, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over *x*'s last axis, output in *out_dtype*: the plain
    version for a CPU tensor, the kernels for a CUDA tensor."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_reference(x, weight, bias, out_dtype, eps)
        raise ValueError(f"no LayerNorm kernel for device {x.device}")
    c = check(x, weight, bias, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, out_dtype, eps, c)
    return _forward(x, weight, bias, out_dtype, eps, c, stats=False)[0]
