"""The control's lower precision: the reference with each matrix product's
operands rounded to float8 (e4m3, three mantissa bits), the step below the
bfloat16 compute that the configurations state. Each operand is scaled so
that its largest magnitude sits at e4m3's largest finite value (448),
rounded, and scaled back; the product and the sums stay float32. The
backward passes each operand's gradient straight through the rounding, as
float8 training recipes do for the forward's casts."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x)


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(fp8(a), fp8(b))
