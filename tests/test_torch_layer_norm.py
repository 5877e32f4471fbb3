"""The LayerNorm of the port's blocks (dinox_torch.ops.layer_norm) on the CPU:
the plain backward against autograd of the eager module, with a constant
row (in float32 one whose fast variance clamps) and a zero row among the
rows; ``models/vit.LayerNorm`` on a CPU tensor giving the eager formula's
bits, gradients and state dict; and the wrapper's checks, with no launch.
The kernels are held against the plain versions on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dinox_torch.models.vit import LayerNorm
from dinox_torch.ops.layer_norm import (
    MAX_DIM,
    check,
    layer_norm,
    layer_norm_backward_reference,
    layer_norm_reference,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _eager(x, weight, bias, out_dtype, eps=1e-5):
    """The module's formula as it stood before the kernels."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(out_dtype)


def _constant_value(c: int, dtype: torch.dtype) -> float:
    """A value for a constant row of width *c*: in float32 one whose fast
    variance E[x^2] - E[x]^2 rounds below 0, so clamp_min cuts it. A bf16
    row's sums are exact or round alike, so its constant rows never clamp."""
    if dtype == torch.bfloat16:
        return 1.3
    for v in np.linspace(0.3, 9.7, 2000):
        row = torch.full((1, c), float(v))
        if _fast_var(row).item() < 0:
            return float(v)
    raise AssertionError(f"no constant row of width {c} clamps")


def _fast_var(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    return (xf * xf).mean(dim=-1, keepdim=True) - mean * mean


def _inputs(rows: int, c: int, dtype: torch.dtype, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, c), generator=g) * 2.0 + 0.5).to(dtype)
    x[1] = _constant_value(c, dtype)
    x[2] = 0.0  # a zero row: variance exactly 0, not clamped
    weight = 1.0 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    return x, weight, bias


def _close(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """Within *rel* of each element and 1e-6 of the largest: for a bf16 dx
    rel is one ulp (2^-7), the two sides rounding f32 values a few ulps of
    f32 apart; for f32 the sums' orders differ."""
    got, want = got.float(), want.float()
    tol = rel * want.abs() + 1e-6 * want.abs().max()
    assert torch.all((got - want).abs() <= tol), (got - want).abs().max().item()


@pytest.mark.parametrize("c", [8, 384, 1024, 1408])
@pytest.mark.parametrize("out_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("x_name", ["bfloat16", "float32"])
def test_plain_backward_matches_autograd_of_the_eager_module(x_name, out_name, c):
    x, weight, bias = _inputs(6, c, DTYPES[x_name])
    assert (_fast_var(x)[1].item() < 0) == (x_name == "float32")  # row 1 clamps in float32
    dy = torch.randn((6, c), generator=torch.Generator().manual_seed(1)).to(DTYPES[out_name])
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    _eager(xr, wr, br, DTYPES[out_name]).backward(dy)
    dx, dw, db = layer_norm_backward_reference(x, weight, dy)
    assert dx.dtype == x.dtype and dw.dtype == db.dtype == torch.float32
    _close(dx, xr.grad, 2.0 ** -7 if x_name == "bfloat16" else 1e-4)
    _close(dw, wr.grad, 1e-5)
    _close(db, br.grad, 1e-6)


@pytest.mark.parametrize("out_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("x_name", ["bfloat16", "float32"])
def test_module_on_the_cpu_is_the_eager_formula(x_name, out_name):
    """Bits of the output and of every gradient, and the state dict's keys."""
    x, weight, bias = _inputs(2 * 5, 64, DTYPES[x_name], seed=2)
    x = x.reshape(2, 5, 64)
    norm = LayerNorm(64, DTYPES[out_name])
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    assert list(norm.state_dict()) == ["weight", "bias"]
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    wb, bb = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    got, want = norm(xa), _eager(xb, wb, bb, DTYPES[out_name])
    assert got.dtype == DTYPES[out_name] and torch.equal(got, want)
    assert torch.equal(layer_norm_reference(x, weight, bias, DTYPES[out_name]), want)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(3)).to(got.dtype)
    got.backward(dy)
    want.backward(dy)
    for a, b in ((xa.grad, xb.grad), (norm.weight.grad, wb.grad), (norm.bias.grad, bb.grad)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case, error", [
    (dict(c=100), ValueError),                            # not a multiple of 8
    (dict(c=MAX_DIM + 8), ValueError),                    # above 8192
    (dict(x_dtype=torch.float16), TypeError),             # rows in another dtype
    (dict(out_dtype=torch.float16), TypeError),           # output in another dtype
    (dict(x_dtype=torch.float32), TypeError),             # float32 rows to bf16: no caller
    (dict(w_dtype=torch.bfloat16), TypeError),            # gamma not float32
    (dict(w_shape=(392,)), ValueError),                   # gamma of another width
])
def test_check_raises_on_what_the_kernels_cannot_take(case, error):
    c = case.get("c", 384)
    x = torch.zeros((3, c), dtype=case.get("x_dtype", torch.bfloat16))
    w = torch.ones(case.get("w_shape", (c,)), dtype=case.get("w_dtype", torch.float32))
    b = torch.zeros(c)
    with pytest.raises(error):
        check(x, w, b, case.get("out_dtype", torch.bfloat16))


@pytest.mark.parametrize("c", [8, 384, MAX_DIM])
def test_check_takes_the_widths_of_the_port(c):
    x = torch.zeros((3, c), dtype=torch.bfloat16)
    assert check(x, torch.ones(c), torch.zeros(c), torch.float32) == c


def test_no_layer_norm_off_the_cpu_and_the_card():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError):
        layer_norm(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), torch.float32)
