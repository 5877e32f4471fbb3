"""The port's packed attention (dinox_torch.ops.flash_attention) against the
JAX package's: its plain forward and backward against the Pallas kernels run
in interpret mode on the CPU and against the XLA twin, the autograd Function
against jax.grad, and the wrapper's CPU path. The kernels themselves are
held against the plain versions on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.ops.flash_attention import (
    flash_attention_packed,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_reference,
)
from dinox_tpu.ops.flash_attention import _packed_bwd, _packed_bwd_split, _xla_sdpa_packed
from dinox_tpu.ops.flash_attention import flash_attention_packed as jax_flash_attention_packed

# (b, n, 3*dim, heads): hd 16, hd 88, and the ViT-S serving row (N=261, hd 64)
SHAPES = [(4, 37, 3 * 96, 6), (2, 33, 3 * 176, 2), (1, 261, 3 * 384, 6)]
# f32: the same math in another summation order; bf16: the bench.py --check
# forward tolerance (bf16 output rounding plus accumulation order).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run_torch(x, heads, dtype):
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return packed_attention_reference(t, heads).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_pallas_kernel(shape, dtype):
    x = _qkv(shape[:3])
    heads = shape[3]
    want = np.asarray(jax_flash_attention_packed(jnp.asarray(x, dtype), heads), np.float32)
    got = _run_torch(x, heads, dtype)
    assert got.shape == (shape[0], shape[1], shape[2] // 3)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_xla_twin(shape, dtype):
    x = _qkv(shape[:3], seed=1)
    heads = shape[3]
    want = np.asarray(_xla_sdpa_packed(jnp.asarray(x, dtype), heads), np.float32)
    np.testing.assert_allclose(_run_torch(x, heads, dtype), want, atol=TOL[dtype], rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    x = torch.from_numpy(_qkv((2, 37, 3 * 96))).to(torch.bfloat16)
    before = flash_attention_packed.launches
    out = flash_attention_packed(x, 6)
    assert flash_attention_packed.launches == before
    torch.testing.assert_close(out, packed_attention_reference(x, 6), rtol=0, atol=0)


# (b, n, 3*dim, heads) and the JAX backward they are held against: the
# single kernel (kernel 2) at hd 32 and 64, the split dq/dkv pair (kernel 3)
# at hd 88, the ViT-G head dim.
BWD_CASES = [((2, 37, 3 * 64, 2), _packed_bwd), ((2, 37, 3 * 128, 2), _packed_bwd),
             ((1, 37, 3 * 176, 2), _packed_bwd_split)]
# f32: the same math in another summation order; bf16: two bf16 ulps at
# |x| < 2 (the plain version follows the kernel's rounding points, so most
# elements are bit-equal and the rest differ by one rounding).
BWD_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,jax_bwd", BWD_CASES, ids=["hd32", "hd64", "hd88-split"])
def test_backward_reference_matches_jax_pallas_kernels(shape, jax_bwd, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape[:3]).astype(np.float32)
    g = rng.normal(size=shape[:2] + (shape[2] // 3,)).astype(np.float32)
    heads = shape[3]
    want = np.asarray(jax_bwd(jnp.asarray(x, dtype), jnp.asarray(g, dtype), heads), np.float32)
    tdt = getattr(torch, dtype)
    got = packed_attention_backward_reference(torch.from_numpy(x).to(tdt),
                                              torch.from_numpy(g).to(tdt), heads)
    assert got.dtype == tdt and got.shape == shape[:3]
    np.testing.assert_allclose(got.float().numpy(), want, atol=BWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("shape", [(2, 37, 3 * 64, 2), (1, 33, 3 * 176, 2)])
def test_autograd_matches_jax_grad(shape):
    x = _qkv(shape[:3], seed=3)
    heads = shape[3]
    want = np.asarray(jax.grad(lambda t: jnp.sum(jax_flash_attention_packed(t, heads) ** 2))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    (flash_attention_packed(t, heads) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-5, rtol=0)


def test_backward_wrapper_takes_plain_path_on_cpu():
    x = torch.from_numpy(_qkv((2, 37, 3 * 96))).to(torch.bfloat16)
    g = torch.from_numpy(_qkv((2, 37, 96), seed=4)).to(torch.bfloat16)
    before = (packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches)
    got = packed_attention_backward(x, g, 6)
    assert (packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches) == before
    torch.testing.assert_close(got, packed_attention_backward_reference(x, g, 6), rtol=0, atol=0)
