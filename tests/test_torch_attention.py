"""The port's packed attention (dinox_torch.ops.flash_attention) against the
JAX package's: its plain version against the Pallas kernel run in interpret
mode on the CPU and against the XLA twin, and the wrapper's CPU path. The
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
from dinox_tpu.ops.flash_attention import _xla_sdpa_packed
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
