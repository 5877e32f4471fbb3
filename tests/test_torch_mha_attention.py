"""The port's head-major attention (kernels 4 and 5's plain versions, the
autograd Function, the sdpa dispatch and the validate twin) against the JAX
package's, and the ``attn_impl="xla"`` repair: the port's "xla" attention is
the JAX package's ``sdpa_xla``, held at bf16 element by element. The Pallas
kernels run in interpret mode on the CPU; the CUDA kernels are held against
the plain versions on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch import validate_attention
from dinox_torch.models import vit as torch_vit
from dinox_torch.ops.flash_attention import (
    flash_attention,
    mha_attention_backward,
    mha_attention_backward_reference,
    mha_attention_bwd_dkv,
    mha_attention_bwd_dq,
    mha_attention_reference,
)
from dinox_tpu.models import vit as jax_vit
from dinox_tpu.ops.flash_attention import _flash_bwd, _flash_fwd, _xla_sdpa
from dinox_tpu.ops.flash_attention import flash_attention as jax_flash_attention

# (b, heads, n, hd): hd 16 with a ragged N, ViT-G's hd 88, the MAE decoder's
# hd 32 with N past one 64-row tile.
SHAPES = [(2, 3, 37, 16), (2, 2, 33, 88), (1, 2, 65, 32)]
# The JAX package's own tolerances (tests/test_flash_attention.py): f32 the
# same math in another summation order, bf16 the kernel check's forward gate.
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# f32: another summation order; bf16: two bf16 ulps at |x| < 2 (the plain
# version follows the kernel's rounding points).
BWD_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _arrays(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_reference_matches_jax(shape, dtype):
    """Against the Pallas kernel (interpret mode) and its XLA twin."""
    arrays = _arrays(shape, 3, seed=0)
    got = mha_attention_reference(*_torch(arrays, dtype))
    assert got.shape == shape and got.dtype == getattr(torch, dtype)
    for jax_fn in (_flash_fwd, _xla_sdpa):
        want = np.asarray(jax_fn(*_jax(arrays, dtype)), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, atol=FWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_jax_pallas_kernel(shape, dtype):
    arrays = _arrays(shape, 4, seed=1)
    want = _flash_bwd(*_jax(arrays, dtype))
    got = mha_attention_backward_reference(*_torch(arrays, dtype))
    for g, w in zip(got, want):
        assert g.shape == shape and g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=BWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_autograd_matches_jax_grad(shape):
    arrays = _arrays(shape, 3, seed=2)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash_attention(q, k, v) ** 2),
                    argnums=(0, 1, 2))(*_jax(arrays, "float32"))
    leaves = [t.requires_grad_(True) for t in _torch(arrays, "float32")]
    (flash_attention(*leaves) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_wrappers_take_the_plain_path_on_cpu():
    q, k, v, do = _torch(_arrays((2, 3, 37, 32), 4, seed=3), "bfloat16")
    counters = (flash_attention, mha_attention_bwd_dq, mha_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out = flash_attention(q, k, v)
    grads = mha_attention_backward(q, k, v, do)
    assert [c.launches for c in counters] == before
    torch.testing.assert_close(out, mha_attention_reference(q, k, v), rtol=0, atol=0)
    for g, w in zip(grads, mha_attention_backward_reference(q, k, v, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sdpa_dispatch_on_cpu(impl):
    """On a CPU tensor both impls take sdpa_xla, which is kernel 4's plain
    version (one function, not a copy); the kernel is not launched."""
    assert torch_vit.sdpa_xla is mha_attention_reference
    q, k, v = _torch(_arrays((2, 3, 37, 16), 3, seed=4), "bfloat16")
    before = flash_attention.launches
    torch.testing.assert_close(torch_vit.sdpa(q, k, v, impl=impl), mha_attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert flash_attention.launches == before


def test_validate_twin_passes_on_cpu(capsys):
    assert validate_attention.main(["--device", "cpu", "--batch", "1", "--heads", "2",
                                    "--seq", "70", "--dim", "32"]) == 0
    out = capsys.readouterr().out
    assert "backend=cpu" in out and "rel_diff=" in out and "TFLOP/s" in out
    assert out.strip().splitlines()[-1] == "PASS"


def _bf16_steps(got, want):
    """|got - want| of two bf16 outputs (as f32 arrays) in bf16 steps at the
    element's magnitude or, below the outputs' root mean square, at that:
    there the difference comes from the rounding of P, not of the element."""
    rms = np.sqrt(np.mean(np.square(want, dtype=np.float64)))
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), rms)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_sdpa_xla_is_the_jax_sdpa_xla_at_bf16():
    """The repair: at (4, 6, 261, 64) bf16 the port's sdpa_xla differs from
    the JAX package's in at most 0.5% of the elements, each by at most one
    bf16 step (see _bf16_steps). (The packed kernel's plain version, which
    "xla" used to take, differs in about half.)"""
    arrays = _arrays((4, 6, 261, 64), 3, seed=5)
    got = torch_vit.sdpa_xla(*_torch(arrays, "bfloat16")).float().numpy()
    want = np.asarray(jax_vit.sdpa_xla(*_jax(arrays, "bfloat16")), np.float32)
    assert (got != want).mean() <= 0.005 and _bf16_steps(got, want).max() <= 1


def test_xla_attention_module_matches_flax_at_bf16():
    """The port's Attention("xla") against flax's Attention(attn_impl="xla")
    on the same weights and input, (4, 261, 384), 6 heads, bf16: at most 10%
    of the output elements differ (the proj rounding spreads the attention's
    few one-step differences)."""
    b, n, dim, heads = 4, 261, 384, 6
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    module = jax_vit.Attention(dim=dim, num_heads=heads, attn_impl="xla", dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    params = jax.tree_util.tree_map(  # live biases: flax initialises them to zero
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32),
        module.init(jax.random.key(0), xj)["params"])
    want = np.asarray(module.apply({"params": params}, xj), np.float32)
    attn = torch_vit.Attention(dim, heads, "xla")
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(attn, name).weight.copy_(torch.from_numpy(np.asarray(params[name]["kernel"]).T))
            getattr(attn, name).bias.copy_(torch.from_numpy(np.asarray(params[name]["bias"])))
        got = attn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, dim)
    assert (got.float().numpy() != want).mean() <= 0.10
