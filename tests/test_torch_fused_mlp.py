"""The port's fused MLP half-block (dinox_torch.ops.fused_mlp) against the
JAX package's: forward and all seven gradients against the Pallas kernels run
in interpret mode on the CPU (as tests/test_fused_mlp.py runs them), the
oracle against the JAX oracle, the ragged row count, the cotangent dtypes,
and the fused MLP path of the port's PatchViT against its unfused path.
Inputs come from numpy seeds; weights go to the port transposed into its
(out, in) layout. The kernels themselves are held against the plain versions
on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.models.vit import PatchViT
from dinox_torch.ops.fused_mlp import (
    fused_mlp_backward,
    fused_mlp_block,
    fused_mlp_forward,
    mlp_block_reference,
)
from dinox_tpu.ops import fused_mlp as jax_fm

NAMES = ["x", "gamma", "beta", "w1", "b1", "w2", "b2"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # bf16: the JAX package's bf16 forward bound


def _args(b=2, n=16, c=32, h=128, seed=0):
    """numpy inputs in the JAX layout (tests/test_fused_mlp.py's scales):
    x, gamma, beta, w1 (c, h), b1, w2 (h, c), b2."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(b, n, c)).astype(f), (1.0 + 0.1 * rng.normal(size=c)).astype(f),
            (0.1 * rng.normal(size=c)).astype(f), (0.1 * rng.normal(size=(c, h))).astype(f),
            (0.1 * rng.normal(size=h)).astype(f), (0.1 * rng.normal(size=(h, c))).astype(f),
            (0.1 * rng.normal(size=c)).astype(f)]


def _jax(args, dtype):
    x, *rest = (jnp.asarray(a) for a in args)
    return [x.astype(dtype)] + rest


def _torch(args, dtype, grad=False):
    out = [torch.from_numpy(a.T.copy() if i in (3, 5) else a) for i, a in enumerate(args)]
    out[0] = out[0].to(getattr(torch, dtype))
    return [t.requires_grad_(grad) for t in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 7])
def test_forward_matches_jax_kernel(dtype, n):
    """The autograd Function (the plain forward on the CPU) against the
    Pallas forward; n=7 gives 2 x 7 rows, which the JAX kernel pads and the
    port's kernel masks."""
    args = _args(n=n)
    want = np.asarray(jax_fm.fused_mlp_block(*_jax(args, getattr(jnp, dtype))), np.float32)
    with torch.no_grad():
        got = fused_mlp_block(*_torch(args, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, 32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_jax_oracle(dtype):
    args = _args(seed=1)
    want = np.asarray(jax_fm.mlp_block_reference(*_jax(args, getattr(jnp, dtype))), np.float32)
    got = mlp_block_reference(*_torch(args, dtype)).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("n", [16, 7])
def test_gradients_match_jax(n):
    """All seven gradients of sum(sin(y)) at f32 against jax.grad through the
    Pallas VJP, within 1e-4 x max(1, max|grad|) (the JAX test's bound)."""
    args = _args(n=n, seed=2)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_fm.fused_mlp_block(*a))),
                    argnums=tuple(range(7)))(*_jax(args, jnp.float32))
    targs = _torch(args, "float32", grad=True)
    torch.sin(fused_mlp_block(*targs)).sum().backward()
    for i, (name, w) in enumerate(zip(NAMES, want)):
        w = np.asarray(w)
        g = targs[i].grad.numpy()
        if i in (3, 5):
            g = g.T
        assert g.dtype == np.float32 and g.shape == w.shape, name
        assert np.abs(w).max() > 0, f"{name}: the test wants a live gradient"
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=name)


def test_plain_backward_matches_jax_kernel_bf16():
    """The plain backward at bf16 against the Pallas backward kernel on the
    same rows: dx within 3e-2, the f32 parameter gradients within 2e-2 of
    the largest."""
    args = _args(n=7, seed=3)
    j = _jax(args, jnp.bfloat16)
    rng = np.random.default_rng(4)
    dy = rng.normal(size=(14, 32)).astype(np.float32)
    want = jax_fm._bwd(j[0].reshape(14, 32), j[1].reshape(1, 32), j[2].reshape(1, 32),
                       j[3].astype(jnp.bfloat16), j[4].reshape(1, -1), j[5].astype(jnp.bfloat16),
                       jnp.asarray(dy, jnp.bfloat16))
    t = _torch(args, "bfloat16")
    got = fused_mlp_backward(t[0].reshape(14, 32), t[1], t[2], t[3].bfloat16(), t[4],
                             t[5].bfloat16(), torch.from_numpy(dy).bfloat16())
    for i, (name, g, w) in enumerate(zip(["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"],
                                         got, want)):
        w = np.asarray(w, np.float32).reshape(g.shape[::-1] if i in (3, 5) else g.shape)
        g = g.float().numpy()
        if i in (3, 5):
            g = g.T
        tol = 3e-2 if i == 0 else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_cotangent_dtypes_follow_the_arguments():
    """db2 comes back in b2's dtype even when it differs from b1's, as the
    JAX VJP does; dx in x's dtype."""
    args = _torch(_args(), "bfloat16", grad=True)
    args[6] = args[6].detach().bfloat16().requires_grad_(True)
    fused_mlp_block(*args).float().sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert args[4].grad.dtype == torch.float32 and args[6].grad.dtype == torch.bfloat16


def test_wrappers_take_the_plain_path_on_cpu():
    t = _torch(_args(n=7), "float32")
    x2 = t[0].reshape(14, 32)
    assert fused_mlp_forward(x2, *t[1:]).shape == (14, 32)
    dx, *grads = fused_mlp_backward(x2, *t[1:6], torch.ones(14, 32))
    assert dx.shape == (14, 32) and [g.shape for g in grads] == [
        (32,), (32,), (128, 32), (128,), (32, 128), (32,)]


CFG = dict(name="t", img_size=28, patch=14, dim=32, depth=2, heads=2, num_registers=2,
           scale_aware=True, attn_impl="xla", dtype="float32", gelu_approx=False)


def test_model_fused_mlp_matches_unfused():
    """fused_mlp=True on the same parameters: outputs within 1e-5 and every
    gradient within 1e-5 of the largest, as the JAX model test holds it."""
    unfused = PatchViT(ModelConfig(**CFG))
    fused = PatchViT(ModelConfig(**CFG, fused_mlp=True))
    fused.load_state_dict(unfused.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
    sp = torch.tensor([[0.7, 0.7, 1.5], [1.0, 1.0, 2.0]])
    outs = []
    for model in (unfused, fused):
        out = model(x, sp)
        torch.sin(out).sum().backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)
    for (name, a), b in zip(unfused.named_parameters(), fused.parameters()):
        scale = a.grad.abs().max().item() + 1e-6
        torch.testing.assert_close(b.grad / scale, a.grad / scale, rtol=0, atol=1e-5, msg=name)
