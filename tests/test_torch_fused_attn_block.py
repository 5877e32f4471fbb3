"""The port's fused attention half-block (dinox_torch.ops.fused_attn_block)
against the JAX package's, and the fused half-block paths of the port's
PatchViT against flax's.

The JAX side runs as tests/test_fused_attn_block.py runs it: the Pallas
kernel in interpret mode on the CPU. The port takes its plain version (the
kernel's rounding points) and the composed backward. Inputs come from numpy
seeds; weights go to the port transposed into its (out, in) layout. The
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models import config as torch_config
from dinox_torch.models.vit import PatchViT, takes_fused_attn, takes_fused_mlp
from dinox_torch.ops.fused_attn_block import fused_attn_block, fused_attn_block_reference
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import PatchViT as JaxPatchViT
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.ops import fused_attn_block as jax_fab

B, N, DIM, HEADS = 2, 13, 32, 2
NAMES = ["x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj"]
# f32: the same math in another summation order; bf16: the JAX package's
# bf16 test bound (tests/test_fused_attn_block.py).
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _args(seed=0, n=N):
    """numpy inputs in the JAX layout: x, gamma, beta, wqkv (dim, 3dim), bqkv,
    wproj (dim, dim), bproj."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [(rng.normal(size=(B, n, DIM)) * 0.5).astype(f), (1 + 0.1 * rng.normal(size=DIM)).astype(f),
            (0.1 * rng.normal(size=DIM)).astype(f), (rng.normal(size=(DIM, 3 * DIM)) * 0.1).astype(f),
            (0.02 * rng.normal(size=3 * DIM)).astype(f), (rng.normal(size=(DIM, DIM)) * 0.1).astype(f),
            (0.02 * rng.normal(size=DIM)).astype(f)]


def _jax(args, dtype):
    x, *rest = (jnp.asarray(a) for a in args)
    return [x.astype(dtype)] + rest


def _torch(args, dtype, grad=False):
    """The port's arguments: x in *dtype*, weights transposed to (out, in)."""
    out = [torch.from_numpy(a.T.copy() if i in (3, 5) else a) for i, a in enumerate(args)]
    out[0] = out[0].to(getattr(torch, dtype))
    return [t.requires_grad_(grad) for t in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_kernel(dtype):
    """y, qkv and attn of the plain version against the Pallas kernel's three
    outputs."""
    args = _args()
    want = jax_fab._call_fused(*_jax(args, getattr(jnp, dtype)), HEADS)
    got = fused_attn_block_reference(*_torch(args, dtype), HEADS)
    for name, g, w in zip(("y", "qkv", "attn"), got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=TOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_forward_matches_jax(dtype):
    args = _args(seed=1)
    want = np.asarray(jax_fab.fused_attn_block(*_jax(args, getattr(jnp, dtype)), HEADS), np.float32)
    with torch.no_grad():
        got = fused_attn_block(*_torch(args, dtype), HEADS)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, DIM)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


def _noise_only(name, shape):
    """True on the k third of bqkv: its gradient is zero in exact arithmetic
    (softmax does not change when one vector is added to every key), so both
    packages differentiate rounding noise there."""
    mask = np.zeros(shape, bool)
    if name == "bqkv":
        mask[DIM:2 * DIM] = True
    return mask


@pytest.mark.parametrize("n", [N, 7])
def test_gradients_match_jax(n):
    """All seven gradients of sum(y^2) at f32 against jax.grad through the
    JAX VJP (interpret-mode kernels), within 2e-4 x max|grad| (the JAX test's
    bound); the k third of bqkv is held to that absolute bound on both sides."""
    args = _args(seed=2, n=n)
    want = jax.grad(lambda *a: jnp.sum(jax_fab.fused_attn_block(*a, HEADS) ** 2),
                    argnums=tuple(range(7)))(*_jax(args, jnp.float32))
    targs = _torch(args, "float32", grad=True)
    (fused_attn_block(*targs, HEADS) ** 2).sum().backward()
    for i, (name, w) in enumerate(zip(NAMES, want)):
        w = np.asarray(w)
        g = targs[i].grad.numpy()
        if i in (3, 5):
            g = g.T
        assert g.dtype == np.float32 and g.shape == w.shape, name
        bound = 2e-4 * np.abs(w).max()
        noise = _noise_only(name, w.shape)
        assert np.abs(w).max() > 0, f"{name}: the test wants a live gradient"
        np.testing.assert_allclose(g[~noise], w[~noise], atol=bound, rtol=0, err_msg=name)
        assert np.abs(g[noise]).max(initial=0) <= bound and np.abs(w[noise]).max(initial=0) <= bound


def test_bf16_gradients_follow_the_argument_dtypes():
    args = _torch(_args(seed=3), "bfloat16", grad=True)
    (fused_attn_block(*args, HEADS).float() ** 2).sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert all(a.grad.dtype == torch.float32 and torch.isfinite(a.grad).all() for a in args[1:])


# -- the model ----------------------------------------------------------------

BASE = dict(name="tiny-fused", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=32,
            num_registers=2, scale_aware=True, attn_impl="pallas", gelu_approx=False)
FUSED = dict(fused_attn=True, fused_mlp=True)


def _models(dtype, seed=0):
    kw = dict(BASE, dtype=dtype, **FUSED)
    jcfg = jax_config.ModelConfig(**kw)
    params = init_backbone(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    model = PatchViT(torch_config.ModelConfig(**kw))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_backbone(params).items()},
                          strict=True)
    assert all(b.fused_attn and b.fused_mlp for b in model.blocks)
    return jcfg, params, model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
            rng.uniform(0.5, 3.0, size=(2, 3)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_patch_vit_matches_flax(dtype):
    jcfg, params, model = _models(dtype)
    x, sp = _inputs()
    want = np.asarray(JaxPatchViT(jcfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(sp)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(sp)).numpy()
    assert got.shape == want.shape == (2, jcfg.seq_len, 32)
    np.testing.assert_allclose(got, want, atol=2e-4 if dtype == "float32" else 6e-2, rtol=0)


def test_fused_patch_vit_gradients_match_flax():
    """Gradients of mean(out^2) for every parameter, f32, within 5e-3 of the
    largest (the JAX fused-vs-unfused model test's bound)."""
    jcfg, params, model = _models("float32", seed=2)
    x, sp = _inputs(seed=3)
    grads = jax.grad(lambda p: jnp.mean(JaxPatchViT(jcfg).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(sp)) ** 2))(params)
    want = jax_to_torch_backbone(jax.tree_util.tree_map(np.asarray, grads))
    (model(torch.from_numpy(x), torch.from_numpy(sp)) ** 2).mean().backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(1e-3, np.abs(w).max())
        np.testing.assert_allclose(got[k], w, atol=5e-3 * scale, rtol=0, err_msg=k)


def test_switches_keep_the_state_dict():
    on = PatchViT(torch_config.ModelConfig(**BASE, **FUSED))
    off = PatchViT(torch_config.ModelConfig(**BASE))
    assert [(k, v.shape) for k, v in on.state_dict().items()] == \
        [(k, v.shape) for k, v in off.state_dict().items()]
    for a, b in zip(on.state_dict().values(), off.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_exclusions():
    """tanh GELU keeps the unfused MLP and xla attention the unfused
    attention, silently; LoRA keeps both unfused."""
    cfg = torch_config.ModelConfig(**dict(BASE, gelu_approx=True), **FUSED)
    assert takes_fused_attn(cfg) and not takes_fused_mlp(cfg)
    blk = PatchViT(cfg).blocks[0]
    assert blk.fused_attn and not blk.fused_mlp
    assert not takes_fused_attn(cfg.replace(attn_impl="xla"))
    lora = cfg.replace(gelu_approx=False, lora_rank=2)
    assert not takes_fused_attn(lora) and not takes_fused_mlp(lora)
    blk = PatchViT(lora).blocks[0]
    assert not blk.fused_attn and not blk.fused_mlp


def test_enable_fused_attn_at_run_time():
    """Serving's switch: the same weights, the fused path from then on."""
    cfg = torch_config.ModelConfig(**dict(BASE, dtype="float32"))
    model = PatchViT(cfg).eval()
    x, sp = (torch.from_numpy(a) for a in _inputs(seed=4))
    with torch.no_grad():
        want = model(x, sp)
        model.enable_fused_attn()
        got = model(x, sp)
    assert model.cfg.fused_attn and all(b.fused_attn for b in model.blocks)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
