"""The port's PatchViT against the JAX package's on the same weights and the
same NHWC input: flax params made by init_backbone, perturbed so that no bias
is zero and no LayerNorm scale is one, carried across with the port's
jax_to_torch_backbone. On the CPU the JAX model takes XLA attention and the
port its plain attention, so this holds the slice's forward as a whole."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models import config as torch_config
from dinox_torch.models.vit import PatchViT
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import PatchViT as JaxPatchViT
from dinox_tpu.models.vit import init_backbone

BASE = dict(name="tiny", img_size=56, patch=14, dim=64, depth=2, heads=2, out_dim=32,
            scale_aware=True)

# (dtype, gelu_approx, with spacing, num_registers, attn_impl)
CASES = [
    ("float32", True, True, 4, "pallas"),
    ("float32", False, False, 0, "xla"),
    ("float32", False, True, 4, "pallas"),
    ("bfloat16", True, True, 4, "pallas"),
    ("bfloat16", False, True, 0, "pallas"),
    ("bfloat16", True, False, 4, "xla"),
]


def _perturbed_params(jcfg, seed):
    params = init_backbone(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _both(dtype, gelu_approx, num_registers, attn_impl, seed=0):
    kw = dict(BASE, dtype=dtype, gelu_approx=gelu_approx, num_registers=num_registers,
              attn_impl=attn_impl)
    jcfg = jax_config.ModelConfig(**kw)
    params = _perturbed_params(jcfg, seed)
    model = PatchViT(torch_config.ModelConfig(**kw)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_backbone(params).items()},
                          strict=True)
    return jcfg, params, model


@pytest.mark.parametrize("dtype,gelu_approx,with_spacing,num_registers,attn_impl", CASES)
def test_patch_vit_matches_jax(dtype, gelu_approx, with_spacing, num_registers, attn_impl):
    jcfg, params, model = _both(dtype, gelu_approx, num_registers, attn_impl)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 56, 56, 3)).astype(np.float32)
    spacing = rng.uniform(0.5, 3.0, size=(3, 3)).astype(np.float32) if with_spacing else None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxPatchViT(jcfg).apply(
            {"params": params}, jnp.asarray(x), None if spacing is None else jnp.asarray(spacing)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if spacing is None else torch.from_numpy(spacing))
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, jcfg.seq_len, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)
        cos = np.sum(got[:, 0] * want[:, 0], -1) / (
            np.linalg.norm(got[:, 0], axis=-1) * np.linalg.norm(want[:, 0], axis=-1))
        assert cos.min() >= 0.999, cos


def test_embed_keeps_compute_dtype_and_token_order():
    _, _, model = _both("bfloat16", True, 4, "pallas")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        tokens = model.embed(x, torch.ones(2, 3))
        no_scale = model.embed(x, None)
    assert tokens.dtype == torch.bfloat16 and tokens.shape == (2, 1 + 16 + 4, 64)
    # registers come last and carry no scale token; CLS and patches do
    torch.testing.assert_close(tokens[:, -4:], no_scale[:, -4:], rtol=0, atol=0)
    assert not torch.equal(tokens[:, :17], no_scale[:, :17])


def test_unported_options_raise():
    # LoRA (test_torch_lora_peft.py) and MoE (test_torch_moe.py) are ported:
    # an MoE config builds, with the MoE MLP in every moe_every'th block.
    moe = PatchViT(torch_config.ModelConfig(**dict(BASE, moe_experts=2, moe_every=2)))
    assert [hasattr(b, "moe") for b in moe.blocks] == [i % 2 == 1 for i in range(len(moe.blocks))]
    assert not any(hasattr(b, "mlp") for b in moe.blocks if hasattr(b, "moe"))
    with pytest.raises(ValueError):
        PatchViT(torch_config.ModelConfig(**dict(BASE, lora_rank=4, lora_targets=("qkv", "norm1"))))


def test_config_schema_matches_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(torch_config.ModelConfig) == fields(jax_config.ModelConfig)
    assert torch_config.HUB_DEFAULT_CONFIG == jax_config.HUB_DEFAULT_CONFIG
    assert ({k: v.to_dict() for k, v in torch_config.MODEL_CONFIGS.items()}
            == {k: v.to_dict() for k, v in jax_config.MODEL_CONFIGS.items()})
    c = torch_config.MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    j = jax_config.MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    assert (c.n_patches, c.seq_len, c.params_millions) == (j.n_patches, j.seq_len, j.params_millions)
    with pytest.raises(ValueError):
        torch_config.ModelConfig(dim=100, heads=6)
