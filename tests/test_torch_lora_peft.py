"""LoRA in the port (models.vit.Linear's factors, zoo.peft) against the JAX
package's (models.lora.LoraDense, zoo.peft): the LoRA PatchViT against flax
on carried, non-zero factors (float32 within 1e-5, bfloat16 at
test_torch_vit.py's tolerance), the interop carrying lora_A/lora_B both
ways, a fresh adapter as a no-op, target subsets, merged against unmerged,
count_parameters against JAX's, and adapters saved by either package
loading into the other with equal arrays and an equal config JSON."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models import config as t_config
from dinox_torch.models.vit import PatchViT
from dinox_torch.zoo import peft as t_peft
from dinox_torch.zoo.hub import LoadedModel
from dinox_torch.zoo.interop import jax_to_torch_backbone, torch_to_jax_backbone
from dinox_tpu.models import config as j_config
from dinox_tpu.models.vit import PatchViT as JPatchViT
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.zoo import peft as j_peft
from dinox_tpu.zoo.hub import LoadedModel as JLoadedModel

BASE = dict(name="tiny", img_size=28, patch=14, dim=32, depth=2, heads=2, out_dim=16,
            scale_aware=True, num_registers=4)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.1)


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.normal(size=a.shape).astype(np.float32), tree)


def _torch_model(kw, params, cls=PatchViT):
    model = cls(t_config.ModelConfig(**kw)) if cls is PatchViT else cls(t_config.ModelConfig(**kw), "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_backbone(params).items()},
                          strict=True)
    return model.eval()


def _inputs(seed=1, n=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 3)).astype(np.float32),
            rng.uniform(0.5, 3.0, size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("dtype,targets", [("float32", ("qkv", "proj", "fc1", "fc2")),
                                           ("float32", ("qkv", "fc2")),
                                           ("bfloat16", ("qkv", "proj", "fc1", "fc2"))])
def test_lora_patch_vit_matches_flax(dtype, targets):
    kw = dict(BASE, dtype=dtype, lora_targets=targets, **LORA)
    jcfg = j_config.ModelConfig(**kw)
    params = _perturbed(init_backbone(jcfg, jax.random.key(0)), 2)  # non-zero lora_B
    model = _torch_model(kw, params)
    x, sp = _inputs()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JPatchViT(jcfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(sp)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(sp)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)
        cos = np.sum(got[:, 0] * want[:, 0], -1) / (
            np.linalg.norm(got[:, 0], axis=-1) * np.linalg.norm(want[:, 0], axis=-1))
        assert cos.min() >= 0.999, cos
    names = {k for k in model.state_dict() if ".lora_" in k}
    assert names == {f"blocks.{i}.{'attn' if t in ('qkv', 'proj') else 'mlp'}.{t}.lora_{f}.weight"
                     for i in range(2) for t in targets for f in "AB"}


def test_interop_carries_the_factors_both_ways():
    jcfg = j_config.ModelConfig(**BASE, **LORA)
    params = _perturbed(init_backbone(jcfg, jax.random.key(1)), 3)
    sd = jax_to_torch_backbone(params)
    a = params["blocks_1"]["mlp"]["fc1"]["lora_A"]
    b = params["blocks_1"]["mlp"]["fc1"]["lora_B"]
    np.testing.assert_array_equal(sd["blocks.1.mlp.fc1.lora_A.weight"], a.T)  # (r, in)
    np.testing.assert_array_equal(sd["blocks.1.mlp.fc1.lora_B.weight"], b.T)  # (out, r)
    assert sd["blocks.0.attn.qkv.lora_A.weight"].shape == (4, 32)
    assert sd["blocks.0.attn.qkv.lora_B.weight"].shape == (96, 4)
    back = torch_to_jax_backbone(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_dropout_acts_only_in_training_and_draws_from_the_generator():
    kw = dict(BASE, dtype="float32", **LORA)
    model = _torch_model(kw, _perturbed(init_backbone(j_config.ModelConfig(**kw), jax.random.key(0)), 4))
    x, sp = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        ref = model(x, sp)
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(x, sp)
        outs = []
        for seed in (5, 5, 6):
            model.set_lora_generator(torch.Generator().manual_seed(seed))
            outs.append(model(x, sp))
        model.eval()
        assert torch.equal(model(x, sp), ref)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], ref)


@pytest.fixture(scope="module")
def bases():
    kw = dict(BASE, dtype="float32")
    jcfg = j_config.ModelConfig(**kw)
    params = _perturbed(init_backbone(jcfg, jax.random.key(0)), 6)
    return JLoadedModel(jcfg, params), _torch_model(kw, params, LoadedModel)


@pytest.mark.parametrize("targets", [None, ["qkv"], ["proj", "fc1"]])
def test_fresh_adapter_is_a_no_op_and_counts_match(bases, targets):
    jbase, base = bases
    lora = t_peft.apply_lora(base, rank=4, alpha=8.0, target_modules=targets, dropout=0.0)
    jlora = j_peft.apply_lora(jbase, rank=4, alpha=8.0, target_modules=targets, dropout=0.0)
    x, sp = _inputs()
    assert torch.equal(lora(x, sp), base(x, sp))
    assert t_peft.count_parameters(lora) == j_peft.count_parameters(jlora)
    assert t_peft.count_parameters(base) == j_peft.count_parameters(jbase)
    assert lora.cfg.lora_targets == tuple(targets or t_peft.DEFAULT_TARGET_MODULES)
    trainable = {k for k, p in lora.named_parameters() if p.requires_grad}
    assert trainable == set(lora.adapter_params()) and trainable
    assert not any(k.startswith(t_peft.FROZEN_SUBTREES + t_peft.FROZEN_LEAVES) for k in trainable)
    for a in (m.lora_A.weight for m in lora.lora_layers()):
        assert a.abs().max() <= (1 / a.shape[1]) ** 0.5 and a.abs().max() > 0
    with pytest.raises(ValueError):
        t_peft.apply_lora(base, target_modules=["qkv", "head"])


def _trained(lora, seed=7):
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for p in lora.adapter_params().values():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return lora


def test_merged_equals_unmerged(bases):
    _, base = bases
    lora = _trained(t_peft.apply_lora(base, rank=4, alpha=8.0, dropout=0.0))
    merged = t_peft.merge_adapter(lora)
    assert merged.cfg.lora_rank == 0 and not any(".lora_" in k for k in merged.state_dict())
    x, sp = _inputs()
    np.testing.assert_allclose(merged(x, sp).numpy(), lora(x, sp).detach().numpy(), atol=1e-5, rtol=0)
    assert not torch.allclose(merged(x, sp), base(x, sp), atol=1e-3)


def test_adapters_cross_between_packages(bases, tmp_path):
    jbase, base = bases
    lora = _trained(t_peft.apply_lora(base, rank=4, alpha=8.0, target_modules=["qkv", "fc2"],
                                      dropout=0.05))
    t_peft.save_adapter(lora, tmp_path / "torch")
    jlora = j_peft.load_adapter(jbase, tmp_path / "torch")
    for k, v in lora.adapter_params().items():
        parts = k.split(".")  # blocks.N.attn.qkv.lora_A.weight
        leaf = jlora.params[f"blocks_{parts[1]}"][parts[2]][parts[3]][parts[4]]
        np.testing.assert_array_equal(np.asarray(leaf).T, v.detach().numpy())
    j_peft.save_adapter(jlora, tmp_path / "jax")
    assert ((tmp_path / "jax" / "adapter_config.json").read_text()
            == (tmp_path / "torch" / "adapter_config.json").read_text())
    back = t_peft.load_adapter(base, tmp_path / "jax")
    assert back.cfg == lora.cfg.replace(lora_targets=("fc2", "qkv"))  # sorted on disk
    for k, v in lora.adapter_params().items():
        assert torch.equal(back.adapter_params()[k], v), k
    x, sp = _inputs()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jlora(jnp.asarray(x), jnp.asarray(sp)))
    np.testing.assert_allclose(back(x, sp).detach().numpy(), want, atol=1e-5, rtol=0)
    merged_j = j_peft.merge_adapter(jlora)
    merged_t = t_peft.merge_adapter(back)
    for k, v in jax_to_torch_backbone(merged_j.params).items():
        np.testing.assert_array_equal(merged_t.state_dict()[k].numpy(), v, err_msg=k)
    assert json.loads((tmp_path / "jax" / "adapter_config.json").read_text())["target_modules"] == ["fc2", "qkv"]
    assert dataclasses.asdict(back.cfg)["lora_dropout"] == 0.05


def test_dropout_masks_replay_under_grad_checkpoint():
    """LoRA dropout with use_grad_checkpoint: the recomputation draws the
    forward's masks (the reference's nn.remat replays its flax rng), so every
    factor's gradient and the generator's end state equal those without
    checkpointing. ViT-T width, depth 2, dropout 0.5; gradients within 1e-6."""
    kw = dict(name="vit-tiny", img_size=32, patch=16, dim=192, depth=2, heads=3, out_dim=16,
              dtype="float32", attn_impl="xla", lora_rank=4, lora_alpha=8.0, lora_dropout=0.5)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, 32, 32, 3)).astype(np.float32))
    w = torch.from_numpy(1e-3 * rng.normal(size=(3, 9, 192)).astype(np.float32))  # (B, N, dim)
    grads, ends = [], []
    for remat in (False, True):
        model = PatchViT(t_config.ModelConfig(**kw, use_grad_checkpoint=remat),
                         generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # a non-zero B, so that A has a gradient
            g = torch.Generator().manual_seed(1)
            for m in model.lora_layers():
                m.lora_B.weight.copy_(torch.randn(m.lora_B.weight.shape, generator=g) * 0.05)
        model.train()
        gen = torch.Generator().manual_seed(3)
        model.set_lora_generator(gen)
        (model(x) * w).sum().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters() if ".lora_" in k})
        ends.append(gen.get_state())
    assert len(grads[0]) == 2 * 4 * 2
    for k in grads[0]:
        assert grads[0][k].abs().max() > 1e-3, k
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6, rtol=0, msg=k)
    assert torch.equal(ends[0], ends[1])
