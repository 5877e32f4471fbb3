"""The port's Switch-MoE family (``dinox_torch.models.moe`` and its use in
the ViT, the step, the hub and LoRA) against the JAX package's: the twin of
``tests/test_moe.py`` and ``tests/test_moe_zoo.py``.

Tolerances: ``MoeMlp`` against flax at float32 within 1e-5 with routing
identical (the smallest top-2 router margin is printed, to show how far a
tie is); the per-token gather reference within 1e-5; three ViT-T-width MoE
steps against JAX's ``build_train_step`` (views patched in, as in
``test_torch_train_step.py``) with the losses and ``loss_moe_aux`` within
1e-5 relative and the parameters within 1e-4 of each tensor's largest
value; hub v2 both ways bit-exact.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.models.moe import MoeMlp
from dinox_torch.models.vit import PatchViT
from dinox_torch.train.state import TrainConfig, create_train_state, state_from_jax
from dinox_torch.train.step import build_train_step
from dinox_torch.utils import flops as t_flops
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint, load_from_hub_dir
from dinox_torch.zoo.interop import jax_to_torch_backbone, jax_to_torch_student, torch_to_jax_backbone
from dinox_torch.zoo.peft import apply_lora
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.moe import MoeMlp as JaxMoeMlp
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.train import state as jax_state
from dinox_tpu.train import step as jax_step
from dinox_tpu.utils import flops as j_flops
from dinox_tpu.zoo import hub as jax_hub

MOE_TINY = dict(name="tiny-moe", img_size=32, patch=16, dim=64, depth=2, heads=2, out_dim=128,
                num_registers=4, scale_aware=True, attn_impl="xla", dtype="float32",
                moe_experts=2, moe_every=2, moe_capacity_factor=1.25)


def _flax_moe(dim=16, e=4, b=2, n=10, cap=1.25, approx=True, seed=0):
    m = JaxMoeMlp(dim, e, mlp_ratio=2.0, capacity_factor=cap, gelu_approx=approx)
    x = jax.random.normal(jax.random.key(seed), (b, n, dim))
    params = m.init(jax.random.key(1), x)["params"]
    return m, params, np.asarray(x)


def _port_moe(params, dim=16, e=4, cap=1.25, approx=True):
    m = MoeMlp(dim, e, mlp_ratio=2.0, capacity_factor=cap, gelu_approx=approx)
    sd = {"router.weight": np.asarray(params["router"]["kernel"]).T,
          "router.bias": np.asarray(params["router"]["bias"]),
          **{k: np.asarray(params[k]) for k in ("w1", "b1", "w2", "b2")}}
    m.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()})
    return m


@pytest.mark.parametrize("cap,approx", [(1.25, True), (1.25, False), (0.5, True), (8.0, True)])
def test_moe_mlp_matches_flax(cap, approx):
    jm, params, x = _flax_moe(cap=cap, approx=approx)
    y_j, inter = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    (aux_j,) = inter["intermediates"]["moe_aux"]
    m = _port_moe(params, cap=cap, approx=approx)
    y, aux = m(torch.from_numpy(x))
    probs, expert, dispatch, _ = m.route(torch.from_numpy(x))
    logits = x @ np.asarray(params["router"]["kernel"]) + np.asarray(params["router"]["bias"])
    want_expert = np.argmax(np.asarray(jax.nn.softmax(logits, axis=-1)), axis=-1)
    top2 = np.sort(probs.detach().numpy(), axis=-1)[..., -2:]
    print(f"smallest top-2 router margin: {np.min(top2[..., 1] - top2[..., 0]):.3e}")
    np.testing.assert_array_equal(expert.numpy(), want_expert)
    assert dispatch.shape[-1] == max(1, int(10 / 4 * cap))  # a floor, as the JAX code computes it
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


def test_moe_matches_per_token_gather():
    """y_t = gate_t * FFN_expert(t)(x_t) when nothing overflows."""
    _, params, x = _flax_moe(cap=8.0)
    m = _port_moe(params, cap=8.0)
    y = m(torch.from_numpy(x))[0].detach().numpy()
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ np.asarray(params["router"]["kernel"]) + np.asarray(params["router"]["bias"])
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    expert = np.argmax(probs, axis=-1)
    w1, b1, w2, b2 = (np.asarray(params[k]) for k in ("w1", "b1", "w2", "b2"))
    ref = np.stack([probs[t, e] * (np.asarray(nn.gelu(xt[t] @ w1[e] + b1[e][0], approximate=True))
                                   @ w2[e] + b2[e][0]) for t, e in enumerate(expert)])
    np.testing.assert_allclose(y, ref.reshape(x.shape), rtol=0, atol=1e-5)


def test_capacity_overflow_drops_tokens():
    """Capacity 1 per expert: the overflow rows are exactly zero, and each
    expert keeps its first token in token order."""
    _, params, x = _flax_moe(dim=8, e=2, b=1, n=6, cap=0.01)
    m = _port_moe(params, dim=8, e=2, cap=0.01)
    y = m(torch.from_numpy(x))[0].detach().numpy()[0]
    _, expert, _, _ = m.route(torch.from_numpy(x))
    expert = expert.numpy()[0]
    kept = [int(np.flatnonzero(expert == e)[0]) for e in np.unique(expert)]
    zero = np.abs(y).max(axis=-1) == 0.0
    assert zero.sum() == 6 - len(kept) and not zero[kept].any()


def _moe_vit(use_grad_checkpoint):
    cfg = ModelConfig(**dict(MOE_TINY, attn_impl="pallas", use_grad_checkpoint=use_grad_checkpoint))
    return PatchViT(cfg, generator=torch.Generator().manual_seed(3)).train()


@pytest.mark.parametrize("use_grad_checkpoint", [False, True])
def test_aux_and_its_gradient_with_and_without_checkpointing(use_grad_checkpoint):
    """The load-balance loss leaves each MoE block as an output, so a
    checkpointed block's recomputation gives the same loss and the same
    router gradients (bit for bit on the CPU) as a plain run, and the mean
    over the MoE blocks is the JAX package's."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    sp = torch.ones(2, 3)
    out = []
    for ckpt in (False, use_grad_checkpoint):
        model = _moe_vit(ckpt)
        tokens, aux = model.forward_with_aux(x, sp)
        router = model.blocks[1].moe.router.weight
        g_router, g_w1 = torch.autograd.grad(aux + 0.1 * tokens.square().mean(),
                                             (router, model.blocks[1].moe.w1))
        out.append((aux.detach(), g_router, g_w1))
        assert torch.count_nonzero(g_router) > 0
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # against JAX on the same weights
    jcfg = jax_config.ModelConfig(**MOE_TINY)
    from dinox_tpu.models.vit import PatchViT as JaxPatchViT

    model = _moe_vit(False)
    params = torch_to_jax_backbone(model.state_dict())
    _, inter = JaxPatchViT(jcfg).apply({"params": params}, x.numpy(), sp.numpy(), train=True,
                                       mutable=["intermediates"])
    leaves = jax.tree_util.tree_leaves(inter["intermediates"])
    np.testing.assert_allclose(float(model.forward_with_aux(x, sp)[1]),
                               float(sum(leaves) / len(leaves)), rtol=1e-6)


# -- three MoE steps against JAX's build_train_step ---------------------------

S = 32
STEP_MODEL = dict(name="vit-t-moe", img_size=32, patch=16, dim=192, depth=2, heads=3, out_dim=64,
                  num_registers=2, dtype="float32", scale_aware=True, moe_experts=4, moe_every=2,
                  moe_capacity_factor=1.25)
TRAIN = dict(img_size=32, batch_size=4, lr=1e-3, warmup_steps=2, max_steps=50, koleo_weight=0.1,
             train_seed=0, moe_aux_weight=0.5)


def _jax_views(px, key, aug_cfg):
    x = px.astype(jnp.float32)
    return jnp.stack([(x[:, :S, :S] - 33000.0) / 1500.0,
                      (x[:, -S:, -S:][:, :, ::-1] - 32500.0) / 2000.0])


def _torch_views(px, generator, aug_cfg):
    x = px.to(torch.float32)
    return torch.stack([(x[:, :S, :S] - 33000.0) / 1500.0,
                        (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0])


def test_three_moe_steps_match_jax():
    """From one perturbed student with warm Adam moments (count 10: a fresh
    nu would turn gradients that are rounding noise into +-lr steps, which
    differ between the packages by construction)."""
    import optax

    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**STEP_MODEL, attn_impl="xla"), **TRAIN)
    tcfg = TrainConfig(model=ModelConfig(**STEP_MODEL, attn_impl="pallas"), **TRAIN)
    jstate = jax_state.create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(7)
    noise = lambda t, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32) + s * rng.normal(size=a.shape).astype(np.float32), t)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    student = jax.tree_util.tree_map(jnp.asarray, noise(jstate.student, 0.05))
    zeros = jax.tree_util.tree_map(np.zeros_like, np_tree(student))
    step = jnp.asarray(10, jnp.int32)
    mu = noise(zeros, 1e-3)
    nu = jax.tree_util.tree_map(lambda a: (1e-3 + np.abs(a)) ** 2, noise(zeros, 1e-2))

    def warm(s):
        return optax.ScaleByAdamState(count=step, mu=mu, nu=nu) \
            if isinstance(s, optax.ScaleByAdamState) else s

    opt_state = jax.tree_util.tree_map(warm, jax_state.make_optimizer(jcfg).init(student),
                                       is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    opt_state = jax.tree_util.tree_map(
        lambda a: step if getattr(a, "dtype", None) == jnp.int32 and a.shape == () else a, opt_state)
    jstate = jstate.replace(step=step, student=student, opt_state=opt_state,
                            teacher=jax.tree_util.tree_map(jnp.copy, student))
    tstate = state_from_jax(tcfg, dict(step=np.asarray(10), student=np_tree(student),
                                       teacher=np_tree(student), center=np.asarray(jstate.center),
                                       mu=mu, nu=nu, count=np.asarray(10)), device="cpu")
    jfn = jax_step.build_train_step(jcfg, donate=False, augment_fn=_jax_views)
    tfn = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
    for i in range(3):
        r = np.random.default_rng(i)
        px = r.integers(30000, 36000, (1, 4, 48, 48, 3)).astype(np.uint16)
        sp = r.uniform(0.5, 2.0, (1, 4, 3)).astype(np.float32)
        jstate, jm = jfn(jstate, jnp.asarray(px), jnp.asarray(sp))
        tstate, tm = tfn(tstate, px, sp)
        for k in ("loss", "loss_dino", "loss_gram", "loss_koleo", "loss_moe_aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    want = jax_to_torch_student(np_tree(jstate.student))
    for name, p in tstate.student.named_parameters():
        w = want[name]
        assert np.abs(p.detach().numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


# -- flops, the hub (v2 both ways), LoRA ---------------------------------------

def test_moe_flops_match_jax():
    for kw in (dict(moe_experts=4), dict(moe_experts=8, moe_capacity_factor=1.0), dict(moe_experts=0)):
        jm = jax_config.MODEL_CONFIGS["vit-small"].replace(**kw)
        tm = ModelConfig(**{k: v for k, v in jm.to_dict().items() if k != "lora_targets"})
        assert t_flops.forward_flops_per_view(tm) == j_flops.forward_flops_per_view(jm)
        if kw["moe_experts"]:
            assert t_flops.moe_flops_per_view_per_block(tm) == j_flops.moe_flops_per_view_per_block(jm)


@pytest.fixture(scope="module")
def jax_moe():
    cfg = jax_config.ModelConfig(**MOE_TINY)
    return jax_hub.LoadedModel(cfg, init_backbone(cfg, jax.random.key(0)))


def test_hub_v2_both_ways_bit_exact(jax_moe, tmp_path):
    jax_hub.export_hub_checkpoint(jax_moe, tmp_path / "from_jax", use_safetensors=True)
    port = load_from_hub_dir(tmp_path / "from_jax", device="cpu")
    assert port.cfg.moe_experts == 2 and port.cfg.moe_every == 2
    want = jax_to_torch_backbone(jax.tree_util.tree_map(np.asarray, jax_moe.params))
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # Same weights, same (hub-default bf16) config: the forwards agree.
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    sp = np.ones((2, 3), np.float32)
    same = jax_hub.LoadedModel(jax_hub._cfg_from_dict(
        json.loads((tmp_path / "from_jax" / "config.json").read_text())), jax_moe.params)
    np.testing.assert_allclose(port(x, sp).numpy(), np.asarray(same(x, sp)), rtol=0, atol=0.1)

    export_hub_checkpoint(port, tmp_path / "from_port", use_safetensors=True)
    cfg = json.loads((tmp_path / "from_port" / "config.json").read_text())
    assert cfg["weights_format"] == "jax" and cfg["moe_experts"] == 2 and cfg["moe_every"] == 2
    assert not (tmp_path / "from_port" / "backbone.pth").exists()
    back = jax_hub.load_from_hub_dir(tmp_path / "from_port")
    la = jax.tree_util.tree_leaves_with_path(jax_moe.params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back.params))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(lb[path]))
    with pytest.raises(NotImplementedError, match="dense-only"):
        export_hub_checkpoint(port, tmp_path / "pth")
    assert not (tmp_path / "pth").exists()


def test_moe_backbone_encodes_and_serves(jax_moe, tmp_path):
    from dinox_torch.serve import EmbedService
    from dinox_torch.zoo.encode import encode

    jax_hub.export_hub_checkpoint(jax_moe, tmp_path, use_safetensors=True)
    model = load_from_hub_dir(tmp_path, device="cpu")
    img = np.random.default_rng(1).uniform(-1000, 400, (40, 40)).astype(np.float32)
    emb = np.asarray(encode(model, img, pixel_spacing=(0.7, 0.7), slice_thickness=2.0))
    assert emb.shape == (1, 64) and np.isfinite(emb).all()
    service = EmbedService(str(tmp_path), [1, 2], device="cpu")
    try:
        out = service.embed([img, img], [(0.7, 0.7, 2.0)] * 2)
    finally:
        service.close()
    out = np.asarray(out)
    assert out.shape == (2, 64) and np.isfinite(out).all()


def test_lora_on_moe_touches_attention_only():
    model = LoadedModel(ModelConfig(**MOE_TINY), "cpu")
    wrapped = apply_lora(model, rank=4, alpha=8.0)
    assert wrapped.cfg.lora_targets == ("qkv", "proj")
    names = list(wrapped.adapter_params())
    assert names and all(".attn." in n for n in names)
    assert not any(p.requires_grad for n, p in wrapped.named_parameters() if ".moe." in n)
    # Explicit fc1/fc2 adapt the dense block alone: an MoE block has no mlp.
    explicit = apply_lora(model, rank=4, target_modules=["qkv", "proj", "fc1", "fc2"])
    mlp = [n for n in explicit.adapter_params() if ".mlp." in n]
    assert mlp and all(n.startswith("blocks.0.") for n in mlp)
    for n, p in model.state_dict().items():
        torch.testing.assert_close(wrapped.state_dict()[n], p, rtol=0, atol=0)


def test_moe_state_dict_keys_are_the_interop_keys():
    cfg = jax_config.ModelConfig(**MOE_TINY)
    want = set(jax_to_torch_backbone(jax.tree_util.tree_map(np.asarray, init_backbone(cfg, jax.random.key(0)))))
    assert set(PatchViT(ModelConfig(**MOE_TINY)).state_dict()) == want


def test_moe_step_on_the_cpu_logs_the_aux_and_moves_the_router():
    cfg = TrainConfig(model=ModelConfig(**dict(MOE_TINY, attn_impl="pallas")), img_size=32,
                      batch_size=4, lr=1e-3, warmup_steps=1, max_steps=20)
    state = create_train_state(cfg, device="cpu")
    before = state.student.backbone.blocks[1].moe.router.weight.detach().clone()
    px = np.random.default_rng(0).integers(30000, 36000, (1, 4, 48, 48, 3)).astype(np.uint16)
    sp = np.ones((1, 4, 3), np.float32)
    fn = build_train_step(cfg, device="cpu", augment_fn=_torch_views)
    for _ in range(2):
        state, m = fn(state, px, sp)
    assert float(m["loss_moe_aux"]) >= 0.99 and np.isfinite(float(m["loss"]))
    assert not torch.equal(state.student.backbone.blocks[1].moe.router.weight, before)
