"""Tests of the port that need a CUDA card: each hand-written kernel against
its plain PyTorch version, the wrappers' input checks, the served forward
through the kernel against plain attention, a training micro-step through
the kernels against plain attention, and the fused half-block paths (kernels
6, 7 and 8) against their plain versions and the unfused model.

They are marked ``cuda`` and skip without a card. This file imports no JAX,
so it runs on the GPU machine, from the repository root, with:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from dinox_torch.bench import fused_block_inputs, fused_mlp_inputs
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.ops import fused_mlp as fm
from dinox_torch.ops.augment import augment_views
from dinox_torch.ops.flash_attention import (
    flash_attention_packed,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_reference,
)
from dinox_torch.ops.fused_attn_block import (
    fused_attn_block,
    fused_attn_block_forward,
    fused_attn_block_reference,
)
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import micro_loss_and_grads
from dinox_torch.zoo.hub import LoadedModel

pytestmark = pytest.mark.cuda

TOL = 2e-2  # bf16 forward tolerance of the JAX package's kernel check (bench.py --check)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# (b, n, 3*dim, heads): ViT-S check and serving shapes (hd 64), ViT-G (hd 88),
# MAE decoder (hd 32), a short ragged N and an N past the TPU kernel's 1024.
SHAPES = [(8, 261, 3 * 384, 6), (32, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16),
          (4, 261, 3 * 512, 16), (3, 37, 3 * 384, 6), (2, 1100, 3 * 384, 6)]
# Backward: the JAX package's bwd tolerance (bench.py --check), and the error
# relative to the largest gradient.
BWD_TOL, BWD_REL = 0.25, 2e-2


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_attention_matches_plain(card, shape):
    x = torch.randn(shape[:3], generator=card, device="cuda").to(torch.bfloat16)
    before = flash_attention_packed.launches
    got = flash_attention_packed(x, shape[3])
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    want = packed_attention_reference(x, shape[3])
    assert (got.float() - want.float()).abs().max().item() < TOL


def test_packed_attention_rejects_what_it_cannot_take(card):
    x = torch.randn((2, 10, 3 * 384), generator=card, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_packed(x, 6)  # float32
    with pytest.raises(ValueError):
        flash_attention_packed(x.to(torch.bfloat16), 4)  # head dim 96
    with pytest.raises(ValueError):
        flash_attention_packed(x.to(torch.bfloat16).transpose(0, 1), 6)  # not contiguous


def test_served_forward_goes_through_the_kernel(card):
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, depth=2)
    model = LoadedModel(cfg, "cuda")
    plain = LoadedModel(cfg.replace(attn_impl="xla"), "cuda")
    plain.load_state_dict(model.state_dict())
    x = torch.randn((4, 224, 224, 3), generator=card, device="cuda")
    sp = torch.rand((4, 3), generator=card, device="cuda") + 0.5
    before = flash_attention_packed.launches
    got = model(x, sp)[:, 0]
    assert flash_attention_packed.launches == before + cfg.depth
    want = plain(x, sp)[:, 0]
    assert torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item() >= 0.999


# The ViT-S training shape (192 views) in place of the serving one.
@pytest.mark.parametrize("shape", [(192, 261, 3 * 384, 6)] + SHAPES[:1] + SHAPES[2:])
def test_packed_attention_backward_matches_plain(card, shape):
    b, n, three_dim, heads = shape
    qkv = torch.randn((b, n, three_dim), generator=card, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, three_dim // 3), generator=card, device="cuda").to(torch.bfloat16)
    before = (packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches)
    got = packed_attention_backward(qkv, do, heads)
    torch.cuda.synchronize()
    assert (packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = packed_attention_backward_reference(qkv, do, heads).float()
    err = (got.float() - want).abs().max().item()
    assert err < BWD_TOL and err / want.abs().max().item() < BWD_REL


def test_packed_attention_backward_rejects_what_it_cannot_take(card):
    qkv = torch.randn((2, 10, 3 * 384), generator=card, device="cuda").to(torch.bfloat16)
    do = torch.randn((2, 10, 384), generator=card, device="cuda").to(torch.bfloat16)
    with pytest.raises(TypeError):
        packed_attention_backward(qkv, do.float(), 6)
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, do[:, :5], 6)  # shape
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, do.transpose(0, 1).contiguous().transpose(0, 1), 6)
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, do, 4)  # head dim 96


def test_autograd_goes_through_the_kernels(card):
    x = torch.randn((4, 261, 3 * 384), generator=card, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    counts = lambda: (flash_attention_packed.launches, packed_attention_bwd_dq.launches,  # noqa: E731
                      packed_attention_bwd_dkv.launches)
    before = counts()
    (flash_attention_packed(x, 6).float() ** 2).sum().backward()
    assert counts() == tuple(c + 1 for c in before)
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape


def test_training_micro_step_through_the_kernels_matches_plain(card):
    """Depth 2, full ViT-S width, scale-aware with a live scale pathway: the
    loss within 1e-2 relative and every gradient at cosine >= 0.99 against
    the same step with plain attention."""
    model = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, depth=2)
    cfgs = [TrainConfig(model=model.replace(attn_impl=impl), batch_size=4, koleo_weight=0.1)
            for impl in ("pallas", "xla")]
    states = [create_train_state(cfg, seed=0) for cfg in cfgs]
    with torch.no_grad():
        states[0].student.backbone.scale_embed.mlp[2].weight.normal_(0.0, 0.02, generator=card)
    for s in states[1:]:
        s.student.load_state_dict(states[0].student.state_dict())
        s.teacher.load_state_dict(states[0].student.state_dict())
    states[0].teacher.load_state_dict(states[0].student.state_dict())
    px = np.random.default_rng(0).integers(25000, 41000, (4, 256, 256, 3)).astype(np.uint16)
    views = augment_views(torch.from_numpy(px).cuda(), torch.Generator().manual_seed(0), cfgs[0].aug)
    batch = views.reshape(-1, 224, 224, 3)
    sp = torch.rand((4, 3), generator=card, device="cuda") * 2.5 + 0.5
    out = [micro_loss_and_grads(s, s.center, batch, sp, cfg) for s, cfg in zip(states, cfgs)]
    (g_k, _, m_k), (g_p, _, m_p) = out
    assert abs(m_k["loss"].item() - m_p["loss"].item()) <= 1e-2 * abs(m_p["loss"].item())
    for a, b in zip(g_k, g_p):
        if not a.any() and not b.any():
            continue
        cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0)
        assert cos.item() >= 0.99


# -- the fused half-blocks -----------------------------------------------------

# (b, n, dim, heads): the JAX check shape, serving bucket 32, the training
# shape, ViT-G (hd 88), hd 32, and a short ragged N.
FUSED_SHAPES = [(8, 261, 384, 6), (32, 261, 384, 6), (192, 261, 384, 6), (2, 261, 1408, 16),
                (4, 261, 512, 16), (3, 37, 384, 6)]
FUSED_TOL = 0.05  # the JAX package's fused half-block gate (bench.py --check)
# (rows, C), hidden 4C: 8 and 192 ViT-S views, ViT-G width, a ragged row count.
MLP_SHAPES = [(8 * 261, 384), (192 * 261, 384), (2 * 261, 1408), (37, 768), (19, 1024)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_attn_block_matches_plain(card, shape):
    b, n, dim, heads = shape
    args = fused_block_inputs(b, n, dim, torch.device("cuda"), seed=1)
    before = fused_attn_block.launches
    got = fused_attn_block_forward(*args, heads)
    torch.cuda.synchronize()
    assert fused_attn_block.launches == before + 1
    for g, w in zip(got, fused_attn_block_reference(*args, heads)):
        assert (g.float() - w.float()).abs().max().item() < FUSED_TOL


def test_fused_attn_block_rejects_what_it_cannot_take(card):
    x, g, b, wq, bq, wp, bp = fused_block_inputs(2, 10, 384, torch.device("cuda"))
    with pytest.raises(TypeError):
        fused_attn_block_forward(x.float(), g, b, wq, bq, wp, bp, 6)  # float32
    with pytest.raises(TypeError):
        fused_attn_block_forward(x, g, b, wq.float(), bq, wp, bp, 6)  # f32 weight
    with pytest.raises(ValueError):
        fused_attn_block_forward(x, g, b, wq, bq, wp, bp, 4)  # head dim 96
    with pytest.raises(ValueError):
        fused_attn_block_forward(x.transpose(0, 1), g, b, wq, bq, wp, bp, 6)  # not contiguous
    with pytest.raises(ValueError):
        fused_attn_block_forward(x, g, b, wq[:384], bq, wp, bp, 6)  # shape


@pytest.mark.parametrize("shape", MLP_SHAPES)
def test_fused_mlp_forward_matches_plain(card, shape):
    args, _ = fused_mlp_inputs(*shape, torch.device("cuda"))
    before = fm.fused_mlp_forward.launches
    got = fm.fused_mlp_forward(*args)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 1
    assert (got.float() - fm.fused_mlp_forward_reference(*args).float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("shape", MLP_SHAPES)
def test_fused_mlp_backward_matches_plain_and_repeats_bit_for_bit(card, shape):
    args, dy = fused_mlp_inputs(*shape, torch.device("cuda"), seed=1)
    parts = (fm.fused_mlp_bwd_rows, fm.fused_mlp_bwd_weights, fm.fused_mlp_bwd_reduce)
    before = [p.launches for p in parts]
    got = fm.fused_mlp_backward(*args[:6], dy)
    again = fm.fused_mlp_backward(*args[:6], dy)
    torch.cuda.synchronize()
    assert [p.launches for p in parts] == [n + 2 for n in before]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fm.fused_mlp_backward_reference(*args[:6], dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() < BWD_REL * w.float().abs().max().item()


def test_fused_mlp_rejects_what_it_cannot_take(card):
    args, dy = fused_mlp_inputs(40, 384, torch.device("cuda"))
    with pytest.raises(TypeError):
        fm.fused_mlp_forward(args[0].float(), *args[1:])  # float32
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0][:, :192].contiguous(), *args[1:])  # width not compiled
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0][::2], *args[1:])  # not contiguous
    with pytest.raises(ValueError):
        fm.fused_mlp_backward(*args[:6], dy[:20])  # gradient shape
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0], args[1], args[2], args[3][:1000].contiguous(), args[4][:1000],
                             args[5][:, :1000].contiguous(), args[6])  # hidden not a multiple of 128


def test_fused_served_forward_matches_unfused(card):
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, depth=2)
    model = LoadedModel(cfg, "cuda")
    fused = LoadedModel(cfg, "cuda")
    fused.load_state_dict(model.state_dict())
    fused.enable_fused_attn()
    x = torch.randn((4, 224, 224, 3), generator=card, device="cuda")
    sp = torch.rand((4, 3), generator=card, device="cuda") + 0.5
    before = (fused_attn_block.launches, flash_attention_packed.launches)
    got = fused(x, sp)[:, 0]
    assert (fused_attn_block.launches, flash_attention_packed.launches) == (
        before[0] + cfg.depth, before[1])
    want = model(x, sp)[:, 0]
    assert torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item() >= 0.999


def test_fused_f32_compute_raises_on_the_card(card):
    cfg = MODEL_CONFIGS["vit-small"].replace(depth=1, dtype="float32", fused_attn=True)
    model = LoadedModel(cfg, "cuda")
    with pytest.raises(TypeError):
        model(torch.zeros((1, 224, 224, 3), device="cuda"))


def test_fused_training_micro_step_matches_unfused(card):
    """Depth 2, full ViT-S width, exact GELU, both switches on, against the
    unfused model from one state: the loss within 1e-2 relative and every
    gradient at cosine >= 0.99; every half-block through kernels 6-8."""
    model = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, depth=2, gelu_approx=False)
    cfgs = [TrainConfig(model=model.replace(fused_attn=f, fused_mlp=f), batch_size=4,
                        koleo_weight=0.1) for f in (True, False)]
    states = [create_train_state(cfg, seed=0) for cfg in cfgs]
    with torch.no_grad():
        states[0].student.backbone.scale_embed.mlp[2].weight.normal_(0.0, 0.02, generator=card)
    for s in states:
        s.student.load_state_dict(states[0].student.state_dict())
        s.teacher.load_state_dict(states[0].student.state_dict())
    px = np.random.default_rng(0).integers(25000, 41000, (4, 256, 256, 3)).astype(np.uint16)
    views = augment_views(torch.from_numpy(px).cuda(), torch.Generator().manual_seed(0), cfgs[0].aug)
    batch = views.reshape(-1, 224, 224, 3)
    sp = torch.rand((4, 3), generator=card, device="cuda") * 2.5 + 0.5
    counters = (fused_attn_block, fm.fused_mlp_forward, fm.fused_mlp_bwd_rows,
                fm.fused_mlp_bwd_weights, fm.fused_mlp_bwd_reduce)
    before = [c.launches for c in counters]
    g_k, _, m_k = micro_loss_and_grads(states[0], states[0].center, batch, sp, cfgs[0])
    d = model.depth
    assert [c.launches - b for c, b in zip(counters, before)] == [2 * d, 2 * d, d, d, d]
    g_p, _, m_p = micro_loss_and_grads(states[1], states[1].center, batch, sp, cfgs[1])
    assert abs(m_k["loss"].item() - m_p["loss"].item()) <= 1e-2 * abs(m_p["loss"].item())
    for a, b in zip(g_k, g_p):
        if not a.any() and not b.any():
            continue
        cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0)
        assert cos.item() >= 0.99
