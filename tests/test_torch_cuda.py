"""Tests of the port that need a CUDA card: each hand-written kernel against
its plain PyTorch version, the wrappers' input checks, the served forward
through the kernel against plain attention, a training micro-step through
the kernels against plain attention, the fused half-block paths (kernels
6, 7 and 8) against their plain versions and the unfused model, the
head-major pair (kernels 4 and 5) with the sdpa dispatch, the forward
tile core of kernels 1 and 4 (csrc/attention_fwd_sm90.cuh), the backward
tile core of kernels 2/3 and 5 (csrc/attention_bwd_sm90.cuh) and kernel 6's
three launches (the GEMM core csrc/gemm_sm90.cuh around kernel 1's core) at
the ragged edges of their tiling, with equal bits on two runs and no spills;
the pretraining loop's device side: the prefetcher's staged batches and
the async checkpoint's snapshot under in-place updates; and evaluation and
fine-tuning: the eval transform on the card, and a LoRA loss and backward
of ViT-S through kernel 1 and the dq/dkv pair against plain attention; the
CIFAR control's RGB views on the card against the CPU and kernel 1 and the
pair at its (512, 69, 576, 6); LoRA dropout replayed under gradient
checkpointing with a generator on the card; and module 11: the
low-precision and factored Adam updates on the card against the CPU, the
MoE MLP in bf16 on the card against the CPU, and kernel 1 and the pair at
the MAE encoder's and decoder's shapes; and module 12: a staged release
loaded back (hub dir and backbone.pth) encoding through kernel 1 with the
source model's bits, and detect_hardware on the card; and module 12b: one
row of bench_batch_sweep and one tune_throughput cell at ViT-S on the card,
each with exact launches of kernels 1, dq and dkv; and module 13a: kernel 1
and the pair at the blocks a rank of the ViT-S bs96 mesh step runs; and
module 13b: the pair at a tp 2 x ep 2 rank's block, and a world-1 NCCL
MoE mesh step bit-equal to the step without a mesh; and the LayerNorm
kernels against their plain versions at the training cells' rows and the
ragged edges, equal bits on two runs, exact launches, and a ViT-S training
micro-step through them against the eager LayerNorm.

They are marked ``cuda`` and skip without a card. This file imports no JAX,
so it runs on the GPU machine, from the repository root, with:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import re

import numpy as np
import pytest
import torch

from dinox_torch.bench import fused_block_inputs, fused_mlp_inputs
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.models.vit import sdpa
from dinox_torch.ops import _build
from dinox_torch.ops import fused_mlp as fm
from dinox_torch.ops import layer_norm as lnk
from dinox_torch.ops.augment import augment_views
from dinox_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    mha_attention_backward,
    mha_attention_backward_reference,
    mha_attention_bwd_dkv,
    mha_attention_bwd_dq,
    mha_attention_reference,
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
    wide = fused_block_inputs(1, 4, 1600, torch.device("cuda"))
    with pytest.raises(ValueError):
        fused_attn_block_forward(*wide, 25)  # dim 1600 > MAX_DIM


def _launch_counts(launches: dict) -> list[int]:
    return [fn.launches for fn in launches.values()]


@pytest.mark.parametrize("shape", MLP_SHAPES)
def test_fused_mlp_forward_matches_plain(card, shape):
    args, _ = fused_mlp_inputs(*shape, torch.device("cuda"))
    before = _launch_counts(fm.FWD_LAUNCHES)
    got = fm.fused_mlp_forward(*args)
    torch.cuda.synchronize()
    assert _launch_counts(fm.FWD_LAUNCHES) == [n + 1 for n in before]
    assert (got.float() - fm.fused_mlp_forward_reference(*args).float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("shape", MLP_SHAPES)
def test_fused_mlp_backward_matches_plain_and_repeats_bit_for_bit(card, shape):
    args, dy = fused_mlp_inputs(*shape, torch.device("cuda"), seed=1)
    before = _launch_counts(fm.BWD_LAUNCHES)
    got = fm.fused_mlp_backward(*args[:6], dy)
    again = fm.fused_mlp_backward(*args[:6], dy)
    torch.cuda.synchronize()
    assert _launch_counts(fm.BWD_LAUNCHES) == [n + 2 for n in before]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fm.fused_mlp_backward_reference(*args[:6], dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() < BWD_REL * w.float().abs().max().item()


def test_fused_mlp_rejects_what_it_cannot_take(card):
    args, dy = fused_mlp_inputs(40, 384, torch.device("cuda"))
    with pytest.raises(TypeError):
        fm.fused_mlp_forward(args[0].float(), *args[1:])  # float32
    wide, _ = fused_mlp_inputs(4, 1416, torch.device("cuda"))
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(*wide)  # width 1416 > MAX_DIM
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0][:, :380].contiguous(), *args[1:])  # width not a multiple of 8
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0][::2], *args[1:])  # not contiguous
    with pytest.raises(ValueError):
        fm.fused_mlp_backward(*args[:6], dy[:20])  # gradient shape
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(args[0], args[1], args[2], args[3][:1001].contiguous(), args[4][:1001],
                             args[5][:, :1001].contiguous(), args[6])  # hidden not a multiple of 8


# Kernels 7 and 8 at the ragged edges of their 64- and 128-row blocks (M = 1,
# 63, 64, 65, 127, 129), the serving rows (8352) and the training rows
# (50112) at ViT-S width; every width class: ViT-T's 192, ViT-S, -B, 1024,
# ViT-G's 1408, and 200 (C mod 64 = 8 and hidden 800 mod 64 = 32: a K box
# wholly past K on fc1's, hidden's and fc2's last stage).
MLP_EDGE_ROWS = [1, 63, 64, 65, 127, 129, 8352, 50112]
MLP_WIDTHS = [192, 200, 384, 768, 1024, 1408]


def _mlp_two_runs(args, dy):
    """Kernels 7 and 8 twice on *args*: equal bits, within the gates of the
    plain versions, one count per launch and call."""
    before = _launch_counts(fm.FWD_LAUNCHES) + _launch_counts(fm.BWD_LAUNCHES)
    fwd = [fm.fused_mlp_forward(*args) for _ in range(2)]
    bwd = [fm.fused_mlp_backward(*args[:6], dy) for _ in range(2)]
    torch.cuda.synchronize()
    after = _launch_counts(fm.FWD_LAUNCHES) + _launch_counts(fm.BWD_LAUNCHES)
    assert after == [n + 2 for n in before]
    assert torch.equal(*fwd) and all(torch.equal(a, b) for a, b in zip(*bwd))
    assert (fwd[0].float() - fm.fused_mlp_forward_reference(*args).float()).abs().max().item() < 2e-2
    for g, w in zip(bwd[0], fm.fused_mlp_backward_reference(*args[:6], dy)):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        assert (g.float() - w.float()).abs().max().item() < BWD_REL * w.float().abs().max().item()
    return fwd[0], bwd[0]


@pytest.mark.parametrize("rows", MLP_EDGE_ROWS)
def test_fused_mlp_ragged_rows(card, rows):
    _mlp_two_runs(*fused_mlp_inputs(rows, 384, torch.device("cuda"), seed=6))


@pytest.mark.parametrize("c", MLP_WIDTHS)
def test_fused_mlp_widths(card, c):
    _mlp_two_runs(*fused_mlp_inputs(65, c, torch.device("cuda"), seed=7))


def test_fused_mlp_never_reads_past_the_operands(card):
    """Rows past M of x, dy and the activations, and rows past the weights,
    read by the ragged last blocks and tiles, reach no output: NaN bytes just
    past every bf16 operand change nothing."""
    args, dy = fused_mlp_inputs(65, 200, torch.device("cuda"), seed=8)
    want = _mlp_two_runs(args, dy)
    tailed = [_nan_tailed(a) if a.dtype == torch.bfloat16 else a for a in args]
    got_f = fm.fused_mlp_forward(*tailed)
    got_b = fm.fused_mlp_backward(*tailed[:6], _nan_tailed(dy))
    torch.cuda.synchronize()
    assert torch.equal(got_f, want[0])
    assert all(torch.equal(a, b) for a, b in zip(got_b, want[1]))


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
    counters = (fused_attn_block, *fm.FWD_LAUNCHES.values(), *fm.BWD_LAUNCHES.values())
    before = [c.launches for c in counters]
    g_k, _, m_k = micro_loss_and_grads(states[0], states[0].center, batch, sp, cfgs[0])
    d = model.depth
    assert [c.launches - b for c, b in zip(counters, before)] == [2 * d] * 3 + [d] * 6
    g_p, _, m_p = micro_loss_and_grads(states[1], states[1].center, batch, sp, cfgs[1])
    assert abs(m_k["loss"].item() - m_p["loss"].item()) <= 1e-2 * abs(m_p["loss"].item())
    for a, b in zip(g_k, g_p):
        if not a.any() and not b.any():
            continue
        cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0)
        assert cos.item() >= 0.99


# -- the head-major pair (kernels 4 and 5) -------------------------------------

# (b, heads, n, hd): the JAX check's unpacked shape, the validate shape, the
# ViT-S training shape, hd 32 (MAE decoder), hd 88 (ViT-G), an N past the TPU
# kernel's 1024 and a short ragged N.
MHA_SHAPES = [(4, 6, 261, 64), (8, 8, 1024, 64), (192, 6, 261, 64), (2, 16, 257, 32),
              (2, 16, 261, 88), (1, 2, 1500, 64), (3, 2, 37, 64)]


def _mha_inputs(card, shape, count):
    return [torch.randn(shape, generator=card, device="cuda").to(torch.bfloat16)
            for _ in range(count)]


@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_mha_attention_matches_plain(card, shape):
    q, k, v = _mha_inputs(card, shape, 3)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert (got.float() - mha_attention_reference(q, k, v).float()).abs().max().item() < TOL


@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_mha_attention_backward_matches_plain(card, shape):
    q, k, v, do = _mha_inputs(card, shape, 4)
    before = (mha_attention_bwd_dq.launches, mha_attention_bwd_dkv.launches)
    got = mha_attention_backward(q, k, v, do)
    torch.cuda.synchronize()
    assert (mha_attention_bwd_dq.launches, mha_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, mha_attention_backward_reference(q, k, v, do)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() < BWD_REL * w.float().abs().max().item()


@pytest.mark.parametrize("shape", [MHA_SHAPES[0], MHA_SHAPES[4], MHA_SHAPES[6]])
def test_mha_backward_gives_kernel_2s_bits(card, shape):
    """Kernel 5 and kernel 2 run one tile code: on the same data, laid out
    head-major and packed, they give the same bits."""
    b, h, n, hd = shape
    q, k, v, do = _mha_inputs(card, shape, 4)
    tokens = lambda t: t.transpose(1, 2).reshape(b, n, h * hd)  # noqa: E731
    packed = packed_attention_backward(torch.cat([tokens(q), tokens(k), tokens(v)], -1),
                                       tokens(do).contiguous(), h)
    head_major = torch.cat([tokens(g) for g in mha_attention_backward(q, k, v, do)], -1)
    assert torch.equal(packed, head_major)


def test_mha_autograd_goes_through_the_kernels(card):
    leaves = [t.requires_grad_(True) for t in _mha_inputs(card, (4, 6, 261, 64), 3)]
    counts = lambda: (flash_attention.launches, mha_attention_bwd_dq.launches,  # noqa: E731
                      mha_attention_bwd_dkv.launches)
    before = counts()
    (flash_attention(*leaves).float() ** 2).sum().backward()
    assert counts() == tuple(c + 1 for c in before)
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    (mha_attention_reference(*plain).float() ** 2).sum().backward()
    for t, p in zip(leaves, plain):
        assert t.grad.dtype == torch.bfloat16
        err = (t.grad.float() - p.grad.float()).abs().max().item()
        assert err < BWD_REL * p.grad.float().abs().max().item()


def test_sdpa_pallas_launches_kernel_4_once_per_call(card):
    q, k, v = _mha_inputs(card, (2, 6, 261, 64), 3)
    before = flash_attention.launches
    outs = [sdpa(q, k, v, impl="pallas") for _ in range(3)]
    assert flash_attention.launches == before + 3
    assert all(torch.equal(o, outs[0]) for o in outs)
    sdpa(q, k, v, impl="xla")
    assert flash_attention.launches == before + 3


def test_mha_attention_rejects_what_it_cannot_take(card):
    q, k, v = _mha_inputs(card, (2, 6, 40, 64), 3)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())  # float32
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())  # head dim 48
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :20].contiguous(), v)  # shape
    with pytest.raises(ValueError):
        mha_attention_backward(q, k, v, q[:1].contiguous())  # gradient shape


# -- the forward tile core (kernels 1 and 4) -----------------------------------

# N at the edges of the 64-row query and key tiles and of the 16/32/64-key
# tail, the ViT N and two past the TPU kernel's 1024.
EDGE_N = (1, 8, 63, 64, 65, 128, 129, 261, 1024, 1500)
EDGE_HD = (32, 64, 88)


def _packed_edge(card, b, n, heads, hd):
    return torch.randn((b, n, 3 * heads * hd), generator=card, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("hd", EDGE_HD)
@pytest.mark.parametrize("n", EDGE_N)
def test_packed_attention_ragged_edges_match_plain(card, n, hd):
    qkv = _packed_edge(card, 2, n, 2, hd)
    before = flash_attention_packed.launches
    got, again = flash_attention_packed(qkv, 2), flash_attention_packed(qkv, 2)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 2 and torch.equal(got, again)
    assert (got.float() - packed_attention_reference(qkv, 2).float()).abs().max().item() < TOL


@pytest.mark.parametrize("hd", EDGE_HD)
@pytest.mark.parametrize("n", EDGE_N)
def test_mha_attention_ragged_edges_match_plain(card, n, hd):
    q, k, v = _mha_inputs(card, (2, 2, n, hd), 3)
    before = flash_attention.launches
    got, again = flash_attention(q, k, v), flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 and torch.equal(got, again)
    assert (got.float() - mha_attention_reference(q, k, v).float()).abs().max().item() < TOL


# (b, n, heads, hd): B*H = 1, and the ViT-S training shape (192 views).
FWD_BIT_SHAPES = [(1, 261, 1, 64), (192, 261, 6, 64)]


@pytest.mark.parametrize("shape", FWD_BIT_SHAPES)
def test_packed_attention_repeats_bit_for_bit(card, shape):
    b, n, heads, hd = shape
    qkv = _packed_edge(card, b, n, heads, hd)
    runs = [flash_attention_packed(qkv, heads) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert (runs[0].float() - packed_attention_reference(qkv, heads).float()).abs().max().item() < TOL


@pytest.mark.parametrize("shape", FWD_BIT_SHAPES)
def test_mha_attention_repeats_bit_for_bit(card, shape):
    b, n, heads, hd = shape
    q, k, v = _mha_inputs(card, (b, heads, n, hd), 3)
    runs = [flash_attention(q, k, v) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert (runs[0].float() - mha_attention_reference(q, k, v).float()).abs().max().item() < TOL


def _nan_tailed(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of *t* at the front of a larger flat buffer whose
    tail (one 64-row tile and more) is NaN."""
    buf = torch.full((t.numel() + 64 * 3 * 1408,), float("nan"), dtype=t.dtype, device=t.device)
    buf[:t.numel()] = t.flatten()
    return buf[:t.numel()].view(t.shape)


def test_packed_attention_never_reads_past_the_operand(card):
    """Rows past N = 261, read by the ragged last tile, never reach the
    softmax or PV: NaN bytes just past qkv change nothing."""
    qkv = _packed_edge(card, 2, 261, 6, 64)
    got = flash_attention_packed(_nan_tailed(qkv), 6)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, flash_attention_packed(qkv, 6))
    assert (got.float() - packed_attention_reference(qkv, 6).float()).abs().max().item() < TOL


def test_mha_attention_never_reads_past_the_operand(card):
    q, k, v = _mha_inputs(card, (2, 6, 261, 64), 3)
    got = flash_attention(*(_nan_tailed(t) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, flash_attention(q, k, v))
    assert (got.float() - mha_attention_reference(q, k, v).float()).abs().max().item() < TOL


# -- the backward tile core (kernels 2/3 and 5) --------------------------------


def _close_to_plain_backward(got, want) -> None:
    """Each gradient within BWD_TOL and BWD_REL of its largest plain value
    (<=: at N = 1 dq is exactly 0 in both)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        err = (g.float() - w.float()).abs().max().item()
        assert err < BWD_TOL and err <= BWD_REL * w.float().abs().max().item()


def _packed_grads(dqkv: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return dqkv.chunk(3, dim=-1)


@pytest.mark.parametrize("hd", EDGE_HD)
@pytest.mark.parametrize("n", EDGE_N)
def test_packed_attention_backward_ragged_edges_match_plain(card, n, hd):
    qkv = _packed_edge(card, 2, n, 2, hd)
    do = torch.randn((2, n, 2 * hd), generator=card, device="cuda").to(torch.bfloat16)
    before = packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches
    got, again = packed_attention_backward(qkv, do, 2), packed_attention_backward(qkv, do, 2)
    torch.cuda.synchronize()
    assert (packed_attention_bwd_dq.launches, packed_attention_bwd_dkv.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    _close_to_plain_backward(_packed_grads(got),
                             _packed_grads(packed_attention_backward_reference(qkv, do, 2)))


@pytest.mark.parametrize("hd", EDGE_HD)
@pytest.mark.parametrize("n", EDGE_N)
def test_mha_attention_backward_ragged_edges_match_plain(card, n, hd):
    """Also bit-equal to kernel 2 on the same data laid out packed."""
    q, k, v, do = _mha_inputs(card, (2, 2, n, hd), 4)
    got, again = mha_attention_backward(q, k, v, do), mha_attention_backward(q, k, v, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close_to_plain_backward(got, mha_attention_backward_reference(q, k, v, do))
    tokens = lambda t: t.transpose(1, 2).reshape(2, n, 2 * hd)  # noqa: E731
    packed = packed_attention_backward(torch.cat([tokens(q), tokens(k), tokens(v)], -1),
                                       tokens(do).contiguous(), 2)
    assert torch.equal(packed, torch.cat([tokens(g) for g in got], -1))


@pytest.mark.parametrize("shape", FWD_BIT_SHAPES)
def test_packed_attention_backward_repeats_bit_for_bit(card, shape):
    b, n, heads, hd = shape
    qkv = _packed_edge(card, b, n, heads, hd)
    do = torch.randn((b, n, heads * hd), generator=card, device="cuda").to(torch.bfloat16)
    runs = [packed_attention_backward(qkv, do, heads) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    _close_to_plain_backward(_packed_grads(runs[0]),
                             _packed_grads(packed_attention_backward_reference(qkv, do, heads)))


@pytest.mark.parametrize("shape", FWD_BIT_SHAPES)
def test_mha_attention_backward_repeats_bit_for_bit(card, shape):
    b, n, heads, hd = shape
    q, k, v, do = _mha_inputs(card, (b, heads, n, hd), 4)
    runs = [mha_attention_backward(q, k, v, do) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _close_to_plain_backward(runs[0], mha_attention_backward_reference(q, k, v, do))


def test_packed_attention_backward_never_reads_past_the_operand(card):
    """Rows past N = 261 of qkv and dO, read by the ragged last tiles, never
    reach a softmax or a product: NaN bytes just past them change nothing."""
    qkv = _packed_edge(card, 2, 261, 6, 64)
    do = torch.randn((2, 261, 384), generator=card, device="cuda").to(torch.bfloat16)
    got = packed_attention_backward(_nan_tailed(qkv), _nan_tailed(do), 6)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, packed_attention_backward(qkv, do, 6))
    _close_to_plain_backward(_packed_grads(got),
                             _packed_grads(packed_attention_backward_reference(qkv, do, 6)))


def test_mha_attention_backward_never_reads_past_the_operand(card):
    q, k, v, do = _mha_inputs(card, (2, 6, 261, 64), 4)
    got = mha_attention_backward(*(_nan_tailed(t) for t in (q, k, v, do)))
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, mha_attention_backward(q, k, v, do)))
    _close_to_plain_backward(got, mha_attention_backward_reference(q, k, v, do))


# -- kernel 6: the GEMM core around kernel 1's core ----------------------------

# (b, n, dim, heads): B*N = 1, 63, 64, 65 (the edges of a 64-row warpgroup
# and of a 128-row GEMM block), the serving bucket 32 (8352 rows, a ragged
# last block) and the training shape (50112 rows).
FUSED_ROW_SHAPES = [(1, 1, 384, 6), (1, 63, 384, 6), (1, 64, 384, 6), (1, 65, 384, 6),
                    (32, 261, 384, 6), (192, 261, 384, 6)]
# (dim, heads): ViT-S, hd 32, ViT-G (one 64-row warpgroup; 1408 is no
# multiple of 128) and dim 96 (not a multiple of 64: a last 32-deep step).
FUSED_DIMS = [(384, 6), (512, 16), (1408, 16), (96, 3)]


def _fused_two_runs(args, heads):
    """Kernel 6 twice on *args*: equal bits, each output within FUSED_TOL of
    the plain version, attn bit-equal to kernel 1 on the kernel's own qkv,
    one count per call and no count of kernel 1 from the attention launch."""
    before = fused_attn_block.launches, flash_attention_packed.launches
    got = fused_attn_block_forward(*args, heads)
    again = fused_attn_block_forward(*args, heads)
    torch.cuda.synchronize()
    assert (fused_attn_block.launches, flash_attention_packed.launches) == (before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, fused_attn_block_reference(*args, heads)):
        assert g.shape == w.shape and (g.float() - w.float()).abs().max().item() < FUSED_TOL
    assert torch.equal(got[2], flash_attention_packed(got[1], heads))
    return got


@pytest.mark.parametrize("shape", FUSED_ROW_SHAPES)
def test_fused_attn_block_ragged_rows(card, shape):
    b, n, dim, heads = shape
    _fused_two_runs(fused_block_inputs(b, n, dim, torch.device("cuda"), seed=3), heads)


@pytest.mark.parametrize("dim, heads", FUSED_DIMS)
def test_fused_attn_block_widths(card, dim, heads):
    _fused_two_runs(fused_block_inputs(2, 65, dim, torch.device("cuda"), seed=4), heads)


def test_fused_attn_block_never_reads_past_the_operand(card):
    """Rows past B*N of x and past the weights, read by the ragged last
    blocks, reach no output: NaN bytes just past them change nothing."""
    args = fused_block_inputs(1, 65, 1408, torch.device("cuda"), seed=5)
    tailed = [_nan_tailed(a) if a.dtype == torch.bfloat16 else a for a in args]
    got = fused_attn_block_forward(*tailed, 16)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, fused_attn_block_forward(*args, 16)))


@pytest.mark.parametrize("name, count", [("packed_attention", 3), ("mha_attention", 3),
                                         ("packed_attention_bwd", 6), ("mha_attention_bwd", 6),
                                         ("fused_attn_block", 7), ("fused_mlp", 3),
                                         ("fused_mlp_bwd", 8)])
def test_forward_kernels_do_not_spill(card, name, count):
    """ptxas -v of the library: every instantiation with 0 bytes of spill
    stores; the forwards at hd 32, 64, 88, the backward pairs' dq and dkv
    kernels at each of them, kernel 6's two GEMMs at one and two consumer
    warpgroups beside kernel 1's core at hd 32, 64, 88, kernel 7's fc1 at
    one and two consumer warpgroups and its fc2, and kernel 8's six
    launches (its two row kernels at two widths each)."""
    _build.load(name)
    spills = re.findall(r"(\d+) bytes spill stores", _build.build_log(name))
    assert len(spills) == count and all(int(x) == 0 for x in spills)


# -- the pretraining loop's device side: the prefetcher and async checkpoints ---


def test_device_prefetcher_stages_batches_on_the_card(card):
    """Each batch comes out on the card equal to the host batch, after the
    consumer's stream waited for its copy on the side stream."""
    from dinox_torch.data.pipeline import Batch
    from dinox_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [Batch(pixels=rng.integers(0, 65535, (1, 16, 256, 256, 3)).astype(np.uint16),
                  spacing=rng.uniform(0.5, 2, (1, 16, 3)).astype(np.float32), indices=np.arange(16))
            for _ in range(6)]
    busy = torch.randn((4096, 4096), device="cuda")
    for got, want in zip(DevicePrefetcher(host, device="cuda", depth=2), host):
        busy @ busy  # keep the consumer's stream busy while later copies run
        assert got.pixels.is_cuda and got.pixels.dtype == torch.uint16
        np.testing.assert_array_equal(got.pixels.cpu().numpy(), want.pixels)
        np.testing.assert_array_equal(got.spacing.cpu().numpy(), want.spacing)


def test_async_checkpoint_holds_the_state_of_the_save_on_the_card(card, tmp_path):
    """The state on the card is updated in place right after save()
    returns; the checkpoint holds the values of the moment of the save."""
    from dinox_torch.models.config import ModelConfig
    from dinox_torch.train.checkpoint import STATE_FILE, CheckpointManager, state_tensors
    from dinox_torch.zoo.safetensors_io import load_file

    cfg = TrainConfig(model=ModelConfig(name="t", img_size=32, patch=16, dim=64, depth=2, heads=2,
                                        out_dim=128, attn_impl="xla"), img_size=32, batch_size=4)
    state = create_train_state(cfg, device="cuda")
    mgr = CheckpointManager(tmp_path / "run")
    for step in (1, 2):  # the second save reuses the first one's snapshot buffers
        want = {k: v.cpu().clone() for k, v in state_tensors(state).items()}
        mgr.save(step, state)
        with torch.no_grad():
            for _ in range(20):
                for p in list(state.student.parameters()) + list(state.teacher.parameters()):
                    p.mul_(1.5).add_(1.0)
        mgr.wait()
        got = load_file(tmp_path / "run" / "ckpt" / str(step) / STATE_FILE)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=f"step {step}: {k}")
    mgr.close()
    assert len(mgr.stats["blocked_each_s"]) == 2


# -- evaluation and LoRA fine-tuning on the card ---------------------------------


def test_eval_transform_on_the_card_matches_the_cpu(card):
    from dinox_torch.ops.augment import eval_transform

    pixels = torch.randint(30500, 35500, (4, 512, 512, 3), generator=card, device="cuda").to(torch.uint16)
    got = eval_transform(pixels, 224, -30.0, 120.0).cpu()
    want = eval_transform(pixels.cpu(), 224, -30.0, 120.0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_lora_step_through_the_kernels_matches_plain_attention(card):
    """One fine-tuning loss and backward of a LoRA ViT-S (bf16, non-zero B)
    through kernel 1 and the dq/dkv pair against plain attention from one
    state: loss within 1e-2 relative, every adapter gradient at cosine >=
    0.99; exact launch counts (depth each) and no weight gradient of a
    frozen layer."""
    from dinox_torch.ops.augment import eval_transform
    from dinox_torch.train.finetune import FinetuneConfig, finetune_loss, init_head
    from dinox_torch.zoo.peft import apply_lora

    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    base = LoadedModel(cfg, "cuda", generator=torch.Generator().manual_seed(0))
    runs = []
    for impl in ("pallas", "xla"):
        model = LoadedModel(cfg.replace(attn_impl=impl), "cuda")
        model.load_state_dict(base.state_dict())
        lora = apply_lora(model, rank=8, dropout=0.0, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            g = torch.Generator().manual_seed(2)
            for m in lora.lora_layers():
                m.lora_B.weight.copy_(torch.randn(m.lora_B.weight.shape, generator=g) * 0.02)
        head = init_head(FinetuneConfig(), 384, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(3)
        pixels = torch.randint(31000, 35000, (16, 512, 512, 3), generator=g, device="cuda").to(torch.uint16)
        x = eval_transform(pixels, 224)
        spacing = torch.rand((16, 3), generator=g, device="cuda") + 0.5
        labels = (torch.arange(16, device="cuda") % 2).float()
        counts = [flash_attention_packed, packed_attention_bwd_dq, packed_attention_bwd_dkv]
        for fn in counts:
            fn.launches = 0
        lora.train()
        loss = finetune_loss(lora, head, x, spacing, labels, "classification")
        loss.backward()
        torch.cuda.synchronize()
        assert all(p.grad is None for k, p in lora.named_parameters() if ".lora_" not in k)
        if impl == "pallas":
            assert [fn.launches for fn in counts] == [cfg.depth] * 3
        runs.append((float(loss.detach()), {k: p.grad.float() for k, p in lora.adapter_params().items()}))
    (l1, g1), (l2, g2) = runs
    assert abs(l1 - l2) <= 1e-2 * abs(l2)
    for k in g1:
        cos = torch.nn.functional.cosine_similarity(g1[k].flatten(), g2[k].flatten(), dim=0)
        assert cos >= 0.99, (k, float(cos))


# -- the CIFAR control and LoRA under gradient checkpointing on the card -------


def test_rgb_views_on_the_card_match_the_cpu(card):
    """augment_rgb_views on the card against the CPU from one generator seed:
    the draws are the CPU generator's on both and the colour products
    weighted channel sums, so they differ only by float32 rounding in
    another order (cuBLAS's resample sums and the per-image mean), which the
    jitter's factors (up to 1.4 x 1.4 x 1.2, the YIQ rows up to 1.7) and the
    normalisation (1 / 0.24) amplify: within 5e-5. The first stage alone,
    _crop_resize on the same boxes, is held within 1e-5 in [0, 1] pixel
    units (two float32 passes of at most 32 taps each: about 64 roundings of
    2^-24 on weights whose absolute sums are near 1); the boxes drawn on
    each device and the jitter alone on the same crops are printed beside
    it, so the reading shows where the error enters."""
    from dinox_torch.data.cifar import synthetic_cifar
    from dinox_torch.ops.augment import _crop_resize, _sample_crop_box
    from dinox_torch.ops.augment_rgb import (_ATTEMPTS, AREA, ASPECT, DRAWS, JITTER, LEFT, TOP,
                                             RgbAugConfig, _color_jitter, augment_rgb_views)

    pixels = torch.from_numpy(synthetic_cifar(64, 1, seed=2)[0])
    cfg = RgbAugConfig()
    u = torch.rand((128, DRAWS), generator=torch.Generator().manual_seed(5))
    images = (pixels.to(torch.float32) / 255.0).repeat(2, 1, 1, 1)
    boxes = [_sample_crop_box(ud[:, AREA:AREA + _ATTEMPTS], ud[:, ASPECT:ASPECT + _ATTEMPTS],
                              ud[:, TOP], ud[:, LEFT], 32, 32, cfg.crop_cfg) for ud in (u.cuda(), u)]
    box_err = max((a.cpu() - b).abs().max().item() for a, b in zip(*boxes))
    box = boxes[1]
    crops = [_crop_resize(images.to(d), *(b.to(d) for b in box), 32).cpu() for d in ("cuda", "cpu")]
    crop_err = (crops[0] - crops[1]).abs().max().item()
    x = crops[1].clamp(0.0, 1.0)
    jit = [_color_jitter(x.to(d), u[:, JITTER:JITTER + 4].to(d), cfg).cpu() for d in ("cuda", "cpu")]
    jitter_err = (jit[0] - jit[1]).abs().max().item()
    got = augment_rgb_views(pixels.cuda(), torch.Generator().manual_seed(5)).cpu()
    want = augment_rgb_views(pixels, torch.Generator().manual_seed(5))
    reading = (f"card vs CPU max abs error: crop boxes {box_err:.3e} px, _crop_resize on equal "
               f"boxes {crop_err:.3e}, _color_jitter on equal "
               f"crops {jitter_err:.3e}, the views {(got - want).abs().max().item():.3e}")
    print(reading)
    assert crop_err <= 1e-5, reading
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0, msg=reading)


def test_packed_pair_at_the_cifar_shape(card):
    """Kernel 1 and the dq/dkv pair at the CIFAR step's (512, 69, 576, 6):
    N = one 64-row tile and a 5-key tail, hd 32; within the JAX check's
    tolerances, twice with equal bits."""
    qkv = torch.randn((512, 69, 576), generator=card, device="cuda").to(torch.bfloat16)
    do = torch.randn((512, 69, 192), generator=card, device="cuda").to(torch.bfloat16)
    out = [flash_attention_packed(qkv, 6) for _ in range(2)]
    grads = [packed_attention_backward(qkv, do, 6) for _ in range(2)]
    assert torch.equal(*out) and torch.equal(*grads)
    torch.testing.assert_close(out[0].float(), packed_attention_reference(qkv, 6).float(), atol=TOL, rtol=0)
    want = packed_attention_backward_reference(qkv, do, 6).float()
    assert (grads[0].float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_lora_dropout_replays_under_grad_checkpoint_on_the_card(card):
    """LoRA dropout 0.5 with a generator on the card: the factors' gradients
    and the generator's end state equal with and without
    use_grad_checkpoint (f32, plain attention)."""
    from dinox_torch.models.config import ModelConfig
    from dinox_torch.models.vit import PatchViT

    kw = dict(name="vit-tiny", img_size=32, patch=16, dim=192, depth=2, heads=3, out_dim=16,
              dtype="float32", attn_impl="xla", lora_rank=4, lora_alpha=8.0, lora_dropout=0.5)
    x = torch.randn((3, 32, 32, 3), generator=card, device="cuda")
    w = 1e-3 * torch.randn((3, 9, 192), generator=card, device="cuda")
    grads, ends = [], []
    for remat in (False, True):
        model = PatchViT(ModelConfig(**kw, use_grad_checkpoint=remat), device="cuda",
                         generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for m in model.lora_layers():
                m.lora_B.weight.normal_(0.0, 0.05, generator=torch.Generator(device="cuda").manual_seed(1))
        model.train()
        gen = torch.Generator(device="cuda").manual_seed(3)
        model.set_lora_generator(gen)
        (model(x) * w).sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters() if ".lora_" in k})
        ends.append(gen.get_state())
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6, rtol=0, msg=k)
    assert torch.equal(ends[0], ends[1])


@pytest.mark.parametrize("kind", [dict(mu_dtype="bfloat16"), dict(nu_dtype="bfloat16"),
                                  dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
                                  dict(factored_nu=True)])
def test_low_precision_update_on_the_card_matches_the_cpu(card, kind):
    """Three updates of a ViT-T-width student from one state with the same
    gradients: the moments within one bf16 step of the CPU's (the card's
    float32 arithmetic may round a moment across a bf16 boundary), the
    parameters within 1e-6 of each tensor's largest value, plus, where a
    moment is bf16, lr * 2^-6 (one bf16 step of a moment moves Adam's step
    by up to 2^-8 of lr)."""
    from dinox_torch.models.config import ModelConfig
    from dinox_torch.train.state import apply_gradients

    mcfg = ModelConfig(name="t", img_size=28, patch=14, dim=192, depth=2, heads=3, out_dim=32,
                       dtype="float32", scale_aware=True)
    cfg = TrainConfig(model=mcfg, img_size=28, lr=1e-2, warmup_steps=1, max_steps=20, **kind)
    states = [create_train_state(cfg, seed=0, device=d) for d in ("cpu", "cuda")]
    g = torch.Generator().manual_seed(5)
    for step in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in states[0].student.parameters()]
        for st in states:
            dev = next(st.student.parameters()).device
            apply_gradients(cfg, st.optimizer, list(st.student.parameters()),
                            [x.to(dev) for x in grads], step)
    low = 2 ** -6 * cfg.lr if "bfloat16" in (cfg.mu_dtype, cfg.nu_dtype) else 0.0
    for (name, a), b in zip(states[0].student.named_parameters(), states[1].student.parameters()):
        pa = a.detach()
        assert (b.detach().cpu() - pa).abs().max() <= 1e-6 * pa.abs().max() + low, name
        sa, sb = states[0].optimizer.state[a], states[1].optimizer.state[b]
        assert sa.keys() == sb.keys()
        for k in sa:
            x, y = sa[k], sb[k].cpu()
            assert x.dtype == y.dtype, (name, k)
            if k != "step":
                assert (x.float() - y.float()).abs().max() <= 2 ** -7 * x.float().abs().max() + 1e-30, (name, k)


def test_moe_mlp_bf16_on_the_card_matches_the_cpu(card):
    """MoeMlp at ViT-S width (E 4, cf 1.25, N 261) in bf16: the same expert
    for every token, the output within 0.05 and the aux within 1e-5."""
    from dinox_torch.models.moe import MoeMlp

    m = MoeMlp(384, 4)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    x = (torch.randn((4, 261, 384), generator=torch.Generator().manual_seed(2))).to(torch.bfloat16)
    y_cpu, aux_cpu = m(x)
    _, e_cpu, _, _ = m.route(x)
    m.cuda()
    y, aux = m(x.cuda())
    _, e, _, _ = m.route(x.cuda())
    assert torch.equal(e.cpu(), e_cpu)
    assert (y.float().cpu() - y_cpu.float()).abs().max() <= 0.05
    assert abs(aux.item() - aux_cpu.item()) <= 1e-5


@pytest.mark.parametrize("shape", [(192, 65, 3 * 384, 6), (192, 257, 3 * 512, 16)])
def test_packed_pair_at_the_mae_shapes(card, shape):
    """Kernel 1 and the dq/dkv pair at the MAE encoder's visible tokens (N 65
    = CLS + 64 kept patches, hd 64) and the decoder's (N 257, hd 32, 16
    heads): within the JAX check's tolerances, twice with equal bits."""
    b, n, three_dim, heads = shape
    qkv = torch.randn((b, n, three_dim), generator=card, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, three_dim // 3), generator=card, device="cuda").to(torch.bfloat16)
    out = [flash_attention_packed(qkv, heads) for _ in range(2)]
    grads = [packed_attention_backward(qkv, do, heads) for _ in range(2)]
    assert torch.equal(*out) and torch.equal(*grads)
    torch.testing.assert_close(out[0].float(), packed_attention_reference(qkv, heads).float(),
                               atol=TOL, rtol=0)
    want = packed_attention_backward_reference(qkv, do, heads).float()
    assert (grads[0].float() - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("shape,tp", [((96, 261, 3 * 384, 6), 1), ((192, 261, 3 * 192, 6), 2),
                                      ((64, 261, 3 * 192, 6), 2)],
                         ids=["dp2-rank", "tp2-rank", "tp2-ep2-rank"])
def test_packed_pair_at_a_mesh_ranks_shapes(card, shape, tp):
    """Kernel 1 and the dq/dkv pair at the blocks a rank of the ViT-S mesh
    step runs: its 2 x 48 view rows under dp 2 at bs96, all 2 x 96 rows at
    3 of the 6 heads under tp 2 ((192, 261, 576, 3), reached through
    flash_attention_packed_sharded), and all 2 x 32 rows at 3 heads under
    tp 2 x ep 2 at bs 32 ((64, 261, 576, 3)); within the JAX check's
    tolerances, twice with equal bits."""
    from dinox_torch.ops.flash_attention import flash_attention_packed_sharded
    from dinox_torch.parallel import Mesh

    b, n, three_dim, heads = shape
    mesh = Mesh(tp, 0, 1, tp, None, None, torch.device("cuda"))
    local = heads // tp
    qkv = torch.randn((b, n, three_dim), generator=card, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, three_dim // 3), generator=card, device="cuda").to(torch.bfloat16)
    before = flash_attention_packed.launches
    out = [flash_attention_packed_sharded(qkv, heads, mesh) for _ in range(2)]
    assert flash_attention_packed.launches - before == 2
    grads = [packed_attention_backward(qkv, do, local) for _ in range(2)]
    assert torch.equal(*out) and torch.equal(*grads)
    torch.testing.assert_close(out[0].float(), packed_attention_reference(qkv, local).float(),
                               atol=TOL, rtol=0)
    want = packed_attention_backward_reference(qkv, do, local).float()
    assert (grads[0].float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_world_one_nccl_moe_mesh_step_is_the_plain_step(card):
    """A world-1 NCCL group's mesh with expert_parallel=1 and MoE at tp 1
    (ViT-S scale-aware, 4 experts, bs 16): two steps bit-equal to the step
    without a mesh, every metric and every state tensor, with the same
    launches of kernels 1, dq and dkv: at world 1 the expert axis and its
    group cost nothing."""
    import itertools
    import socket

    import torch.distributed as dist

    from dinox_torch.parallel import make_mesh
    from dinox_torch.pretrain import DeviceSyntheticBatches
    from dinox_torch.train.checkpoint import state_tensors
    from dinox_torch.train.state import TrainConfig, create_train_state
    from dinox_torch.train.step import build_train_step

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(model_parallel=1, expert_parallel=1)
        assert (mesh.dp, mesh.tp, mesh.ep, mesh.expert_group) == (1, 1, 1, None)
        mcfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, moe_experts=4)
        cfg = TrainConfig(model=mcfg, batch_size=16, warmup_steps=2, max_steps=10, koleo_weight=0.1)
        plain, meshed = create_train_state(cfg, 0, "cuda"), create_train_state(cfg, 0, mesh=mesh)
        fns = build_train_step(cfg, "cuda"), build_train_step(cfg, mesh=mesh)
        counters = (flash_attention_packed, packed_attention_bwd_dq, packed_attention_bwd_dkv)
        batches = DeviceSyntheticBatches(2, 16, 1, 512, 0, n_datasets=5, device="cuda")
        for batch in itertools.islice(iter(batches), 2):
            got, launched = [], []
            for state, fn in ((plain, fns[0]), (meshed, fns[1])):
                before = [c.launches for c in counters]
                got.append(fn(state, batch.pixels, batch.spacing)[1])
                launched.append([c.launches - b for c, b in zip(counters, before)])
            assert sorted(got[0]) == sorted(got[1]) and "loss_moe_aux" in got[0]
            assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])
            assert launched[0] == launched[1] == [2 * mcfg.depth, mcfg.depth, mcfg.depth]
        a, b = state_tensors(plain), state_tensors(meshed)
        assert a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)
    finally:
        dist.destroy_process_group()


def test_staged_release_cls_through_kernel_1_is_bit_equal(card, tmp_path):
    """A ViT-S backbone staged by zoo.publish.stage_release, loaded back as
    the hub dir and as backbone.pth (with the staged config.json), encodes 40
    slices through kernel 1 to CLS features with the source model's bits;
    launches == depth x forwards."""
    import json

    from dinox_torch.zoo import encode_batch, load_model
    from dinox_torch.zoo.publish import stage_release

    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    model = LoadedModel(cfg, "cuda", generator=torch.Generator().manual_seed(3))
    staged = stage_release(model, tmp_path / "release", model_name="t")
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1000, 1500, (512, 512)).astype(np.float32) for _ in range(40)]
    sps = [tuple(rng.uniform(0.5, 3.0, 3)) for _ in imgs]
    want = encode_batch(model, imgs, sps, batch_size=32)
    override = json.loads((staged / "config.json").read_text())
    for loaded in (load_model(staged, device="cuda"),
                   load_model(staged / "backbone.pth", config_override=override, device="cuda")):
        before = flash_attention_packed.launches
        got = encode_batch(loaded, imgs, sps, batch_size=32)
        assert flash_attention_packed.launches == before + cfg.depth * 2
        assert torch.equal(got, want)
    assert "TPU" not in (staged / "README.md").read_text()


def test_detect_hardware_reports_the_card(card):
    from dinox_torch.utils.hardware import detect_hardware

    hw = detect_hardware()
    assert hw.backend == "gpu" and hw.device_kind == torch.cuda.get_device_name(0)
    assert hw.num_devices == torch.cuda.device_count() and hw.num_hosts == 1
    assert hw.batch_size_recommendation == 64


def test_bench_batch_sweep_row_on_the_card(card):
    from dinox_torch.bench_batch_sweep import bench_one
    from dinox_torch.utils.flops import card_peaks

    depth = MODEL_CONFIGS["vit-small"].depth
    counters = (flash_attention_packed, packed_attention_bwd_dq, packed_attention_bwd_dkv)
    before = [c.launches for c in counters]
    row = bench_one("vit-small", 16, 2, 1, None, 1, device="cuda",
                    peak_flops=card_peaks(torch.cuda.get_device_name(0))[0])
    assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2 * depth, 3 * depth, 3 * depth]
    assert row["slices_per_s"] > 0 and 0 < row["mfu"] < 1


def test_tune_throughput_cell_on_the_card(card, tmp_path):
    from dinox_torch import tune_throughput

    depth = MODEL_CONFIGS["vit-small"].depth
    args = tune_throughput.parse_args(["--synthetic", "--steps", "2", "--warmup", "1",
                                       "--out-dir", str(tmp_path)])
    counters = (flash_attention_packed, packed_attention_bwd_dq, packed_attention_bwd_dkv)
    before = [c.launches for c in counters]
    rec = tune_throughput.measure(args, 16, 8, 4)
    assert rec["status"] == "ok" and rec["bound"] == "compute_bound"
    assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2 * depth, 3 * depth, 3 * depth]
    assert 0 < rec["peak_bytes_in_use"] <= torch.cuda.get_device_properties(0).total_memory


# -- the LayerNorm kernels (ops/layer_norm.py, csrc/layer_norm.cu) ---------------

# (rows, C): the ViT-S and ViT-L training cells' rows (128 and 64 slices x 2
# views x 261 tokens), then the ragged edges: one row, rows that do not fill
# the last CTA (16 rows a CTA at C 384, 8 at 1024, 256 at 8, 1 at 8192),
# C = 8 and 8192, ViT-G's 1408 (a row over two warps) and ViT-T's 192.
LN_SHAPES = [(66816, 384), (33408, 1024)]
LN_EDGES = [(1, 384), (17, 384), (9, 1024), (300, 8), (3, 8192), (77, 1408), (5, 192)]
# (x, y) dtypes, the pairs the kernels take: the block and ScaleEmbedding
# norms, a float32 model's norms, the final and the MAE decoder norm.
LN_PATHS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
            (torch.bfloat16, torch.float32)]


def _ln_inputs(card, rows, c, x_dtype, y_dtype):
    x = (torch.randn((rows, c), generator=card, device="cuda") * 2.0 + 0.5).to(x_dtype)
    w = 1.0 + 0.1 * torch.randn(c, generator=card, device="cuda")
    b = 0.1 * torch.randn(c, generator=card, device="cuda")
    dy = torch.randn((rows, c), generator=card, device="cuda").to(y_dtype)
    return x, w, b, dy


def _ln_kernels(x, w, b, dy, y_dtype):
    """y, dx, dgamma, dbeta through the kernels' autograd function."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    y = lnk.layer_norm(*leaves, y_dtype)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def _ln_close(got, want, atol):
    """Within one unit in the last place of *want*'s value in *got*'s dtype
    (2^-7 of its binade in bf16, 2^-23 in f32), plus *atol*."""
    want = want.to(got.dtype).float()
    bits = 7 if got.dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - bits)
    err = (got.float() - want).abs()
    assert torch.all(err <= ulp + atol), (err - ulp).max().item()


def _ln_check(card, rows, c, x_dtype, y_dtype):
    """The kernels against the plain versions on the card. y: 1 ulp and
    2e-6 (the statistics' sums in another order move an f32 value near 0 by
    more than a bf16 ulp). dx: 1 ulp and 1e-5 of the largest (the row sums
    in another order); dgamma and dbeta: 1e-4 of the largest (f32 sums of up
    to 66,816 rows in another order)."""
    x, w, b, dy = _ln_inputs(card, rows, c, x_dtype, y_dtype)
    y, dx, dw, db = _ln_kernels(x, w, b, dy, y_dtype)
    assert y.dtype == y_dtype and dx.dtype == x_dtype and dw.dtype == db.dtype == torch.float32
    _ln_close(y, lnk.layer_norm_reference(x, w, b, y_dtype), 2e-6)
    want_dx, want_dw, want_db = lnk.layer_norm_backward_reference(x, w, dy)
    _ln_close(dx, want_dx, 1e-5 * want_dx.float().abs().max().item())
    for got, want in ((dw, want_dw), (db, want_db)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("path", LN_PATHS, ids=["bf16", "f32", "bf16-f32"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_matches_plain_at_the_cells_rows(card, shape, path):
    _ln_check(card, *shape, *path)


@pytest.mark.parametrize("shape", LN_EDGES)
def test_layer_norm_ragged_edges_match_plain(card, shape):
    for path in LN_PATHS:
        _ln_check(card, *shape, *path)


@pytest.mark.parametrize("shape", LN_SHAPES + LN_EDGES[:2])
def test_layer_norm_repeats_bit_for_bit(card, shape):
    args = _ln_inputs(card, *shape, torch.bfloat16, torch.bfloat16)
    first, again = (_ln_kernels(*args, torch.bfloat16) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("path", LN_PATHS[::2], ids=["bf16", "bf16-f32"])
def test_layer_norm_without_a_gradient_matches_plain(card, path):
    """The forward alone, with no statistics written, as every embedding
    batch runs it (inference_mode, an embed batch's 64 x 261 rows of 384):
    the plain version's values within 1 ulp and 2e-6, and the same bits as
    the forward that writes the statistics for a backward."""
    x, w, b, dy = _ln_inputs(card, 64 * 261, 384, *path)
    with torch.inference_mode():
        y = lnk.layer_norm(x, w, b, path[1])
    _ln_close(y, lnk.layer_norm_reference(x, w, b, path[1]), 2e-6)
    assert torch.equal(y, _ln_kernels(x, w, b, dy, path[1])[0])


def test_layer_norm_clamped_rows_drop_the_variance_term(card):
    """Constant float32 rows, some of whose fast variance rounds below 0 in
    the kernel (rstd saved negated): dx from the kernel's own statistics as
    the plain backward's formula gives it, rstd (dxh - mean(dxh)) where
    clamped. (Against the eager formula's own statistics a constant row
    cannot be held: E[x^2] - E[x]^2 of a row of 9.7 is a few ulps of 94,
    as large as eps, so each order of summation gives its own rstd.)"""
    rows, c = 256, 384
    x = torch.linspace(0.3, 9.7, rows, device="cuda")[:, None].expand(rows, c).contiguous()
    x[::2] += torch.randn((rows // 2, c), generator=card, device="cuda")
    w = 1.0 + 0.1 * torch.randn(c, generator=card, device="cuda")
    b = torch.zeros(c, device="cuda")
    dy = torch.randn((rows, c), generator=card, device="cuda")
    stats = torch.empty((2, rows), device="cuda")
    lnk.layer_norm_fwd(x, w, b, torch.empty_like(x), stats)
    mean, rs = stats[0][:, None], stats[1][:, None]
    assert (rs[1::2] < 0).any() and (rs[1::2] > 0).any() and (rs[::2] > 0).all()
    grid = lnk.backward_grid(rows, c, x.dtype, dy.dtype)
    dx, part = torch.empty_like(x), torch.empty((grid, 2 * c), device="cuda")
    lnk.layer_norm_bwd(x, w, dy, stats, dx, part, grid)
    r = rs.abs()
    xhat, dxh = (x - mean) * r, dy * w
    a2 = torch.where(rs < 0, 0.0, (dxh * xhat).mean(dim=-1, keepdim=True))
    want = r * (dxh - dxh.mean(dim=-1, keepdim=True) - xhat * a2)
    assert (dx - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_layer_norm_launches(card):
    """One forward launch a call; with a gradient the dx launch and the
    parameters' launch; with x's gradient alone (frozen norms) no parameters'
    launch; under no_grad nothing saved."""
    x, w, b, dy = _ln_inputs(card, 100, 384, torch.bfloat16, torch.bfloat16)
    fns = (lnk.layer_norm_fwd, lnk.layer_norm_bwd, lnk.layer_norm_bwd_params)
    before = [f.launches for f in fns]
    with torch.no_grad():
        y = lnk.layer_norm(x, w, b, torch.bfloat16)
    assert y.grad_fn is None and [f.launches - n for f, n in zip(fns, before)] == [1, 0, 0]
    _ln_kernels(x, w, b, dy, torch.bfloat16)
    assert [f.launches - n for f, n in zip(fns, before)] == [2, 1, 1]
    xr = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(lnk.layer_norm(xr, w, b, torch.bfloat16), xr, dy)
    assert [f.launches - n for f, n in zip(fns, before)] == [3, 2, 1]
    assert torch.equal(dx, _ln_kernels(x, w, b, dy, torch.bfloat16)[1])


def test_layer_norm_takes_a_non_contiguous_chunk(card):
    """A rank's token chunk under sequence parallelism may come strided."""
    x, w, b, dy = _ln_inputs(card, 2 * 40, 384, torch.bfloat16, torch.bfloat16)
    chunk = x.view(2, 40, 384)[:, 20:]
    assert not chunk.is_contiguous()
    got = lnk.layer_norm(chunk, w, b, torch.bfloat16)
    assert torch.equal(got, lnk.layer_norm(chunk.contiguous(), w, b, torch.bfloat16))


def test_layer_norm_rejects_what_it_cannot_take(card):
    x, w, b, _ = _ln_inputs(card, 4, 384, torch.bfloat16, torch.bfloat16)
    with pytest.raises(TypeError):
        lnk.layer_norm(x.half(), w, b, torch.bfloat16)
    with pytest.raises(TypeError):
        lnk.layer_norm(x.float(), w, b, torch.bfloat16)  # float32 rows to bf16: no caller
    with pytest.raises(ValueError):
        lnk.layer_norm(x[:, :100], w[:100], b[:100], torch.bfloat16)  # C not a multiple of 8
    with pytest.raises(ValueError):
        lnk.layer_norm(x, w.cpu(), b, torch.bfloat16)


def test_training_micro_step_through_the_layer_norm_kernels_matches_eager(card, monkeypatch):
    """Depth 2, full ViT-S width, scale-aware with a live scale pathway: the
    loss within 1e-3 relative and every gradient at cosine >= 0.99 against
    the same step with the eager LayerNorm on the card; exact launches: each
    of the student's and the teacher's passes runs 2 x depth + 2 norms (the
    blocks', the final and the ScaleEmbedding's), the student's backward
    one dx and one parameters' launch each."""
    from dinox_torch.models import vit

    model = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, depth=2)
    cfg = TrainConfig(model=model, batch_size=4, koleo_weight=0.1)
    states = [create_train_state(cfg, seed=0) for _ in range(2)]
    with torch.no_grad():
        states[0].student.backbone.scale_embed.mlp[2].weight.normal_(0.0, 0.02, generator=card)
    for s in states:
        s.student.load_state_dict(states[0].student.state_dict())
        s.teacher.load_state_dict(states[0].student.state_dict())
    px = np.random.default_rng(0).integers(25000, 41000, (4, 256, 256, 3)).astype(np.uint16)
    views = augment_views(torch.from_numpy(px).cuda(), torch.Generator().manual_seed(0), cfg.aug)
    batch = views.reshape(-1, 224, 224, 3)
    sp = torch.rand((4, 3), generator=card, device="cuda") * 2.5 + 0.5
    fns = (lnk.layer_norm_fwd, lnk.layer_norm_bwd, lnk.layer_norm_bwd_params)
    norms = 2 * model.depth + 2
    before = [f.launches for f in fns]
    g_k, _, m_k = micro_loss_and_grads(states[0], states[0].center, batch, sp, cfg)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [2 * norms, norms, norms]
    monkeypatch.setattr(vit, "layer_norm", lnk.layer_norm_reference)
    before = [f.launches for f in fns]
    g_e, _, m_e = micro_loss_and_grads(states[1], states[1].center, batch, sp, cfg)
    assert [f.launches - n for f, n in zip(fns, before)] == [0, 0, 0]
    assert abs(m_k["loss"].item() - m_e["loss"].item()) <= 1e-3 * abs(m_e["loss"].item())
    for a, b in zip(g_k, g_e):
        if not a.any() and not b.any():
            continue
        cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0)
        assert cos.item() >= 0.99
