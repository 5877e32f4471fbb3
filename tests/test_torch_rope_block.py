"""DINOv3's ViT-7B block in the port (RoPE, SwiGLU, LayerScale, no qkv
bias; ``models.vit.RopeBlock``) against the benchmark's plain float32
reference, ``benchmark/reference/vit_rope.py`` and ``dino_rope.py``, at
small sizes on the CPU: the RoPE and SwiGLU ops (their plain versions, which
hold the kernels' rounding points), one block, a depth-2 ``PatchViT``, one
training step; the checkpoint round trip through the hub and the
``pretrain`` CLI's preset; and the combinations the block refuses.

Tolerances: the ops round once from float32, so in bf16 they give the
reference's float32 result rounded to bf16, bit for bit, which the same
rotation or gate computed in bf16 (a rounding after each product) does
not. The block, the model and the step run in float32 compute, where the
reference's float32 arithmetic leaves gaps of ~1e-6; a bf16 rotation or
gate there moves the outputs by ~1e-3."""

import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dinox_torch.models.config import MODEL_CONFIGS, PORT_ONLY_FIELDS, ModelConfig
from dinox_torch.models.vit import PatchViT, RopeBlock
from dinox_torch.ops import rope as rk
from dinox_torch.ops import swiglu as sk

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import dino_rope, vit_rope  # noqa: E402

SMALL = dict(dim=256, depth=2, heads=2, ffn_hidden=512, img_size=64, out_dim=64, scale_aware=True)
RHO = 1.37


def _qkv(b=3, grid=4, heads=2, hd=128, regs=4, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 1 + grid * grid + regs, 3 * heads * hd), generator=g).to(dtype)


def _ref_rotate(qkv, heads, cos, sin):
    """The reference's rotation of the patch rows' q and k, float32."""
    b, n, width = qkv.shape
    hd = width // 3 // heads
    x = qkv.float().view(b, n, 3, heads, hd).clone()
    p = slice(1, 1 + cos.shape[0])
    for part in (0, 1):
        x[:, p, part] = vit_rope.rotate(x[:, p, part].transpose(1, 2), cos, sin).transpose(1, 2)
    return x.view(b, n, width)


def test_rope_tables_are_the_references():
    cos, sin = rk.rope_tables(4, 128, RHO)
    rc, rs = vit_rope.rope_tables(4, 128, RHO)
    assert torch.equal(cos, rc[:, :64]) and torch.equal(sin, rs[:, :64])
    assert torch.equal(rc[:, :64], rc[:, 64:])


def test_rope_matches_the_reference_rounded_once():
    qkv = _qkv()
    cos, sin = rk.rope_tables(4, 128, RHO)
    rc, rs = vit_rope.rope_tables(4, 128, RHO)
    want = _ref_rotate(qkv, 2, rc, rs)
    got = qkv.clone()
    rk.apply_rope(got, cos, sin, 2, first=1)
    assert torch.equal(got, want.to(torch.bfloat16))
    # CLS, the registers and v as they were
    assert torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[:, 17:], qkv[:, 17:])
    assert torch.equal(got[..., 2 * 256:], qkv[..., 2 * 256:])
    # the rotation in bf16 (each product and the sum rounded) misses it
    lo, hi = qkv.float()[:, 1:17, :512].unflatten(-1, (4, 2, 64)).unbind(-2)
    c, s = cos[None, :, None].bfloat16(), sin[None, :, None].bfloat16()
    bf = (lo.bfloat16() * c - hi.bfloat16() * s).float()
    assert not torch.equal(bf.bfloat16(), want[:, 1:17, :512].unflatten(-1, (4, 2, 64))[..., 0, :].bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_backward_matches_the_reference(dtype):
    leaf = _qkv(dtype=torch.float32, seed=1).requires_grad_(True)
    cos, sin = rk.rope_tables(4, 128, RHO)
    rc, rs = vit_rope.rope_tables(4, 128, RHO)
    dy = torch.randn(leaf.shape, generator=torch.Generator().manual_seed(2))
    (want,) = torch.autograd.grad(_ref_rotate(leaf, 2, rc, rs), leaf, dy)
    x = leaf.detach().to(dtype).requires_grad_(True)
    (got,) = torch.autograd.grad(rk.apply_rope(x * 1, cos, sin, 2, first=1), x, dy.to(dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:  # the gradient's rotation from the bf16 dy, rounded once
        (want16,) = torch.autograd.grad(_ref_rotate(leaf, 2, rc, rs), leaf, dy.to(dtype).float())
        assert torch.equal(got, want16.to(dtype))


def test_swiglu_matches_the_reference_rounded_once():
    g = torch.Generator().manual_seed(3)
    h32 = 2 * torch.randn((37, 2 * 96), generator=g)
    h = h32.bfloat16()
    u, gate = h.float().chunk(2, dim=-1)
    want = F.silu(u) * gate
    assert torch.equal(sk.swiglu(h), want.bfloat16())
    bf = (F.silu(u.bfloat16()) * gate.bfloat16()).float()  # the gate in bf16
    assert not torch.equal(bf.bfloat16(), want.bfloat16())
    # backward: float32 to 1e-6; bf16 within one rounding of the float32
    # reference's gradient, where a bf16 gate's backward is not
    dz = torch.randn((37, 96), generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        x = h32.to(dtype).requires_grad_(True)
        (got,) = torch.autograd.grad(sk.swiglu(x * 1), x, dz.to(dtype))
        ref = x.detach().float().requires_grad_(True)
        uu, gg = ref.chunk(2, dim=-1)
        (want,) = torch.autograd.grad(F.silu(uu) * gg, ref, dz.to(dtype).float())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        else:
            err = (got.float() - want).abs()
            assert (err <= 2.0 ** -8 * want.abs()).all()
            d16 = dz.to(dtype)
            s16 = torch.sigmoid(uu.detach().bfloat16())
            du16 = d16 * gg.detach().bfloat16() * (s16 * (1 + uu.detach().bfloat16() * (1 - s16)))
            bad = (du16.float() - want[:, :96]).abs() > 2.0 ** -8 * want[:, :96].abs()
            assert bad.any()


def _model(**kw) -> PatchViT:
    cfg = MODEL_CONFIGS["vit-7b16"].replace(**{**SMALL, **kw})
    model = PatchViT(cfg).train()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # biases off zero, gains about 1, a live scale token
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
            elif name.startswith("scale_embed"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    model.set_rope_rescale(RHO)
    return model


def _params(model) -> dict:
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def _inputs(b=3, size=64):
    g = torch.Generator().manual_seed(5)
    return torch.rand((b, size, size, 3), generator=g), torch.rand((b, 3), generator=g) + 0.5


def test_block_matches_the_reference():
    model = _model(dtype="float32")
    p = _params(model)
    x = torch.randn((3, 21, 256), generator=torch.Generator().manual_seed(6))
    tables = vit_rope.rope_tables(4, 128, RHO)
    want = vit_rope.block(x, p, 0, model.cfg.to_dict(), tables, torch.matmul)
    got = model.blocks[0](x)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert isinstance(model.blocks[0], RopeBlock)
    assert sorted(k for k in p if k.startswith("blocks.0.")) == sorted(
        f"blocks.0.{k}" for k in ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.proj.weight",
                                  "attn.proj.bias", "ls1.gamma", "norm2.weight", "norm2.bias",
                                  "mlp.w12.weight", "mlp.w12.bias", "mlp.w3.weight", "mlp.w3.bias",
                                  "ls2.gamma"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_vit_matches_the_reference(dtype):
    """Depth 2, dim 256, 2 heads of 128, SwiGLU 512 wide: float32 compute
    to 5e-5 (the final LayerNorm's outputs are ~1); bf16 compute (its GEMMs
    round to bf16) to a CLS cosine of 0.9995."""
    model = _model(dtype=dtype)
    x, sp = _inputs()
    want = vit_rope.tokens(x, sp, _params(model), model.cfg.to_dict(), rescale=RHO)
    got = model(x, sp)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=5e-5)
    else:
        cos = F.cosine_similarity(got[:, 0], want[:, 0], dim=-1)
        assert cos.min().item() >= 0.9995
    model.eval()  # no rescale at inference
    torch.testing.assert_close(model(x, sp), vit_rope.tokens(x, sp, _params(model), model.cfg.to_dict()),
                               rtol=0, atol=5e-5 if dtype == "float32" else 0.1)


def test_one_training_step_matches_dino_rope():
    from dinox_torch.train.state import TrainConfig, create_train_state
    from dinox_torch.train.step import build_train_step

    mcfg = MODEL_CONFIGS["vit-7b16"].replace(**{**SMALL, "img_size": 32, "dtype": "float32",
                                                 "use_grad_checkpoint": True})
    recipe = dict(lr=1e-3, min_lr=1e-6, warmup_steps=10, max_steps=100, weight_decay=0.04, ema=0.9,
                  teacher_temp=0.04, student_temp=0.1, center_momentum=0.9, gram_weight=1.0,
                  koleo_weight=0.1, crop_scale=[0.3, 1.0], train_seed=0)
    cfg = TrainConfig(model=mcfg, img_size=32, batch_size=4, accumulation_steps=2,
                      crop_scale_min=0.3, crop_scale_max=1.0,
                      **{k: v for k, v in recipe.items() if k != "crop_scale"})
    state = create_train_state(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for net in (state.student, state.teacher):
            for name, p in net.named_parameters():
                if name.endswith("gamma"):
                    p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
                elif name.startswith("backbone.scale_embed") or p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))
    state.step = 5
    w0 = {k: v.detach().clone() for k, v in state.student.named_parameters()}
    t0 = {k: v.detach().clone() for k, v in state.teacher.named_parameters()}
    pixels = torch.randint(25000, 41000, (2, 4, 48, 48, 3), generator=g, dtype=torch.int32).to(torch.int16)
    pixels = pixels.view(torch.uint16)
    spacing = torch.rand((2, 4, 3), generator=g) + 0.5
    state, metrics = build_train_step(cfg, device="cpu")(state, pixels, spacing)
    ref = dino_rope.train({k: v.clone() for k, v in w0.items()}, {k: v.clone() for k, v in t0.items()},
                          mcfg.to_dict(), recipe, [(pixels, spacing)], start=5)
    assert abs(float(metrics["loss"]) - ref["losses"][0]) <= 1e-4 * abs(ref["losses"][0])
    # Each leaf's change (Adam turns float32 noise in a near-zero gradient
    # into up to lr, so the norms, not the elements, are held)
    for net, start, final in ((state.student, w0, ref["student"]), (state.teacher, t0, ref["teacher"])):
        for name, p in net.named_parameters():
            moved, want = p.detach() - start[name], final[name] - start[name]
            assert (moved - want).norm() <= 1e-3 * want.norm() + 1e-7, name


def test_hub_round_trip_and_the_cli_preset(tmp_path):
    from dinox_torch.pretrain import parse_args
    from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint, load_model

    model = _model(dtype="float32").eval()
    export_hub_checkpoint(model, tmp_path / "hub")
    config = json.loads((tmp_path / "hub/config.json").read_text())
    assert {k: config[k] for k in PORT_ONLY_FIELDS} == {k: getattr(model.cfg, k) for k in PORT_ONLY_FIELDS}
    loaded = load_model(tmp_path / "hub", device="cpu")
    assert isinstance(loaded, LoadedModel) and isinstance(loaded.blocks[0], RopeBlock)
    assert loaded.cfg.to_dict() == {**model.cfg.to_dict(), "name": loaded.cfg.name, "out_dim": loaded.cfg.out_dim,
                                    "dtype": loaded.cfg.dtype, "gelu_approx": loaded.cfg.gelu_approx}
    x, sp = _inputs()
    with torch.no_grad():
        want = PatchViT(loaded.cfg).eval()
        want.load_state_dict(model.state_dict())
        torch.testing.assert_close(loaded(x, sp), want(x, sp), rtol=0, atol=0)
    args = parse_args(["--config", "vit-7b16", "--run-dir", str(tmp_path / "run")])
    assert MODEL_CONFIGS[args.config].block == "dinov3"


def test_the_block_refuses_what_it_does_not_take():
    from dinox_torch.models.mae import MaeModel
    from dinox_torch.models.vit import set_mesh
    from dinox_torch.parallel.mesh import Mesh

    base = MODEL_CONFIGS["vit-7b16"].replace(**SMALL)
    for kw in (dict(fused_attn=True), dict(fused_mlp=True, gelu_approx=False), dict(moe_experts=2),
               dict(lora_rank=4)):
        with pytest.raises(ValueError, match="does not take"):
            PatchViT(base.replace(**kw))
    model = PatchViT(base)
    with pytest.raises(ValueError, match="does not take"):
        MaeModel(base)
    with pytest.raises(ValueError, match="model_parallel=2"):
        set_mesh(model, Mesh(2, 0, 1, 2, None, None, torch.device("cpu")))
    # One field picks the block; the DINOv3 block's values come with it and
    # only with it, so no partial combination builds.
    for kw in (dict(block="dinov2"), dict(layer_scale=1e-5), dict(ffn_hidden=1536), dict(rope_rescale=2.0)):
        with pytest.raises(ValueError):
            ModelConfig(**kw)
    for kw in (dict(ffn_hidden=0), dict(ffn_hidden=100), dict(layer_scale=0.0), dict(rope_rescale=0.5)):
        with pytest.raises(ValueError):
            base.replace(**kw)
    assert ModelConfig().block == "vit" and ModelConfig().hidden == 1536 and base.hidden == SMALL["ffn_hidden"]
