"""Benchmark of the port's training step on one CUDA card.

    python -m dinox_torch.bench            # training rate, one JSON line
    python -m dinox_torch.bench --check    # kernels against their plain versions

The training arm is the JAX package's ``bench.py`` recipe: ViT-S
scale-aware, ``attn_impl="pallas"``, batch 96 (192 views), KoLeo 0.1,
warmup 100 and horizon 5000 steps, synthetic uint16 512x512 canvases
(``integers(25000, 41000)``) and spacings (``uniform(0.4, 3.0)``) from seed
0, 5 warm-up steps and 20 timed steps; the loss must stay finite. It runs
the JAX bench's dense arms: exact GELU, tanh GELU (the default) and tanh
with the fused attention half-block (``tanh+fused_attn``), and its
Switch-MoE arm (``moe4``: tanh, unfused, 4 experts in every second block,
capacity factor 1.25), and prints the JAX bench's headline: ``value`` and
``mfu`` (against the card's dense bf16 peak) of the better tanh arm (never
the MoE arm), ``vs_baseline`` (``value`` over the reference's 159
slices/s), each arm's rate, ``moe4_mfu`` with the MoE-aware FLOPs, and the
card's name and power limit. A failing arm raises. ``--check`` holds the packed attention
forward and backward kernels against the plain versions at (8, 261, 384, 6) and
(2, 261, 1408, 16), forward within 0.02, backward within 0.25 (bf16), the
head-major forward (kernel 4, the JAX check's "unpacked" line) at
(4, 6, 261, 64) within 0.02, and the fused attention half-block against its
plain version at (8, 261, 384, 6) with the JAX check's input scales, within
0.05; all fold into one ``kernel_check`` JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    mha_attention_reference,
    packed_attention_reference,
)
from dinox_torch.ops.fused_attn_block import fused_attn_block, fused_attn_block_reference
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.platform import resolve_device
from dinox_torch.utils.trace_analysis import device_ops

# The reference's training rate on an RTX 3090 Ti, slices/s: the JAX bench's
# vs_baseline divisor (bench.py:31, which cites the reference's
# docs/EXPERIMENTS.md).
BASELINE_SLICES_PER_S = 159.0
CHECK_SHAPES = ((8, 261, 384, 6), (2, 261, 1408, 16))
UNPACKED_SHAPE = (4, 6, 261, 64)  # (b, heads, n, hd)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bench_config(batch_size: int, gelu_approx: bool = True, fused_attn: bool = False,
                 fused_mlp: bool = False, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25) -> TrainConfig:
    return TrainConfig(
        model=MODEL_CONFIGS["vit-small"].replace(scale_aware=True, attn_impl="pallas",
                                                 gelu_approx=gelu_approx, fused_attn=fused_attn,
                                                 fused_mlp=fused_mlp, moe_experts=moe_experts,
                                                 moe_capacity_factor=moe_capacity_factor),
        batch_size=batch_size, koleo_weight=0.1, warmup_steps=100, max_steps=5000)


def bench_train_step(batch_size: int, steps: int = 20, warmup: int = 5, gelu_approx: bool = True,
                     fused_attn: bool = False, fused_mlp: bool = False, moe_experts: int = 0,
                     moe_capacity_factor: float = 1.25,
                     device: torch.device | str | None = None, profile: bool = False,
                     cfg: TrainConfig | None = None) -> dict[str, Any]:
    """Time *steps* training steps after *warmup*, on the card unless
    *device* is ``"cpu"``; *fused_attn*, *fused_mlp*, *moe_experts* and
    *moe_capacity_factor* set the model's switches (the fused MLP applies
    with exact GELU only); *cfg*, when given, is the config instead (its
    batch size must be *batch_size*). Returns
    ``slices_per_s``, ``step_ms`` and every
    step's ``losses``; with *profile*, one more step runs under
    ``torch.profiler`` and ``profile`` holds its device time, wall time and
    device time by kernel. Raises if a loss is not finite."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = bench_config(batch_size, gelu_approx, fused_attn, fused_mlp, moe_experts,
                           moe_capacity_factor)
    state = create_train_state(cfg, seed=0, device=dev)
    step_fn = build_train_step(cfg, device=dev)
    rng = np.random.default_rng(0)
    pixels = torch.as_tensor(rng.integers(25000, 41000, (1, batch_size, 512, 512, 3))
                             .astype(np.uint16), device=dev)
    spacing = torch.as_tensor(rng.uniform(0.4, 3.0, (1, batch_size, 3)).astype(np.float32),
                              device=dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = []
    for _ in range(warmup):
        state, metrics = step_fn(state, pixels, spacing)
        losses.append(metrics["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, pixels, spacing)
        losses.append(metrics["loss"])
    sync()
    dt = (time.perf_counter() - t0) / steps
    out: dict[str, Any] = {"slices_per_s": batch_size / dt, "step_ms": dt * 1e3}
    if profile:
        out["profile"] = _profile_step(step_fn, state, pixels, spacing, sync, losses, dev)
    out["losses"] = [float(v) for v in losses]
    if not np.isfinite(out["losses"]).all():
        raise FloatingPointError(f"bench produced a non-finite loss: {out['losses']}")
    return out


def _profile_step(step_fn, state, pixels, spacing, sync, losses, dev) -> dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pixels, spacing)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    losses.append(metrics["loss"])
    by_name = device_ops(prof)
    return {"wall_ms": wall_ms, "device_ms": sum(t for t, _, _ in by_name),
            "top": [{"name": k, "ms": t, "count": c} for t, c, k in by_name]}


def check_kernels(device: torch.device | str | None = None) -> bool:
    """The attention kernels against the plain versions on the card: for the
    packed pair, forward error and the error of the gradient of sum(out^2),
    which on the plain side is torch's autograd through the plain forward;
    for the head-major kernel, forward error; for the fused half-block, the
    error of y."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for b, n, dim, heads in CHECK_SHAPES:
        qkv = torch.randn((b, n, 3 * dim), generator=g, device=dev).to(torch.bfloat16)
        grads, outs = [], []
        for fn in (flash_attention_packed, packed_attention_reference):
            x = qkv.clone().requires_grad_(True)
            out = fn(x, heads)
            (out.float() ** 2).sum().backward()
            outs.append(out.detach().float())
            grads.append(x.grad.float())
        fwd_err = (outs[0] - outs[1]).abs().max().item()
        bwd_err = (grads[0] - grads[1]).abs().max().item()
        good = fwd_err < 0.02 and bwd_err < 0.25
        ok &= good
        print(f"# packed b={b} dim={dim} h={heads}: fwd_err={fwd_err:.3e} bwd_err={bwd_err:.3e} "
              f"{'OK' if good else 'FAIL'}", file=sys.stderr)
    q, k, v = (torch.randn(UNPACKED_SHAPE, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    f_err = (flash_attention(q, k, v).float() - mha_attention_reference(q, k, v).float()
             ).abs().max().item()
    good = f_err < 0.02
    ok &= good
    print(f"# unpacked fwd_err={f_err:.3e} {'OK' if good else 'FAIL'}", file=sys.stderr)
    fb_err = fused_block_error(dev)
    good = fb_err < 0.05
    ok &= good
    print(f"# fused half-block err={fb_err:.3e} {'OK' if good else 'FAIL'}", file=sys.stderr)
    return ok


def fused_block_inputs(b: int, n: int, dim: int, device: torch.device, seed: int = 0):
    """Inputs of the fused attention half-block at the JAX check's scales:
    x ~ 0.5 N(0, 1) in bf16, gamma ~ 1 + 0.1 N, beta ~ 0.1 N, weights ~ 0.05 N
    at dim 384 (cast to bf16, ``(out, in)`` layout), biases ~ 0.02 N, f32.
    At other widths the weights scale by sqrt(384 / dim), so qkv and y keep
    the check's magnitudes and one bf16 step stays below its tolerance."""
    rng = np.random.default_rng(seed)
    ws = 0.05 * (384 / dim) ** 0.5

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    return (t(rng.normal(size=(b, n, dim)) * 0.5, torch.bfloat16),
            t(1 + 0.1 * rng.normal(size=(dim,))), t(0.1 * rng.normal(size=(dim,))),
            t(rng.normal(size=(3 * dim, dim)) * ws, torch.bfloat16),
            t(0.02 * rng.normal(size=(3 * dim,))),
            t(rng.normal(size=(dim, dim)) * ws, torch.bfloat16),
            t(0.02 * rng.normal(size=(dim,))))


def fused_mlp_inputs(rows: int, c: int, device: torch.device, seed: int = 0
                     ) -> tuple[tuple, torch.Tensor]:
    """Arguments of the fused MLP (x, gamma, beta, w1, b1, w2, b2; hidden 4c,
    weights in the ``(out, in)`` layout) and an output gradient: x ~ 0.5 N,
    gamma ~ 1 + 0.1 N, beta and biases ~ 0.1 N, weights ~ N(0, 0.25 / fan_in)
    (so |y| stays below 4, where one bf16 step is below the forward's 0.02
    tolerance), dy ~ N(0, 1); bf16 rows and weights, f32 vectors."""
    hidden = 4 * c
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, std=1.0, mean=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=device) * std + mean).to(dtype)

    bf16 = torch.bfloat16
    args = (rn(rows, c, std=0.5, dtype=bf16), rn(c, std=0.1, mean=1.0), rn(c, std=0.1),
            rn(hidden, c, std=0.5 / c ** 0.5, dtype=bf16), rn(hidden, std=0.1),
            rn(c, hidden, std=0.5 / hidden ** 0.5, dtype=bf16), rn(c, std=0.1))
    return args, rn(rows, c, dtype=bf16)


def fused_block_error(device: torch.device, shape: tuple[int, int, int, int] = (8, 261, 384, 6)
                      ) -> float:
    """Largest error of the fused half-block's y against its plain version."""
    b, n, dim, heads = shape
    args = fused_block_inputs(b, n, dim, device)
    with torch.no_grad():
        got = fused_attn_block(*args, heads)
    want = fused_attn_block_reference(*args, heads)[0]
    return (got.float() - want.float()).abs().max().item()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device()
    card = torch.cuda.get_device_name(0)
    if "--check" in argv:
        ok = check_kernels()
        print(json.dumps({"metric": "kernel_check", "value": int(ok), "unit": "pass",
                          "card": card_line()}))
        return 0 if ok else 1
    peak = card_peaks(card)[0]
    mcfg = bench_config(96).model
    rates = {}
    for name, approx, fused, experts in (("exact", False, False, 0), ("tanh", True, False, 0),
                                         ("tanh+fused_attn", True, True, 0), ("moe4", True, False, 4)):
        res = bench_train_step(96, gelu_approx=approx, fused_attn=fused, moe_experts=experts)
        rates[name] = res["slices_per_s"]
        print(f"# gelu={name} batch=96: {rates[name]:.1f} slices/s, {res['step_ms']:.1f} ms/step",
              file=sys.stderr)
        torch.cuda.empty_cache()
    # The JAX bench's headline arm: the better dense tanh arm, never the MoE arm.
    best = max(rates["tanh"], rates["tanh+fused_attn"])
    print(json.dumps({
        "metric": "vit_s_pretrain_slices_per_sec", "value": best, "unit": "slices/s",
        "vs_baseline": best / BASELINE_SLICES_PER_S, "gelu": "tanh",
        "mfu": mfu(best, mcfg, peak),
        "exact_gelu_slices_per_sec": rates["exact"],
        "exact_gelu_mfu": mfu(rates["exact"], mcfg.replace(gelu_approx=False), peak),
        "fused_attn_slices_per_sec": rates["tanh+fused_attn"],
        "moe4_slices_per_sec": rates["moe4"],
        "moe4_mfu": mfu(rates["moe4"], bench_config(96, moe_experts=4).model, peak),
        "peak_flops": peak, "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
