#!/usr/bin/env python3
"""On-card smoke test of dinox_torch's serving and training paths (one CUDA
card).

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel under dinox_torch/ops/csrc with nvcc.
3. Holds the packed attention forward kernel against its plain PyTorch
   version on the card at the shapes the serving path and the JAX package's
   kernel check use.
4. Makes a full-width ViT-S scale-aware backbone (bf16, seeded random
   weights), exports it as a hub dir, and serves it with dinox_torch.serve
   (EmbedService + HTTP on 127.0.0.1, buckets 1/8/32).
5. POSTs /embed requests of 512x512 HU slices (1, 8, 40 and 3x32 images),
   checks the answers (status, dim, finite unit-norm embeddings, CLS cosine
   >= 0.999 against the same weights with plain attention) and that every
   forward went through the kernel (launches == depth x forwards).
6. Holds the backward kernel pair (dq, dkv) against the plain backward at
   six shapes, the training shape and the ViT-G one included.
7. Runs one training micro-step of full ViT-S (bs 8) through the kernels
   and once with plain attention, from one state and the same views: the
   losses within 1e-2 relative, every gradient at cosine >= 0.99.
8. Trains: dinox_torch.bench.bench_train_step(96), 5 warm-up and 20 timed
   steps and one profiled step, every loss finite, and exact launch counts
   per step (forward 2 x depth, each backward kernel depth).
9. (Run right after 3.) Holds the fused attention half-block kernel (TPU
   kernel 6) against its plain version at five shapes (y, qkv and attn
   within 0.05), the fused MLP forward (kernel 7) at three within 0.02, and
   the fused MLP backward's three launches (kernel 8) at the same three
   within 2e-2 of each output's largest value, with equal bits on two runs.
10. Serves the same hub dir with EmbedService(fused_attn=True) and the same
   requests: CLS cosine >= 0.999 against the unfused service, kernel 6
   launches == depth x forwards, packed attention forward launches == 0.
11. Runs one micro-step of full ViT-S (bs 8, exact GELU) with fused_attn and
   fused_mlp through the kernels against the unfused exact-GELU model, from
   one state and the same views (loss within 1e-2 relative, gradient cosine
   >= 0.99), then trains that fused configuration at bs96 (3 warm-up, 10
   timed and one profiled step) with exact launch counts per step.
12. Times each kernel, its plain version, the PyTorch library call that
   computes the same function (none for kernels 6-8), the port's own unfused
   composition of each fused half-block, and its bound (kernel 1 at the
   serving shape, the rest at the training shape, kernel 6 at both), and
   prints them as one JSON line.

The last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero; without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from dinox_torch import serve
from dinox_torch.bench import bench_train_step, fused_block_inputs, fused_mlp_inputs
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.models.vit import Attention, LayerNorm, Mlp
from dinox_torch.ops import _build
from dinox_torch.ops import flash_attention as fa
from dinox_torch.ops import fused_attn_block as fab
from dinox_torch.ops import fused_mlp as fm
from dinox_torch.ops.augment import augment_views
from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import micro_loss_and_grads
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.roofline import (
    bound_ms,
    fused_attn_work,
    fused_mlp_bwd_work,
    fused_mlp_fwd_work,
)
from dinox_torch.zoo.encode import _preprocess
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint

SEED = 0
BUCKETS = [1, 8, 32]
TOL = 0.02  # bf16 forward tolerance of the JAX package's kernel check (bench.py --check)
# (b, n, 3*dim, heads): the kernel-check shapes (ViT-S, ViT-G hd 88), the
# serving bucket-32 shape, and the MAE decoder's hd 32.
CHECK_SHAPES = [(8, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16), (32, 261, 3 * 384, 6),
                (4, 261, 3 * 512, 16)]
SERVING_SHAPE = (32, 261, 3 * 384, 6)
# Backward gates: the JAX package's bwd tolerance (bench.py --check) and the
# error relative to the largest gradient.
BWD_TOL, BWD_REL = 0.25, 2e-2
# (b, n, 3*dim, heads): the check shape, the ViT-S training shape (2 x 96
# views), ViT-G (hd 88, TPU kernel 3's shape), hd 32, a short ragged N and
# an N past the TPU kernel's 1024.
BWD_SHAPES = [(8, 261, 3 * 384, 6), (192, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16),
              (4, 261, 3 * 512, 16), (3, 37, 3 * 384, 6), (2, 1100, 3 * 384, 6)]
TRAINING_SHAPE = (192, 261, 3 * 384, 6)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 96, 5, 20
VIT_G_SHAPE = (2, 261, 3 * 1408, 16)
# The fused half-blocks. Kernel 6's gate is the JAX package's (bench.py
# --check); (b, n, dim, heads): the check shape, the serving bucket 32, the
# training shape, ViT-G (hd 88) and hd 32.
FUSED_TOL = 0.05
FUSED_ATTN_SHAPES = [(8, 261, 384, 6), (32, 261, 384, 6), (192, 261, 384, 6),
                     (2, 261, 1408, 16), (4, 261, 512, 16)]
FUSED_SERVING_SHAPE, FUSED_TRAINING_SHAPE = FUSED_ATTN_SHAPES[1], FUSED_ATTN_SHAPES[2]
# Kernels 7 and 8: (rows, C) with hidden 4C: 8 and 192 views of ViT-S, and
# ViT-G width on 2 views.
MLP_TOL = 0.02
MLP_SHAPES = [(8 * 261, 384), (192 * 261, 384), (2 * 261, 1408)]
FUSED_WARMUP, FUSED_STEPS = 3, 10
# Device kernels grouped by what they do, by substrings of their names.
KERNEL_KINDS = [
    ("attention forward kernel", ("packed_attention_fwd",)),
    ("attention backward dq kernel", ("packed_attention_bwd_dq",)),
    ("attention backward dkv kernel", ("packed_attention_bwd_dkv",)),
    ("fused attention half-block kernel", ("fused_attn_block",)),
    ("fused MLP forward kernel", ("fused_mlp_fwd",)),
    ("fused MLP backward rows kernel", ("fused_mlp_bwd_rows",)),
    ("fused MLP backward weights kernel", ("fused_mlp_bwd_weights",)),
    ("fused MLP backward reduce kernel", ("fused_mlp_bwd_reduce",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer/EMA (multi-tensor)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("dtype casts", ("copy_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Each wrapper that launches a kernel, by the name its count goes under.
COUNTERS = {
    "packed_attention": fa.flash_attention_packed,
    "packed_attention_bwd_dq": fa.packed_attention_bwd_dq,
    "packed_attention_bwd_dkv": fa.packed_attention_bwd_dkv,
    "fused_attn_block": fab.fused_attn_block,
    "fused_mlp_fwd": fm.fused_mlp_forward,
    "fused_mlp_bwd_rows": fm.fused_mlp_bwd_rows,
    "fused_mlp_bwd_weights": fm.fused_mlp_bwd_weights,
    "fused_mlp_bwd_reduce": fm.fused_mlp_bwd_reduce,
}
MLP_BWD_PARTS = ("fused_mlp_bwd_rows", "fused_mlp_bwd_weights", "fused_mlp_bwd_reduce")


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def median_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median over *iters* single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernels() -> float:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for b, n, three_dim, heads in CHECK_SHAPES:
        qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
        got = flash_attention_packed(qkv, heads)
        torch.cuda.synchronize()
        err = (got.float() - packed_attention_reference(qkv, heads).float()).abs().max().item()
        print(f"kernel check packed_attention b={b} n={n} dim={three_dim // 3} heads={heads}: "
              f"max_abs_err={err:.3e} (tol {TOL})", flush=True)
        if not np.isfinite(err) or err >= TOL:
            fail(f"packed_attention disagrees with its plain version at {(b, n, three_dim, heads)}")
        worst = max(worst, err)
    return worst


def post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url + "/embed", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            fail(f"/embed answered {r.status}")
        return json.loads(r.read())


def check_embeddings(resp: dict, count: int, dim: int) -> np.ndarray:
    emb = np.asarray(resp["embeddings"], np.float32)
    if resp["dim"] != dim or emb.shape != (count, dim):
        fail(f"/embed returned shape {emb.shape}, dim {resp['dim']}; expected ({count}, {dim})")
    if not np.isfinite(emb).all():
        fail("non-finite embeddings")
    if np.abs(np.linalg.norm(emb, axis=1) - 1.0).max() > 1e-3:
        fail("embeddings are not unit-norm")
    return emb


def check_backward() -> tuple[float, float]:
    """The dq + dkv pair against the plain backward at BWD_SHAPES. Returns the
    worst error of the dq slots and of the dk/dv slots."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst_dq = worst_dkv = 0.0
    for b, n, three_dim, heads in BWD_SHAPES:
        dim = three_dim // 3
        qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
        do = torch.randn((b, n, dim), generator=g, device="cuda").to(torch.bfloat16)
        got = fa.packed_attention_backward(qkv, do, heads)
        torch.cuda.synchronize()
        want = fa.packed_attention_backward_reference(qkv, do, heads).float()
        diff = (got.float() - want).abs()
        err_dq, err_dkv = diff[..., :dim].max().item(), diff[..., dim:].max().item()
        err = max(err_dq, err_dkv)
        rel = err / want.abs().max().item()
        bit_equal = (got.float() == want).float().mean().item()
        print(f"kernel check packed_attention backward b={b} n={n} dim={dim} heads={heads}: "
              f"max_abs_err={err:.3e} (tol {BWD_TOL}; dq {err_dq:.3e}, dk/dv {err_dkv:.3e}), "
              f"max_abs_err/max|want|={rel:.3e} (tol {BWD_REL}), bit-equal {bit_equal:.5f}",
              flush=True)
        if not np.isfinite(err) or err >= BWD_TOL or rel >= BWD_REL:
            fail(f"the backward pair disagrees with its plain version at {(b, n, three_dim, heads)}")
        worst_dq, worst_dkv = max(worst_dq, err_dq), max(worst_dkv, err_dkv)
    return worst_dq, worst_dkv


def check_step(models: tuple, label: str) -> None:
    """One micro-step of full ViT-S scale-aware at bs 8 for each of the two
    model configs *models* (the one under test first), from one state (scale
    pathway made live) and the same views."""
    cfgs = [TrainConfig(model=m, batch_size=8, koleo_weight=0.1) for m in models]
    states = [create_train_state(cfg, seed=SEED) for cfg in cfgs]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    with torch.no_grad():  # a live scale pathway: the fresh output layer is zero
        states[0].student.backbone.scale_embed.mlp[2].weight.normal_(0.0, 0.02, generator=gen)
    weights = states[0].student.state_dict()
    for st in states:
        st.student.load_state_dict(weights)
        st.teacher.load_state_dict(weights)
    rng = np.random.default_rng(SEED + 4)
    pixels = torch.as_tensor(rng.integers(25000, 41000, (8, 512, 512, 3)).astype(np.uint16),
                             device="cuda")
    spacing = torch.as_tensor(rng.uniform(0.4, 3.0, (8, 3)).astype(np.float32), device="cuda")
    views = augment_views(pixels, torch.Generator().manual_seed(SEED), cfgs[0].aug)
    batch = views.reshape((-1,) + tuple(views.shape[2:]))
    (g_k, _, m_k), (g_p, _, m_p) = (micro_loss_and_grads(st, st.center, batch, spacing, cfg)
                                    for st, cfg in zip(states, cfgs))
    loss_k, loss_p = m_k["loss"].item(), m_p["loss"].item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    names = [n for n, _ in states[0].student.named_parameters()]
    cos, skipped = {}, []
    for name, a, b in zip(names, g_k, g_p):
        if not a.any() and not b.any():
            skipped.append(name)
            continue
        cos[name] = F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()
    worst = min(cos, key=cos.get)
    print(f"training micro-step, ViT-S scale-aware bs8, {label}: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, tol 1e-2); gradient cosine min "
          f"{cos[worst]:.6f} ({worst}) over {len(cos)} tensors, {len(skipped)} skipped as zero "
          f"in both {skipped}", flush=True)
    if not np.isfinite(loss_k) or rel > 1e-2 or cos[worst] < 0.99:
        fail(f"the training step ({label}) disagrees")


def report_training(res: dict, cfg, card: str, steps: int) -> None:
    """Rate, MFU, busy share and device time by kind of a bench_train_step
    result with a profile."""
    peak = card_peaks(card)[0]
    print(f"training rate: {res['slices_per_s']:.2f} slices/s ({res['step_ms']:.2f} ms per step "
          f"of {TRAIN_BATCH} slices, host clock over {steps} steps); MFU "
          f"{mfu(res['slices_per_s'], cfg, peak):.4f} against {peak / 1e12:.0f} TFLOP/s bf16",
          flush=True)
    prof = res["profile"]
    print(f"one profiled step: device time {prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
          f"wall = {100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy (torch.profiler); top "
          f"items:", flush=True)
    for item in prof["top"][:8]:
        print(f"  {item['ms']:8.3f} ms  x{item['count']:<4d} {item['name'][:90]}", flush=True)
    by_kind: dict[str, list] = {}
    for item in prof["top"]:
        kind = next((k for k, keys in KERNEL_KINDS if any(w in item["name"] for w in keys)), "other")
        acc = by_kind.setdefault(kind, [0.0, 0])
        acc[0] += item["ms"]
        acc[1] += item["count"]
    print("  by kind: " + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in
                                    sorted(by_kind.items(), key=lambda kv: -kv[1][0])), flush=True)


def train(card: str) -> dict[str, int]:
    """The training path at full width: bench_train_step(96), tanh arm, with
    exact launch counts. Returns the counts of this run."""
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, profile=True)
    counts = launch_counts()
    steps = TRAIN_WARMUP + TRAIN_STEPS + 1
    want = dict.fromkeys(COUNTERS, 0)
    want.update(packed_attention=steps * 2 * cfg.depth, packed_attention_bwd_dq=steps * cfg.depth,
                packed_attention_bwd_dkv=steps * cfg.depth)
    print(f"trained {steps} steps of ViT-S scale-aware bs{TRAIN_BATCH}: losses "
          f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, all finite; launches {counts} "
          f"(want {want}: forward 2 x depth, each backward kernel depth, per step)", flush=True)
    if counts != want:
        fail("the training step did not run every attention through the kernels exactly once")
    report_training(res, cfg, card, TRAIN_STEPS)
    return counts


def train_fused(card: str) -> dict[str, int]:
    """The fused half-block configuration at full width: ViT-S scale-aware
    bs96, exact GELU, fused_attn and fused_mlp, with exact launch counts per
    step. Returns the counts of this run."""
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, gelu_approx=False,
                                             fused_attn=True, fused_mlp=True)
    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=FUSED_STEPS, warmup=FUSED_WARMUP, gelu_approx=False,
                           fused_attn=True, fused_mlp=True, profile=True)
    counts = launch_counts()
    steps = FUSED_WARMUP + FUSED_STEPS + 1
    d = cfg.depth
    want = dict.fromkeys(COUNTERS, 0)
    want.update(fused_attn_block=steps * 2 * d, fused_mlp_fwd=steps * 2 * d,
                packed_attention_bwd_dq=steps * d, packed_attention_bwd_dkv=steps * d,
                **{part: steps * d for part in MLP_BWD_PARTS})
    print(f"trained {steps} steps of ViT-S scale-aware bs{TRAIN_BATCH}, exact GELU, fused_attn + "
          f"fused_mlp: losses {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, all finite; "
          f"launches {counts} (want {want}: kernels 6 and 7 2 x depth, each of kernel 8's three "
          f"and dq/dkv depth, packed forward 0, per step)", flush=True)
    if counts != want:
        fail("the fused training step did not run every half-block through the kernels exactly once")
    report_training(res, cfg, card, FUSED_STEPS)
    return counts


def time_forward(peaks: tuple[float, float], shape: tuple[int, int, int, int]) -> None:
    """Prints the forward kernel's time, its plain version's, the library
    call's and its bound at *shape* (beside the serving-shape entry)."""
    b, n, three_dim, heads = shape
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    kern_ms = median_ms(lambda: flash_attention_packed(qkv, heads))
    plain_ms = median_ms(lambda: packed_attention_reference(qkv, heads), iters=10)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    moved = (qkv.numel() + b * n * dim) * qkv.element_size()
    t, by = bound_ms(moved, 4.0 * b * heads * n * n * hd, peaks)
    print(f"packed_attention forward at {shape}: {kern_ms:.4f} ms, bound {t:.4f} ms ({by}: "
          f"{moved / 1e6:.1f} MB), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms", flush=True)


def time_backward(peaks: tuple[float, float], shape: tuple[int, int, int, int] = TRAINING_SHAPE
                  ) -> dict[str, dict]:
    """Times of the pair, each kernel, the plain backward and the library
    backward at *shape*, with their bounds."""
    b, n, three_dim, heads = shape
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, dim), generator=g, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b * heads, 3, n), dtype=torch.float32, device="cuda")
    fa.packed_attention_bwd_dq(qkv, do, heads, dqkv, stats)
    dq_ms = median_ms(lambda: fa.packed_attention_bwd_dq(qkv, do, heads, dqkv, stats))
    dkv_ms = median_ms(lambda: fa.packed_attention_bwd_dkv(qkv, do, heads, stats, dqkv))
    pair_ms = median_ms(lambda: fa.packed_attention_backward(qkv, do, heads))
    plain_ms = median_ms(lambda: fa.packed_attention_backward_reference(qkv, do, heads), iters=10)
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0))
    out = F.scaled_dot_product_attention(q, k, v)
    go = do.view(b, n, heads, hd).transpose(1, 2)
    lib_ms = median_ms(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True))
    nbytes = qkv.element_size()
    stats_bytes = stats.numel() * stats.element_size()
    flops = 2.0 * b * heads * n * n * hd  # one (n, n, hd) product
    pair_bound = bound_ms((qkv.numel() + do.numel() + dqkv.numel()) * nbytes, 5 * flops, peaks)
    # dkv alone: reads qkv, dO and the statistics, writes the dk and dv slots;
    # S^T, dP^T, dV and dK.
    dkv_bound = bound_ms((qkv.numel() + do.numel() + 2 * b * n * dim) * nbytes + stats_bytes,
                      4 * flops, peaks)
    print(f"packed attention backward at {shape}: pair {pair_ms:.4f} ms (dq {dq_ms:.4f} "
          f"+ dkv {dkv_ms:.4f}), bound {pair_bound[0]:.4f} ms ({pair_bound[1]}: "
          f"{(qkv.numel() + do.numel() + dqkv.numel()) * nbytes / 1e6:.1f} MB, "
          f"{5 * flops / 1e9:.2f} GFLOP); plain {plain_ms:.4f} ms; "
          f"SDPA backward {lib_ms:.4f} ms; dkv alone bound {dkv_bound[0]:.4f} ms", flush=True)
    return {"dq": {"ms": pair_ms, "plain_ms": plain_ms, "bound": pair_bound, "library_ms": lib_ms},
            "dkv": {"ms": dkv_ms, "plain_ms": plain_ms, "bound": dkv_bound, "library_ms": lib_ms}}


def check_fused_attn() -> float:
    """Kernel 6 against its plain version at FUSED_ATTN_SHAPES, all three
    outputs (y, qkv, attn), inputs at the JAX check's scales. Returns the
    worst error."""
    worst = 0.0
    for i, (b, n, dim, heads) in enumerate(FUSED_ATTN_SHAPES):
        args = fused_block_inputs(b, n, dim, torch.device("cuda"), seed=SEED + 10 + i)
        got = fab.fused_attn_block_forward(*args, heads)
        torch.cuda.synchronize()
        want = fab.fused_attn_block_reference(*args, heads)
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        print(f"kernel check fused_attn_block b={b} n={n} dim={dim} heads={heads}: max_abs_err "
              f"y {errs[0]:.3e}, qkv {errs[1]:.3e}, attn {errs[2]:.3e} (tol {FUSED_TOL})",
              flush=True)
        if not np.isfinite(errs).all() or max(errs) >= FUSED_TOL:
            fail(f"fused_attn_block disagrees with its plain version at {(b, n, dim, heads)}")
        worst = max(worst, *errs)
    return worst


def check_fused_mlp() -> tuple[float, float]:
    """Kernel 7 against the plain forward and kernel 8's three launches
    against the plain backward at MLP_SHAPES; the backward twice, for equal
    bits. Returns the worst forward error and the worst backward error."""
    worst_f = worst_b = 0.0
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for i, (rows, c) in enumerate(MLP_SHAPES):
        args, dy = fused_mlp_inputs(rows, c, torch.device("cuda"), SEED + 20 + i)
        got = fm.fused_mlp_forward(*args)
        torch.cuda.synchronize()
        err = (got.float() - fm.fused_mlp_forward_reference(*args).float()).abs().max().item()
        runs = [fm.fused_mlp_backward(*args[:6], dy) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        want = fm.fused_mlp_backward_reference(*args[:6], dy)
        abs_errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(runs[0], want)]
        rels = [e / w.float().abs().max().item() for e, w in zip(abs_errs, want)]
        worst_rel = int(np.argmax(rels))
        print(f"kernel check fused_mlp rows={rows} C={c} hidden={4 * c}: forward max_abs_err "
              f"{err:.3e} (tol {MLP_TOL}); backward max_abs_err/max|want| worst "
              f"{rels[worst_rel]:.3e} ({names[worst_rel]}; tol {BWD_REL}), max_abs_err "
              f"{max(abs_errs):.3e}; two runs bit-equal: {same}", flush=True)
        if not np.isfinite(err) or err >= MLP_TOL:
            fail(f"fused_mlp forward disagrees with its plain version at {(rows, c)}")
        if not np.isfinite(rels).all() or max(rels) >= BWD_REL or not same:
            fail(f"fused_mlp backward disagrees with its plain version at {(rows, c)}")
        worst_f, worst_b = max(worst_f, err), max(worst_b, *abs_errs)
    return worst_f, worst_b


def time_fused(peaks: tuple[float, float]) -> dict[str, dict]:
    """Times of kernels 6, 7 and 8, each beside its plain version, its bound
    and the port's own unfused composition of the same half-block (LayerNorm,
    Linear layers, kernel 1 or GELU, residual; for kernel 8 autograd through
    it). Kernel 6 at the training and serving shapes, 7 and 8 at the
    training rows."""
    out: dict[str, dict] = {}
    dev = torch.device("cuda")
    for label, (b, n, dim, heads) in (("training", FUSED_TRAINING_SHAPE),
                                      ("serving", FUSED_SERVING_SHAPE)):
        args = fused_block_inputs(b, n, dim, dev, seed=SEED + 30)
        norm, attn = LayerNorm(dim, torch.bfloat16).to(dev), Attention(dim, heads, "pallas").to(dev)
        with torch.no_grad():
            for p, v in zip((norm.weight, norm.bias, attn.qkv.weight, attn.qkv.bias,
                             attn.proj.weight, attn.proj.bias), args[1:]):
                p.copy_(v.float())
            kern = median_ms(lambda: fab.fused_attn_block_forward(*args, heads))
            plain = median_ms(lambda: fab.fused_attn_block_reference(*args, heads), iters=10)
            unfused = median_ms(lambda: args[0] + attn(norm(args[0])))
        moved, flops = fused_attn_work(b, n, dim, heads)
        bound = bound_ms(moved, flops, peaks)
        print(f"fused_attn_block at {(b, n, dim, heads)} ({label}): {kern:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}: {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB), plain "
              f"{plain:.4f} ms, unfused composition {unfused:.4f} ms", flush=True)
        out[f"attn_{label}"] = {"ms": kern, "plain_ms": plain, "unfused_ms": unfused, "bound": bound,
                                "shape": [b, n, dim, heads]}
    # Kernel 6's composed backward at the training shape (plain products around
    # the dq/dkv pair), and its three products with an f32 result from bf16
    # operands (dwproj, dwqkv, dln) through torch.mm(out_dtype=float32).
    b, n, dim, heads = FUSED_TRAINING_SHAPE
    leaves = [a.detach().requires_grad_(True) for a in fused_block_inputs(b, n, dim, dev, SEED + 32)]
    y = fab.fused_attn_block(*leaves, heads)
    dy = torch.randn_like(y)
    bwd = median_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), iters=10)
    flat = [t.detach().reshape(-1, t.shape[-1]) for t in (dy, y, leaves[0])]
    qkv = torch.randn((b * n, 3 * dim), device=dev).to(torch.bfloat16)
    f32 = torch.float32
    mm = median_ms(lambda: (torch.mm(flat[0].t(), flat[1], out_dtype=f32),
                            torch.mm(qkv.t(), flat[2], out_dtype=f32),
                            torch.mm(qkv, leaves[3].detach(), out_dtype=f32)))
    print(f"fused_attn_block backward (composed) at {FUSED_TRAINING_SHAPE}: {bwd:.4f} ms, of which "
          f"the three f32-result products (torch.mm(out_dtype=float32)) {mm:.4f} ms", flush=True)
    out["attn_training"].update(backward_ms=bwd, f32_products_ms=mm)

    rows, c = MLP_SHAPES[1]
    hidden = 4 * c
    args, dy = fused_mlp_inputs(rows, c, dev, SEED + 31)
    norm, mlp = LayerNorm(c, torch.bfloat16).to(dev), Mlp(c, hidden, gelu_approx=False).to(dev)
    with torch.no_grad():
        for p, v in zip((norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                         mlp.fc2.bias), args[1:]):
            p.copy_(v.float())
        kern = median_ms(lambda: fm.fused_mlp_forward(*args))
        plain = median_ms(lambda: fm.fused_mlp_forward_reference(*args), iters=10)
        unfused = median_ms(lambda: args[0] + mlp(norm(args[0])))
    moved, flops = fused_mlp_fwd_work(rows, c, hidden)
    bound = bound_ms(moved, flops, peaks)
    print(f"fused_mlp forward at ({rows}, {c}, {hidden}): {kern:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}: {flops / 1e9:.2f} GFLOP), plain {plain:.4f} ms, unfused composition "
          f"{unfused:.4f} ms", flush=True)
    out["mlp_fwd"] = {"ms": kern, "plain_ms": plain, "unfused_ms": unfused, "bound": bound}

    total = median_ms(lambda: fm.fused_mlp_backward(*args[:6], dy))
    # Each of the three launches alone, on the workspace of one backward.
    blocks = -(-rows // fm.row_block(c))
    chunks = min(fm.WEIGHT_CHUNKS, blocks)
    ws = dict(dx=torch.empty_like(args[0]), lnb=torch.empty_like(args[0]),
              ab=torch.empty((rows, hidden), dtype=torch.bfloat16, device=dev),
              dhb=torch.empty((rows, hidden), dtype=torch.bfloat16, device=dev),
              part=torch.empty((blocks, 3 * c + hidden), device=dev),
              wpart=torch.empty((chunks, 2 * c * hidden), device=dev),
              out=torch.empty(2 * c * hidden + 3 * c + hidden, device=dev))
    parts = {
        "fused_mlp_bwd_rows": median_ms(lambda: fm.fused_mlp_bwd_rows(
            *args[:6], dy, ws["dx"], ws["lnb"], ws["ab"], ws["dhb"], ws["part"])),
        "fused_mlp_bwd_weights": median_ms(lambda: fm.fused_mlp_bwd_weights(
            dy, ws["ab"], ws["dhb"], ws["lnb"], ws["wpart"], chunks)),
        "fused_mlp_bwd_reduce": median_ms(lambda: fm.fused_mlp_bwd_reduce(
            ws["wpart"], ws["part"], ws["out"], c, hidden, chunks)),
    }
    plain = median_ms(lambda: fm.fused_mlp_backward_reference(*args[:6], dy), iters=5, warmup=2)
    xr = args[0].detach().requires_grad_(True)
    params = [xr] + list(norm.parameters()) + list(mlp.parameters())
    y = xr + mlp(norm(xr))
    unfused = median_ms(lambda: torch.autograd.grad(y, params, dy, retain_graph=True))
    moved, flops = fused_mlp_bwd_work(rows, c, hidden)
    bound = bound_ms(moved, flops, peaks)
    print(f"fused_mlp backward at ({rows}, {c}, {hidden}): {total:.4f} ms for three launches ("
          + ", ".join(f"{k.rsplit('_', 1)[1]} {v:.4f}" for k, v in parts.items())
          + f"), bound {bound[0]:.4f} ms ({bound[1]}: {flops / 1e9:.2f} GFLOP), plain "
          f"{plain:.4f} ms, unfused composition (autograd) {unfused:.4f} ms", flush=True)
    out["mlp_bwd"] = {"ms": total, "plain_ms": plain, "unfused_ms": unfused, "bound": bound,
                      "parts": parts}
    return out


def serve_fused(service, reqs: dict, timed: list, served: dict, depth: int) -> None:
    """The same hub dir and requests through *service*, an
    EmbedService(fused_attn=True): CLS cosine against the unfused service's
    answers, exact launch counts."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        service.warmup()
        reset_launch_counts()
        forwards0 = service.stats["forwards"]
        cos = []
        for n, (_, _, body) in reqs.items():
            got = check_embeddings(post(url, body), n, 384)
            cos.append(np.sum(got * served[n], axis=1).min())
        t0 = time.perf_counter()
        for (_, _, body), want in zip(timed, served["timed"]):
            got = check_embeddings(post(url, body), 32, 384)
            cos.append(np.sum(got * want, axis=1).min())
        served_s = time.perf_counter() - t0
        counts = launch_counts()
        forwards = service.stats["forwards"] - forwards0
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    print(f"fused serving (EmbedService(fused_attn=True)): {forwards} forwards; launches "
          f"fused_attn_block {counts['fused_attn_block']} (depth x forwards = {depth * forwards}), "
          f"packed_attention {counts['packed_attention']} (want 0); CLS cosine against the "
          f"unfused service min {min(cos):.6f}; served img/s at bucket 32: {96 / served_s:.2f}",
          flush=True)
    if forwards != 7 or counts["fused_attn_block"] != depth * forwards or counts["packed_attention"]:
        fail("the fused serving path did not run every block through kernel 6 exactly once")
    if min(cos) < 0.999:
        fail("the fused service's embeddings disagree with the unfused service's")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    card = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card {card}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    max_err = check_kernels()
    fused_attn_err = check_fused_attn()
    mlp_err = check_fused_mlp()

    # -- the serving path ----------------------------------------------------
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    gen = torch.Generator().manual_seed(SEED)
    model = LoadedModel(cfg, "cpu", generator=gen)
    with torch.no_grad():  # a live scale pathway: the fresh output layer is zero
        model.scale_embed.mlp[2].weight.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        export_hub_checkpoint(model, tmp, use_safetensors=True)
        service = serve.EmbedService(tmp, BUCKETS, device="cuda")
        fused_service = serve.EmbedService(tmp, BUCKETS, device="cuda", fused_attn=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        service.warmup()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health["model"] != {"dim": 384, "img_size": 224, "scale_aware": True}:
            fail(f"unexpected /healthz model {health['model']}")

        def request(count: int) -> tuple[list, list, bytes]:
            imgs = rng.integers(-1000, 1500, size=(count, 512, 512)).astype(np.float32)
            sps = rng.uniform(0.5, 3.0, size=(count, 3)).round(3).tolist()
            body = json.dumps({"images": imgs.astype(np.int32).tolist(), "spacings": sps}).encode()
            return imgs, sps, body

        reqs = {n: request(n) for n in (1, 8, 40)}
        timed = [request(32) for _ in range(3)]

        reset_launch_counts()
        forwards0 = service.stats["forwards"]
        served = {n: check_embeddings(post(url, body), n, 384) for n, (_, _, body) in reqs.items()}
        t0 = time.perf_counter()
        embed_ms = 0.0  # the server's own time in EmbedService.embed
        served["timed"] = []
        for _, _, body in timed:
            resp = post(url, body)
            served["timed"].append(check_embeddings(resp, 32, 384))
            embed_ms += resp["latency_ms"]
        served_s = time.perf_counter() - t0
        launches = flash_attention_packed.launches
        forwards = service.stats["forwards"] - forwards0

        expected = cfg.depth * forwards
        print(f"served {sum(reqs) + 96} images in {forwards} forwards; packed_attention "
              f"launches {launches} (depth x forwards = {expected})", flush=True)
        if forwards != 1 + 1 + 2 + 3 or launches != expected:
            fail("the serving path did not run every block's attention through the kernel")
        print(f"served img/s at bucket 32 (HTTP+JSON+preprocess+forward, 3 requests of 32 "
              f"512x512 slices): {96 / served_s:.2f}", flush=True)
        pre = []
        for im in timed[0][0][:10]:
            t1 = time.perf_counter()
            _preprocess(im, 224, "hu_float", 40.0, 400.0)
            pre.append(time.perf_counter() - t1)
        pre_ms = float(np.median(pre)) * 1e3
        trip_ms = served_s / 3 * 1e3
        print(f"bucket-32 request: round trip {trip_ms:.1f} ms; inside EmbedService.embed "
              f"{embed_ms / 3:.1f} ms, of which preprocessing ~{32 * pre_ms:.1f} ms "
              f"({pre_ms:.2f} ms per 512x512 slice, host clock); HTTP+JSON outside it "
              f"{trip_ms - embed_ms / 3:.1f} ms", flush=True)

        # Same weights, plain attention, on the card: CLS cosine of the 8-image request.
        imgs, sps, _ = reqs[8]
        ref = LoadedModel(cfg.replace(attn_impl="xla"), "cuda")
        ref.load_state_dict(service.model.state_dict())
        xs = np.stack([_preprocess(im, 224, "hu_float", 40.0, 400.0) for im in imgs])
        cls = ref(xs, np.asarray(sps, np.float32))[:, 0, :]
        want = (cls / cls.norm(dim=-1, keepdim=True)).cpu().numpy()
        cos = np.sum(want * served[8], axis=1)
        print(f"served vs plain-attention CLS cosine: min {cos.min():.6f}", flush=True)
        if cos.min() < 0.999:
            fail("served embeddings disagree with the plain-attention model")

        # Device forward at bucket 32 and the attention share of it.
        x32 = np.stack([_preprocess(im, 224, "hu_float", 40.0, 400.0) for im in timed[0][0]])
        sp32 = np.asarray(timed[0][1], np.float32)
        xt = torch.as_tensor(x32, device="cuda")
        st = torch.as_tensor(sp32, device="cuda")
        fwd_ms = median_ms(lambda: service.model(xt, st), iters=20, warmup=3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            service.model(xt, st)
            torch.cuda.synchronize()
        by_name = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                          if e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(t for t, _, _ in by_name) / 1e3
        print(f"bs32 forward device time (torch.profiler, one forward): {busy_ms:.3f} ms of "
              f"{fwd_ms:.3f} ms wall = {100 * busy_ms / fwd_ms:.1f}% busy; top items:", flush=True)
        for t, count, key in by_name[:8]:
            print(f"  {t / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    serve_fused(fused_service, reqs, timed, served, cfg.depth)

    # -- kernel timing at the serving shape ----------------------------------
    b, n, three_dim, heads = SERVING_SHAPE
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    kern_ms = median_ms(lambda: flash_attention_packed(qkv, heads))
    plain_ms = median_ms(lambda: packed_attention_reference(qkv, heads))
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    peaks = card_peaks(card)
    moved = (qkv.numel() + b * n * dim) * qkv.element_size()
    flops = 4 * b * heads * n * n * hd
    fwd_bound = bound_ms(moved, flops, peaks)
    print(f"ViT-S bs32 forward on the card: {fwd_ms:.3f} ms ({32 / fwd_ms * 1e3:.1f} img/s); "
          f"attention {cfg.depth} x {kern_ms:.4f} ms = {100 * cfg.depth * kern_ms / fwd_ms:.1f}%",
          flush=True)
    print(f"packed_attention at {SERVING_SHAPE}: {moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP",
          flush=True)
    time_forward(peaks, TRAINING_SHAPE)

    # -- the training path ---------------------------------------------------
    bwd_err = check_backward()
    vit_s = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    check_step((vit_s, vit_s.replace(attn_impl="xla")), "kernels vs plain attention")
    train_counts = train(card)
    bwd = time_backward(peaks)
    time_backward(peaks, VIT_G_SHAPE)  # TPU kernel 3's shape

    # -- the fused half-block training path ----------------------------------
    exact = vit_s.replace(gelu_approx=False)
    check_step((exact.replace(fused_attn=True, fused_mlp=True), exact),
               "fused half-blocks (kernels 6-8) vs unfused, exact GELU")
    fused_counts = train_fused(card)
    fused = time_fused(peaks)

    kernels = [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/packed_attention.cu",
        "replaces": "dinox_tpu/ops/flash_attention.py:200",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound[0],
        "bound_by": fwd_bound[1],
        "library_ms": lib_ms,
    }]
    # The pair replaces kernel 2 (_packed_bwd_kernel) and kernel 3 (the split
    # dq/dkv kernels); the dq entry carries the pair's time and bound.
    for part, err, replaces in (("dq", bwd_err[0], "dinox_tpu/ops/flash_attention.py:222"),
                                ("dkv", bwd_err[1], "dinox_tpu/ops/flash_attention.py:339")):
        name = f"packed_attention_bwd_{part}"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dinox_torch/ops/csrc/packed_attention_bwd.cu",
            "replaces": replaces,
            "launches": train_counts[name],
            "max_abs_err": err,
            "ms": bwd[part]["ms"],
            "plain_ms": bwd[part]["plain_ms"],
            "bound_ms": bwd[part]["bound"][0],
            "bound_by": bwd[part]["bound"][1],
            "library_ms": bwd[part]["library_ms"],
        })
    fused_entries = (
        ("fused_attn_block", "fused_attn_block.cu", "fused_attn_block.py:46", fused_attn_err,
         fused["attn_training"], fused_counts["fused_attn_block"]),
        ("fused_mlp_fwd", "fused_mlp.cu", "fused_mlp.py:65", mlp_err[0], fused["mlp_fwd"],
         fused_counts["fused_mlp_fwd"]),
        ("fused_mlp_bwd", "fused_mlp_bwd.cu", "fused_mlp.py:76", mlp_err[1], fused["mlp_bwd"],
         min(fused_counts[p] for p in MLP_BWD_PARTS)),
    )
    for name, src, replaces, err, t, count in fused_entries:
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"dinox_torch/ops/csrc/{src}",
            "replaces": f"dinox_tpu/ops/{replaces}",
            "launches": count,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": None,  # no single PyTorch call computes the fused half-block
            "unfused_ms": t["unfused_ms"],
        }
        if name == "fused_attn_block":
            serving = fused["attn_serving"]
            entry["serving"] = {"shape": serving["shape"], "ms": serving["ms"],
                                "bound_ms": serving["bound"][0], "unfused_ms": serving["unfused_ms"]}
            entry["backward_ms"] = t["backward_ms"]  # composed, not a kernel of this entry
        if name == "fused_mlp_bwd":  # three launches: ms is their sum, parts each one's
            entry["parts"] = {p: {"launches": fused_counts[p], "ms": t["parts"][p]}
                              for p in MLP_BWD_PARTS}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
