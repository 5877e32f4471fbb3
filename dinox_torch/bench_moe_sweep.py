"""MoE efficiency sweep on one CUDA card: experts x capacity factors at a
fixed batch, with the MoE-aware MFU. The twin of the JAX package's
``scripts/bench_moe_sweep.py`` (its flags plus ``--device``).

Each point runs the real train step (student and teacher, DINO losses,
backward, AdamW, EMA) of the scale-aware tanh config on the bench's
synthetic batch (uint16 512^2 canvases from seed 0) and reports slices/s and the MFU of
``utils.flops`` (router, dispatch and combine einsums and the expert FFN
per MoE block) against the card's dense bf16 peak. A point that fails
fails the run: its error is raised, not folded into a status row.

    python -m dinox_torch.bench_moe_sweep --experts 4 8 --capacity-factors 1.0 1.25 2.0 \\
        --batch-size 96 [--out sweep.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.utils.flops import card_peaks, mfu, train_flops_per_slice
from dinox_torch.utils.platform import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experts", type=int, nargs="+", default=[4, 8])
    p.add_argument("--capacity-factors", type=float, nargs="+", default=[1.0, 1.25, 2.0])
    p.add_argument("--batch-size", type=int, default=96)
    p.add_argument("--moe-every", type=int, default=2)
    p.add_argument("--config", default="vit-small")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; or 'cpu')")
    return p.parse_args(argv)


def bench_point(config: str, batch_size: int, experts: int, cf: float, moe_every: int, steps: int,
                warmup: int, device: torch.device, peak_flops: float) -> dict:
    mcfg = MODEL_CONFIGS[config].replace(scale_aware=True, attn_impl="pallas", gelu_approx=True,
                                         moe_experts=experts, moe_every=moe_every,
                                         moe_capacity_factor=cf)
    cfg = TrainConfig(model=mcfg, batch_size=batch_size, koleo_weight=0.1, warmup_steps=100,
                      max_steps=5000)
    state = create_train_state(cfg, seed=0, device=device)
    step_fn = build_train_step(cfg, device=device)
    rng = np.random.default_rng(0)
    pixels = torch.as_tensor(rng.integers(25000, 41000, (1, batch_size, 512, 512, 3))
                             .astype(np.uint16), device=device)
    spacing = torch.as_tensor(rng.uniform(0.4, 3.0, (1, batch_size, 3)).astype(np.float32),
                              device=device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        state, metrics = step_fn(state, pixels, spacing)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, pixels, spacing)
    sync()
    dt = (time.perf_counter() - t0) / steps
    if not np.isfinite(float(metrics["loss"])):
        raise FloatingPointError(f"E{experts}/cf{cf}: non-finite loss {float(metrics['loss'])}")
    rate = batch_size / dt
    return {"experts": experts, "capacity_factor": cf, "batch_size": batch_size,
            "ms_per_step": dt * 1e3, "slices_per_s": rate, "mfu": mfu(rate, mcfg, peak_flops),
            "tflops_per_slice": train_flops_per_slice(mcfg) / 1e12}


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    peak = card_peaks(torch.cuda.get_device_name(dev))[0] if dev.type == "cuda" else float("nan")
    results = []
    for e in args.experts:
        for cf in args.capacity_factors:
            row = bench_point(args.config, args.batch_size, e, cf, args.moe_every, args.steps,
                              args.warmup, dev, peak)
            results.append(row)
            print(f"# E{e}/cf{cf}: {row['slices_per_s']:.1f} slices/s (mfu {row['mfu']:.4f}, "
                  f"{row['tflops_per_slice']:.4f} TF/slice)", file=sys.stderr, flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    best = max(results, key=lambda r: r["mfu"])
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"results": results, "best_mfu": best}, indent=2))
    print(json.dumps(best))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
