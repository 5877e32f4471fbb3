"""ViT-Large / ViT-Giant train-step benchmark on one CUDA card: the twin of
the JAX package's ``scripts/bench_scale.py`` (its flags plus
``--factored-nu``, the pretraining CLI's flag, and ``--device``).

The real train step (student and teacher, DINO + Gram + KoLeo 0.1,
backward, the optimizer, EMA) of the scale-aware preset with
``use_grad_checkpoint``, on synthetic uint16 512^2 canvases from seed 0;
warm-up steps, then timed steps. The last line is the JAX script's JSON
(``img/s``, ``vs_baseline`` against the reference's published rate, step
ms, MFU against the card's dense bf16 peak, loss); the line before it gives
``torch.cuda.max_memory_allocated`` over the run and the optimizer state's
bytes. ``--mu-dtype``/``--nu-dtype bfloat16`` and ``--factored-nu`` pick
the optimizer-memory options of ``train.optim``.

    python -m dinox_torch.bench_scale [--config vit-giant] [--batch-size 32] [--steps 10]
        [--mu-dtype bfloat16 --nu-dtype bfloat16 | --factored-nu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Iterable

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.train.state import TrainConfig, TrainState, create_train_state, make_optimizer
from dinox_torch.train.step import build_train_step
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.platform import resolve_device

# The reference's published rates (img/s): ViT-L at bs64 x accum4 with
# gradient checkpointing, ViT-G at bs32 x accum8 (the JAX script's table).
REFERENCE_IMG_S = {"vit-large": 23.5, "vit-giant": 5.4}
# Optimizer kinds: (label, mu_dtype, nu_dtype, factored_nu).
KINDS = {"f32": ("float32", "float32", False), "bf16": ("bfloat16", "bfloat16", False),
         "factored": ("float32", "float32", True), "bf16+factored": ("bfloat16", "float32", True)}


def scale_config(config: str, batch_size: int, accum: int = 1, img_size: int = 224,
                 mu_dtype: str = "float32", nu_dtype: str = "float32", factored_nu: bool = False,
                 attn_impl: str = "pallas") -> TrainConfig:
    return TrainConfig(
        model=MODEL_CONFIGS[config].replace(scale_aware=True, attn_impl=attn_impl,
                                            use_grad_checkpoint=True),
        img_size=img_size, batch_size=batch_size, accumulation_steps=accum, koleo_weight=0.1,
        warmup_steps=100, max_steps=5000, mu_dtype=mu_dtype, nu_dtype=nu_dtype,
        factored_nu=factored_nu)


def optimizer_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer's state tensors on the card."""
    return sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.is_cuda)


def synthetic_batch(cfg: TrainConfig, canvas: int, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(0)
    shape = (cfg.accumulation_steps, cfg.batch_size)
    pixels = rng.integers(25000, 41000, shape + (canvas, canvas, 3)).astype(np.uint16)
    spacing = rng.uniform(0.4, 3.0, shape + (3,)).astype(np.float32)
    return torch.as_tensor(pixels, device=device), torch.as_tensor(spacing, device=device)


def measure(cfg: TrainConfig, state: TrainState, pixels: torch.Tensor, spacing: torch.Tensor,
            steps: int, warmup: int, device: torch.device) -> dict[str, Any]:
    """*warmup* then *steps* timed steps of *state* under *cfg*. Returns
    step_ms, img_s, the last loss, the peak allocated bytes over the run and
    the optimizer state's bytes."""
    step_fn = build_train_step(cfg, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(warmup):
        state, metrics = step_fn(state, pixels, spacing)
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, pixels, spacing)
    if cuda:
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / steps
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    return {"step_ms": dt * 1e3, "img_s": cfg.effective_batch_size / dt, "loss": loss,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else 0,
            "optimizer_bytes": optimizer_bytes(state.optimizer)}


def report(config: str, cfg: TrainConfig, res: dict[str, Any], peak_flops: float) -> dict:
    """The JAX script's JSON line for a :func:`measure` result."""
    return {
        "metric": f"{config.replace('-', '_')}_pretrain_img_per_sec",
        "value": res["img_s"], "unit": "img/s",
        "vs_baseline": res["img_s"] / REFERENCE_IMG_S[config],
        "step_ms": res["step_ms"],
        "mfu": mfu(res["img_s"], cfg.model.replace(img_size=cfg.img_size), peak_flops),
        "loss": res["loss"],
    }


def run_kinds(config: str, batch_size: int, kinds: Iterable[str], steps: int = 10, warmup: int = 3,
              device: torch.device | str | None = None, canvas: int = 512, accum: int = 1,
              img_size: int = 224) -> list[tuple[str, TrainConfig, dict[str, Any]]]:
    """One model of *config*, measured under each optimizer kind of *kinds*
    (keys of ``KINDS``) in turn: the optimizer (and its state) is made
    anew for each kind. Returns (kind, config, result) for each."""
    dev = resolve_device(device)
    out = []
    state = None
    for kind in kinds:
        mu, nu, factored = KINDS[kind]
        cfg = scale_config(config, batch_size, accum, img_size, mu, nu, factored)
        if state is None:
            state = create_train_state(cfg, seed=0, device=dev)
            pixels, spacing = synthetic_batch(cfg, canvas, dev)
        else:
            state.optimizer.state.clear()
            state.optimizer = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            state.optimizer = make_optimizer(cfg, state.student)
        out.append((kind, cfg, measure(cfg, state, pixels, spacing, steps, warmup, dev)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="vit-large", choices=["vit-large", "vit-giant"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--mu-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--nu-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--factored-nu", action="store_true")
    p.add_argument("--attn-impl", default="pallas", choices=["pallas", "xla"])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; or 'cpu')")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = scale_config(args.config, args.batch_size, args.accum, args.img_size, args.mu_dtype,
                       args.nu_dtype, args.factored_nu, args.attn_impl)
    print(f"{args.config}: ~{cfg.model.params_millions:.0f}M params, bs={args.batch_size}x{args.accum}, "
          f"remat=on, mu_dtype={args.mu_dtype}, nu_dtype={args.nu_dtype}, "
          f"factored_nu={args.factored_nu}", flush=True)
    state = create_train_state(cfg, seed=0, device=dev)
    pixels, spacing = synthetic_batch(cfg, args.canvas, dev)
    res = measure(cfg, state, pixels, spacing, args.steps, args.warmup, dev)
    peak = card_peaks(torch.cuda.get_device_name(dev))[0] if dev.type == "cuda" else float("nan")
    print(json.dumps({"max_memory_allocated": res["max_memory_allocated"],
                      "optimizer_bytes": res["optimizer_bytes"]}), flush=True)
    print(json.dumps(report(args.config, cfg, res, peak)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
