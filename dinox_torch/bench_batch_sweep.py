"""Batch-size sweep of the headline ViT-S train step, with the device time
of each kind of work per slice: the twin of ``scripts/bench_batch_sweep.py``,
with the same flags plus ``--device`` and the same JSON keys.

For each batch size: slices/s and MFU (against the card's dense bf16 peak,
``utils.flops.card_peaks``; ``None`` on the CPU, which has no such peak).
With ``--profile``, ``--profile-steps`` more steps run under
``torch.profiler``, whose Chrome trace goes to ``--trace-root/bs{N}``; it is
aggregated by ``utils.trace_analysis`` into device ms per step by kind of
work (the ported kernels by number, cuBLAS GEMMs, copies and casts,
reductions, elementwise, other), and a table of per-slice microseconds by
kind is printed, so the kind whose per-slice cost grows with the batch is
the answer to "why is a larger batch not faster". A batch size that fails
(out of memory among others) gives a row with its ``status`` and the sweep
goes on; the exit code is 1 when every batch size failed.

The step is the headline one: ViT-S scale-aware, ``attn_impl="pallas"``
(kernels 1 and 2/3 on the card), tanh GELU, KoLeo 0.1, warmup 100 of 5000
steps, on synthetic uint16 512^2 canvases from seed 0.

    python -m dinox_torch.bench_batch_sweep --batch-sizes 64 128 256 \\
        --profile --out docs/batch_sweep.json
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.platform import resolve_device
from dinox_torch.utils.trace_analysis import summarize_trace_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-sizes", type=int, nargs="+",
                   default=[64, 96, 128, 192, 256])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--config", default="vit-small")
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization (use_grad_checkpoint): "
                        "sweep batch x remat at L/G scale")
    p.add_argument("--factored-nu", action="store_true",
                   help="factored second moment (fits ViT-G's optimizer state "
                        "in less memory)")
    p.add_argument("--mu-dtype", default="float32")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="bench-only; 3e-5 for vit-giant (collapse otherwise)")
    p.add_argument("--profile", action="store_true",
                   help="capture a trace per batch size and compare kinds of work")
    p.add_argument("--profile-steps", type=int, default=4)
    p.add_argument("--trace-root", type=Path,
                   default=Path(tempfile.gettempdir()) / "bs_sweep_traces")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def bench_one(config: str, batch_size: int, steps: int, warmup: int,
              profile_dir: Path | None, profile_steps: int,
              remat: bool = False, factored_nu: bool = False,
              mu_dtype: str = "float32", lr: float = 1e-4,
              device: torch.device | str | None = None,
              peak_flops: Optional[float] = None) -> dict:
    """One row of the sweep: *warmup* steps, then *steps* timed ones (host
    clock, the card synchronised at both ends), then with *profile_dir*
    *profile_steps* more under torch.profiler. *peak_flops* (FLOP/s) is the
    MFU's denominator; without it ``mfu`` is None."""
    dev = resolve_device(device)
    cfg = TrainConfig(
        model=MODEL_CONFIGS[config].replace(
            scale_aware=True, attn_impl="pallas", gelu_approx=True,
            use_grad_checkpoint=remat),
        batch_size=batch_size,
        koleo_weight=0.1,
        warmup_steps=100,
        max_steps=5000,
        lr=lr,
        factored_nu=factored_nu,
        mu_dtype=mu_dtype,
    )
    state = create_train_state(cfg, seed=0, device=dev)
    step_fn = build_train_step(cfg, device=dev)

    rng = np.random.default_rng(0)
    pixels = torch.as_tensor(
        rng.integers(25000, 41000, (1, batch_size, 512, 512, 3)).astype(np.uint16), device=dev)
    spacing = torch.as_tensor(
        rng.uniform(0.4, 3.0, (1, batch_size, 3)).astype(np.float32), device=dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        state, metrics = step_fn(state, pixels, spacing)
    sync()

    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, pixels, spacing)
    sync()
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(float(metrics["loss"]))

    row = {
        "batch_size": batch_size,
        "remat": remat,
        "ms_per_step": round(dt * 1e3, 2),
        "slices_per_s": round(batch_size / dt, 1),
        "mfu": (round(mfu(batch_size / dt, MODEL_CONFIGS[config], peak_flops), 3)
                if peak_flops else None),
    }

    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
        with profile(activities=[activity]) as prof:
            for _ in range(profile_steps):
                state, metrics = step_fn(state, pixels, spacing)
            sync()
        prof.export_chrome_trace(str(profile_dir / "trace.json"))
        summary = summarize_trace_dir(profile_dir, steps=profile_steps)
        row["categories_ms_per_step"] = {
            k: round(v["ms_per_step"], 3) for k, v in summary["categories"].items()
        }
    return row


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    peak = card_peaks(torch.cuda.get_device_name(dev))[0] if dev.type == "cuda" else None
    results = []
    for bs in args.batch_sizes:
        pdir = (args.trace_root / f"bs{bs}") if args.profile else None
        if pdir is not None:
            pdir.mkdir(parents=True, exist_ok=True)
        try:
            row = bench_one(args.config, bs, args.steps, args.warmup,
                            pdir, args.profile_steps, remat=args.remat,
                            factored_nu=args.factored_nu,
                            mu_dtype=args.mu_dtype, lr=args.lr, device=dev, peak_flops=peak)
        except Exception as e:
            row = {"batch_size": bs, "status": f"{type(e).__name__}: {e}"}
            print(f"# bs{bs} failed: {row['status']}", file=sys.stderr)
            results.append(row)
            continue
        finally:
            # The failed or finished step's state goes before the next size.
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        results.append(row)
        print(f"# bs={bs}: {row['slices_per_s']} slices/s "
              f"({row['ms_per_step']} ms/step, mfu {row['mfu']})", file=sys.stderr)

    ok = [r for r in results if "slices_per_s" in r]
    if args.profile and len(ok) >= 2:
        # per-SLICE µs by kind: the kind that grows with the batch size is
        # what breaks large-batch scaling.
        kinds = sorted({c for r in ok for c in r.get("categories_ms_per_step", {})})
        print(f"\n# per-slice µs by kind "
              f"(columns: bs {[r['batch_size'] for r in ok]})", file=sys.stderr)
        for c in kinds:
            vals = [r["categories_ms_per_step"].get(c, 0.0) * 1e3 / r["batch_size"]
                    for r in ok]
            print(f"# {c:<44} " + " ".join(f"{v:>8.1f}" for v in vals),
                  file=sys.stderr)

    best = max(ok, key=lambda r: r["slices_per_s"]) if ok else None
    payload = {"results": results, "best": best}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(payload, indent=2))
    print(json.dumps(best or {"status": "all failed"}))
    return 0 if best else 1


if __name__ == "__main__":
    raise SystemExit(main())
