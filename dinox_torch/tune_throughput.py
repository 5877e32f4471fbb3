"""Offline throughput grid search: the twin of ``scripts/tune_throughput.py``,
with the same flags plus ``--device`` and the same files and keys.

Sweeps batch size x loader workers x prefetch depth over the real train
step, splitting each optimizer update into data wait, host-to-device copy
and device step (the card synchronised after the copy and after the step),
classifying each cell as io_bound, h2d_bound or compute_bound, and
recording out-of-memory cells, rusage and the 1-minute loadavg. Writes
``results.json``, ``results.csv`` and ``summary.json`` (the best stable
configuration, the largest batch that ran, the batches that ran out of
memory) under ``--out-dir``.

- ``--synthetic`` (or no ``--index-csv``) cycles a pool of two batches
  made on the host before the cell starts, so the loader is not measured.
- ``--index-csv`` feeds the step from ``data.pipeline.TrainLoader``
  (``--cache-slices`` in-memory slices; ``--decoded-cache auto|build``
  reads the decoded-slice memmap of ``data.slice_cache``); ``--inflate N``
  repeats the index rows N times per epoch, so a small tree does not end an
  epoch mid-measurement.
- ``--loader-only`` times the host pipeline alone (decode, 2.5D assembly,
  batching): no model, no card.

On the card a cell that raises ``torch.cuda.OutOfMemoryError`` is an
``"oom"`` cell; its state, optimizer and step are released and the caching
allocator emptied before the next cell. ``peak_bytes_in_use`` is
``torch.cuda.max_memory_allocated()`` over the cell (None on the CPU).

    python -m dinox_torch.tune_throughput --synthetic --batch-sizes 64 128 256 \\
        --out-dir throughput_tuning
    python -m dinox_torch.tune_throughput --index-csv data/index.csv \\
        --loader-only --batch-sizes 64 --num-workers 4 8 16 --out-dir throughput_tuning
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import gc
import itertools
import json
import os
import resource
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from dinox_torch.data.index import load_index_rows
from dinox_torch.data.pipeline import TrainLoader
from dinox_torch.data.slice_cache import build_slice_cache, open_slice_cache
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.utils.platform import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="vit-small")
    p.add_argument("--index-csv", type=Path, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--scale-aware", action="store_true", default=True)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[64, 128, 256])
    p.add_argument("--num-workers", type=int, nargs="+", default=[8])
    p.add_argument("--prefetch", type=int, nargs="+", default=[4],
                   help="loader prefetch queue depths to sweep")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--attn-impl", default="pallas")
    p.add_argument("--inflate", type=int, default=1,
                   help="virtually inflate the dataset by repeating the "
                        "index rows N times per epoch")
    p.add_argument("--cache-slices", type=int, default=512,
                   help="decoded-slice LRU size (0 = decode every read; use "
                        "0 for an honest cold-decode loader ceiling)")
    p.add_argument("--decoded-cache", choices=["auto", "build", "off"],
                   default="off",
                   help="on-disk decoded-slice memmap (data/slice_cache.py). "
                        "Default off: the tuner measures the decode path; "
                        "'auto'/'build' measure the cached production path")
    p.add_argument("--loader-only", action="store_true",
                   help="measure the host pipeline alone (loader-stress "
                        "ceiling): no model, no device transfers")
    p.add_argument("--out-dir", type=Path, default=Path("throughput_tuning"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def _usage_snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = None
    return {"maxrss_mb": round(ru.ru_maxrss / 1024, 1),
            "cpu_user_s": round(ru.ru_utime, 2),
            "cpu_sys_s": round(ru.ru_stime, 2),
            "loadavg_1m": load1}


def _make_loader(args, batch_size: int, num_workers: int, prefetch: int) -> TrainLoader:
    rows = load_index_rows(args.index_csv)
    decoded_cache = None
    if args.decoded_cache != "off":
        index_dir = Path(args.index_csv).parent
        if args.decoded_cache == "build":
            build_slice_cache(rows, args.canvas, index_dir, workers=num_workers)
        decoded_cache = open_slice_cache(index_dir, args.canvas)
    if args.inflate > 1:
        rows = rows * args.inflate
    return TrainLoader(rows, batch_size, seed=0, canvas=args.canvas,
                       num_workers=num_workers, prefetch=prefetch,
                       cache_slices=args.cache_slices,
                       decoded_cache=decoded_cache)


def measure_loader_only(args, batch_size: int, num_workers: int,
                        prefetch: int) -> dict:
    """Host-pipeline ceiling: PNG decode + 2.5D stack + batch assembly
    throughput with no device in the loop."""
    rec: dict = {"batch_size": batch_size, "num_workers": num_workers,
                 "prefetch": prefetch, "status": "ok", "mode": "loader_only"}
    loader = None
    try:
        loader = _make_loader(args, batch_size, num_workers, prefetch)
        it = iter(loader)
        for _ in range(args.warmup):
            next(it)
        u0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            next(it)
        dt = time.perf_counter() - t0
        u1 = resource.getrusage(resource.RUSAGE_SELF)
        n = args.steps * batch_size
        rec.update(
            img_per_s=round(n / dt, 1),
            batch_ms=round(dt / args.steps * 1000, 1),
            decode_mb_per_s=round(
                n * args.canvas * args.canvas * 3 * 2 / dt / 1e6, 1),
            cpu_frac=round((u1.ru_utime - u0.ru_utime
                            + u1.ru_stime - u0.ru_stime) / dt, 2),
        )
        rec.update(_usage_snapshot())
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = str(e).splitlines()[0][:200] if str(e) else type(e).__name__
        traceback.print_exc()
    finally:
        if loader is not None:
            loader.close()
    return rec


def measure(args, batch_size: int, num_workers: int, prefetch: int) -> dict:
    """One train cell: *args.warmup* updates, then *args.steps* timed ones."""
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = TrainConfig(
        model=MODEL_CONFIGS[args.config].replace(
            scale_aware=args.scale_aware, attn_impl=args.attn_impl
        ),
        batch_size=batch_size,
        koleo_weight=0.1,
        warmup_steps=100,
        max_steps=5000,
    )
    rec: dict = {"batch_size": batch_size, "num_workers": num_workers,
                 "prefetch": prefetch, "status": "ok", "mode": "train"}
    loader = state = step_fn = dev_batch = m = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        if args.synthetic or args.index_csv is None:
            rng = np.random.default_rng(0)
            # Made before the cell and cycled: drawing ~100M random ints per
            # step on the host would measure numpy, not the pipeline.
            pool = [
                (
                    rng.integers(25000, 41000,
                                 (1, batch_size, args.canvas, args.canvas, 3),
                                 dtype=np.uint16),
                    rng.uniform(0.4, 3.0, (1, batch_size, 3)).astype(np.float32),
                )
                for _ in range(2)
            ]

            def batches():
                i = 0
                while True:
                    yield pool[i % len(pool)]
                    i += 1

            it = batches()
        else:
            loader = _make_loader(args, batch_size, num_workers, prefetch)

            def batches():
                for b in loader:
                    yield b.pixels[None], b.spacing[None]

            it = batches()

        state = create_train_state(cfg, seed=0, device=dev)
        step_fn = build_train_step(cfg, device=dev)
        # Three legs per optimizer update: host data wait, the explicit
        # host -> device copy, the device step. Folding the copy into the
        # device time would misclassify a copy-bound cell.
        t_data, t_h2d, t_step = [], [], []
        for i in range(args.warmup + args.steps):
            t0 = time.perf_counter()
            pixels, spacing = next(it)
            t1 = time.perf_counter()
            dev_batch = (torch.as_tensor(pixels).to(dev), torch.as_tensor(spacing).to(dev))
            sync()
            t2 = time.perf_counter()
            state, m = step_fn(state, *dev_batch)
            sync()
            t3 = time.perf_counter()
            if i >= args.warmup:
                t_data.append(t1 - t0)
                t_h2d.append(t2 - t1)
                t_step.append(t3 - t2)
        data_s, h2d_s, step_s = (float(np.mean(t)) for t in (t_data, t_h2d, t_step))
        total = data_s + h2d_s + step_s
        legs = {"io_bound": data_s, "h2d_bound": h2d_s, "compute_bound": step_s}
        rec.update(
            data_wait_s=round(data_s, 4),
            h2d_s=round(h2d_s, 4),
            h2d_mb_per_s=round(
                batch_size * args.canvas * args.canvas * 3 * 2 / max(h2d_s, 1e-9) / 1e6, 1),
            device_step_s=round(step_s, 4),
            step_total_s=round(total, 4),
            data_wait_frac=round(data_s / total, 3),
            img_per_s=round(batch_size / total, 1),
            # upper bound with perfect loader/transfer/compute overlap
            # (what the trainer's device prefetch approximates)
            img_per_s_overlapped=round(batch_size / max(legs.values()), 1),
            bound=max(legs, key=legs.get),
        )
        rec.update(_usage_snapshot())
        rec["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    except Exception as e:  # noqa: BLE001 — classify OOM vs other failures
        msg = str(e)
        rec["status"] = "oom" if isinstance(e, torch.cuda.OutOfMemoryError) else "error"
        rec["error"] = msg.splitlines()[0][:200] if msg else type(e).__name__
        traceback.print_exc()
    finally:
        if loader is not None:
            loader.close()
        # Release the cell's state, optimizer, step and batch before the
        # next cell: after an OOM they would otherwise hold the card.
        loader = state = step_fn = dev_batch = m = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.loader_only and args.index_csv is None:
        print("error: --loader-only requires --index-csv", file=sys.stderr)
        return 2
    args.out_dir.mkdir(parents=True, exist_ok=True)
    fn = measure_loader_only if args.loader_only else measure
    results = []
    for bs, nw, pf in itertools.product(args.batch_sizes, args.num_workers,
                                        args.prefetch):
        print(f"measuring batch={bs} workers={nw} prefetch={pf} ...", flush=True)
        rec = fn(args, bs, nw, pf)
        print(f"  -> {rec}", flush=True)
        results.append(rec)

    (args.out_dir / "results.json").write_text(json.dumps(results, indent=2))
    keys = sorted({k for r in results for k in r})
    with open(args.out_dir / "results.csv", "w", newline="") as f:
        w = csv_mod.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(results)

    ok = [r for r in results if r["status"] == "ok"]
    summary = {
        "mode": "loader_only" if args.loader_only else "train",
        "best_img_per_s": max((r["img_per_s"] for r in ok), default=0.0),
        "best_config": max(ok, key=lambda r: r["img_per_s"], default=None),
        "max_stable_batch": max((r["batch_size"] for r in ok), default=0),
        "oom_batches": sorted({r["batch_size"] for r in results if r["status"] == "oom"}),
    }
    (args.out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
