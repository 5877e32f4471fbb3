"""Inference / serving benchmark of the port: the twin of
``scripts/bench_inference.py`` (its flags plus ``--device``).

Throughput mode times the embedding forward (ViT -> final norm -> CLS,
L2-normalised) on device-resident inputs at each batch size: ``--steps``
forwards under ``torch.inference_mode()`` between two synchronises, after
one untimed forward, and reports the best img/s. A batch size that runs
out of device memory is printed and skipped. ``--slo`` measures p50/p95/p99
single-image request latency and the coalescing ratio against the port's
micro-batcher (``serve.EmbedService``) at each concurrency. Each mode ends
with one JSON line (``metric``, ``value``, ``unit``, ``batch_size`` or
``concurrency``, ``all``).

    python -m dinox_torch.bench_inference [--config vit-small] [--steps 20] [--fused-attn]
    python -m dinox_torch.bench_inference --slo --concurrency 1 4 16
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from dinox_torch import serve
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.models.vit import PatchViT
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.hub import export_hub_checkpoint


def _model_config(args):
    return MODEL_CONFIGS[args.config].replace(scale_aware=True, attn_impl=args.attn_impl,
                                              img_size=args.img_size, fused_attn=args.fused_attn)


def slo_bench(args, device: torch.device) -> int:
    """p50/p95/p99 single-image request latency against concurrency through
    EmbedService (buckets 1/8/32), and the coalescing ratio (requests per
    forward). Each client sends sequential 1-image requests."""
    cfg = _model_config(args)
    rng = np.random.default_rng(0)
    rows = []
    with tempfile.TemporaryDirectory() as td:
        export_hub_checkpoint(PatchViT(cfg, generator=torch.Generator().manual_seed(0)), td)
        service = serve.EmbedService(td, buckets=[1, 8, 32], fused_attn=args.fused_attn,
                                     device=device)
    try:
        service.warmup()
        img = rng.uniform(-400, 400, (args.img_size, args.img_size)).astype(np.float32)
        sp = [0.7, 0.7, 1.5]
        for conc in args.concurrency:
            f0, r0 = service.stats["forwards"], service.stats["requests"]
            lat: list[float] = []
            lock = threading.Lock()
            barrier = threading.Barrier(conc)

            def client():
                barrier.wait()
                mine = []
                for _ in range(args.requests_per_client):
                    t0 = time.perf_counter()
                    service.embed([img], [sp])
                    mine.append(time.perf_counter() - t0)
                with lock:
                    lat.extend(mine)

            threads = [threading.Thread(target=client) for _ in range(conc)]
            t_all = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_all
            ms = np.sort(np.asarray(lat)) * 1000
            served = service.stats["requests"] - r0
            fwds = service.stats["forwards"] - f0
            rows.append({
                "concurrency": conc,
                "p50_ms": round(float(np.percentile(ms, 50)), 1),
                "p95_ms": round(float(np.percentile(ms, 95)), 1),
                "p99_ms": round(float(np.percentile(ms, 99)), 1),
                "req_per_s": round(len(lat) / wall, 1),
                "coalesce_ratio": round(served / max(fwds, 1), 2),
            })
            print(f"conc={conc}: p50={rows[-1]['p50_ms']}ms p95={rows[-1]['p95_ms']}ms "
                  f"{rows[-1]['req_per_s']} req/s coalesce={rows[-1]['coalesce_ratio']}x", flush=True)
    finally:
        service.close()
    print(f"service forwards={service.stats['forwards']} requests={service.stats['requests']} "
          f"images={service.stats['images']}", flush=True)
    top = rows[-1]
    print(json.dumps({
        "metric": f"{args.config.replace('-', '_')}_serve_p95_ms",
        "value": top["p95_ms"],
        "unit": "ms",
        "concurrency": top["concurrency"],
        "all": rows,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="vit-small",
                   choices=["vit-tiny", "vit-small", "vit-large", "vit-giant"])
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[64, 128, 256, 512])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--attn-impl", default="pallas", choices=["pallas", "xla"])
    p.add_argument("--fused-attn", action="store_true",
                   help="fused LN->QKV->attn->proj half-block kernel (ops/fused_attn_block.py)")
    p.add_argument("--slo", action="store_true",
                   help="latency-SLO mode: p50/p95 per-request latency vs concurrency against "
                        "serve.EmbedService, instead of raw forward throughput")
    p.add_argument("--concurrency", type=int, nargs="+", default=[1, 4, 16])
    p.add_argument("--requests-per-client", type=int, default=25)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.slo:
        return slo_bench(args, device)

    cfg = _model_config(args)
    model = PatchViT(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)

    def embed(x: torch.Tensor, spacing: torch.Tensor) -> torch.Tensor:
        cls = model(x, spacing)[:, 0, :]
        return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def run(x: torch.Tensor, spacing: torch.Tensor, steps: int) -> float:
        """*steps* forwards; the checksum of their embeddings."""
        with torch.inference_mode():
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(steps):
                acc += embed(x, spacing).sum(dtype=torch.float32)
            return float(acc)  # a real fetch: waits for the last forward

    results = []
    for bs in args.batch_sizes:
        try:
            x = torch.as_tensor(rng.normal(0.0, 1.0, (bs, args.img_size, args.img_size, 3))
                                .astype(np.float32), device=device)
            sp = torch.as_tensor(rng.uniform(0.4, 3.0, (bs, 3)).astype(np.float32), device=device)
            checksum = run(x, sp, 1)  # first call: kernel builds, allocator warm-up
        except torch.cuda.OutOfMemoryError as e:  # large bs: record, continue
            print(f"bs={bs}: {type(e).__name__}: {str(e)[:120]}", flush=True)
            x = sp = None
            torch.cuda.empty_cache()
            continue
        assert np.isfinite(checksum), f"non-finite embed checksum at bs={bs}: {checksum}"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        checksum = run(x, sp, args.steps)
        dt = (time.perf_counter() - t0) / args.steps
        img_s = bs / dt
        results.append({"batch_size": bs, "img_per_sec": round(img_s, 1),
                        "latency_ms": round(dt * 1000, 2)})
        print(f"bs={bs}: {img_s:.0f} img/s, {dt * 1000:.2f} ms/batch", flush=True)

    if not results:
        print("no successful batch size", file=sys.stderr)
        return 1
    best = max(results, key=lambda r: r["img_per_sec"])
    print(json.dumps({
        "metric": f"{args.config.replace('-', '_')}_encode_img_per_sec",
        "value": best["img_per_sec"],
        "unit": "img/s",
        "batch_size": best["batch_size"],
        "all": results,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
