#!/usr/bin/env python3
"""On-card smoke test of dinox_torch's serving path (one CUDA card).

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel under dinox_torch/ops/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path and the JAX package's kernel check use.
4. Makes a full-width ViT-S scale-aware backbone (bf16, seeded random
   weights), exports it as a hub dir, and serves it with dinox_torch.serve
   (EmbedService + HTTP on 127.0.0.1, buckets 1/8/32).
5. POSTs /embed requests of 512x512 HU slices (1, 8, 40 and 3x32 images),
   checks the answers (status, dim, finite unit-norm embeddings, CLS cosine
   >= 0.999 against the same weights with plain attention) and that every
   forward went through the kernel (launches == depth x forwards).
6. Times each kernel, its plain version, the PyTorch library call that
   computes the same function, and its bound, at the serving shape, and
   prints them as one JSON line; then the served rate.

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
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.ops import _build
from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
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
# Published dense bf16 tensor-core peak (FLOP/s) and memory rate (B/s), NVIDIA data sheets.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12), "nvl": (835e12, 3.9e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[float, float]:
    low = name.lower()
    return PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"]


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

        flash_attention_packed.launches = 0
        forwards0 = service.stats["forwards"]
        served = {n: check_embeddings(post(url, body), n, 384) for n, (_, _, body) in reqs.items()}
        t0 = time.perf_counter()
        embed_ms = 0.0  # the server's own time in EmbedService.embed
        for _, _, body in timed:
            resp = post(url, body)
            check_embeddings(resp, 32, 384)
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

    # -- kernel timing at the serving shape ----------------------------------
    b, n, three_dim, heads = SERVING_SHAPE
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    kern_ms = median_ms(lambda: flash_attention_packed(qkv, heads))
    plain_ms = median_ms(lambda: packed_attention_reference(qkv, heads))
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops_peak, bytes_peak = card_peaks(card)
    moved = (qkv.numel() + b * n * dim) * qkv.element_size()
    flops = 4 * b * heads * n * n * hd
    t_bytes, t_ops = moved / bytes_peak * 1e3, flops / flops_peak * 1e3
    print(f"ViT-S bs32 forward on the card: {fwd_ms:.3f} ms ({32 / fwd_ms * 1e3:.1f} img/s); "
          f"attention {cfg.depth} x {kern_ms:.4f} ms = {100 * cfg.depth * kern_ms / fwd_ms:.1f}%",
          flush=True)
    print(f"packed_attention at {SERVING_SHAPE}: {moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP",
          flush=True)
    kernels = [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/packed_attention.cu",
        "replaces": "dinox_tpu/ops/flash_attention.py:200",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
