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
9. Times each kernel, its plain version, the PyTorch library call that
   computes the same function, and its bound (the forward at the serving
   shape, the backward at the training shape), and prints them as one JSON
   line.

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
from dinox_torch.bench import bench_train_step
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.ops import _build
from dinox_torch.ops import flash_attention as fa
from dinox_torch.ops.augment import augment_views
from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import micro_loss_and_grads
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.roofline import bound_ms
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
# Device kernels grouped by what they do, by substrings of their names.
KERNEL_KINDS = [
    ("attention forward kernel", ("packed_attention_fwd",)),
    ("attention backward dq kernel", ("packed_attention_bwd_dq",)),
    ("attention backward dkv kernel", ("packed_attention_bwd_dkv",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer/EMA (multi-tensor)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("dtype casts", ("copy_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def launch_counts() -> dict[str, int]:
    return {"packed_attention": fa.flash_attention_packed.launches,
            "packed_attention_bwd_dq": fa.packed_attention_bwd_dq.launches,
            "packed_attention_bwd_dkv": fa.packed_attention_bwd_dkv.launches}


def reset_launch_counts() -> None:
    fa.flash_attention_packed.launches = 0
    fa.packed_attention_bwd_dq.launches = 0
    fa.packed_attention_bwd_dkv.launches = 0


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


def check_step_against_plain() -> None:
    """One micro-step of full ViT-S scale-aware at bs 8 through the kernels
    and with plain attention, from one state (scale pathway made live) and
    the same views."""
    model = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    cfgs = [TrainConfig(model=model.replace(attn_impl=impl), batch_size=8, koleo_weight=0.1)
            for impl in ("pallas", "xla")]
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
    print(f"training micro-step, ViT-S scale-aware bs8, kernels vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, tol 1e-2); gradient cosine min "
          f"{cos[worst]:.6f} ({worst}) over {len(cos)} tensors, {len(skipped)} skipped as zero "
          f"in both {skipped}", flush=True)
    if not np.isfinite(loss_k) or rel > 1e-2 or cos[worst] < 0.99:
        fail("the training step through the kernels disagrees with plain attention")


def train(card: str) -> dict[str, int]:
    """The training path at full width: bench_train_step(96), tanh arm, with
    exact launch counts. Returns the counts of this run."""
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, profile=True)
    counts = launch_counts()
    steps = TRAIN_WARMUP + TRAIN_STEPS + 1
    want = {"packed_attention": steps * 2 * cfg.depth, "packed_attention_bwd_dq": steps * cfg.depth,
            "packed_attention_bwd_dkv": steps * cfg.depth}
    print(f"trained {steps} steps of ViT-S scale-aware bs{TRAIN_BATCH}: losses "
          f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, all finite; launches {counts} "
          f"(want {want}: forward 2 x depth, each backward kernel depth, per step)", flush=True)
    if counts != want:
        fail("the training step did not run every attention through the kernels exactly once")
    peak = card_peaks(card)[0]
    print(f"training rate: {res['slices_per_s']:.2f} slices/s ({res['step_ms']:.2f} ms per step "
          f"of {TRAIN_BATCH} slices, host clock over {TRAIN_STEPS} steps); MFU "
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

        reset_launch_counts()
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
    check_step_against_plain()
    train_counts = train(card)
    bwd = time_backward(peaks)
    time_backward(peaks, VIT_G_SHAPE)  # TPU kernel 3's shape

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
