#!/usr/bin/env python3
"""On-card smoke test of dinox_torch's serving and training paths, its
head-major attention path, its pretraining CLI, its evaluation,
inference-bench and LoRA fine-tuning CLIs, the CIFAR control and the
DICOM/NIfTI preprocessing CLIs (one CUDA card).

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel under dinox_torch/ops/csrc with nvcc.
3. Holds the packed attention forward kernel against its plain PyTorch
   version on the card at the shapes the serving path, the training path,
   the inference bench (bs 64-512), the CIFAR control ((512/392/488, 69,
   576, 6): N 69, hd 32) and the JAX package's kernel check use, each twice
   with equal bits, and both forward kernels of the tile core
   attention_fwd_sm90.cuh (kernels 1 and 4) at the ragged edges of its
   tiling (N 1 to 1500, hd 32/64/88), each twice with equal bits.
4. Makes a full-width ViT-S scale-aware backbone (bf16, seeded random
   weights), exports it as a hub dir, and serves it with dinox_torch.serve
   (EmbedService + HTTP on 127.0.0.1, buckets 1/8/32).
5. POSTs /embed requests of 512x512 HU slices (1, 8, 40 and 3x32 images),
   checks the answers (status, dim, finite unit-norm embeddings, CLS cosine
   >= 0.999 against the same weights with plain attention) and that every
   forward went through the kernel (launches == depth x forwards).
6. Holds the backward kernel pair (dq, dkv) against the plain backward at
   eight shapes, each twice with equal bits, the training shape, the LoRA
   fine-tuning step's (bs 32), the CIFAR step's (512, 69, 576, 6) and the
   ViT-G one included, then both
   backward pairs of the tile core attention_bwd_sm90.cuh (kernels 2/3 and
   5) at the ragged edges of its tiling (N 1 to 1500, hd 32/64/88): each
   twice with equal bits, kernel 5 bit-equal to kernel 2.
7. Runs one training micro-step of full ViT-S (bs 8) through the kernels
   and once with plain attention, from one state and the same views: the
   losses within 1e-2 relative, every gradient at cosine >= 0.99.
8. Trains: dinox_torch.bench.bench_train_step(96), 5 warm-up and 20 timed
   steps and one profiled step, every loss finite, and exact launch counts
   per step (forward 2 x depth, each backward kernel depth).
9. (Run right after 3.) Holds the fused attention half-block kernel (TPU
   kernel 6: LN + QKV and proj + residual on the GEMM core gemm_sm90.cuh
   around kernel 1's attention core) against its plain version at nine
   shapes (the inference bench's bs 64-512 among them) and at the ragged edges of its row blocks and widths (B*N 1, 63,
   64, 65; dim 96 and 1408): y, qkv and attn within 0.05, twice with equal
   bits, attn bit-equal to kernel 1 on the kernel's own qkv; the fused MLP
   forward's two launches (kernel 7: fc1 and fc2 on gemm_sm90.cuh) within
   0.02 and the fused MLP backward's six (kernel 8: norm, hidden, dln, dx,
   weights, reduce) within 2e-2 of each output's largest value, at three
   shapes and at the ragged edges (rows 1, 63, 64, 65, 127, 129 and 8352;
   widths 192 and 200), each twice with equal bits.
10. Serves the same hub dir with EmbedService(fused_attn=True) and the same
   requests: CLS cosine >= 0.999 against the unfused service, kernel 6
   launches == depth x forwards, packed attention forward launches == 0.
11. Runs one micro-step of full ViT-S (bs 8, exact GELU) with fused_attn and
   fused_mlp through the kernels against the unfused exact-GELU model, from
   one state and the same views (loss within 1e-2 relative, gradient cosine
   >= 0.99), then trains that fused configuration at bs96 (3 warm-up, 10
   timed and one profiled step) with exact launch counts per step (each
   launch of kernels 7 and 8 counted on its own).
12. (Run right after 6.) Holds the head-major pair against its plain
   versions at six shapes (the JAX check's unpacked shape, the bring-up
   shape (8, 8, 1024, 64), the training shape, hd 32, hd 88 and N=1500):
   kernel 4 within 0.02, each of kernel 5's dq, dk, dv within 2e-2 of its
   largest value and bit-equal to kernel 2 on the same data laid out packed;
   sdpa(impl="pallas") launches kernel 4 once per call.
13. Drives the head-major path with exact launch counts: the bring-up gate
   dinox_torch.validate_attention.main([]) at its defaults (PASS, 11
   launches of kernel 4), then a gradient of sum(out^2) through
   sdpa(impl="pallas") (kernel 4 once, each of kernel 5's launches once)
   against autograd through the plain version, within 2e-2 of the largest
   gradient.
14. Times each kernel, its plain version, the PyTorch library call that
   computes the same function (none for kernels 6-8), the port's own unfused
   composition of each fused half-block, and its bound (kernel 1 at the
   serving shape, kernel 4 at the bring-up shape, the rest at the training
   shape, kernels 1, 4 and 6 at both), and prints them as one JSON line. For
   kernel 6 also each of its three launches' device time (torch.profiler)
   beside its own bound, the call's back-to-back time, the GEMM launches'
   registers, shared memory, CTAs per SM and grid split, and the achieved
   TFLOP/s and TB/s; for kernels 7 and 8 the same for each of their two and
   six launches. For
   kernels 1, 4 and both backward pairs (each of their dq and dkv kernels)
   it also prints what sets the time: registers, shared memory per CTA and
   resident CTAs per SM (the occupancy API), the time of back-to-back
   launches (SDPA's backward's too), and the achieved TFLOP/s (on the
   algorithm's operations and on those the tiles issue) and TB/s beside the
   bound; the pair at the training shape is also held against its plain
   version there.
15. Drives the pretraining CLI (python -m dinox_torch.pretrain) at full
   width and depth: ViT-S scale-aware bs96, tanh, attn_impl "pallas", KoLeo
   0.1, on four batches of the v2 synthetic profiles staged on the card.
   A straight run of 40 steps in this process (exact launch counts: kernel
   1 2 x depth and each backward kernel depth per step, every loss finite;
   the samples/s of each 10 steps (11-20 end before the first save, 21-30
   hold the step-20 save) beside step 8's bench_train_step slices/s; the
   caching allocator's cudaMalloc, cudaFree and retries, and the pauses of
   Python's garbage collector in the run; the checkpoints' bytes, the time the loop was blocked in each save, the
   part of it spent allocating snapshot buffers, the snapshot copies'
   device time and the write time); a resume from its step-20 checkpoint, written in the background
   while steps 21 on updated the state in place (steps 21-40 as the
   straight run's); the same run as a subprocess, interrupted by SIGINT once step 12
   is logged (exit 0, a checkpoint at the step it stopped at), then resumed
   to 40 (lr bit-equal to the straight run at every step, losses after the
   seam within 1e-3 relative; restore and start-up times); 5 steps with
   --fused-attn (kernel 6 2 x depth per step, the packed forward 0); and
   40 steps each over a tree of 48 x 32 512^2 PNGs written with write_png16
   (1536 slices, three times the loader's in-memory cache, so every epoch
   decodes), through the host loader (8 workers, device prefetch 2) with
   the decoded cache off and built (samples/s and data wait share of steps
   21-40, well past the batches queued before the first step; the PNG
   decodes of the run and the decoder in use). The kernels line gives each kernel's launches in this phase as
   pretrain_launches.
16. Evaluates the straight run of 15 over its PNG tree (module 9):
   python -m dinox_torch.evaluate_panorgan's main through run_export and
   the safetensors reader (every metric a number; kernel 1 launches ==
   depth x forwards exactly), embed_rows against the same weights with
   plain attention (CLS cosine >= 0.999), embedded slices/s with and
   without PNG decoding, view_retrieval_eval (exit 0 or 2, its gate) and
   check_checkpoint once each.
17. Runs python -m dinox_torch.bench_inference at full ViT-S width: the
   throughput mode at bs 64/128/256/512 unfused (kernel 1 only) and
   --fused-attn (kernel 6 only), each batch size over 12800 images, both
   kinds twice in turn; then --slo at concurrency 1/4/16 both ways, 200
   requests or more a concurrency; exact launch counts. Kernels 1 and 6
   are checked at every batch size of the bench (steps 3 and 8), and
   kernel 1 is timed against SDPA and its bound at the bench's largest
   shape (512, 261, 1152, 6).
18. Fine-tunes the straight run with LoRA (module 10): finetune_lora's
   main at bs 32, rank 8, 2 epochs over two profiles of the tree, with
   --unfreeze-blocks 0 and 1 (per training step kernel 1, dq and dkv
   depth each, kernel 1 depth per validation forward, kernels 4-8 zero;
   finite losses; the adapter files), the adapter loaded and merged (CLS
   cosine >= 0.999 against the unmerged model), one LoRA loss and backward
   through the kernels against plain attention (loss within 1e-2
   relative, adapter gradients at cosine >= 0.99), and the step's ms and
   samples/s beside bench_train_step(96). The kernels line gives kernels
   1, 2 and 6 eval_launches, bench_inference_launches and
   finetune_launches, and kernel 1 its inference_bench timing.
19. Runs the CIFAR control (module 10's rest) at its published width (img
   32, patch 4, dim 192, depth 6, 6 heads, 4 registers: N 69, hd 32; bf16)
   on synthetic_cifar: one micro-step (bs 8) through the kernels against
   plain attention (loss within 1e-2 relative, gradient cosine >= 0.99);
   python -m dinox_torch.baseline_cifar10_pretrain --attn-impl pallas for
   40 steps of bs 256 (exact launches per step: kernel 1 2 x depth, dq and
   dkv depth; finite losses), the step's ms, samples/s and busy share;
   baseline_cifar10_linear_probe (exit 0 or 2; kernel 1 depth x 12
   forwards) with its CLS embeddings against plain attention (cosine >=
   0.999) and baseline_cifar10_view_retrieval_eval (exit 0 or 2; 2 x depth
   launches); kernel 1 and the pair timed at (512, 69, 576, 6) beside
   SDPA, its backward and their bounds.
20. Turns DICOM and NIfTI into training (module 8b): 4 DICOM series of 32
   512^2 slices (write_dicom) and 2 NIfTI volumes (write_nifti) through
   preprocess_dicom, preprocess_nifti, extract_dicom_spacing,
   combine_indices, make_split_manifest, build_slice_cache and
   validate_samples in this process (each exits 0, slices/s each, every PNG
   equal to encode_hu16 of the written HU), then python -m
   dinox_torch.pretrain over the combined index and its split manifest at
   ViT-S bs32 for 5 steps (exact launches). The kernels line gives kernels
   1 and 2 (dq, dkv) cifar_launches and preprocess_launches, and kernel 1
   and the dq entry (the pair) their cifar timing.

The last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero; without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import io
import json
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dinox_torch import (
    baseline_cifar10_linear_probe,
    baseline_cifar10_pretrain,
    baseline_cifar10_view_retrieval_eval,
    bench_inference,
    check_checkpoint,
    evaluate_panorgan,
    finetune_lora,
    pretrain,
    serve,
    validate_attention,
    view_retrieval_eval,
)
from dinox_torch.bench import bench_train_step, fused_block_inputs, fused_mlp_inputs
from dinox_torch.data.cifar import synthetic_cifar
from dinox_torch.data.dicom import write_dicom
from dinox_torch.data.hu import HU_SHIFT, encode_hu16
from dinox_torch.data.index import IndexRow, load_index_rows, write_index_rows
from dinox_torch.data.nifti import write_nifti
from dinox_torch.data.png16 import decoder_in_use, read_png16, write_png16
from dinox_torch.data.synthetic import PROFILES_V2, draw_spacing, synth_series_np
from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.evaluation.embedder import _load_batches, embed_rows
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.models.vit import Attention, LayerNorm, Mlp, PatchViT, sdpa
from dinox_torch.ops import _build
from dinox_torch.ops import flash_attention as fa
from dinox_torch.ops import fused_attn_block as fab
from dinox_torch.ops import fused_mlp as fm
from dinox_torch.ops.augment import augment_views, eval_transform
from dinox_torch.ops.augment_rgb import RgbAugConfig, augment_rgb_views
from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
from dinox_torch.train.finetune import (
    FinetuneConfig,
    FinetuneState,
    build_finetune_step,
    finetune_loss,
    init_head,
    make_finetune_optimizer,
)
from dinox_torch.preprocessing import (
    build_slice_cache,
    combine_indices,
    extract_dicom_spacing,
    make_split_manifest,
    preprocess_dicom,
    preprocess_nifti,
    validate_samples,
)
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step, micro_loss_and_grads
from dinox_torch.utils.flops import card_peaks, mfu
from dinox_torch.utils.roofline import (
    attention_bwd_work,
    attention_fwd_work,
    bound_ms,
    fused_attn_parts_work,
    fused_attn_work,
    fused_mlp_bwd_parts_work,
    fused_mlp_bwd_work,
    fused_mlp_fwd_parts_work,
    fused_mlp_fwd_work,
)
from dinox_torch.zoo.encode import _preprocess
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint
from dinox_torch.zoo.peft import apply_lora, load_adapter, merge_adapter

SEED = 0
# The CIFAR control (img 32, patch 4, 4 registers: N = 69; dim 192 over 6
# heads: hd 32): its training step's 2 x 256 views, and the linear probe's
# batches of 512 with its tails (5000 = 9 x 512 + 392 train and 1000 = 512 +
# 488 test images).
CIFAR_SHAPE = (512, 69, 3 * 192, 6)
CIFAR_FWD_SHAPES = [CIFAR_SHAPE, (392, 69, 3 * 192, 6), (488, 69, 3 * 192, 6)]
CIFAR_STEPS, CIFAR_BATCH, CIFAR_WINDOW = 40, 256, 50
CIFAR_ARGS = ["--attn-impl", "pallas", "--max-steps", str(CIFAR_STEPS), "--batch-size",
              str(CIFAR_BATCH), "--warmup-steps", "10", "--ckpt-every", "20", "--log-json"]
# The DICOM/NIfTI leg: DICOM series and NIfTI volumes of 512^2 slices, then
# 5 pretraining steps of ViT-S bs32 over their PNGs.
DICOM_SERIES, NIFTI_VOLUMES, SERIES_SLICES, PRE_STEPS, PRE_BATCH = 4, 2, 32, 5, 32
BUCKETS = [1, 8, 32]
TOL = 0.02  # bf16 forward tolerance of the JAX package's kernel check (bench.py --check)
# (b, n, 3*dim, heads): the kernel-check shapes (ViT-S, ViT-G hd 88), the
# serving bucket-32 shape, the MAE decoder's hd 32, the ViT-S training
# shape (2 x 96 views) that the unfused training step gives it, the
# inference bench's largest batch (3072 (batch, head) pairs), its other
# three batch sizes (the evaluation's bs 64 among them) and the CIFAR
# control's three.
CHECK_SHAPES = [(8, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16), (32, 261, 3 * 384, 6),
                (4, 261, 3 * 512, 16), (192, 261, 3 * 384, 6), (512, 261, 3 * 384, 6),
                (64, 261, 3 * 384, 6), (128, 261, 3 * 384, 6), (256, 261, 3 * 384, 6),
                *CIFAR_FWD_SHAPES]
SERVING_SHAPE = (32, 261, 3 * 384, 6)
# Backward gates: the JAX package's bwd tolerance (bench.py --check) and the
# error relative to the largest gradient.
BWD_TOL, BWD_REL = 0.25, 2e-2
# (b, n, 3*dim, heads): the check shape, the ViT-S training shape (2 x 96
# views), ViT-G (hd 88, TPU kernel 3's shape), hd 32, a short ragged N, an
# N past the TPU kernel's 1024, the LoRA fine-tuning step's bs 32, the
# DICOM/NIfTI leg's pretraining step (2 x 32 views) and the CIFAR step's
# 512 views of 69 tokens at hd 32.
BWD_SHAPES = [(8, 261, 3 * 384, 6), (192, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16),
              (4, 261, 3 * 512, 16), (3, 37, 3 * 384, 6), (2, 1100, 3 * 384, 6),
              (32, 261, 3 * 384, 6), (64, 261, 3 * 384, 6), CIFAR_SHAPE]
TRAINING_SHAPE = CHECK_SHAPES[4]
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 96, 5, 20
# The pretraining CLI at full width and depth: ViT-S scale-aware bs96, tanh,
# attn_impl "pallas", the bench's KoLeo weight, on the v2 synthetic profiles
# staged on the card.
PRETRAIN_STEPS, PRETRAIN_KILL_AT, PRETRAIN_FUSED_STEPS, LOADER_STEPS = 40, 12, 5, 40
CLI_ARGS = ["--config", "vit-small", "--scale-aware", "--batch-size", str(TRAIN_BATCH),
            "--warmup-steps", "10", "--ckpt-every", "20", "--koleo-weight", "0.1", "--log-json",
            "--no-tensorboard"]
PRETRAIN_ARGS = CLI_ARGS + ["--synthetic-device-batches", "4", "--synthetic-datasets", "5"]
RESUME_TOL = 1e-3  # relative, losses after the seam against the straight run
# The host loader's tree: 48 series x 32 slices at 512^2 from the v2 profiles,
# three times the 512 slices the loader keeps decoded in memory.
TREE_SERIES, TREE_SLICES, TREE_SIZE = 48, 32, 512
VIT_G_SHAPE = (2, 261, 3 * 1408, 16)
# The inference bench (python -m dinox_torch.bench_inference): each batch
# size timed over INFER_IMAGES images (INFER_IMAGES / bs steps, 25 at bs 512,
# about 1-2.5 s a window on the card), unfused and fused twice in turn; each
# --slo concurrency in a run of its own with SLO_SAMPLES requests in all, so
# that p99 rests on 200 latencies; kernel 1's shape at bs 512.
INFER_BATCHES, INFER_IMAGES, INFER_REPEATS = [64, 128, 256, 512], 12800, 2
SLO_CONCURRENCY, SLO_SAMPLES = [1, 4, 16], 200
INFER_SHAPE = CHECK_SHAPES[5]
# LoRA fine-tuning: bs 32, 3 steps an epoch, 2 validation batches.
FT_BATCH, FT_TRAIN, FT_VAL = 32, 96, 64
# The fused half-blocks. Kernel 6's gate is the JAX package's (bench.py
# --check); (b, n, dim, heads): the check shape, the serving bucket 32, the
# training shape, ViT-G (hd 88), hd 32 and the inference bench's batch sizes
# (bs 512: 133,632 rows).
FUSED_TOL = 0.05
FUSED_ATTN_SHAPES = [(8, 261, 384, 6), (32, 261, 384, 6), (192, 261, 384, 6),
                     (2, 261, 1408, 16), (4, 261, 512, 16),
                     (64, 261, 384, 6), (128, 261, 384, 6), (256, 261, 384, 6), (512, 261, 384, 6)]
FUSED_SERVING_SHAPE, FUSED_TRAINING_SHAPE = FUSED_ATTN_SHAPES[1], FUSED_ATTN_SHAPES[2]
# Kernel 6's ragged edges, (b, n, dim, heads): B*N = 1, 63, 64, 65 (the edges
# of a 64-row warpgroup and of a 128-row GEMM block), dim 96 (a last 32-deep
# K step) and ViT-G's 1408 (one warpgroup, no multiple of 128) at 65 rows.
FUSED_EDGES = [(1, 1, 384, 6), (1, 63, 384, 6), (1, 64, 384, 6), (1, 65, 384, 6),
               (1, 65, 96, 3), (1, 65, 1408, 16)]
# Kernel 6's three launches, by substrings of their kernels' names.
FUSED_ATTN_PARTS = {"qkv": "fused_attn_block_qkv", "attention": "attention_fwd_sm90",
                    "proj": "fused_attn_block_proj"}
# Kernels 7 and 8: (rows, C) with hidden 4C: 8 and 192 views of ViT-S, and
# ViT-G width on 2 views.
MLP_TOL = 0.02
MLP_SHAPES = [(8 * 261, 384), (192 * 261, 384), (2 * 261, 1408)]
# Their ragged edges, (rows, C): the 64- and 128-row blocks at ViT-S width,
# the serving rows, ViT-T's 192 and 200 (a K box wholly past K in the last
# stage of fc1, hidden and fc2).
MLP_EDGES = [(1, 384), (63, 384), (64, 384), (65, 384), (127, 384), (129, 384), (32 * 261, 384),
             (65, 192), (65, 200)]
FUSED_WARMUP, FUSED_STEPS = 3, 10
# The head-major pair (kernels 4 and 5), (b, heads, n, hd): the JAX check's
# unpacked shape, the bring-up gate's, the ViT-S training shape, the MAE
# decoder's hd 32, ViT-G's hd 88, and an N past the TPU kernel's 1024.
MHA_SHAPES = [(4, 6, 261, 64), (8, 8, 1024, 64), (192, 6, 261, 64), (2, 16, 257, 32),
              (2, 16, 261, 88), (1, 2, 1500, 64)]
MHA_CHECK_SHAPE, MHA_VALIDATE_SHAPE, MHA_TRAINING_SHAPE = MHA_SHAPES[:3]
# The forward tile core's ragged edges, (n, hd), for kernels 1 and 4 at two
# heads of batch 2: one key, the 64-row tile boundaries, a 16- and a 32-key
# tail, and N past the TPU kernel's 1024.
FWD_EDGES = [(1, 32), (63, 64), (64, 88), (65, 64), (90, 32), (129, 88), (1500, 64)]
# The backward tile core's ragged edges, N x hd, for both pairs at two heads
# of batch 2: the edges of the 64-row tiles and of the 16/32/64-row tail on
# both axes, the ViT N and two past the TPU kernel's 1024.
BWD_EDGE_N = (1, 8, 63, 64, 65, 128, 129, 261, 1024, 1500)
BWD_EDGE_HD = (32, 64, 88)
VALIDATE_LAUNCHES = 11  # the gate's first call and 10 steady calls
# Device kernels grouped by what they do, by substrings of their names.
KERNEL_KINDS = [
    ("attention forward kernel", ("attention_fwd_sm90",)),
    ("attention backward dq kernel", ("attention_bwd_sm90_dq",)),
    ("attention backward dkv kernel", ("attention_bwd_sm90_dkv",)),
    ("fused attention half-block kernel (LN + QKV and proj launches)", ("fused_attn_block",)),
    *((f"fused MLP forward kernel, {p} launch", (f"fused_mlp_fwd_{p}",)) for p in fm.FWD_PARTS),
    *((f"fused MLP backward kernel, {p} launch", (f"fused_mlp_bwd_{p}",)) for p in fm.BWD_PARTS),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer/EMA (multi-tensor)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("dtype casts", ("copy_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
]


# In the fused step the attention forward launches are kernel 6's second
# launch (kernel 1's core on the qkv of its first).
FUSED_KERNEL_KINDS = [("fused attention half-block kernel, attention launch (kernel 1's core)",
                       ("attention_fwd_sm90",))] + KERNEL_KINDS[1:]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Each wrapper that launches a kernel, by the name its count goes under.
COUNTERS = {
    "packed_attention": fa.flash_attention_packed,
    "packed_attention_bwd_dq": fa.packed_attention_bwd_dq,
    "packed_attention_bwd_dkv": fa.packed_attention_bwd_dkv,
    "fused_attn_block": fab.fused_attn_block,
    **{f"fused_mlp_fwd_{p}": fn for p, fn in fm.FWD_LAUNCHES.items()},
    **{f"fused_mlp_bwd_{p}": fn for p, fn in fm.BWD_LAUNCHES.items()},
    "mha_attention": fa.flash_attention,
    "mha_attention_bwd_dq": fa.mha_attention_bwd_dq,
    "mha_attention_bwd_dkv": fa.mha_attention_bwd_dkv,
}
MLP_FWD_PARTS = tuple(f"fused_mlp_fwd_{p}" for p in fm.FWD_PARTS)
MLP_BWD_PARTS = tuple(f"fused_mlp_bwd_{p}" for p in fm.BWD_PARTS)


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


def stream_ms(fn, iters: int = 50) -> float:
    """Mean time of one call among *iters* launched back to back with no wait
    between them (CUDA events around the run): the kernel's time on the card
    without the host's time to start one call, which median_ms includes."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def what_sets_the_time(name: str, occ: dict[str, int], where: str, ms: float, device_ms: float,
                       moved: float, flops: float, bound: tuple[float, str],
                       issued: float | None = None) -> None:
    """Prints the occupancy *occ* of a kernel (fa.forward_occupancy or
    fa.backward_occupancy) and its achieved rates beside its bound."""
    extra = (f" ({issued / device_ms / 1e9:.1f} TFLOP/s of the {issued / 1e9:.2f} GFLOP issued)"
             if issued else "")
    print(f"{name} at {where}: {occ['registers']} registers per thread, {occ['smem_bytes']} B of "
          f"shared memory per CTA, {occ['ctas_per_sm']} resident CTAs per SM; {ms:.4f} ms per "
          f"call, {device_ms:.4f} ms "
          f"back to back: {flops / device_ms / 1e9:.1f} TFLOP/s{extra} and "
          f"{moved / device_ms / 1e9:.3f} TB/s, {100 * bound[0] / device_ms:.1f}% of the "
          f"{bound[0]:.4f} ms bound ({bound[1]})", flush=True)


def check_kernels() -> tuple[float, float]:
    """Kernel 1 at CHECK_SHAPES, then kernels 1 and 4 at FWD_EDGES, each
    shape and edge run twice for equal bits. Returns the worst error of each
    kernel."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for b, n, three_dim, heads in CHECK_SHAPES:
        qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
        got, again = (flash_attention_packed(qkv, heads) for _ in range(2))
        torch.cuda.synchronize()
        err = (got.float() - packed_attention_reference(qkv, heads).float()).abs().max().item()
        same = torch.equal(got, again)
        print(f"kernel check packed_attention b={b} n={n} dim={three_dim // 3} heads={heads}: "
              f"max_abs_err={err:.3e} (tol {TOL}); two runs bit-equal: {same}", flush=True)
        if not np.isfinite(err) or err >= TOL or not same:
            fail(f"packed_attention disagrees with its plain version at {(b, n, three_dim, heads)}")
        worst = max(worst, err)
    worst_mha = 0.0
    for n, hd in FWD_EDGES:
        qkv = torch.randn((2, n, 6 * hd), generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = mha_inputs((2, 2, n, hd), 3, g)
        runs1 = [flash_attention_packed(qkv, 2) for _ in range(2)]
        runs4 = [fa.flash_attention(q, k, v) for _ in range(2)]
        torch.cuda.synchronize()
        err1 = (runs1[0].float() - packed_attention_reference(qkv, 2).float()).abs().max().item()
        err4 = (runs4[0].float() - fa.mha_attention_reference(q, k, v).float()).abs().max().item()
        same = torch.equal(*runs1) and torch.equal(*runs4)
        print(f"kernel check forward edge n={n} hd={hd}: packed_attention max_abs_err={err1:.3e}, "
              f"mha_attention max_abs_err={err4:.3e} (tol {TOL}); two runs bit-equal: {same}",
              flush=True)
        if not np.isfinite([err1, err4]).all() or max(err1, err4) >= TOL or not same:
            fail(f"a forward kernel disagrees with its plain version at the edge n={n} hd={hd}")
        worst, worst_mha = max(worst, err1), max(worst_mha, err4)
    return worst, worst_mha


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
    """The dq + dkv pair against the plain backward at BWD_SHAPES, each shape
    twice for equal bits. Returns the worst error of the dq slots and of the
    dk/dv slots."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst_dq = worst_dkv = 0.0
    for b, n, three_dim, heads in BWD_SHAPES:
        dim = three_dim // 3
        qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
        do = torch.randn((b, n, dim), generator=g, device="cuda").to(torch.bfloat16)
        got, again = (fa.packed_attention_backward(qkv, do, heads) for _ in range(2))
        torch.cuda.synchronize()
        want = fa.packed_attention_backward_reference(qkv, do, heads).float()
        diff = (got.float() - want).abs()
        err_dq, err_dkv = diff[..., :dim].max().item(), diff[..., dim:].max().item()
        err = max(err_dq, err_dkv)
        rel = err / want.abs().max().item()
        bit_equal = (got.float() == want).float().mean().item()
        same = torch.equal(got, again)
        print(f"kernel check packed_attention backward b={b} n={n} dim={dim} heads={heads}: "
              f"max_abs_err={err:.3e} (tol {BWD_TOL}; dq {err_dq:.3e}, dk/dv {err_dkv:.3e}), "
              f"max_abs_err/max|want|={rel:.3e} (tol {BWD_REL}), bit-equal {bit_equal:.5f}; two "
              f"runs bit-equal: {same}", flush=True)
        if not np.isfinite(err) or err >= BWD_TOL or rel >= BWD_REL or not same:
            fail(f"the backward pair disagrees with its plain version at {(b, n, three_dim, heads)}")
        worst_dq, worst_dkv = max(worst_dq, err_dq), max(worst_dkv, err_dkv)
    return worst_dq, worst_dkv


def check_backward_edges() -> tuple[float, float]:
    """Both backward pairs of the tile core at BWD_EDGE_N x BWD_EDGE_HD (batch
    2, two heads): each within BWD_TOL and BWD_REL of the plain backward (at
    N = 1 dq is exactly 0), twice with equal bits, and kernel 5 bit-equal to
    kernel 2 on the same data laid out packed. Returns the worst error of
    kernel 2's and of kernel 5's gradients."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)
    worst2 = worst5 = 0.0
    for n in BWD_EDGE_N:
        for hd in BWD_EDGE_HD:
            q, k, v, do = mha_inputs((2, 2, n, hd), 4, g)
            qkv = torch.cat([to_tokens(t) for t in (q, k, v)], -1)
            do_tokens = to_tokens(do).contiguous()
            runs2 = [fa.packed_attention_backward(qkv, do_tokens, 2) for _ in range(2)]
            runs5 = [fa.mha_attention_backward(q, k, v, do) for _ in range(2)]
            torch.cuda.synchronize()
            want = fa.mha_attention_backward_reference(q, k, v, do)
            errs2 = [(a.float() - w.float()).abs().max().item()
                     for a, w in zip(runs2[0].chunk(3, dim=-1), (to_tokens(t) for t in want))]
            errs5 = [(a.float() - w.float()).abs().max().item() for a, w in zip(runs5[0], want)]
            tops = [w.float().abs().max().item() for w in want]
            rel = max(e / t if t else (0.0 if e == 0 else np.inf)
                      for e, t in zip(errs2 + errs5, tops + tops))
            same = (torch.equal(*runs2) and all(torch.equal(a, b) for a, b in zip(*runs5)))
            same25 = torch.equal(runs2[0], torch.cat([to_tokens(t) for t in runs5[0]], -1))
            print(f"kernel check backward edge n={n} hd={hd}: kernel 2 max_abs_err "
                  f"{max(errs2):.3e}, kernel 5 {max(errs5):.3e} (tol {BWD_TOL}), worst "
                  f"max_abs_err/max|want| {rel:.3e} (tol {BWD_REL}); two runs bit-equal: {same}; "
                  f"kernel 5 bit-equal to kernel 2: {same25}", flush=True)
            if not np.isfinite(errs2 + errs5).all() or max(errs2 + errs5) >= BWD_TOL or rel > BWD_REL:
                fail(f"a backward pair disagrees with the plain backward at the edge n={n} hd={hd}")
            if not same or not same25:
                fail(f"the backward pairs' bits are not repeatable or not equal at n={n} hd={hd}")
            worst2, worst5 = max(worst2, *errs2), max(worst5, *errs5)
    return worst2, worst5


def padded_rows(n: int) -> int:
    """Rows the backward core multiplies on its looped axis (keys in dq,
    queries in dkv): 64-row tiles, the last at the narrowest of 16, 32 or 64
    rows that covers N (272 at N = 261)."""
    full, rem = divmod(n, 64)
    return 64 * full + (next(w for w in (16, 32, 64) if w >= rem) if rem else 0)


def bwd_issued_flops(b: int, n: int, heads: int, hd: int) -> tuple[float, float]:
    """Operations the backward core's tiles issue, (dq kernel, dkv kernel):
    5 and 4 products of (the CTA's rows, padded to 64) x padded_rows(N) x
    (hd padded to 32)."""
    one = 2.0 * b * heads * (-(-n // 64) * 64) * padded_rows(n) * (-(-hd // 32) * 32)
    return 5 * one, 4 * one


def what_sets_the_pairs_time(name: str, b: int, n: int, heads: int, hd: int, per_call: dict,
                             device: dict, peaks: tuple[float, float]) -> dict[str, tuple]:
    """what_sets_the_time for the dq and the dkv kernel of the backward pair
    csrc/<name>.cu, each alone: dq reads q, k, v and dO and writes dq and the
    (m, l, D) statistics (S, dP, dQ); dkv reads q, k, v, dO and the
    statistics and writes dk and dv (S^T, dP^T, dV, dK). Returns each
    kernel's bound."""
    elems, stats_bytes = b * n * heads * hd, 3 * 4 * b * heads * n
    flops = 2.0 * b * heads * n * n * hd  # one (n, n, hd) product
    issued = bwd_issued_flops(b, n, heads, hd)
    work = {"dq": (5 * 2 * elems + stats_bytes, 3 * flops, issued[0]),
            "dkv": (6 * 2 * elems + stats_bytes, 4 * flops, issued[1])}
    bounds = {}
    for part, (moved, ops, iss) in work.items():
        bounds[part] = bound_ms(moved, ops, peaks)
        what_sets_the_time(f"{name} {part}", fa.backward_occupancy(name, hd, part), f"{(b, n, heads, hd)}",
                           per_call[part], device[part], moved, ops, bounds[part], issued=iss)
    return bounds


def mha_inputs(shape: tuple[int, ...], count: int, gen: torch.Generator) -> list[torch.Tensor]:
    return [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(count)]


def to_tokens(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> token-major (B, N, H*hd)."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def check_mha() -> tuple[float, float]:
    """Kernel 4 against its plain version and kernel 5 against the plain
    backward at MHA_SHAPES, kernel 5 bit-equal to kernel 2 on the same data
    laid out packed, and sdpa(impl="pallas") one launch of kernel 4 per call.
    Returns the worst forward and backward errors."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    worst_f = worst_b = 0.0
    for shape in MHA_SHAPES:
        heads = shape[1]
        q, k, v, do = mha_inputs(shape, 4, g)
        out = fa.flash_attention(q, k, v)
        grads = fa.mha_attention_backward(q, k, v, do)
        packed = fa.packed_attention_backward(torch.cat([to_tokens(t) for t in (q, k, v)], -1),
                                              to_tokens(do).contiguous(), heads)
        torch.cuda.synchronize()
        err = (out.float() - fa.mha_attention_reference(q, k, v).float()).abs().max().item()
        want = fa.mha_attention_backward_reference(q, k, v, do)
        abs_errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(grads, want)]
        rels = [e / w.float().abs().max().item() for e, w in zip(abs_errs, want)]
        same = torch.equal(packed, torch.cat([to_tokens(t) for t in grads], -1))
        print(f"kernel check mha_attention {shape}: forward max_abs_err {err:.3e} (tol {TOL}); "
              f"backward max_abs_err/max|want| dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv "
              f"{rels[2]:.3e} (tol {BWD_REL}), max_abs_err {max(abs_errs):.3e}; bit-equal to the "
              f"packed pair (kernel 2): {same}", flush=True)
        if not np.isfinite(err) or err >= TOL:
            fail(f"mha_attention disagrees with its plain version at {shape}")
        if not np.isfinite(rels).all() or max(rels) >= BWD_REL:
            fail(f"the head-major backward disagrees with its plain version at {shape}")
        if not same:
            fail(f"the head-major backward and the packed one give different bits at {shape}")
        worst_f, worst_b = max(worst_f, err), max(worst_b, *abs_errs)
    q, k, v = mha_inputs(MHA_CHECK_SHAPE, 3, g)
    before = fa.flash_attention.launches
    outs = [sdpa(q, k, v, impl="pallas") for _ in range(3)]
    launched = fa.flash_attention.launches - before
    print(f"sdpa(impl='pallas') on the card: {launched} launches of mha_attention in 3 calls",
          flush=True)
    if launched != 3 or not all(torch.equal(o, outs[0]) for o in outs):
        fail("sdpa(impl='pallas') did not launch kernel 4 exactly once per call")
    return worst_f, worst_b


def mha_path() -> dict[str, int]:
    """This slice's path as its users call it, with the counts set to 0 just
    before and read just after: the bring-up gate at its defaults
    (VALIDATE_LAUNCHES of kernel 4), then a gradient of sum(out^2) through
    sdpa(impl="pallas") at the unpacked check shape (kernel 4 once, each of
    kernel 5's launches once), held against autograd through the plain
    version within BWD_REL of each largest gradient. Returns the counts."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    leaves = [t.requires_grad_(True) for t in mha_inputs(MHA_CHECK_SHAPE, 3, g)]
    reset_launch_counts()
    rc = validate_attention.main([])
    (sdpa(*leaves, impl="pallas").float() ** 2).sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    (fa.mha_attention_reference(*plain).float() ** 2).sum().backward()
    rels = [(t.grad.float() - p.grad.float()).abs().max().item() / p.grad.float().abs().max().item()
            for t, p in zip(leaves, plain)]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(mha_attention=VALIDATE_LAUNCHES + 1, mha_attention_bwd_dq=1, mha_attention_bwd_dkv=1)
    print(f"head-major path: validate_attention.main([]) returned {rc}; gradient of sum(out^2) "
          f"through sdpa(impl='pallas') at {MHA_CHECK_SHAPE} against the plain autograd: "
          f"max_abs_err/max|want| dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} (tol "
          f"{BWD_REL}); launches {counts} (want {want})", flush=True)
    if rc != 0:
        fail("the bring-up gate (dinox_torch.validate_attention) failed")
    if not np.isfinite(rels).all() or max(rels) >= BWD_REL:
        fail("the gradient through sdpa(impl='pallas') disagrees with the plain autograd")
    if counts != want:
        fail("the head-major path did not run through kernels 4 and 5 as counted")
    return counts


def time_mha(peaks: tuple[float, float]) -> dict[str, dict]:
    """Kernel 4 at the bring-up and training shapes and kernel 5 at the
    training shape, each beside its plain version, its bound and the library
    call on the same (B, H, N, hd) tensors (F.scaled_dot_product_attention,
    forward and backward: a yardstick the port never calls)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    out: dict[str, dict] = {}
    for label, shape in (("validate", MHA_VALIDATE_SHAPE), ("training", MHA_TRAINING_SHAPE)):
        b, h, n, hd = shape
        q, k, v = mha_inputs(shape, 3, g)
        kern = median_ms(lambda: fa.flash_attention(q, k, v))
        device_ms = stream_ms(lambda: fa.flash_attention(q, k, v))
        plain = median_ms(lambda: fa.mha_attention_reference(q, k, v), iters=10)
        lib = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        moved, flops = attention_fwd_work(b, n, h * hd, h)
        bound = bound_ms(moved, flops, peaks)
        print(f"mha_attention forward at {shape} ({label}): {kern:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {plain:.4f} ms, "
              f"SDPA {lib:.4f} ms", flush=True)
        # Two passes: Q K^T twice and P V once, 1.5x the bound's operations.
        what_sets_the_time("mha_attention", fa.forward_occupancy("mha_attention", hd),
                           f"{shape} ({label})", kern, device_ms, moved, flops, bound,
                           issued=1.5 * flops)
        out[label] = {"shape": list(shape), "ms": kern, "plain_ms": plain, "library_ms": lib,
                      "bound": bound, "device_ms": device_ms}
    b, h, n, hd = MHA_TRAINING_SHAPE
    q, k, v, do = mha_inputs(MHA_TRAINING_SHAPE, 4, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((b * h, 3, n), dtype=torch.float32, device="cuda")
    fa.mha_attention_bwd_dq(q, k, v, do, dq, stats)
    calls = {"mha_attention_bwd_dq": lambda: fa.mha_attention_bwd_dq(q, k, v, do, dq, stats),
             "mha_attention_bwd_dkv": lambda: fa.mha_attention_bwd_dkv(q, k, v, do, stats, dk, dv)}
    parts = {name: median_ms(fn) for name, fn in calls.items()}
    parts_device = {name: stream_ms(fn) for name, fn in calls.items()}
    pair = median_ms(lambda: fa.mha_attention_backward(q, k, v, do))
    pair_device = stream_ms(lambda: fa.mha_attention_backward(q, k, v, do))
    plain = median_ms(lambda: fa.mha_attention_backward_reference(q, k, v, do), iters=10)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves)
    lib = median_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    lib_device = stream_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    moved, flops = attention_bwd_work(b, n, h * hd, h)
    bound = bound_ms(moved, flops, peaks)
    print(f"mha_attention backward at {MHA_TRAINING_SHAPE}: pair {pair:.4f} ms (dq "
          f"{parts['mha_attention_bwd_dq']:.4f} + dkv {parts['mha_attention_bwd_dkv']:.4f}), "
          f"{pair_device:.4f} ms back to back (dq {parts_device['mha_attention_bwd_dq']:.4f} + dkv "
          f"{parts_device['mha_attention_bwd_dkv']:.4f}), bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); plain {plain:.4f} ms; SDPA backward "
          f"{lib:.4f} ms, {lib_device:.4f} ms back to back", flush=True)
    what_sets_the_pairs_time("mha_attention_bwd", b, n, h, hd,
                             {part: parts[f"mha_attention_bwd_{part}"] for part in ("dq", "dkv")},
                             {part: parts_device[f"mha_attention_bwd_{part}"] for part in ("dq", "dkv")},
                             peaks)
    out["backward"] = {"shape": list(MHA_TRAINING_SHAPE), "ms": pair, "plain_ms": plain,
                       "library_ms": lib, "bound": bound, "parts": parts, "device_ms": pair_device,
                       "library_device_ms": lib_device, "parts_device_ms": parts_device}
    return out


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
    compare_micro_steps(states, cfgs, views, spacing, "ViT-S scale-aware bs8, " + label)


def compare_micro_steps(states: list, cfgs: list, views: torch.Tensor, spacing: torch.Tensor,
                        label: str) -> None:
    """micro_loss_and_grads of two states (the one under test first) on the
    same (n_views, B, S, S, 3) views: the losses within 1e-2 relative and
    every gradient that is not zero in both at cosine >= 0.99."""
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
    print(f"training micro-step, {label}: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, tol 1e-2); gradient cosine min "
          f"{cos[worst]:.6f} ({worst}) over {len(cos)} tensors, {len(skipped)} skipped as zero "
          f"in both {skipped}", flush=True)
    if not np.isfinite(loss_k) or rel > 1e-2 or cos[worst] < 0.99:
        fail(f"the training step ({label}) disagrees")


def report_training(res: dict, cfg, card: str, steps: int, kinds: list = KERNEL_KINDS) -> None:
    """Rate, MFU, busy share and device time by *kinds* of a bench_train_step
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
        kind = next((k for k, keys in kinds if any(w in item["name"] for w in keys)), "other")
        acc = by_kind.setdefault(kind, [0.0, 0])
        acc[0] += item["ms"]
        acc[1] += item["count"]
    print("  by kind: " + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in
                                    sorted(by_kind.items(), key=lambda kv: -kv[1][0])), flush=True)


def train(card: str) -> tuple[dict[str, int], float]:
    """The training path at full width: bench_train_step(96), tanh arm, with
    exact launch counts. Returns the counts of this run and its slices/s."""
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
    return counts, res["slices_per_s"]


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
    want.update(fused_attn_block=steps * 2 * d, packed_attention_bwd_dq=steps * d,
                packed_attention_bwd_dkv=steps * d, **{part: steps * 2 * d for part in MLP_FWD_PARTS},
                **{part: steps * d for part in MLP_BWD_PARTS})
    print(f"trained {steps} steps of ViT-S scale-aware bs{TRAIN_BATCH}, exact GELU, fused_attn + "
          f"fused_mlp: losses {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, all finite; "
          f"launches {counts} (want {want}: kernel 6 and each of kernel 7's two launches 2 x "
          f"depth, each of kernel 8's six and dq/dkv depth, packed forward 0, per step)", flush=True)
    if counts != want:
        fail("the fused training step did not run every half-block through the kernels exactly once")
    report_training(res, cfg, card, FUSED_STEPS, FUSED_KERNEL_KINDS)
    return counts


def time_forward(peaks: tuple[float, float], shape: tuple[int, int, int, int], label: str,
                 seed: int) -> dict:
    """Kernel 1's time at *shape*, its plain version's, the library call's
    (SDPA on the head-major views of the same qkv), its bound, and what sets
    its time."""
    b, n, three_dim, heads = shape
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    kern_ms = median_ms(lambda: flash_attention_packed(qkv, heads))
    device_ms = stream_ms(lambda: flash_attention_packed(qkv, heads))
    plain_ms = median_ms(lambda: packed_attention_reference(qkv, heads), iters=10)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    moved, flops = attention_fwd_work(b, n, dim, heads)
    bound = bound_ms(moved, flops, peaks)
    print(f"packed_attention forward at {shape} ({label}): {kern_ms:.4f} ms, bound {bound[0]:.4f} "
          f"ms ({bound[1]}: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} "
          f"ms, SDPA {lib_ms:.4f} ms", flush=True)
    what_sets_the_time("packed_attention", fa.forward_occupancy("packed_attention", hd),
                       f"{shape} ({label})", kern_ms, device_ms, moved, flops, bound)
    return {"shape": list(shape), "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound": bound, "device_ms": device_ms}


def time_backward(peaks: tuple[float, float], shape: tuple[int, int, int, int] = TRAINING_SHAPE
                  ) -> dict[str, dict]:
    """The packed pair at *shape*: held against the plain backward on the
    inputs it is timed on, then the times of the pair, of each kernel and of
    SDPA's backward, per call and back to back, the plain backward's, the
    bounds, and what sets each kernel's time."""
    b, n, three_dim, heads = shape
    dim, hd = three_dim // 3, three_dim // 3 // heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, dim), generator=g, device="cuda").to(torch.bfloat16)
    got = fa.packed_attention_backward(qkv, do, heads)
    torch.cuda.synchronize()
    want = fa.packed_attention_backward_reference(qkv, do, heads).float()
    err = (got.float() - want).abs().max().item()
    rel = err / want.abs().max().item()
    print(f"kernel check packed_attention backward at {shape} on the timed inputs: max_abs_err "
          f"{err:.3e} (tol {BWD_TOL}), max_abs_err/max|want| {rel:.3e} (tol {BWD_REL})", flush=True)
    if not np.isfinite(err) or err >= BWD_TOL or rel >= BWD_REL:
        fail(f"the backward pair disagrees with its plain version on the timed inputs at {shape}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b * heads, 3, n), dtype=torch.float32, device="cuda")
    fa.packed_attention_bwd_dq(qkv, do, heads, dqkv, stats)
    calls = {"dq": lambda: fa.packed_attention_bwd_dq(qkv, do, heads, dqkv, stats),
             "dkv": lambda: fa.packed_attention_bwd_dkv(qkv, do, heads, stats, dqkv),
             "pair": lambda: fa.packed_attention_backward(qkv, do, heads)}
    per_call = {name: median_ms(fn) for name, fn in calls.items()}
    device = {name: stream_ms(fn) for name, fn in calls.items()}
    plain_ms = median_ms(lambda: fa.packed_attention_backward_reference(qkv, do, heads), iters=10)
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0))
    out = F.scaled_dot_product_attention(q, k, v)
    go = do.view(b, n, heads, hd).transpose(1, 2)
    lib_ms = median_ms(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True))
    lib_device = stream_ms(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True))
    moved, flops = attention_bwd_work(b, n, dim, heads)
    pair_bound = bound_ms(moved, flops, peaks)
    issued = bwd_issued_flops(b, n, heads, hd)
    print(f"packed attention backward at {shape}: pair {per_call['pair']:.4f} ms (dq "
          f"{per_call['dq']:.4f} + dkv {per_call['dkv']:.4f}), {device['pair']:.4f} ms back to back "
          f"(dq {device['dq']:.4f} + dkv {device['dkv']:.4f}), bound {pair_bound[0]:.4f} ms "
          f"({pair_bound[1]}: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; the tiles issue "
          f"{sum(issued) / 1e9:.2f}: {flops / device['pair'] / 1e9:.1f} TFLOP/s, "
          f"{sum(issued) / device['pair'] / 1e9:.1f} issued, {moved / device['pair'] / 1e9:.3f} "
          f"TB/s back to back); plain {plain_ms:.4f} ms; SDPA backward {lib_ms:.4f} ms, "
          f"{lib_device:.4f} ms back to back", flush=True)
    bounds = what_sets_the_pairs_time("packed_attention_bwd", b, n, heads, hd, per_call, device, peaks)
    return {"dq": {"ms": per_call["pair"], "device_ms": device["pair"], "plain_ms": plain_ms,
                   "bound": pair_bound, "library_ms": lib_ms, "library_device_ms": lib_device},
            "dkv": {"ms": per_call["dkv"], "device_ms": device["dkv"], "plain_ms": plain_ms,
                    "bound": bounds["dkv"], "library_ms": lib_ms, "library_device_ms": lib_device}}


def check_fused_attn() -> float:
    """Kernel 6 against its plain version at FUSED_ATTN_SHAPES and
    FUSED_EDGES, all three outputs (y, qkv, attn), inputs at the JAX check's
    scales: each shape twice with equal bits, and attn bit-equal to kernel 1
    on the kernel's own qkv. Returns the worst error."""
    worst = 0.0
    for i, (b, n, dim, heads) in enumerate(FUSED_ATTN_SHAPES + FUSED_EDGES):
        args = fused_block_inputs(b, n, dim, torch.device("cuda"), seed=SEED + 10 + i)
        got, again = (fab.fused_attn_block_forward(*args, heads) for _ in range(2))
        torch.cuda.synchronize()
        want = fab.fused_attn_block_reference(*args, heads)
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        as_kernel_1 = torch.equal(got[2], flash_attention_packed(got[1], heads))
        print(f"kernel check fused_attn_block b={b} n={n} dim={dim} heads={heads}: max_abs_err "
              f"y {errs[0]:.3e}, qkv {errs[1]:.3e}, attn {errs[2]:.3e} (tol {FUSED_TOL}); two runs "
              f"bit-equal: {same}; attn bit-equal to kernel 1 on its qkv: {as_kernel_1}", flush=True)
        if not np.isfinite(errs).all() or max(errs) >= FUSED_TOL:
            fail(f"fused_attn_block disagrees with its plain version at {(b, n, dim, heads)}")
        if not same or not as_kernel_1:
            fail(f"fused_attn_block's bits are not repeatable or not kernel 1's at {(b, n, dim, heads)}")
        worst = max(worst, *errs)
    return worst


def launch_parts_ms(fn, keys: dict[str, str], label: str, calls: int = 20) -> dict[str, float]:
    """Device ms of each launch of a multi-launch kernel: for every part of
    *keys* (part: substring of its kernel's name), the mean over the
    launches that torch.profiler recorded in *calls* calls of *fn*."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part, key in keys.items():
        events = [e for e in prof.key_averages() if key in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in events)  # the trace may miss a launch at its start
        if not calls // 2 <= count <= calls:
            fail(f"the profile of {calls} {label} calls holds {count} launches of {key}")
        out[part] = sum(e.self_device_time_total for e in events) / count / 1e3
    return out


def what_sets_kernel_6s_time(b: int, n: int, dim: int, heads: int, args: tuple, label: str,
                             peaks: tuple[float, float]) -> dict:
    """Kernel 6's back-to-back time, each launch's device time beside its own
    bound with its achieved rates, and the GEMM launches' occupancy and
    grid split. Returns {"device_ms", "parts": {part: {"ms", "bound_ms"}}}."""
    device_ms = stream_ms(lambda: fab.fused_attn_block_forward(*args, heads))
    parts_ms = launch_parts_ms(lambda: fab.fused_attn_block_forward(*args, heads), FUSED_ATTN_PARTS,
                               "kernel 6")
    work = fused_attn_parts_work(b, n, dim, heads)
    parts = {}
    for part, ms in parts_ms.items():
        moved, flops = work[part]
        bound = bound_ms(moved, flops, peaks)
        if part == "attention":
            occ, split = fa.forward_occupancy("packed_attention", dim // heads), "kernel 1's grid"
        else:
            occ = fab.fused_attn_block_occupancy(part, dim)
            grid = fab.fused_attn_block_grid(part, b * n, dim)
            split = (f"grid {grid['row_blocks']} row blocks x {grid['column_groups']} column "
                     f"groups of {grid['tiles_per_cta']} tiles")
        print(f"fused_attn_block launch {part} at {(b, n, dim, heads)} ({label}): {ms:.4f} ms "
              f"device, bound {bound[0]:.4f} ms ({bound[1]}: {moved / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), {100 * bound[0] / ms:.1f}% of it; "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {moved / ms / 1e9:.3f} TB/s; "
              f"{occ['registers']} registers, {occ['smem_bytes']} B of shared memory per CTA, "
              f"{occ['ctas_per_sm']} CTAs per SM; {split}", flush=True)
        parts[part] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
    total = sum(p["ms"] for p in parts.values())
    moved, flops = fused_attn_work(b, n, dim, heads)
    print(f"fused_attn_block at {(b, n, dim, heads)} ({label}): {device_ms:.4f} ms back to back "
          f"({total:.4f} ms in its three launches; bound {bound_ms(moved, flops, peaks)[0]:.4f} ms "
          f"fused, {sum(p['bound_ms'] for p in parts.values()):.4f} ms by launch): "
          f"{flops / device_ms / 1e9:.1f} TFLOP/s, {moved / device_ms / 1e9:.3f} TB/s", flush=True)
    return {"device_ms": device_ms, "parts": parts}


def check_fused_mlp() -> tuple[float, float]:
    """Kernel 7's two launches against the plain forward and kernel 8's six
    against the plain backward at MLP_SHAPES and MLP_EDGES, each twice for
    equal bits. Returns the worst forward error and the worst backward
    error."""
    worst_f = worst_b = 0.0
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for i, (rows, c) in enumerate(MLP_SHAPES + MLP_EDGES):
        args, dy = fused_mlp_inputs(rows, c, torch.device("cuda"), SEED + 20 + i)
        fwd = [fm.fused_mlp_forward(*args) for _ in range(2)]
        torch.cuda.synchronize()
        err = (fwd[0].float() - fm.fused_mlp_forward_reference(*args).float()).abs().max().item()
        runs = [fm.fused_mlp_backward(*args[:6], dy) for _ in range(2)]
        torch.cuda.synchronize()
        same = torch.equal(*fwd) and all(torch.equal(a, b) for a, b in zip(*runs))
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
        if not np.isfinite(rels).all() or max(rels) >= BWD_REL:
            fail(f"fused_mlp backward disagrees with its plain version at {(rows, c)}")
        if not same:
            fail(f"fused_mlp's bits are not repeatable at {(rows, c)}")
        worst_f, worst_b = max(worst_f, err), max(worst_b, *abs_errs)
    return worst_f, worst_b


def what_sets_mlp_time(kind: str, fn, work: dict, shape: tuple[int, int, int],
                       peaks: tuple[float, float]) -> dict[str, dict]:
    """Each launch of kernel 7 (*kind* "fwd") or 8 ("bwd") in calls of *fn*:
    its device time (torch.profiler) beside its own bound in *work* (part:
    (bytes, flops)), achieved TFLOP/s and TB/s, registers, shared memory and
    CTAs per SM. Returns {part: {"ms", "bound_ms", "bound_by"}}."""
    parts = fm.FWD_PARTS if kind == "fwd" else fm.BWD_PARTS
    parts_ms = launch_parts_ms(fn, {p: f"fused_mlp_{kind}_{p}" for p in parts}, f"kernel {kind}")
    out = {}
    for part, ms in parts_ms.items():
        moved, flops = work[part]
        bound = bound_ms(moved, flops, peaks)
        occ = fm.fused_mlp_occupancy(part, shape[1])
        print(f"fused_mlp {kind} launch {part} at {shape}: {ms:.4f} ms device, bound "
              f"{bound[0]:.4f} ms ({bound[1]}: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{100 * bound[0] / ms:.1f}% of it; {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{moved / ms / 1e9:.3f} TB/s; {occ['registers']} registers, {occ['smem_bytes']} B "
              f"of shared memory per CTA, {occ['ctas_per_sm']} CTAs per SM", flush=True)
        out[part] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
    return out


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
                                "shape": [b, n, dim, heads],
                                **what_sets_kernel_6s_time(b, n, dim, heads, args, label, peaks)}
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
    shape = (rows, c, hidden)
    args, dy = fused_mlp_inputs(rows, c, dev, SEED + 31)
    norm, mlp = LayerNorm(c, torch.bfloat16).to(dev), Mlp(c, hidden, gelu_approx=False).to(dev)
    with torch.no_grad():
        for p, v in zip((norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                         mlp.fc2.bias), args[1:]):
            p.copy_(v.float())
        kern = median_ms(lambda: fm.fused_mlp_forward(*args))
        device_ms = stream_ms(lambda: fm.fused_mlp_forward(*args))
        plain = median_ms(lambda: fm.fused_mlp_forward_reference(*args), iters=10)
        unfused = median_ms(lambda: args[0] + mlp(norm(args[0])))
    moved, flops = fused_mlp_fwd_work(*shape)
    bound = bound_ms(moved, flops, peaks)
    parts = what_sets_mlp_time("fwd", lambda: fm.fused_mlp_forward(*args),
                               fused_mlp_fwd_parts_work(*shape), shape, peaks)
    print(f"fused_mlp forward at {shape}: {kern:.4f} ms per call, {device_ms:.4f} ms back to back "
          f"({sum(p['ms'] for p in parts.values()):.4f} ms in its two launches), bound "
          f"{bound[0]:.4f} ms ({bound[1]}: {flops / 1e9:.2f} GFLOP) fused, "
          f"{sum(p['bound_ms'] for p in parts.values()):.4f} ms by launch: "
          f"{flops / device_ms / 1e9:.1f} TFLOP/s back to back; plain {plain:.4f} ms, unfused "
          f"composition {unfused:.4f} ms", flush=True)
    out["mlp_fwd"] = {"ms": kern, "device_ms": device_ms, "plain_ms": plain, "unfused_ms": unfused,
                      "bound": bound, "parts": parts}

    total = median_ms(lambda: fm.fused_mlp_backward(*args[:6], dy))
    device_ms = stream_ms(lambda: fm.fused_mlp_backward(*args[:6], dy), iters=20)
    plain = median_ms(lambda: fm.fused_mlp_backward_reference(*args[:6], dy), iters=5, warmup=2)
    xr = args[0].detach().requires_grad_(True)
    params = [xr] + list(norm.parameters()) + list(mlp.parameters())
    y = xr + mlp(norm(xr))
    unfused = median_ms(lambda: torch.autograd.grad(y, params, dy, retain_graph=True))
    moved, flops = fused_mlp_bwd_work(*shape)
    bound = bound_ms(moved, flops, peaks)
    chunks, per_chunk = fm.weight_chunks(rows, c, hidden)
    parts = what_sets_mlp_time("bwd", lambda: fm.fused_mlp_backward(*args[:6], dy),
                               fused_mlp_bwd_parts_work(*shape, chunks), shape, peaks)
    print(f"fused_mlp backward at {shape}: {total:.4f} ms per call, {device_ms:.4f} ms back to "
          f"back ({sum(p['ms'] for p in parts.values()):.4f} ms in its six launches; weights split "
          f"over {chunks} chunks of {per_chunk} rows), bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{flops / 1e9:.2f} GFLOP) fused, {sum(p['bound_ms'] for p in parts.values()):.4f} ms by "
          f"launch: {flops / device_ms / 1e9:.1f} TFLOP/s back to back; plain {plain:.4f} ms, "
          f"unfused composition (autograd) {unfused:.4f} ms", flush=True)
    out["mlp_bwd"] = {"ms": total, "device_ms": device_ms, "plain_ms": plain, "unfused_ms": unfused,
                      "bound": bound, "parts": parts, "chunks": chunks}
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


def read_metrics(run_dir: Path) -> dict[int, dict]:
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return {}
    return {r["step"]: r for r in map(json.loads, path.read_text().splitlines())}


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that receives (generation, seconds) for every pass of
    Python's cyclic garbage collector while the block runs."""
    pauses: list[tuple[int, float]] = []
    started = [0.0]

    def note(phase: str, info: dict) -> None:
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - started[0]))

    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def want_counts(**counts: int) -> dict[str, int]:
    want = dict.fromkeys(COUNTERS, 0)
    want.update(counts)
    return want


class _Tee(io.StringIO):
    """Standard output that is also kept, to read the CLI's closing lines."""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return super().write(text)


def run_cli(argv: list[str], label: str, main=pretrain.main, codes: tuple[int, ...] = (0,)
            ) -> tuple[float, str]:
    """A CLI's main (python -m dinox_torch.pretrain's by default) in this
    process; returns its wall seconds and what it printed. Fails the smoke
    test unless it returns one of *codes*."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee()) as out:
        rc = main(argv)
    torch.cuda.synchronize()
    if rc not in codes:
        fail(f"{main.__module__} {label} returned {rc}")
    return time.perf_counter() - t0, out.getvalue()


def write_tree(root: Path) -> Path:
    """A loader tree: TREE_SERIES series of TREE_SLICES 512^2 16-bit PNGs
    (HU from synth_series_np over the v2 profiles, stored as HU + 32768),
    written with write_png16, and its index CSV."""
    def series(s: int) -> list[IndexRow]:
        rng = np.random.default_rng([SEED, s])
        prof = PROFILES_V2[s % len(PROFILES_V2)]
        spacing = draw_spacing(prof, rng)
        vol = synth_series_np(prof, rng, TREE_SLICES, TREE_SIZE)
        (root / f"series{s:03d}").mkdir(parents=True)
        rows = []
        for z in range(TREE_SLICES):
            path = root / f"series{s:03d}" / f"{z:04d}.png"
            write_png16(path, np.clip(np.round(vol[z]) + HU_SHIFT, 0, 65535).astype(np.uint16), filters=z % 5)
            rows.append(IndexRow(png_path=str(path), series_dir=f"series{s:03d}", slice_index=z,
                                 spacing_x=spacing[0], spacing_y=spacing[1], spacing_z=spacing[2],
                                 dataset=prof.name))
        return rows

    with ThreadPoolExecutor(8) as pool:  # numpy and zlib release the GIL
        rows = [row for part in pool.map(series, range(TREE_SERIES)) for row in part]
    write_index_rows(rows, root / "index.csv")
    return root / "index.csv"


def pretrain_path(card: str, bench_rate: float, tmp: Path) -> dict[str, int]:
    """The pretraining path through python -m dinox_torch.pretrain at full
    width and depth: a straight run with exact launch counts, the same run
    interrupted by SIGINT and resumed (lr bit-equal, losses after the seam
    within RESUME_TOL), the --fused-attn path, and the host loader over a
    PNG tree. Leaves the straight run in tmp/straight and the tree in
    tmp/tree for the phases after it. Returns the launch counts of the
    straight run and, under "fused_attn_block", of the fused run."""
    depth = MODEL_CONFIGS["vit-small"].depth
    root = Path(__file__).resolve().parent
    # 1. Straight, in process.
    straight = tmp / "straight"
    reset_launch_counts()
    alloc0 = torch.cuda.memory_stats()
    # Metrics drained every 10 steps: steps 11-20 run before the first
    # save (at step 20, after that drain), steps 21-30 hold it.
    with gc_pauses() as pauses:
        wall, _ = run_cli(PRETRAIN_ARGS + ["--max-steps", str(PRETRAIN_STEPS), "--run-dir",
                                           str(straight), "--metric-flush-steps", "10",
                                           "--metric-flush-secs", "600"], "straight run")
    counts = launch_counts()
    alloc = {k: torch.cuda.memory_stats().get(k, 0) - alloc0.get(k, 0)
             for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}
    want = want_counts(packed_attention=PRETRAIN_STEPS * 2 * depth,
                       packed_attention_bwd_dq=PRETRAIN_STEPS * depth,
                       packed_attention_bwd_dkv=PRETRAIN_STEPS * depth)
    ref = read_metrics(straight)
    losses = [ref[s]["loss"] for s in sorted(ref)]
    print(f"pretrain straight run: {PRETRAIN_STEPS} steps of ViT-S scale-aware bs{TRAIN_BATCH} "
          f"in {wall:.1f} s; losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} "
          f"(want {want}: forward 2 x depth, each backward kernel depth, per step)", flush=True)
    if sorted(ref) != list(range(1, PRETRAIN_STEPS + 1)) or not np.isfinite(losses).all():
        fail("the pretraining run did not log a finite loss at every step")
    if counts != want:
        fail("the pretraining run did not run every attention through the kernels exactly once")
    print(f"pretrain straight run, the caching allocator: {alloc} (cudaMalloc, cudaFree, "
          f"retries after a failed allocation); Python's garbage collector: "
          f"{len(pauses)} passes, {sum(t for _, t in pauses) * 1e3:.1f} ms in all, generation 2: "
          f"{[round(t * 1e3, 1) for g, t in pauses if g == 2]} ms; "
          f"{len(gc.get_objects())} objects tracked after the run", flush=True)
    for last, what in ((10, "the first steps"), (20, "before the first save"),
                       (30, "the step-20 save inside"), (40, "no save inside; the step-40 save comes after")):
        rate = ref[last]["samples_per_s"]
        print(f"pretrain loop rate, steps {last - 9}-{last} ({what}): {rate:.2f} samples/s (host "
              f"clock between metric drains) beside bench_train_step({TRAIN_BATCH}) "
              f"{bench_rate:.2f} slices/s: the loop costs {100 * (1 - rate / bench_rate):.1f}% "
              f"over the bare step", flush=True)
    ck = json.loads((straight / "checkpoints.json").read_text())
    print(f"pretrain checkpoints: {ck['saves']} saves of {ck['bytes']} bytes; the loop blocked "
          f"{[round(b * 1e3, 1) for b in ck['blocked_each_s']]} ms in save() (each save), of which "
          f"{ck['alloc_s'] * 1e3:.1f} ms allocating the snapshot buffers on the card (the first "
          f"save; later saves reuse them); the snapshot copies took "
          f"{ck['snapshot_device_s'] * 1e3:.3f} ms of device time in all; the writes took "
          f"{ck['write_s'] * 1e3:.1f} ms in all (device -> host, serialise, rename; in the "
          f"background); total {(ck['blocked_s'] + ck['write_s']) * 1e3:.1f} ms", flush=True)

    # 2. Resumed from the straight run's step-20 checkpoint, which was
    # written in the background while steps 21 on updated the state in
    # place: the snapshot must hold step 20's state.
    mid = tmp / "from20"
    (mid / "ckpt").mkdir(parents=True)
    shutil.copytree(straight / "ckpt" / "20", mid / "ckpt" / "20")
    shutil.copy(straight / "config.json", mid / "config.json")
    run_cli(PRETRAIN_ARGS + ["--max-steps", str(PRETRAIN_STEPS), "--run-dir", str(mid),
                             "--resume", str(mid)], "resume from step 20")
    got = read_metrics(mid)
    rel = [abs(got[s]["loss"] - ref[s]["loss"]) / abs(ref[s]["loss"]) for s in range(21, PRETRAIN_STEPS + 1)]
    print(f"pretrain resume from the step-20 checkpoint (saved asynchronously while the loop "
          f"went on): steps {min(got)}-{max(got)}, lr bit-equal "
          f"{all(got[s]['lr'] == ref[s]['lr'] for s in got)}, losses max rel diff "
          f"{max(rel):.3e} (tol {RESUME_TOL})", flush=True)
    if (sorted(got) != list(range(21, PRETRAIN_STEPS + 1)) or max(rel) > RESUME_TOL
            or not all(got[s]["lr"] == ref[s]["lr"] for s in got)):
        fail("the step-20 checkpoint does not hold the state of step 20")

    # 3. The same run interrupted by SIGINT, then resumed.
    killed = tmp / "killed"
    cmd = [sys.executable, "-m", "dinox_torch.pretrain", *PRETRAIN_ARGS, "--max-steps",
           str(PRETRAIN_STEPS), "--run-dir", str(killed)]
    with open(tmp / "leg1.log", "w") as log:
        proc = subprocess.Popen(cmd + ["--metric-flush-steps", "1"], cwd=root, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 600
            while max(read_metrics(killed), default=0) < PRETRAIN_KILL_AT:
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail(f"the first leg ended or stalled before step {PRETRAIN_KILL_AT}:\n"
                         f"{(tmp / 'leg1.log').read_text()[-3000:]}")
                time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
    leg1 = read_metrics(killed)
    seam = max(leg1)
    saved = sorted(int(d.name) for d in (killed / "ckpt").iterdir() if d.name.isdigit())
    print(f"pretrain SIGINT at step >= {PRETRAIN_KILL_AT}: exit {rc}, stopped at step {seam}, "
          f"checkpoints {saved}", flush=True)
    if rc != 0 or not saved or saved[-1] != seam or seam >= PRETRAIN_STEPS:
        fail(f"the interrupted run did not exit 0 with a checkpoint at its last step:\n"
             f"{(tmp / 'leg1.log').read_text()[-3000:]}")
    t0 = time.perf_counter()
    leg2 = subprocess.run(cmd + ["--resume", str(killed)], cwd=root, capture_output=True, text=True,
                          timeout=900)
    leg2_s = time.perf_counter() - t0
    if leg2.returncode != 0:
        fail(f"the resumed run exited {leg2.returncode}:\n{leg2.stdout[-3000:]}{leg2.stderr[-3000:]}")
    said = dict(re.findall(r"(restore_s|startup_s)=([0-9.]+)", leg2.stdout))
    got = read_metrics(killed)
    if sorted(got) != list(range(1, PRETRAIN_STEPS + 1)):
        fail(f"the resumed run logged steps {sorted(got)}")
    lr_equal = all(got[s]["lr"] == ref[s]["lr"] for s in got)
    rel = [abs(got[s]["loss"] - ref[s]["loss"]) / abs(ref[s]["loss"]) for s in range(seam + 1, PRETRAIN_STEPS + 1)]
    before = [abs(got[s]["loss"] - ref[s]["loss"]) / abs(ref[s]["loss"]) for s in range(1, seam + 1)]
    print(f"pretrain resume from step {seam}: lr bit-equal to the straight run at every step: "
          f"{lr_equal}; losses after the seam max rel diff {max(rel):.3e} (tol {RESUME_TOL}), "
          f"before it {max(before):.3e}; restore {said.get('restore_s', '?')} s, "
          f"start-up (main to the loop, restore included) {said.get('startup_s', '?')} s, "
          f"the resumed leg {leg2_s:.1f} s in all for {PRETRAIN_STEPS - seam} steps", flush=True)
    if not lr_equal or not np.isfinite(rel).all() or max(rel) > RESUME_TOL:
        fail("the resumed run does not continue the straight run")

    # 4. --fused-attn: kernel 6 for every block's attention half.
    reset_launch_counts()
    run_cli(PRETRAIN_ARGS + ["--fused-attn", "--max-steps", str(PRETRAIN_FUSED_STEPS),
                             "--run-dir", str(tmp / "fused")], "--fused-attn run")
    fused_counts = launch_counts()
    n = PRETRAIN_FUSED_STEPS
    want = want_counts(fused_attn_block=n * 2 * depth, packed_attention_bwd_dq=n * depth,
                       packed_attention_bwd_dkv=n * depth)
    fused = read_metrics(tmp / "fused")
    print(f"pretrain --fused-attn: {n} steps, losses "
          f"{[round(fused[s]['loss'], 4) for s in sorted(fused)]}; launches {fused_counts} (want "
          f"{want}: kernel 6 2 x depth, packed forward 0, dq/dkv depth, per step)", flush=True)
    if fused_counts != want or not np.isfinite([r["loss"] for r in fused.values()]).all():
        fail("the --fused-attn pretraining run did not go through kernel 6 exactly as expected")
    counts["fused_attn_block"] = fused_counts["fused_attn_block"]

    # 5. The host loader over a PNG tree, without and with the decoded
    # cache. Metrics are drained at steps 20 and 40 only, and no periodic
    # save falls in the run: steps 21-40 come well after the ~7 batches
    # the loader and the prefetcher queue before the first step.
    t0 = time.perf_counter()
    index_csv = write_tree(tmp / "tree")
    n_slices = TREE_SERIES * TREE_SLICES
    print(f"wrote {TREE_SERIES} x {TREE_SLICES} {TREE_SIZE}^2 PNGs with write_png16 in "
          f"{time.perf_counter() - t0:.1f} s; png decoder: {decoder_in_use()}", flush=True)
    for cache in ("off", "build"):
        run_dir = tmp / f"loader_{cache}"
        reset_launch_counts()
        wall, out = run_cli(CLI_ARGS + [
            "--index-csv", str(index_csv), "--num-workers", "8", "--device-prefetch", "2",
            "--decoded-cache", cache, "--max-steps", str(LOADER_STEPS), "--ckpt-every", "0",
            "--metric-flush-steps", "20", "--metric-flush-secs", "600", "--run-dir", str(run_dir)],
            f"loader run (--decoded-cache {cache})")
        rows = read_metrics(run_dir)
        decodes = int(re.search(r"png_decodes=(\d+)", out).group(1))
        print(f"pretrain host loader (--decoded-cache {cache}, 8 workers, device prefetch 2): "
              f"{LOADER_STEPS} steps in {wall:.1f} s, losses finite "
              f"{bool(np.isfinite([r['loss'] for r in rows.values()]).all())}; steps 1-20: "
              f"samples_per_s {rows[20]['samples_per_s']:.2f}, data_wait_frac "
              f"{rows[20]['data_wait_frac']:.4f}; steps 21-{LOADER_STEPS}: samples_per_s "
              f"{rows[LOADER_STEPS]['samples_per_s']:.2f}, data_wait_frac "
              f"{rows[LOADER_STEPS]['data_wait_frac']:.4f}; PNG decodes in the run {decodes} "
              f"for {n_slices} slices ({decodes / n_slices:.2f} per slice); packed_attention "
              f"launches {launch_counts()['packed_attention']} (want {LOADER_STEPS * 2 * depth})",
              flush=True)
        if (sorted(rows) != list(range(1, LOADER_STEPS + 1))
                or not np.isfinite([r["loss"] for r in rows.values()]).all()
                or "samples_per_s" not in rows[20] or "samples_per_s" not in rows[LOADER_STEPS]
                or launch_counts()["packed_attention"] != LOADER_STEPS * 2 * depth):
            fail(f"the loader-fed pretraining run (--decoded-cache {cache}) failed")
        if cache == "off" and decodes <= n_slices:
            fail("the loader decoded no slice twice: the timed window read from its memory cache")
    return counts


def eval_forwards(rows: list[IndexRow], batch: int, n_retrieval: int, max_slices: int,
                  n_counterfactual: int) -> int:
    """The forwards python -m dinox_torch.evaluate_panorgan makes over *rows*
    (a scale-aware model): two per batch of each dataset's view retrieval,
    one per batch of the deterministic embedding, three per batch of the
    spacing counterfactual."""
    by_ds: dict[str, int] = {}
    for r in rows:
        by_ds[r.dataset or "unknown"] = by_ds.get(r.dataset or "unknown", 0) + 1

    def batches(n: int) -> int:
        return -(-n // batch)

    return (sum(2 * batches(min(n_retrieval, n)) for n in by_ds.values())
            + batches(min(max_slices, len(rows))) + 3 * batches(min(n_counterfactual, len(rows))))


def print_device_profile(fn, wall_ms: float, label: str, what: str) -> None:
    """One call of *fn* under torch.profiler: its device time beside
    *wall_ms* (the busy share) and its eight costliest kernels."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _, _ in by_name) / 1e3
    print(f"{label} device time (torch.profiler, {what}): {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall = {100 * busy_ms / wall_ms:.1f}% busy; top items:", flush=True)
    for t, count, key in by_name[:8]:
        print(f"  {t / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)


def first_batch(rows: list[IndexRow], n: int) -> tuple[np.ndarray, np.ndarray]:
    """The evaluation loader's first batch of *n* rows (pixels, spacing)."""
    batches = _load_batches(rows, np.arange(min(n, len(rows))), 512, n)
    try:
        return next(batches)
    finally:
        batches.close()


def cls_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def eval_path(tmp: Path) -> dict[str, int]:
    """Evaluation (module 9) at full ViT-S width and depth on the pretraining
    phase's straight run and PNG tree: evaluate_panorgan.main through
    run_export (every metric a number, kernel 1 launches == depth x
    forwards), embed_rows against plain attention (CLS cosine >= 0.999),
    embedded slices/s with and without PNG decoding, view_retrieval_eval
    and check_checkpoint once each. Returns evaluate_panorgan's launches."""
    depth = MODEL_CONFIGS["vit-small"].depth
    run, index_csv = tmp / "straight", tmp / "tree" / "index.csv"
    rows = load_index_rows(index_csv)
    reset_launch_counts()
    wall, _ = run_cli(["--checkpoint", str(run), "--index-csv", str(index_csv), "--out",
                       str(tmp / "eval.json")], "on the straight run", evaluate_panorgan.main)
    counts = launch_counts()
    forwards = eval_forwards(rows, 64, 512, 4096, 256)
    res = json.loads((tmp / "eval.json").read_text())["metrics"]
    print(f"evaluate_panorgan over {len(rows)} slices of {len({r.dataset for r in rows})} datasets: "
          f"{wall:.1f} s; {forwards} forwards, launches {counts} (want kernel 1 depth x forwards "
          f"= {depth * forwards}, every other 0); probe {res['dataset_discrimination_probe']}; "
          f"spacing r2 {res['spacing_prediction'].get('r2')}; clustering enrichment "
          f"{res['domain_clustering']['enrichment_vs_random']:.3f}; counterfactual "
          f"{res['spacing_counterfactual']['cosine_distance_real_vs_2x']}", flush=True)
    if counts != want_counts(packed_attention=depth * forwards):
        fail("evaluate_panorgan did not run every forward's attention through kernel 1 exactly once")
    numbers = [
        *(v["top1"] for v in res["view_retrieval_per_dataset"].values()),
        res["dataset_discrimination_probe"].get("accuracy"), res["dataset_discrimination_probe"].get("auc"),
        res["spacing_counterfactual"].get("cosine_distance_real_vs_2x", {}).get("mean"),
        res["domain_clustering"].get("overall_same_dataset_rate"), res["spacing_prediction"].get("r2"),
        *(d["embedding_std"] for d in res["embedding_stats"]["per_dataset"].values())]
    if (len(res["view_retrieval_per_dataset"]) != 5 or any("error" in v for v in res.values())
            or not all(isinstance(x, float) and np.isfinite(x) for x in numbers)):
        fail(f"evaluate_panorgan left a metric without a number: {res}")

    model = load_any_model(run, "cuda")
    ref = LoadedModel(model.cfg.replace(attn_impl="xla"), "cuda")
    ref.load_state_dict(model.state_dict())
    some = rows[:256]  # eight whole series
    got, _ = embed_rows(model, some)
    want, _ = embed_rows(ref, some)
    cos = cls_cosine(got, want)
    t0 = time.perf_counter()
    embed_rows(model, rows)
    with_decode = len(rows) / (time.perf_counter() - t0)
    pixels, spacing = first_batch(rows, 64)
    px = torch.as_tensor(pixels, device="cuda")

    def embed_batch():
        return model(eval_transform(px, 224), spacing)[:, 0].float().cpu()

    embed_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        embed_batch()
    from_memory = 10 * len(px) / (time.perf_counter() - t0)
    print(f"embed_rows vs plain attention on the card: CLS cosine min {cos.min():.6f} over "
          f"{len(some)} slices; embedded slices/s (bs64, host clock): {with_decode:.2f} from the "
          f"PNGs ({len(rows)} slices, decode on 8 threads + eval transform + forward), "
          f"{from_memory:.2f} from a decoded batch in memory (eval transform + forward + "
          f"the CLS to the host)", flush=True)
    if cos.min() < 0.999:
        fail("embed_rows through the kernel disagrees with plain attention")

    _, out = run_cli(["--checkpoint", str(run), "--index-csv", str(index_csv), "--out",
                      str(tmp / "vr.json")], "on the straight run", view_retrieval_eval.main, (0, 2))
    vr = json.loads((tmp / "vr.json").read_text())
    if vr["n"] != min(512, len(rows)) or not np.isfinite(vr["top1"]) or ("PASS" if vr["passed"] else "FAIL") not in out:
        fail(f"view_retrieval_eval wrote {vr}")
    _, out = run_cli(["--run-dir", str(run)], "on the straight run", check_checkpoint.main)
    if f"latest: step={PRETRAIN_STEPS} " not in out or f"metrics: {PRETRAIN_STEPS} steps" not in out:
        fail("check_checkpoint did not read the straight run's last checkpoint")
    return counts


def inference_path(peaks: tuple[float, float]) -> tuple[dict[str, int], dict]:
    """python -m dinox_torch.bench_inference at full ViT-S width and depth:
    the throughput mode unfused (kernel 1) and --fused-attn (kernel 6) at
    bs 64-512, INFER_REPEATS times in turn, each batch size over
    INFER_IMAGES images; the --slo mode through EmbedService at concurrency
    1/4/16 both ways, SLO_SAMPLES requests each; exact launch counts; then
    kernel 1 timed at the bench's largest shape. Returns the launches
    (kernel 1 of the unfused runs, kernel 6 of the fused) and that timing."""
    depth = MODEL_CONFIGS["vit-small"].depth
    total: dict[str, int] = {"packed_attention": 0, "fused_attn_block": 0}
    rates: dict[str, list[list[float]]] = {"": [], " --fused-attn": []}
    for rep in range(INFER_REPEATS):
        for fused in ([], ["--fused-attn"]):
            kernel, tag = ("fused_attn_block", " --fused-attn") if fused else ("packed_attention", "")
            res, forwards = [], 0
            reset_launch_counts()
            for bs in INFER_BATCHES:
                steps = INFER_IMAGES // bs
                _, out = run_cli(["--batch-sizes", str(bs), "--steps", str(steps), *fused],
                                 f"throughput bs{bs}{tag}", bench_inference.main)
                res += json.loads(out.strip().splitlines()[-1])["all"]
                forwards += 1 + steps
            counts = launch_counts()
            rates[tag].append([r["img_per_sec"] for r in res])
            print(f"bench_inference{tag} (pass {rep + 1} of {INFER_REPEATS}, {INFER_IMAGES} images "
                  f"a batch size): {[(r['batch_size'], r['img_per_sec'], r['latency_ms']) for r in res]} "
                  f"(bs, img/s, ms a batch); launches {counts} (want {kernel} depth x {forwards} "
                  f"forwards)", flush=True)
            if [r["batch_size"] for r in res] != INFER_BATCHES or counts != want_counts(
                    **{kernel: depth * forwards}):
                fail("bench_inference did not run every batch size through its kernel exactly as expected")
            total[kernel] += counts[kernel]
            if rep:
                continue
            # Where the bs512 forward's time goes: the bench's model, one forward.
            model = PatchViT(MODEL_CONFIGS["vit-small"].replace(scale_aware=True, fused_attn=bool(fused)),
                             device="cuda").eval()
            x = torch.randn((INFER_BATCHES[-1], 224, 224, 3), device="cuda")
            sp = torch.rand((INFER_BATCHES[-1], 3), device="cuda") + 0.4
            with torch.inference_mode():
                model(x, sp)
                print_device_profile(lambda: model(x, sp), res[-1]["latency_ms"],
                                     f"bench_inference bs{INFER_BATCHES[-1]}{tag}",
                                     "one forward, beside the bench's ms per batch")
            del model, x, sp
            rows = []
            reset_launch_counts()
            forwards = 0
            for conc in SLO_CONCURRENCY:
                _, out = run_cli(["--slo", "--concurrency", str(conc), "--requests-per-client",
                                  str(-(-SLO_SAMPLES // conc)), *fused], f"--slo c{conc}{tag}",
                                 bench_inference.main)
                rows += json.loads(out.strip().splitlines()[-1])["all"]
                # The requests' forwards and the warm-up's one forward a bucket (1, 8, 32).
                forwards += int(re.search(r"service forwards=(\d+)", out).group(1)) + 3
            counts = launch_counts()
            print(f"bench_inference --slo{tag} ({SLO_SAMPLES}+ requests a concurrency): {rows}; "
                  f"{forwards} forwards ({3 * len(SLO_CONCURRENCY)} of them the warm-ups'), launches "
                  f"{counts} (want {kernel} depth x forwards)", flush=True)
            if ([r["concurrency"] for r in rows] != SLO_CONCURRENCY
                    or counts != want_counts(**{kernel: depth * forwards})):
                fail("the --slo bench did not run every forward through its kernel exactly once")
            total[kernel] += counts[kernel]
    for tag, runs in rates.items():
        spread = [f"{min(r):.1f}-{max(r):.1f}" for r in zip(*runs)]
        print(f"bench_inference{tag} img/s over {INFER_REPEATS} passes, bs {INFER_BATCHES}: "
              f"{spread}", flush=True)
    return total, time_forward(peaks, INFER_SHAPE, "inference bench bs512", SEED + 7)


def labeled_csvs(tmp: Path) -> tuple[Path, Path]:
    """Two classes from the tree, one profile each (the first two datasets
    by name): FT_TRAIN rows of the first series for training, FT_VAL of the
    last for validation, half of each class."""
    rows = load_index_rows(tmp / "tree" / "index.csv")
    names = sorted({r.dataset for r in rows})[:2]
    paths = []
    for split, n in (("train", FT_TRAIN), ("val", FT_VAL)):
        picked = []
        for label, name in enumerate(names):
            mine = [r for r in rows if r.dataset == name]
            picked += [(r, label) for r in (mine[:n // 2] if split == "train" else mine[-(n // 2):])]
        path = tmp / f"{split}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_path", "label", "spacing_x", "spacing_y", "spacing_z"])
            w.writerows([r.png_path, label, r.spacing_x, r.spacing_y, r.spacing_z] for r, label in picked)
        paths.append(path)
    return paths[0], paths[1]


def finetune_path(tmp: Path, bench_rate: float) -> dict[str, int]:
    """LoRA fine-tuning (module 10) at full ViT-S width and depth from the
    straight run: finetune_lora.main at bs 32, rank 8, 2 epochs, with
    --unfreeze-blocks 0 and 1 (exact launch counts: kernel 1, dq and dkv
    depth per step, kernel 1 depth per validation forward, every other 0;
    finite losses; the files written); the adapter loaded and merged (CLS
    cosine >= 0.999 against the unmerged model); one LoRA loss and backward
    through the kernels against plain attention (loss within 1e-2 relative,
    adapter gradients at cosine >= 0.99); the step's ms and samples/s.
    Returns the launches of the two runs."""
    depth = MODEL_CONFIGS["vit-small"].depth
    run = tmp / "straight"
    train_csv, val_csv = labeled_csvs(tmp)
    steps, val_batches = 2 * (FT_TRAIN // FT_BATCH), 2 * -(-FT_VAL // FT_BATCH)
    total = dict.fromkeys(COUNTERS, 0)
    for unfreeze in ("0", "1"):
        out_dir = tmp / f"adapter{unfreeze}"
        reset_launch_counts()
        wall, _ = run_cli(["--backbone", str(run), "--train-csv", str(train_csv), "--val-csv",
                           str(val_csv), "--out", str(out_dir), "--epochs", "2", "--batch-size",
                           str(FT_BATCH), "--rank", "8", "--warmup-steps", "2", "--lr", "1e-3",
                           "--unfreeze-blocks", unfreeze], f"--unfreeze-blocks {unfreeze}",
                          finetune_lora.main)
        counts = launch_counts()
        want = want_counts(packed_attention=depth * (steps + val_batches),
                           packed_attention_bwd_dq=depth * steps, packed_attention_bwd_dkv=depth * steps)
        history = json.loads((out_dir / "history.json").read_text())
        files = sorted(p.name for p in out_dir.iterdir())
        print(f"finetune_lora --unfreeze-blocks {unfreeze}: {steps} steps of bs{FT_BATCH} and "
              f"{val_batches} validation forwards in {wall:.1f} s; history "
              f"{[{k: round(v, 4) for k, v in h.items()} for h in history]}; files {files}; "
              f"launches {counts} (want {want})", flush=True)
        expected = {"adapter_config.json", "adapter_model.safetensors", "finetune_config.json",
                    "head.pth", "history.json"} | ({"unfrozen_blocks.pth"} if unfreeze == "1" else set())
        if (counts != want or len(history) != 2 or set(files) != expected
                or not np.isfinite([[h["train_loss"], h["loss"]] for h in history]).all()):
            fail(f"finetune_lora --unfreeze-blocks {unfreeze} did not run as expected")
        for k in total:
            total[k] += counts[k]

    base = load_any_model(run, "cuda")
    lora = load_adapter(base, tmp / "adapter0")
    merged = merge_adapter(lora)
    rows = load_index_rows(tmp / "tree" / "index.csv")[:FT_BATCH]
    cos = cls_cosine(embed_rows(lora, rows)[0], embed_rows(merged, rows)[0])
    print(f"load_adapter + merge_adapter: CLS cosine min {cos.min():.6f} against the unmerged "
          f"model ({len(rows)} slices)", flush=True)
    if cos.min() < 0.999:
        fail("the merged adapter disagrees with the unmerged model")

    # One LoRA loss and backward, kernels against plain attention, from one
    # state with a non-zero B (a zero B leaves A without a gradient).
    pixels, spacing = first_batch(rows, len(rows))
    x = eval_transform(torch.as_tensor(pixels, device="cuda"), 224)
    sp = torch.as_tensor(spacing, device="cuda")
    labels = (torch.arange(len(rows), device="cuda") % 2).float()
    ft_cfg = FinetuneConfig()
    results = []
    for impl in ("pallas", "xla"):
        model = LoadedModel(base.cfg.replace(attn_impl=impl), "cuda")
        model.load_state_dict(base.state_dict())
        adapted = apply_lora(model, rank=8, dropout=0.0, generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            g = torch.Generator().manual_seed(SEED + 1)
            for m in adapted.lora_layers():
                m.lora_B.weight.copy_(torch.randn(m.lora_B.weight.shape, generator=g) * 0.02)
        head = init_head(ft_cfg, base.dim, device="cuda")
        adapted.train()
        loss = finetune_loss(adapted, head, x, sp, labels, "classification")
        loss.backward()
        results.append((float(loss.detach()), {k: p.grad.float() for k, p in adapted.adapter_params().items()}))
    (l1, g1), (l2, g2) = results
    grad_cos = min(float(F.cosine_similarity(g1[k].flatten(), g2[k].flatten(), dim=0)) for k in g1)
    print(f"LoRA micro-step (bs{len(rows)}) kernels vs plain attention: loss {l1:.6f} vs {l2:.6f} "
          f"(rel {abs(l1 - l2) / abs(l2):.2e}), adapter gradient cosine min {grad_cos:.6f} over "
          f"{len(g1)} tensors", flush=True)
    if abs(l1 - l2) > 1e-2 * abs(l2) or grad_cos < 0.99:
        fail("the LoRA micro-step through the kernels disagrees with plain attention")

    # The fine-tuning step's time, on a batch on the card.
    model = apply_lora(base, rank=8, generator=torch.Generator().manual_seed(SEED))
    head = init_head(ft_cfg, base.dim, device="cuda")
    state = FinetuneState(model, head, make_finetune_optimizer(ft_cfg, model, head))
    step, _ = build_finetune_step(state, ft_cfg)
    px, lab = torch.as_tensor(pixels, device="cuda"), labels
    for _ in range(3):
        step(px, sp, lab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(px, sp, lab) for _ in range(10)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"fine-tuning step (LoRA rank 8, bs{FT_BATCH}, augmentation + forward + backward + "
          f"AdamW): {step_ms:.2f} ms, {FT_BATCH / step_ms * 1e3:.2f} samples/s (host clock over "
          f"10 steps) beside bench_train_step({TRAIN_BATCH}) {bench_rate:.2f} slices/s; losses "
          f"finite {bool(torch.isfinite(torch.stack(losses)).all())}", flush=True)
    if not torch.isfinite(torch.stack(losses)).all():
        fail("the fine-tuning step gave a non-finite loss")
    print_device_profile(lambda: step(px, sp, lab), step_ms, f"fine-tuning step bs{FT_BATCH}",
                         "one step")
    return total


def cifar_model(impl: str):
    """The CIFAR control's ModelConfig as baseline_cifar10_pretrain builds it on the card."""
    args = baseline_cifar10_pretrain.parse_args(["--run-dir", "unused", "--attn-impl", impl])
    return baseline_cifar10_pretrain.cifar_model_config(args, torch.device("cuda"))


def cifar_path(tmp: Path, peaks: tuple[float, float]) -> tuple[dict[str, int], dict, dict]:
    """The CIFAR control at its published width (ViT img 32, patch 4, dim
    192, depth 6, 6 heads, 4 registers; N = 69, hd 32; bf16): one micro-step
    (bs 8) through the kernels against plain attention; python -m
    dinox_torch.baseline_cifar10_pretrain --attn-impl pallas for 40 steps of
    bs 256 on synthetic_cifar (exact launches per step, finite losses), the
    step's ms, samples/s and busy share; the linear probe (exit 0 or 2,
    launches depth x 12 forwards) and its CLS embeddings against plain
    attention (cosine >= 0.999); the view retrieval (exit 0 or 2, launches 2
    x depth); kernel 1 and the pair timed at (512, 69, 576, 6). Returns the
    three CLIs' launches and the two timings."""
    depth = cifar_model("pallas").depth
    cfgs = [TrainConfig(model=cifar_model(impl), img_size=32, batch_size=8, koleo_weight=0.1)
            for impl in ("pallas", "xla")]
    states = [create_train_state(cfg, seed=SEED) for cfg in cfgs]
    for st in states[1:]:
        st.student.load_state_dict(states[0].student.state_dict())
        st.teacher.load_state_dict(states[0].teacher.state_dict())
    x_train, _, x_test, _ = synthetic_cifar()
    pixels = torch.as_tensor(x_train[:8], device="cuda")
    views = augment_rgb_views(pixels, torch.Generator().manual_seed(SEED), RgbAugConfig())
    compare_micro_steps(states, cfgs, views, torch.ones((8, 3), device="cuda"),
                        "CIFAR ViT (N 69, hd 32) bs8, kernels vs plain attention")
    del states

    run = tmp / "cifar"
    total = dict.fromkeys(COUNTERS, 0)
    reset_launch_counts()
    wall, _ = run_cli(CIFAR_ARGS + ["--run-dir", str(run)], "--attn-impl pallas",
                      baseline_cifar10_pretrain.main)
    counts = launch_counts()
    want = want_counts(packed_attention=CIFAR_STEPS * 2 * depth,
                       packed_attention_bwd_dq=CIFAR_STEPS * depth,
                       packed_attention_bwd_dkv=CIFAR_STEPS * depth)
    metrics = read_metrics(run)
    losses = [metrics[k]["loss"] for k in sorted(metrics)]
    rates = {k: round(v["samples_per_s"], 2) for k, v in metrics.items() if "samples_per_s" in v}
    print(f"baseline_cifar10_pretrain --attn-impl pallas: {CIFAR_STEPS} steps of bs{CIFAR_BATCH} "
          f"in {wall:.1f} s; losses {losses[0]:.4f} -> {losses[-1]:.4f}; the loop's samples/s at "
          f"its metric drains {rates}; launches {counts} (want {want}: forward 2 x depth, each "
          f"backward kernel depth, per step)", flush=True)
    if sorted(metrics) != list(range(1, CIFAR_STEPS + 1)) or not np.isfinite(losses).all():
        fail("the CIFAR pretraining run did not log a finite loss at every step")
    if counts != want:
        fail("the CIFAR pretraining run did not run every attention through the kernels exactly once")
    for k in total:
        total[k] += counts[k]

    # The step alone, on the run's config: host-clock rate over two windows
    # of CIFAR_WINDOW steps (each ~2 s or more), their spread, and the busy
    # share against their mean.
    cfg = TrainConfig(model=cifar_model("pallas"), img_size=32, batch_size=CIFAR_BATCH,
                      warmup_steps=10, max_steps=3 + 2 * CIFAR_WINDOW, koleo_weight=0.1)
    state = create_train_state(cfg, seed=SEED)
    rgb_cfg = RgbAugConfig()
    step = build_train_step(cfg, augment_fn=lambda px, g, _: augment_rgb_views(px, g, rgb_cfg))
    px = torch.as_tensor(x_train[:CIFAR_BATCH][None], device="cuda")
    ones = torch.ones((1, CIFAR_BATCH, 3), device="cuda")
    for _ in range(3):
        step(state, px, ones)
    torch.cuda.synchronize()
    windows = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(CIFAR_WINDOW):
            step(state, px, ones)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / CIFAR_WINDOW * 1e3)
    step_ms = sum(windows) / 2
    print(f"CIFAR training step (bs{CIFAR_BATCH}, RGB augmentation + student and teacher forward "
          f"+ backward + AdamW + EMA): {windows[0]:.2f} / {windows[1]:.2f} ms, "
          f"{CIFAR_BATCH / windows[0] * 1e3:.2f} / {CIFAR_BATCH / windows[1] * 1e3:.2f} samples/s "
          f"(host clock, two windows of {CIFAR_WINDOW} steps, spread "
          f"{100 * abs(windows[0] - windows[1]) / min(windows):.1f}%)", flush=True)
    print_device_profile(lambda: step(state, px, ones), step_ms, f"CIFAR training step bs{CIFAR_BATCH}",
                         "one step, against the windows' mean")
    del state, step

    reset_launch_counts()
    _, out = run_cli(["--checkpoint", str(run), "--out", str(tmp / "probe.json")], "on the CIFAR run",
                     baseline_cifar10_linear_probe.main, (0, 2))
    counts = launch_counts()
    probe = json.loads((tmp / "probe.json").read_text())
    forwards = -(-probe["n_train"] // 512) + -(-probe["n_test"] // 512)
    print(f"baseline_cifar10_linear_probe: top1 {probe['top1']:.4f} (gate {probe['pass_threshold']} "
          f"on real CIFAR; synthetic here), {probe['n_train']} + {probe['n_test']} images in "
          f"{forwards} forwards; launches {counts} (want kernel 1 depth x forwards = "
          f"{depth * forwards})", flush=True)
    if (forwards != 12 or counts != want_counts(packed_attention=depth * forwards)
            or ("PASS" if probe["passed"] else "FAIL") not in out):
        fail("the CIFAR linear probe did not run as expected")
    for k in total:
        total[k] += counts[k]

    model = load_backbone_from_run(run, device="cuda")
    ref = LoadedModel(model.cfg.replace(attn_impl="xla"), "cuda")
    ref.load_state_dict(model.state_dict())
    got, want_e = (baseline_cifar10_linear_probe.embed(m, x_test, 512, torch.device("cuda"))
                   for m in (model, ref))
    cos = cls_cosine(got, want_e)
    print(f"CIFAR probe CLS embeddings through kernel 1 vs plain attention: cosine min "
          f"{cos.min():.6f} over {len(cos)} test images", flush=True)
    if cos.min() < 0.999:
        fail("the CIFAR probe's embeddings through kernel 1 disagree with plain attention")

    reset_launch_counts()
    _, out = run_cli(["--checkpoint", str(run), "--out", str(tmp / "cifar_vr.json")],
                     "on the CIFAR run", baseline_cifar10_view_retrieval_eval.main, (0, 2))
    counts = launch_counts()
    vr = json.loads((tmp / "cifar_vr.json").read_text())
    print(f"baseline_cifar10_view_retrieval_eval: {vr}; launches {counts} (want kernel 1 2 x depth)",
          flush=True)
    if vr["n"] != 512 or not np.isfinite(vr["top1"]) or counts != want_counts(packed_attention=2 * depth):
        fail("the CIFAR view retrieval did not run as expected")
    for k in total:
        total[k] += counts[k]

    fwd = time_forward(peaks, CIFAR_SHAPE, "CIFAR step", SEED + 7)
    bwd = time_backward(peaks, CIFAR_SHAPE)
    return total, fwd, bwd


def preprocess_path(tmp: Path) -> dict[str, int]:
    """DICOM and NIfTI to training (module 8b): DICOM_SERIES series of
    SERIES_SLICES 512^2 slices written with write_dicom (out of z order, a
    SliceThickness that is not the z step) and NIFTI_VOLUMES volumes with write_nifti, then
    preprocess_dicom, preprocess_nifti, extract_dicom_spacing,
    combine_indices, make_split_manifest, build_slice_cache and
    validate_samples in this process (each exits 0; slices/s each; every PNG
    decodes to encode_hu16 of the written HU), then python -m
    dinox_torch.pretrain over the combined index and manifest at ViT-S bs32
    for PRE_STEPS steps (exact launches). Returns the pretraining run's
    launches."""
    raw, nii, out = tmp / "raw", tmp / "nii", tmp / "processed"
    written: dict[tuple[str, int], np.ndarray] = {}  # (series_dir, slice) -> HU

    def dicom_series(s: int) -> None:
        rng = np.random.default_rng([SEED, 100 + s])
        prof = PROFILES_V2[s % len(PROFILES_V2)]
        hu = np.clip(np.round(synth_series_np(prof, rng, SERIES_SLICES, 512)), -1000, 3000)
        uid = f"1.2.826.{s}"
        d = raw / "lidc" / uid.replace(".", "_")
        d.mkdir(parents=True)
        for k, z in enumerate(rng.permutation(SERIES_SLICES)):
            write_dicom(d / f"{k:03d}.dcm", (hu[z] + 1024).astype(np.int16), series_uid=uid,
                        patient_id=f"P{s}", pixel_spacing=(0.7, 0.7), slice_thickness=2.0,
                        position_z=1.25 * z, rescale_slope=1.0, rescale_intercept=-1024.0)
            written[(f"lidc/{uid.replace('.', '_')}", int(z))] = hu[z]

    def nifti_volume(v: int) -> None:
        rng = np.random.default_rng([SEED, 200 + v])
        hu = synth_series_np(PROFILES_V2[v], rng, SERIES_SLICES, 512).astype(np.float32)
        write_nifti(nii / f"vol_{v:03d}.nii.gz", np.ascontiguousarray(hu.transpose(2, 1, 0)),
                    spacing=(0.75, 0.75, 2.5))
        for z in range(SERIES_SLICES):
            written[(f"msd/vol_{v:03d}", z)] = np.clip(hu[z], -1000, 4000)

    nii.mkdir()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(dicom_series, range(DICOM_SERIES)))
        list(pool.map(nifti_volume, range(NIFTI_VOLUMES)))
    print(f"wrote {DICOM_SERIES} DICOM series and {NIFTI_VOLUMES} NIfTI volumes of {SERIES_SLICES} "
          f"512^2 slices in {time.perf_counter() - t0:.1f} s", flush=True)

    n_dicom, n_all = DICOM_SERIES * SERIES_SLICES, (DICOM_SERIES + NIFTI_VOLUMES) * SERIES_SLICES
    dicom_index, nifti_index = out / "dicom" / "_index" / "index.csv", out / "nifti" / "_index" / "index.csv"
    combined, manifest = out / "combined.csv", out / "split_manifest.json"
    steps = [
        (preprocess_dicom, ["--src", str(raw), "--out", str(out / "dicom"), "--dataset", "lidc"], n_dicom),
        (preprocess_nifti, ["--src", str(nii), "--out", str(out / "nifti"), "--dataset", "msd"],
         n_all - n_dicom),
        (extract_dicom_spacing, ["--index", str(dicom_index), "--dicom-root", str(raw), "--out",
                                 str(out / "dicom_spacing.csv")], n_dicom),
        (combine_indices, [f"lidc={out / 'dicom_spacing.csv'}", f"msd={nifti_index}", "--out",
                           str(combined)], n_all),
        (make_split_manifest, ["--index", str(combined), "--out", str(manifest), "--val-fraction",
                               "0.17"], n_all),
        (build_slice_cache, ["--index-csv", str(combined), "--canvas", "512"], n_all),
        (validate_samples, ["--index", str(combined), "--out", str(out / "qa"), "--n", "16"], 16),
    ]
    for module, argv, n in steps:
        wall, _ = run_cli(argv, "", module.main)
        print(f"python -m {module.__name__}: {n} slices in {wall:.3f} s = {n / wall:.1f} slices/s "
              f"(host clock)", flush=True)
    if {r.spacing_z for r in load_index_rows(dicom_index)} != {1.25}:
        fail("preprocess_dicom did not take spacing_z from the median z step")

    rows = load_index_rows(combined)
    bad = 0
    for r in rows:
        key = (r.series_dir, r.slice_index)
        bad += key not in written or not np.array_equal(read_png16(r.png_path), encode_hu16(written[key]))
    spacing = {(r.dataset, r.spacing_x, r.spacing_y, r.spacing_z) for r in rows}
    n_val = len(json.loads(manifest.read_text())["val"]["series_dir"])
    print(f"combined index: {len(rows)} slices of {len({r.series_dir for r in rows})} series, "
          f"spacings {sorted(spacing)}, {n_val} val series; PNGs not equal to encode_hu16 of the "
          f"written HU: {bad}", flush=True)
    if len(rows) != n_all or bad or spacing != {("lidc", 0.7, 0.7, 2.0), ("msd", 0.75, 0.75, 2.5)}:
        fail("the preprocessing CLIs did not turn the DICOM and NIfTI files into their HU PNGs")

    depth = MODEL_CONFIGS["vit-small"].depth
    reset_launch_counts()
    wall, text = run_cli(["--config", "vit-small", "--scale-aware", "--index-csv", str(combined),
                          "--split-manifest", str(manifest), "--batch-size", str(PRE_BATCH),
                          "--max-steps", str(PRE_STEPS), "--warmup-steps", "1", "--run-dir",
                          str(tmp / "pre_run"), "--log-json", "--no-tensorboard"], "over the DICOM/NIfTI tree")
    counts = launch_counts()
    metrics = read_metrics(tmp / "pre_run")
    losses = [metrics[k]["loss"] for k in sorted(metrics)]
    want = want_counts(packed_attention=PRE_STEPS * 2 * depth, packed_attention_bwd_dq=PRE_STEPS * depth,
                       packed_attention_bwd_dkv=PRE_STEPS * depth)
    print(f"pretrain over the preprocessed tree ({n_all - SERIES_SLICES * n_val} training slices): "
          f"{PRE_STEPS} steps of ViT-S bs{PRE_BATCH} in {wall:.1f} s, losses {losses}; launches "
          f"{counts} (want {want})", flush=True)
    if (sorted(metrics) != list(range(1, PRE_STEPS + 1)) or not np.isfinite(losses).all()
            or counts != want or "decoded-slice cache" not in text):
        fail("pretraining over the preprocessed DICOM/NIfTI tree did not run as expected")
    return counts



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

    max_err, edge_err4 = check_kernels()
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
        print_device_profile(lambda: service.model(xt, st), fwd_ms, "bs32 forward", "one forward")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    serve_fused(fused_service, reqs, timed, served, cfg.depth)

    # -- kernel timing at the serving and training shapes ---------------------
    peaks = card_peaks(card)
    fwd = time_forward(peaks, SERVING_SHAPE, "serving", SEED + 1)
    print(f"ViT-S bs32 forward on the card: {fwd_ms:.3f} ms ({32 / fwd_ms * 1e3:.1f} img/s); "
          f"attention {cfg.depth} x {fwd['ms']:.4f} ms = "
          f"{100 * cfg.depth * fwd['ms'] / fwd_ms:.1f}%", flush=True)
    fwd_train = time_forward(peaks, TRAINING_SHAPE, "training", SEED + 6)

    # -- the training path ---------------------------------------------------
    bwd_err = check_backward()
    edge_err2, edge_err5 = check_backward_edges()

    # -- the head-major pair (kernels 4 and 5) and its path --------------------
    mha_err = check_mha()
    mha_counts = mha_path()

    vit_s = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    check_step((vit_s, vit_s.replace(attn_impl="xla")), "kernels vs plain attention")
    train_counts, bench_rate = train(card)
    bwd = time_backward(peaks)
    time_backward(peaks, VIT_G_SHAPE)  # TPU kernel 3's shape

    # -- the fused half-block training path ----------------------------------
    exact = vit_s.replace(gelu_approx=False)
    check_step((exact.replace(fused_attn=True, fused_mlp=True), exact),
               "fused half-blocks (kernels 6-8) vs unfused, exact GELU")
    fused_counts = train_fused(card)
    fused = time_fused(peaks)
    mha = time_mha(peaks)

    # -- the pretraining CLI (module 8), then evaluation (module 9), the
    # inference bench and LoRA fine-tuning (module 10) on its run and tree --
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pretrain_counts = pretrain_path(card, bench_rate, tmp)
        eval_counts = eval_path(tmp)
        infer_counts, infer_fwd = inference_path(peaks)
        finetune_counts = finetune_path(tmp, bench_rate)

    # -- the CIFAR control (module 10's rest) and DICOM/NIfTI to training
    # (module 8b) --
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cifar_counts, cifar_fwd, cifar_bwd = cifar_path(tmp, peaks)
        preprocess_counts = preprocess_path(tmp)

    def later_paths(name: str) -> dict[str, int]:
        return {"eval_launches": eval_counts[name],
                "bench_inference_launches": infer_counts.get(name, 0),
                "finetune_launches": finetune_counts[name],
                "cifar_launches": cifar_counts[name],
                "preprocess_launches": preprocess_counts[name]}

    kernels = [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/packed_attention.cu",
        "replaces": "dinox_tpu/ops/flash_attention.py:200",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound"][0],
        "bound_by": fwd["bound"][1],
        "library_ms": fwd["library_ms"],
        "shape": fwd["shape"],
        "device_ms": fwd["device_ms"],
        "training": {"shape": fwd_train["shape"], "ms": fwd_train["ms"],
                     "plain_ms": fwd_train["plain_ms"], "bound_ms": fwd_train["bound"][0],
                     "library_ms": fwd_train["library_ms"], "device_ms": fwd_train["device_ms"]},
        "pretrain_launches": pretrain_counts["packed_attention"],
        **later_paths("packed_attention"),
        "inference_bench": {"shape": infer_fwd["shape"], "ms": infer_fwd["ms"],
                            "plain_ms": infer_fwd["plain_ms"], "bound_ms": infer_fwd["bound"][0],
                            "bound_by": infer_fwd["bound"][1], "library_ms": infer_fwd["library_ms"],
                            "device_ms": infer_fwd["device_ms"]},
        "cifar": {"shape": cifar_fwd["shape"], "ms": cifar_fwd["ms"], "plain_ms": cifar_fwd["plain_ms"],
                  "bound_ms": cifar_fwd["bound"][0], "bound_by": cifar_fwd["bound"][1],
                  "library_ms": cifar_fwd["library_ms"], "device_ms": cifar_fwd["device_ms"]},
    }]
    # The pair replaces kernel 2 (_packed_bwd_kernel) and kernel 3 (the split
    # dq/dkv kernels); the dq entry carries the pair's time and bound.
    for part, err, replaces in (("dq", max(bwd_err[0], edge_err2), "dinox_tpu/ops/flash_attention.py:222"),
                                ("dkv", max(bwd_err[1], edge_err2), "dinox_tpu/ops/flash_attention.py:339")):
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
            "device_ms": bwd[part]["device_ms"],
            "library_device_ms": bwd[part]["library_device_ms"],
            "pretrain_launches": pretrain_counts[name],
            **later_paths(name),
        })
        if part == "dq":  # the pair at the CIFAR shape: time, bound and SDPA's backward
            c = cifar_bwd["dq"]
            kernels[-1]["cifar"] = {"shape": list(CIFAR_SHAPE), "ms": c["ms"], "device_ms": c["device_ms"],
                                    "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                                    "bound_by": c["bound"][1], "library_ms": c["library_ms"],
                                    "library_device_ms": c["library_device_ms"]}
    fused_entries = (
        ("fused_attn_block", "fused_attn_block.cu", "fused_attn_block.py:46", fused_attn_err,
         fused["attn_training"], fused_counts["fused_attn_block"]),
        ("fused_mlp_fwd", "fused_mlp.cu", "fused_mlp.py:65", mlp_err[0], fused["mlp_fwd"],
         min(fused_counts[p] for p in MLP_FWD_PARTS)),
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
        if name == "fused_attn_block":  # three launches: parts holds each one's device time
            serving = fused["attn_serving"]
            entry["device_ms"] = t["device_ms"]
            entry["parts"] = {p: {"launches": count, **v} for p, v in t["parts"].items()}
            entry["serving"] = {"shape": serving["shape"], "ms": serving["ms"],
                                "bound_ms": serving["bound"][0], "unfused_ms": serving["unfused_ms"],
                                "device_ms": serving["device_ms"], "parts": serving["parts"]}
            entry["backward_ms"] = t["backward_ms"]  # composed, not a kernel of this entry
            entry["pretrain_launches"] = pretrain_counts["fused_attn_block"]  # the --fused-attn run
            entry.update(later_paths("fused_attn_block"))
        if name.startswith("fused_mlp"):  # two or six launches: parts holds each one's device time
            entry["device_ms"] = t["device_ms"]
            entry["parts"] = {p: {"launches": fused_counts[f"{name}_{p}"], **v}
                              for p, v in t["parts"].items()}
        kernels.append(entry)
    # Kernel 4 at the bring-up shape, the one its path runs at; the training
    # shape beside it.
    fwd4, train_fwd = mha["validate"], mha["training"]
    kernels.append({
        "name": "mha_attention",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/mha_attention.cu",
        "replaces": "dinox_tpu/ops/flash_attention.py:32",
        "launches": mha_counts["mha_attention"],
        "max_abs_err": max(mha_err[0], edge_err4),
        "ms": fwd4["ms"],
        "plain_ms": fwd4["plain_ms"],
        "bound_ms": fwd4["bound"][0],
        "bound_by": fwd4["bound"][1],
        "library_ms": fwd4["library_ms"],
        "shape": fwd4["shape"],
        "device_ms": fwd4["device_ms"],
        "training": {"shape": train_fwd["shape"], "ms": train_fwd["ms"],
                     "plain_ms": train_fwd["plain_ms"], "bound_ms": train_fwd["bound"][0],
                     "library_ms": train_fwd["library_ms"], "device_ms": train_fwd["device_ms"]},
    })
    # Kernel 5: two launches; ms is the pair's, parts each one's.
    bwd5 = mha["backward"]
    kernels.append({
        "name": "mha_attention_bwd",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/mha_attention_bwd.cu",
        "replaces": "dinox_tpu/ops/flash_attention.py:107",
        "launches": min(mha_counts[p] for p in bwd5["parts"]),
        "max_abs_err": max(mha_err[1], edge_err5),
        "ms": bwd5["ms"],
        "plain_ms": bwd5["plain_ms"],
        "bound_ms": bwd5["bound"][0],
        "bound_by": bwd5["bound"][1],
        "library_ms": bwd5["library_ms"],
        "shape": bwd5["shape"],
        "device_ms": bwd5["device_ms"],
        "library_device_ms": bwd5["library_device_ms"],
        "parts": {p.rsplit("_", 1)[1]: {"launches": mha_counts[p], "ms": ms,
                                        "device_ms": bwd5["parts_device_ms"][p]}
                  for p, ms in bwd5["parts"].items()},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
