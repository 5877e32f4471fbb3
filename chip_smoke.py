#!/usr/bin/env python3
"""On-card smoke test of dinox_torch's serving and training paths, its
head-major attention path, its pretraining CLI, its evaluation,
inference-bench and LoRA fine-tuning CLIs, the CIFAR control, the
DICOM/NIfTI preprocessing CLIs, module 11 (the optimizer-memory options at
ViT-L/G, the Switch-MoE family, the MAE objective and in-loop monitoring),
module 12 (release staging served back, data preparation into training,
the integration canary), module 12b (the run and bench tooling), module
13a (the data-, tensor- and sequence-parallel mesh: a world-1 NCCL group,
then two gloo ranks sharing the card through the pretraining CLI) and
module 13b (expert parallelism, MoE, LoRA and factored moments under
tensor parallelism, and pipeline parallelism: gloo ranks sharing the card),
on one CUDA card.

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
8. Trains: dinox_torch.bench.bench_train_step(96), 5 warm-up and 60 timed
   steps and one profiled step, every loss finite, and exact launch counts
   per step (forward 2 x depth, each backward kernel depth; the LayerNorm
   kernels' forward 2 x (2 x depth + 2), dx and parameters 2 x depth + 2).
   Its rate is the reference of the later phases' comparisons.
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
   launch of kernels 7 and 8 counted on its own). Then holds the LayerNorm
   kernels (ops/layer_norm.py: forward, dx, parameters) against their plain
   versions at the training cells' rows (66816 x 384, 33408 x 1024) and the
   ragged edges (rows 1 to 300, C 8 to 8192), bf16 -> bf16, bf16 -> f32 and
   f32 -> f32, each twice with equal bits, and the forward without a
   gradient at an embedding batch's rows (64 x 261 x 384); times them at
   the cells' two pairs beside their bounds, the plain versions, eager
   autograd and F.layer_norm (the yardstick only).
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
21. Optimizer memory (module 11; run after 22-24): bench_scale's step
   (dinox_torch.bench_scale, use_grad_checkpoint) at ViT-L and ViT-G bs
   32, each model built once and measured under f32 moments, bf16 mu and
   nu, --factored-nu, and bf16 mu with --factored-nu, the optimizer made
   anew between kinds (2 warm-up and 5 timed steps each): exact launches
   (kernel 1 3 x depth a step: student, teacher, recomputation; dq and dkv
   depth), finite losses, and for each kind img/s, MFU, the peak allocated
   memory and the optimizer state's bytes.
22. MoE (module 11): one micro-step of ViT-S E4 (bs 8) through the kernels
   against plain attention (loss within 1e-2 relative, gradient cosine >=
   0.99, >= 99% of the token routings equal, the flips' top-2 margins
   printed); the bench's moe4 arm at bs 96 (exact launches, one profiled
   step; slices/s and moe4_mfu); python -m dinox_torch.pretrain
   --moe-experts 4 for 20 steps (exact launches, finite loss_moe_aux); that
   run exported as a hub v2 dir and served through EmbedService (CLS cosine
   >= 0.999 against plain attention, launches == depth x forwards);
   bench_moe_sweep at E 4/8 x cf 1.0/1.25 (exact launches).
23. MAE (module 11): kernel 1 and the pair are gated (3 and 6) at the
   encoder's (192, 65, 1152, 6) and the decoder's (192, 257, 1536, 16), and
   at ViT-L's (64, 261, 3072, 16) and ViT-G's (64, 261, 4224, 16); one MAE
   micro-step through the kernels against plain attention (same views and
   mask noise; 1e-2, 0.99); the MAE step at bs 96 timed and profiled (ms,
   busy share); python -m dinox_torch.pretrain --loss-type mae for 20 steps
   (kernel 1, dq and dkv depth + 8 a step: no teacher forward).
24. Monitoring (module 11): python -m dinox_torch.pretrain --monitor-every
   10 for 20 steps (two health.jsonl lines and two 192 x 388 previews;
   kernel 1 depth launches a snapshot), then python -m dinox_torch.monitor
   --run-dir on that run (stats.json, a 224 px heatmap, depth launches).
   Kernel 1 and the pair are timed at the MAE decoder's shape and at
   ViT-G's bs-32 shape beside SDPA, its backward and their bounds. The
   kernels line gives kernels 1, 2 (dq, dkv) and 6 moe_launches,
   mae_launches, scale_launches and monitor_launches, and kernel 1 and the
   dq entry their mae_decoder and vit_g timings; a module11 line before it
   holds the moe4 arm, the MAE step and every bench_scale result.

25. Release staging (module 12; run after 18, on the straight run of 15):
   python -m dinox_torch.publish_release with 16's evaluate_panorgan and
   view_retrieval_eval JSONs and 18's adapter (the staged files,
   WEIGHTS.sha256 against every weight file, the card's parameter count
   equal to the backbone's and its Hardware row; no launch); the staged dir
   and its backbone.pth (with the staged config.json) loaded back on the
   card (load times) and 64 slices of 15's PNG tree encoded through kernel
   1 by zoo.encode_batch: CLS bit-equal to load_backbone_from_run's; the
   staged dir served by EmbedService(fused_attn=True) through kernel 6 (CLS
   cosine >= 0.999 against the unfused backbone). Exact launches.
26. Data preparation into training (module 12; run after 20): python -m
   dinox_torch.preprocessing.prepare_data --dry-run (every Parquet manifest
   read back through the port's reader and held to its index CSV),
   temperature_resample at T 2.0 (the composition against
   temperature_weights), then 5 steps of python -m dinox_torch.pretrain at
   ViT-S bs 32 on the resampled index through kernels 1 and 2/3 (exact
   launches); the Parquet writer's and reader's host rate on a 100000-row
   manifest.
27. The integration canary (module 12): python -m
   dinox_torch.integration_canary at its defaults (8 steps, tol 1e-5) with
   --device cuda and --report in the temp dir: all three gates pass, each
   gate's wall time, the repository's canary_report.json untouched. Its
   trainer runs --attn-impl xla, as the JAX canary's does: no kernel. The
   kernels line gives kernels 1, 2 (dq, dkv) and 6 release_launches and
   prepare_launches.
28. The run tools (module 12b; run after 25, on the runs of 15): python -m
   dinox_torch.compare_runs of the straight run against the SIGINT-resumed
   one (overlap_steps 40, max_rel_diff <= 1e-3), soak_seam_analysis at the
   SIGINT seam (lr_ratio equal to the straight run's across that step to
   1e-6; jump_ratio and n_duplicates_dropped printed) and on the run
   resumed from step 20, log_runs over the six runs (a row each, steps_done
   as run). Host work: no launch.
29. The diagnostics: diagnose_scale_pathway on the straight run at --n 32
   --canvas 512 (exactly 84 launches of kernel 1, 7 forwards x 12 blocks at
   (32, 261, 1152, 6); the counterfactual curve within 1e-3 absolute of the
   same weights through plain attention); round5_patch_probe over the val
   series (half of 15's 48) of a split written by make_split_manifest
   (kernel 1 12 x ceil(val rows / 64) launches; CLS cosine >= 0.999
   against plain attention); round5_data_probe on the same tree.
30. The sweeps: bench_batch_sweep at bs 64/96/128/192/256 with --profile
   (exact launches of kernels 1, dq and dkv; every row ok; the per-slice
   device µs by kind printed; bs 96 within 25% of step 8's rate, which the
   shared host sets, and within 5% of its profiled step's device ms);
   tune_throughput --synthetic --batch-sizes 512 1024
   512 --steps 20 (the
   middle cell "oom", the second bs-512 cell ok, within 10% of the first
   and at its peak memory); its index-CSV grid over 15's PNG tree at bs
   64, workers {4, 8} x prefetch {2, 4} (exact launches; each cell's bound
   and data_wait_frac), then --loader-only over the same grid.
31. The LoRA ablation: python -m dinox_torch.ablation_lora_lidc all on
   18's labelled CSVs and the straight run (four adapter dirs, each arm's
   best AUROC printed as the runbook prints it, exact launches). Each phase
   prints its wall time. The kernels line gives kernels 1, 2 (dq, dkv) and
   6 tools_launches (28-29), sweep_launches (30) and ablation_launches
   (31).
32. Data parallelism (module 13a). (a) In a child process, a world-1 NCCL
   group runs the mesh step at ViT-S scale-aware bs96 (tanh, "pallas",
   KoLeo 0.1) for 3 steps beside the step without a mesh, from one seed on
   the same staged batches: every metric and every state tensor bit-equal;
   the NCCL all-reduce of the gradient bucket timed. (b) Two child
   processes share gloo and the card as ranks 0 and 1 of the CLI
   (--synthetic --batch-size 96, 48 rows a rank, 2 steps, --ckpt-every 2)
   against the same argv in this process without the dist flags: per-step
   losses within 1e-2 relative, the final checkpoint's student at cosine
   >= 0.99 (all its tensors as one vector), exact launches per rank (kernel 1 24, dq and dkv 12 a step,
   kernel 6 0). Gloo on CUDA tensors stages every collective on the host:
   its step times are not NCCL's.
33. Tensor and sequence parallelism: two gloo ranks with --model-parallel 2
   --sequence-parallel --fused-attn (1 step of a 3-step schedule) against
   the one-process --fused-attn run of 4 steps (kernel 6 there, kernel 1
   and the pair at (192, 261, 576, 3) on the ranks, kernel 6 0), with 32's
   gates (the final student compared at the ranks' last checkpoint step);
   then one process resumes the tp run's checkpoint for steps 2-3, within
   1e-2 of the straight run's. Kernel 1 and the pair are held
   against their plain versions at both ranks' shapes, (96, 261, 1152, 6)
   and (192, 261, 576, 3), and timed beside SDPA; the kernels line gives
   kernels 1, 2 (dq, dkv) and 6 dp_launches and tp_launches (per rank).
   The two-rank runs of phases 32b-36 (dp, tp + SP, ep, the LoRA
   backbone at tp 2, pp) share one spawn of two children, one run after
   the other in one gloo group (one process start-up for all five).
34. Expert parallelism (module 13b): two gloo ranks with --moe-experts 4
   --expert-parallel 2 (a (1, 1, 2) mesh; 2 steps of a 4-step schedule at
   bs96) against the one-process run with the same flags, with 33's gates,
   then one process resumes rank 0's checkpoint for steps 3-4 within 1e-2
   of the straight run's.
35. Tensor x expert parallelism: four gloo ranks at (1, 2, 2) with
   --moe-experts 4 --model-parallel 2 --expert-parallel 2
   --sequence-parallel --factored-nu at a global bs 32 (2 steps of a
   4-step schedule; kernel 1 and the pair at (64, 261, 576, 3) on each
   rank) against one process with the same flags, with 34's gates and
   resume. Beside it, a LoRA r8 ViT-S backbone (bf16, dropout 0.1) runs
   its eval forward and a training forward and backward at tp 2 on two
   gloo ranks through kernel 1 and the pair, against one process: CLS
   cosine >= 0.999, each factor's gradient at cosine >= 0.99, exact
   launches per rank. Kernel 1 and the pair are held against their plain
   versions at (64, 261, 576, 3) and (32, 261, 576, 3) and timed at the
   first beside SDPA; the kernels line gives kernels 1, 2 (dq, dkv) and 6
   ep_launches, tp_ep_launches and lora_tp_launches (per rank).
36. Pipeline parallelism (module 13b-3): two gloo ranks, one stage of 6
   ViT-S blocks each, run the CLI with --pipeline-parallel 2
   --pp-microbatches 4 --attn-impl xla at bs96 (4 steps of a 6-step
   schedule, a checkpoint at step 4) against the one-process --attn-impl
   xla run of 6 steps, with 32's gates (losses within 1e-2, the student at
   cosine >= 0.99 at step 4); then one process resumes rank 0's checkpoint
   for steps 5-6 within 1e-2 of the straight run's. The stage blocks run the
   reference's plain attention, so kernels 1, 2 (dq, dkv) and 6 launch 0
   times on every rank (pp_launches on the kernels line). Prints each
   rank's parameter and state bytes (its stage cut of the checkpoint) and
   max_memory_allocated beside the one process's (each rank's parameter
   bytes must be below the one process's), rank 0's ms a step and the
   phase's seconds.

37. DINOv3 ViT-7B/16's block at the 7B cell's shapes: kernel 1 and the
   backward pair at head dim 128 at (64, 261, 12288, 32) against their
   plain versions (TOL; BWD_TOL and BWD_REL), twice with equal bits, and
   timed beside SDPA; the RoPE kernels (ops/rope.py) on that qkv, at the
   teacher's tables and a student's rescale of 1.6, bit-equal to their
   plain versions forward and backward (CLS, registers and v untouched);
   the SwiGLU kernels (ops/swiglu.py) at (16704, 8192) within one bf16
   step of theirs and at least 99% of elements bit-equal; each timed per
   call and back to back beside its bound and its plain version. Then one
   optimizer step of a 2-block vit-7b16 stack at its widths (bs4,
   recomputation, scale token) with every counter set to 0 just before it:
   kernel 1, RoPE and SwiGLU forward 3 x depth (student, recomputation,
   teacher), each backward kernel depth, the LayerNorm forward 2 x (2 x
   depth + 2) + 2 x depth, dx and parameters 2 x depth + 2, every other
   kernel 0. The kernels line gains packed_attention_hd128,
   packed_attention_bwd_hd128, rope and swiglu. `python3 chip_smoke.py
   --dinov3` runs steps 1-2 and this phase alone.

The last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero; without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import hashlib
import io
import itertools
import json
import os
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
import torch.distributed as dist
import torch.nn.functional as F

from dinox_torch import (
    ablation_lora_lidc,
    baseline_cifar10_linear_probe,
    baseline_cifar10_pretrain,
    baseline_cifar10_view_retrieval_eval,
    bench_batch_sweep,
    bench_inference,
    bench_moe_sweep,
    bench_scale,
    check_checkpoint,
    compare_runs,
    diagnose_scale_pathway,
    evaluate_panorgan,
    finetune_lora,
    log_runs,
    monitor,
    pretrain,
    publish_release,
    round5_data_probe,
    round5_patch_probe,
    serve,
    soak_seam_analysis,
    tune_throughput,
    validate_attention,
    view_retrieval_eval,
)
from dinox_torch.bench import bench_config, bench_train_step, fused_block_inputs, fused_mlp_inputs
from dinox_torch.data.cifar import synthetic_cifar
from dinox_torch.data.dicom import write_dicom
from dinox_torch.data.hu import HU_SHIFT, encode_hu16
from dinox_torch.data.index import (
    IndexRow,
    load_index_rows,
    load_split_manifest,
    val_series_set,
    write_index_rows,
)
from dinox_torch.data.nifti import write_nifti
from dinox_torch.data.png16 import decoder_in_use, read_png16, write_png16
from dinox_torch.data.synthetic import PROFILES_V2, draw_spacing, synth_series_np
from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.evaluation.embedder import _load_batches, embed_rows
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.models.moe import MoeMlp
from dinox_torch.models.vit import Attention, LayerNorm, Mlp, PatchViT, sdpa
from dinox_torch.ops import _build
from dinox_torch.ops import flash_attention as fa
from dinox_torch.ops import fused_attn_block as fab
from dinox_torch.ops import fused_mlp as fm
from dinox_torch.ops import layer_norm as lnk
from dinox_torch.ops import rope as rk
from dinox_torch.ops import swiglu as sk
from dinox_torch.ops.augment import augment_views, eval_transform
from dinox_torch.ops.augment_rgb import RgbAugConfig, augment_rgb_views
from dinox_torch.ops.flash_attention import flash_attention_packed, packed_attention_reference
from dinox_torch.parallel import Mesh, init_distributed, make_mesh, model_group_share, shard_model
from dinox_torch.parallel.pipeline import stage_tensors
from dinox_torch.parallel.collectives import all_reduce_bucket
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
    prepare_data,
    preprocess_dicom,
    preprocess_nifti,
    temperature_resample,
    validate_samples,
)
from dinox_torch.pretrain import DeviceSyntheticBatches
from dinox_torch.train.checkpoint import state_tensors
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.zoo.safetensors_io import load_file
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
    layer_norm_bwd_work,
    layer_norm_fwd_work,
    rope_work,
    swiglu_bwd_work,
    swiglu_fwd_work,
)
from dinox_torch.utils.trace_analysis import device_ops
from dinox_torch.zoo import encode_batch, load_model
from dinox_torch.zoo.card import DEFAULT_HARDWARE
from dinox_torch.zoo.encode import _preprocess
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint
from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.merge import temperature_weights
from dinox_torch.zoo.schemas import SliceMetadata
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
# Module 12 (phases 25-27): the staged release encodes RELEASE_SLICES slices
# of the PNG tree in forwards of RELEASE_BATCH; prepare_data's resampled
# index trains PREP_STEPS steps of ViT-S bs PREP_BATCH (the resample's total
# is one pass); the Parquet codec is timed on PARQUET_ROWS rows.
RELEASE_SLICES, RELEASE_BATCH = 64, 32
PREP_STEPS, PREP_BATCH, PARQUET_ROWS = 5, 32, 100_000
TOL = 0.02  # bf16 forward tolerance of the JAX package's kernel check (bench.py --check)
# (b, n, 3*dim, heads): the kernel-check shapes (ViT-S, ViT-G hd 88), the
# serving bucket-32 shape, the MAE decoder's hd 32, the ViT-S training
# shape (2 x 96 views) that the unfused training step gives it, the
# inference bench's largest batch (3072 (batch, head) pairs), its other
# three batch sizes (the evaluation's bs 64 among them) and the CIFAR
# control's three.
# Module 11's paths (phases 21-23), (b, n, 3*dim, heads): the MAE encoder on
# CLS + 64 kept patches of 2 x 96 views (hd 64), its decoder (N 257, hd 32,
# 16 heads), and bench_scale's ViT-L and ViT-G steps at bs 32 (2 x 32 views;
# hd 64 and 88).
MAE_ENC_SHAPE, MAE_DEC_SHAPE = (192, 65, 3 * 384, 6), (192, 257, 3 * 512, 16)
VIT_L_SHAPE, VIT_G_TRAIN_SHAPE = (64, 261, 3 * 1024, 16), (64, 261, 3 * 1408, 16)
MODULE11_SHAPES = [MAE_ENC_SHAPE, MAE_DEC_SHAPE, VIT_L_SHAPE, VIT_G_TRAIN_SHAPE]
# Module 13a (phases 32-33), (b, n, 3*dim, heads): the block a rank of the
# ViT-S bs96 mesh step runs, its 2 x 48 view rows at dp 2 and all 2 x 96
# rows at 3 of the 6 heads at tp 2.
MESH_DP_SHAPE, MESH_TP_SHAPE = (96, 261, 3 * 384, 6), (192, 261, 3 * 192, 3)
# Module 13b (phases 34-35): the blocks a rank runs at tp 2 x ep 2 with the
# global bs TPEP_BATCH (all 2 x 32 view rows at 3 of the 6 heads), and at tp
# 2 in the LoRA backbone's forward and backward at bs LORA_TP_BATCH.
TPEP_BATCH, LORA_TP_BATCH = 32, 32
MESH_TPEP_SHAPE = (2 * TPEP_BATCH, 261, 3 * 192, 3)
LORA_TP_SHAPE = (LORA_TP_BATCH, 261, 3 * 192, 3)
CHECK_SHAPES = [(8, 261, 3 * 384, 6), (2, 261, 3 * 1408, 16), (32, 261, 3 * 384, 6),
                (4, 261, 3 * 512, 16), (192, 261, 3 * 384, 6), (512, 261, 3 * 384, 6),
                (64, 261, 3 * 384, 6), (128, 261, 3 * 384, 6), (256, 261, 3 * 384, 6),
                *CIFAR_FWD_SHAPES, *MODULE11_SHAPES, MESH_DP_SHAPE, MESH_TP_SHAPE, MESH_TPEP_SHAPE,
                LORA_TP_SHAPE]
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
              (32, 261, 3 * 384, 6), (64, 261, 3 * 384, 6), CIFAR_SHAPE, *MODULE11_SHAPES,
              MESH_DP_SHAPE, MESH_TP_SHAPE, MESH_TPEP_SHAPE, LORA_TP_SHAPE]
# Module 11 (phases 21-24): bench_scale at ViT-L and ViT-G bs 32 under each
# optimizer kind (warm-up and timed steps per kind); the MoE, MAE and monitor
# runs of the pretraining CLI; the MoE sweep's points; the MAE decoder's depth.
SCALE_CONFIGS, SCALE_KINDS = ("vit-large", "vit-giant"), ("f32", "bf16", "factored", "bf16+factored")
SCALE_BATCH, SCALE_WARMUP, SCALE_STEPS = 32, 2, 5
MODULE11_STEPS, MONITOR_EVERY = 20, 10
SWEEP_EXPERTS, SWEEP_FACTORS, SWEEP_WARMUP, SWEEP_STEPS = (4, 8), (1.0, 1.25), 2, 5
MAE_DECODER_DEPTH = 8
TRAINING_SHAPE = CHECK_SHAPES[4]
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 96, 5, 20
# Step 8's timed window, the reference rate the later phases compare with:
# over 20 steps (~2.4 s) one run on an H100 80GB HBM3 read 742.84 slices/s
# where others read 786-797, a stall of the card's shared host; 60 steps
# (~7 s) dilute such a stall.
BENCH_STEPS = 60
# The pretraining CLI at full width and depth: ViT-S scale-aware bs96, tanh,
# attn_impl "pallas", the bench's KoLeo weight, on the v2 synthetic profiles
# staged on the card.
PRETRAIN_STEPS, PRETRAIN_KILL_AT, PRETRAIN_FUSED_STEPS, LOADER_STEPS = 40, 12, 5, 40
CLI_ARGS = ["--config", "vit-small", "--scale-aware", "--batch-size", str(TRAIN_BATCH),
            "--warmup-steps", "10", "--ckpt-every", "20", "--koleo-weight", "0.1", "--log-json",
            "--no-tensorboard"]
PRETRAIN_ARGS = CLI_ARGS + ["--synthetic-device-batches", "4", "--synthetic-datasets", "5"]
RESUME_TOL = 1e-3  # relative, losses after the seam against the straight run
# Module 13a (phases 32-33): the world-1 NCCL mesh step's steps beside the
# step without a mesh; the two-rank CLI runs (--synthetic host batches, the
# global bs96 of CLI_ARGS) and their gates (losses relative, as the
# micro-steps', and the final student's cosine); the tp run stops at
# MESH_CLI_STEPS of a schedule of MESH_CLI_STEPS + 2, which one process
# finishes from its checkpoint.
MESH_STEPS, MESH_CLI_STEPS, MESH_LOSS_TOL, MESH_COS = 3, 2, 1e-2, 0.99
MESH_ARGS = CLI_ARGS + ["--synthetic", "--ckpt-every", "3"]
# Phase 33's tp + SP run takes fewer steps than 32b's dp run (of a schedule
# of MESH_TP_STEPS + 2, a checkpoint each MESH_TP_STEPS): its gloo steps take
# 10-22 s each on the card. (Phases 32b and 34 were cut from 6 to 2 steps,
# 33 from 2 to 1 and 35 from 3 to 2 to make room for phase 36.)
MESH_TP_STEPS = 1
# Module 13b (phases 34-35): the MoE runs' experts; the tp x ep run's steps
# (of a schedule of TPEP_STEPS + 2, which one process finishes from rank 0's
# checkpoint); the LoRA backbone's rank, and its gates (CLS cosine, each
# factor gradient's cosine).
MOE_ARGS = ["--moe-experts", "4"]
TPEP_STEPS, LORA_TP_RANK, LORA_CLS_COS, LORA_GRAD_COS = 2, 8, 0.999, 0.99
# Module 13b-3 (phase 36): the pipeline run's stages and microbatches (the
# ViT-S bs96 step: 2 x 96 views, 4 microbatches of 48), and its steps, of
# a schedule of PP_STEPS + 2 that one process finishes from rank 0's
# checkpoint.
PP_STAGES, PP_MICRO, PP_STEPS = 2, 4, 4
# Separates the runs that one spawn of rank workers makes in turn; the
# two-rank CLI runs of phases 32b-36 in the order of that spawn (the LoRA
# step of phase 35 between 34 and 36 prints no done line).
RUN_SEP = "--then"
RUN_DP, RUN_TP, RUN_EP, RUN_PP = range(4)
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
# Module 12b (phases 28-31). diagnose_scale_pathway's batch (7 forwards at
# (32, 261, 1152, 6)); the share of the tree's series round5_patch_probe
# reads (24 of 48: 768 slices, both splits of its probe hold every
# profile); tune_throughput's ViT-S batch that does not fit the card,
# between two cells of bs 512, which does (on an H100 80GB HBM3, with the
# LayerNorm kernels, the step's peak grows by ~0.080 GiB a slice: bs 512
# peaks at 42.4 GiB and bs 640 at 52.6 of the card's 79.2, so bs 1024
# needs ~83.5 and runs out; with the eager LayerNorm it was 0.127 GiB a
# slice and bs 640 ran out); its index-CSV grid.
DIAG_N, PROBE_VAL_FRACTION = 32, 0.5
TUNE_FIT_BATCH, TUNE_OOM_BATCH = 512, 1024
# Phase 30's bs-96 row against phase 8's bench_train_step(96). The card's
# time a step is compared within 5%. The rate is the host's since the
# LayerNorm kernels (~80 ms a step against ~62 of device time), and a
# one-card host shares its cores: on an H100 80GB HBM3 the row read +1.9%, -5.9%,
# +0.0%, -3.0% and -20.2% of phase 8's rate in five runs, while
# bench_train_step(96) itself, timed again just before the sweep, read
# 16.4% and 24.6% under phase 8 (the device ms within 0.6% in each).
SWEEP_RATE_TOL, SWEEP_DEVICE_TOL = 0.25, 0.05
# The synthetic cells' timed steps. The card sets a bs-512 step (0.543 s):
# four such cells of 20 steps, two of them after an OOM cell, stayed within
# 2.2% in img/s on an H100 80GB HBM3. About half of a bs-64 step is the
# host's, and inside this script its rate moved by up to 15.3% from one
# cell to the next over 100 steps, so a bs-64 cell cannot show a 10% change.
TUNE_STEPS = 20
TUNE_WORKERS, TUNE_PREFETCH = ["4", "8"], ["2", "4"]
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
# The LayerNorm kernels (ops/layer_norm.py), (rows, C): the training cells'
# rows (ViT-S 128 slices x 2 views x 261 tokens of 384, ViT-L 64 x 2 x 261
# of 1024), each on every (x, y) dtype pair the kernels take: the block
# norms' (bf16 -> bf16), the final norm's (bf16 -> f32), a float32 model's
# (f32 -> f32); timed on the cells' two; then the ragged edges (one row,
# rows short of the last CTA, C 8 and 8192, ViT-G's 1408); and an embedding
# batch's rows (64 slices x 261 tokens) without a gradient.
LN_SHAPES = [(66816, 384), (33408, 1024)]
LN_PATHS = {"bf16": (torch.bfloat16, torch.bfloat16), "bf16_f32": (torch.bfloat16, torch.float32),
            "f32": (torch.float32, torch.float32)}
LN_TIMED = ("bf16", "bf16_f32")
LN_EDGES = [(1, 384), (17, 384), (9, 1024), (300, 8), (3, 8192), (77, 1408)]
LN_EMBED = (64 * 261, 384)
# Worst |kernel - plain| over the largest |plain| of y, dx, dgamma and dbeta:
# a bf16 y one ulp apart near the largest value is 2^-8 to 2^-7 of it.
LN_REL = 1e-2
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
    ("LayerNorm kernels (forward, dx, parameters)", ("dinox_layer_norm",)),
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
# The LayerNorm kernels' wrappers (ops/layer_norm.py: forward, dx,
# parameters). Every path counts them beside COUNTERS; a path holds them to
# exact numbers where its want names them (see held).
LN_COUNTERS = {"layer_norm_fwd": lnk.layer_norm_fwd, "layer_norm_bwd": lnk.layer_norm_bwd,
               "layer_norm_bwd_params": lnk.layer_norm_bwd_params}
MLP_FWD_PARTS = tuple(f"fused_mlp_fwd_{p}" for p in fm.FWD_PARTS)
MLP_BWD_PARTS = tuple(f"fused_mlp_bwd_{p}" for p in fm.BWD_PARTS)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in (COUNTERS | LN_COUNTERS).items()}


def reset_launch_counts() -> None:
    for fn in (COUNTERS | LN_COUNTERS).values():
        fn.launches = 0


def held(counts: dict[str, int], want: dict[str, int]) -> bool:
    """*counts* equal to *want* at each of *want*'s keys: every COUNTERS key
    (want_counts sets them), and the LayerNorm keys where a path names
    them."""
    return all(counts.get(k, 0) == v for k, v in want.items())


def ln_launches(counts: dict[str, int]) -> list[int]:
    """The LayerNorm launches of *counts*: forward, dx, parameters."""
    return [counts.get(k, 0) for k in LN_COUNTERS]


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
    if not held(counts, want):
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


def check_step(models: tuple, label: str, loss_type: str = "dino") -> None:
    """One micro-step of full ViT-S scale-aware at bs 8 for each of the two
    model configs *models* (the one under test first), from one state (scale
    pathway made live) and the same views (and, for MAE, the same mask
    noise). With MoE, also the experts each token went to in both runs."""
    cfgs = [TrainConfig(model=m, batch_size=8, koleo_weight=0.1, loss_type=loss_type) for m in models]
    states = [create_train_state(cfg, seed=SEED) for cfg in cfgs]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    if loss_type != "mae":
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
    noise = torch.rand((16, models[0].n_patches), generator=torch.Generator().manual_seed(SEED + 9))
    compare_micro_steps(states, cfgs, views, spacing, "ViT-S scale-aware bs8, " + label,
                        mask_noise=noise if loss_type == "mae" else None,
                        routing=models[0].moe_experts > 0)


@contextlib.contextmanager
def recorded_routing(model: torch.nn.Module):
    """Yields a list that receives (expert, top-2 margin) of every MoE MLP
    call of *model* while the block runs."""
    seen: list[tuple[torch.Tensor, torch.Tensor]] = []

    def note(mod, args) -> None:
        with torch.no_grad():
            probs, expert, _, _ = mod.route(args[0])
            top2 = probs.topk(2, dim=-1).values
            seen.append((expert, top2[..., 0] - top2[..., 1]))

    hooks = [m.register_forward_pre_hook(note) for m in model.modules() if isinstance(m, MoeMlp)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def compare_micro_steps(states: list, cfgs: list, views: torch.Tensor, spacing: torch.Tensor,
                        label: str, mask_noise: torch.Tensor | None = None,
                        routing: bool = False) -> None:
    """micro_loss_and_grads of two states (the one under test first) on the
    same (n_views, B, S, S, 3) views: the losses within 1e-2 relative and
    every gradient that is not zero in both at cosine >= 0.99. With
    *routing* (MoE): first the routing each student's forward takes on its
    own: at least 99% of the token decisions equal (a token whose top-2
    router margin is below the two runs' rounding difference may go either
    way, and a flipped token's router gradient differs; the flips' margins
    are printed); then the step of the second state runs with the first's
    routing (``MoeMlp.route``'s *expert*), so that the gradients compare
    the attention kernels, not a flipped token."""
    batch = views.reshape((-1,) + tuple(views.shape[2:]))
    with recorded_routing(states[0].student) as seen:
        first = micro_loss_and_grads(states[0], states[0].center, batch, spacing, cfgs[0],
                                     mask_noise=mask_noise)
    moes = [m for m in states[1].student.modules() if isinstance(m, MoeMlp)]
    if routing:
        sp2 = torch.cat([spacing, spacing]) if cfgs[1].model.scale_aware else None
        with torch.no_grad(), recorded_routing(states[1].student) as own:
            states[1].student.forward_features(batch, sp2)
        same = torch.cat([(a == b).flatten() for (a, _), (b, _) in zip(seen, own)])
        margins = torch.cat([m.flatten() for _, m in own])
        flips = margins[~same]
        print(f"MoE routing, {label}: {int(same.sum())} of {same.numel()} token decisions "
              f"({len(seen)} MoE calls) go to the same expert in both runs "
              f"({100 * same.float().mean().item():.3f}%); the {int((~same).sum())} others had top-2 "
              f"margins up to {flips.max().item() if flips.numel() else 0.0:.3e} in the plain run "
              f"(median margin of all tokens {margins.median().item():.3e})", flush=True)
        if same.float().mean().item() < 0.99:
            fail(f"the MoE routing ({label}) disagrees on more than 1% of the tokens")
        for m, (expert, _) in zip(moes, seen):  # the second run takes the first's routing
            m.route = functools.partial(MoeMlp.route, m, expert=expert)
    try:
        second = micro_loss_and_grads(states[1], states[1].center, batch, spacing, cfgs[1],
                                      mask_noise=mask_noise)
    finally:
        for m in moes:
            m.__dict__.pop("route", None)
    (g_k, _, m_k), (g_p, _, m_p) = first, second
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
    """Rate, MFU (unless *cfg* is None: no FLOP count for that objective),
    busy share and device time by *kinds* of a bench_train_step result with
    a profile."""
    peak = card_peaks(card)[0]
    util = "" if cfg is None else (f"; MFU {mfu(res['slices_per_s'], cfg, peak):.4f} against "
                                   f"{peak / 1e12:.0f} TFLOP/s bf16")
    print(f"training rate: {res['slices_per_s']:.2f} slices/s ({res['step_ms']:.2f} ms per step "
          f"of {TRAIN_BATCH} slices, host clock over {steps} steps){util}", flush=True)
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


def host_state() -> str:
    """This process's live threads and the machine's load averages: what
    else holds the host where a step's rate is host-set."""
    names = sorted(t.name for t in threading.enumerate())
    return f"{len(names)} threads {names}; load averages {os.getloadavg()}"


def train(card: str) -> tuple[dict[str, int], float, float]:
    """The training path at full width: bench_train_step(96), tanh arm, with
    exact launch counts (the LayerNorm kernels' among them). Returns the
    counts of this run, its slices/s and the device ms of its profiled
    step."""
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=BENCH_STEPS, warmup=TRAIN_WARMUP, profile=True)
    counts = launch_counts()
    steps = TRAIN_WARMUP + BENCH_STEPS + 1
    norms = 2 * cfg.depth + 2  # the blocks', the final and the ScaleEmbedding's
    want = want_counts(packed_attention=steps * 2 * cfg.depth, packed_attention_bwd_dq=steps * cfg.depth,
                       packed_attention_bwd_dkv=steps * cfg.depth, layer_norm_fwd=steps * 2 * norms,
                       layer_norm_bwd=steps * norms, layer_norm_bwd_params=steps * norms)
    print(f"trained {steps} steps of ViT-S scale-aware bs{TRAIN_BATCH}: losses "
          f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, all finite; launches {counts} "
          f"(want {want}: attention forward 2 x depth, each backward kernel depth; the LayerNorm "
          f"forward 2 x {norms} (the student's and the teacher's norms), dx and parameters "
          f"{norms} (the student's backward); per step)", flush=True)
    if not held(counts, want):
        fail("the training step did not run every attention and LayerNorm through the kernels "
             "exactly once")
    report_training(res, cfg, card, BENCH_STEPS)
    print(f"phase 8 host: {host_state()}", flush=True)
    return counts, res["slices_per_s"], res["profile"]["device_ms"]


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
    if not held(counts, want):
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


def ln_inputs(rows: int, c: int, x_dtype: torch.dtype, y_dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, c), generator=g, device="cuda") * 2.0 + 0.5).to(x_dtype)
    w = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    b = 0.1 * torch.randn(c, generator=g, device="cuda")
    dy = torch.randn((rows, c), generator=g, device="cuda").to(y_dtype)
    return x, w, b, dy


def ln_kernels(x, w, b, dy, y_dtype) -> tuple[torch.Tensor, ...]:
    """y, dx, dgamma, dbeta through the kernels' autograd function."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    y = lnk.layer_norm(*leaves, y_dtype)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def check_layer_norm() -> float:
    """The LayerNorm kernels (forward, dx, parameters) against their plain
    versions at LN_SHAPES and LN_EDGES on every path, each twice for equal
    bits; then the forward alone, as an embedding batch runs it (no
    gradient: no statistics written), at LN_EMBED's rows on the cells'
    paths, against the plain version and bit-equal to the forward that
    writes the statistics. Returns the worst error over the largest plain
    value."""
    worst = 0.0
    for label in LN_TIMED:
        xd, yd = LN_PATHS[label]
        x, w, b, dy = ln_inputs(*LN_EMBED, xd, yd, SEED + 39)
        with torch.inference_mode():
            y = lnk.layer_norm(x, w, b, yd)
        want = lnk.layer_norm_reference(x, w, b, yd).float()
        rel = (y.float() - want).abs().max().item() / want.abs().max().item()
        same = torch.equal(y, ln_kernels(x, w, b, dy, yd)[0])
        print(f"kernel check layer_norm without a gradient, rows={LN_EMBED[0]} C={LN_EMBED[1]} "
              f"{label}: max_abs_err/max|want| {rel:.3e} (tol {LN_REL}); bit-equal to the forward "
              f"that writes the statistics: {same}", flush=True)
        if not np.isfinite(rel) or rel >= LN_REL or not same:
            fail(f"layer_norm's forward without a gradient disagrees at {LN_EMBED} {label}")
        worst = max(worst, rel)
    names = ("y", "dx", "dgamma", "dbeta")
    for i, (rows, c) in enumerate(LN_SHAPES + LN_EDGES):
        for label, (xd, yd) in LN_PATHS.items():
            args = ln_inputs(rows, c, xd, yd, SEED + 40 + i)
            runs = [ln_kernels(*args, yd) for _ in range(2)]
            torch.cuda.synchronize()
            want = (lnk.layer_norm_reference(*args[:3], yd),
                    *lnk.layer_norm_backward_reference(args[0], args[1], args[3]))
            rels = [(g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                    for g, w in zip(runs[0], want)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            k = int(np.argmax(rels))
            print(f"kernel check layer_norm rows={rows} C={c} {label}: max_abs_err/max|want| worst "
                  f"{rels[k]:.3e} ({names[k]}; tol {LN_REL}); two runs bit-equal: {same}",
                  flush=True)
            if not np.isfinite(rels).all() or max(rels) >= LN_REL:
                fail(f"layer_norm disagrees with its plain version at {(rows, c)} {label}")
            if not same:
                fail(f"layer_norm's bits are not repeatable at {(rows, c)} {label}")
            worst = max(worst, *rels)
    return worst


def time_layer_norm(peaks: tuple[float, float]) -> dict[str, dict]:
    """The LayerNorm kernels at LN_SHAPES on the cells' paths (LN_TIMED:
    the block norms' and the final norm's): the forward (with
    the rows' statistics, as the student's pass runs it) and the backward
    (dx and the parameters' launch), each per call and back to back, beside
    its bound, the plain version's time, autograd of the plain forward (the
    eager chain the blocks ran before the kernels) and F.layer_norm's
    forward and backward (the library's yardstick, which the port does not
    call; it takes gamma and beta in x's dtype)."""
    out: dict[str, dict] = {}
    for rows, c in LN_SHAPES:
        for label in LN_TIMED:
            xd, yd = LN_PATHS[label]
            x, w, b, dy = ln_inputs(rows, c, xd, yd, SEED + 50)
            y = torch.empty((rows, c), dtype=yd, device="cuda")
            stats = torch.empty((2, rows), device="cuda")
            grid = lnk.backward_grid(rows, c, xd, yd)
            dx, part = torch.empty_like(x), torch.empty((grid, 2 * c), device="cuda")
            dw, db = torch.empty(c, device="cuda"), torch.empty(c, device="cuda")

            def fwd():
                lnk.layer_norm_fwd(x, w, b, y, stats)

            def bwd():
                lnk.layer_norm_bwd(x, w, dy, stats, dx, part, grid)
                lnk.layer_norm_bwd_params(part, dw, db)

            fwd()
            t = {"shape": [rows, c], "path": label, "grid": grid,
                 "ms": median_ms(fwd), "device_ms": stream_ms(fwd),
                 "bwd_ms": median_ms(bwd), "bwd_device_ms": stream_ms(bwd),
                 "plain_ms": median_ms(lambda: lnk.layer_norm_reference(x, w, b, yd), iters=10),
                 "bwd_plain_ms": median_ms(lambda: lnk.layer_norm_backward_reference(x, w, dy),
                                           iters=10),
                 "library_ms": median_ms(lambda: F.layer_norm(x, (c,), w.to(xd), b.to(xd),
                                                              lnk.LN_EPS))}
            leaves = [t_.detach().requires_grad_(True) for t_ in (x, w, b)]
            eager = lnk.layer_norm_reference(*leaves, yd)
            t["bwd_eager_autograd_ms"] = median_ms(
                lambda: torch.autograd.grad(eager, leaves, dy, retain_graph=True), iters=10)
            lib = F.layer_norm(leaves[0], (c,), leaves[1].to(xd), leaves[2].to(xd), lnk.LN_EPS)
            t["bwd_library_ms"] = median_ms(
                lambda: torch.autograd.grad(lib, leaves, dy.to(lib.dtype), retain_graph=True),
                iters=10)
            del eager, lib, leaves
            fb = bound_ms(*layer_norm_fwd_work(rows, c, xd.itemsize, yd.itemsize), peaks)
            bb = bound_ms(*layer_norm_bwd_work(rows, c, xd.itemsize, yd.itemsize), peaks)
            t.update(bound_ms=fb[0], bound_by=fb[1], bwd_bound_ms=bb[0], bwd_bound_by=bb[1],
                     pct_of_bound=100 * fb[0] / t["device_ms"],
                     bwd_pct_of_bound=100 * bb[0] / t["bwd_device_ms"])
            print(f"layer_norm {label} at ({rows}, {c}): forward {t['ms']:.4f} ms per call, "
                  f"{t['device_ms']:.4f} ms back to back, {t['pct_of_bound']:.1f}% of the "
                  f"{fb[0]:.4f} ms bound ({fb[1]}); plain {t['plain_ms']:.4f} ms, F.layer_norm "
                  f"{t['library_ms']:.4f} ms. Backward (dx + parameters over {grid} CTAs) "
                  f"{t['bwd_ms']:.4f} ms per call, {t['bwd_device_ms']:.4f} ms back to back, "
                  f"{t['bwd_pct_of_bound']:.1f}% of the {bb[0]:.4f} ms bound ({bb[1]}); plain "
                  f"{t['bwd_plain_ms']:.4f} ms, eager autograd {t['bwd_eager_autograd_ms']:.4f} "
                  f"ms, F.layer_norm's backward {t['bwd_library_ms']:.4f} ms", flush=True)
            out[f"{label}_{c}"] = t
    return out


# -- DINOv3 ViT-7B/16's block (phase 37) -----------------------------------
# The 7B cell's micro-step: 2 x 32 views of 261 tokens (CLS, the 16 x 16
# patches, 4 registers) at dim 4096, 32 heads of 128; the SwiGLU's rows are
# its 16704 tokens by 8192. RoPE at the teacher's tables and at a student's
# rescale draw. The launch gates run a 2-block stack at the full widths.
D3_VIEWS, D3_GRID, D3_REGS, D3_DIM, D3_HEADS, D3_HIDDEN = 64, 16, 4, 4096, 32, 8192
D3_TOKENS = 1 + D3_GRID * D3_GRID + D3_REGS
D3_SHAPE = (D3_VIEWS, D3_TOKENS, 3 * D3_DIM, D3_HEADS)
D3_RESCALES = (1.0, 1.6)
D3_STEP_DEPTH, D3_STEP_BATCH = 2, 4
# A SwiGLU kernel rounds the float32 gate once, as the plain version does;
# its exp may differ from PyTorch's by a float32 ulp, which moves a bf16
# rounding now and then. A gate computed in bf16 rounds twice and misses
# the plain bits far more often.
D3_GATE_BIT_EQUAL = 0.99
D3_COUNTERS = {"rope_fwd": rk.rope_fwd, "rope_bwd": rk.rope_bwd, "swiglu_fwd": sk.swiglu_fwd,
               "swiglu_bwd": sk.swiglu_bwd}


def check_dinov3_attention() -> tuple[float, float]:
    """Kernel 1 and the backward pair (kernels 2/3) at D3_SHAPE, head dim
    128, against their plain versions, each twice for equal bits. Returns
    the worst error forward and backward."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 70)
    b, n, three_dim, heads = D3_SHAPE
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, n, three_dim // 3), generator=g, device="cuda").to(torch.bfloat16)
    out = [flash_attention_packed(qkv, heads) for _ in range(2)]
    back = [fa.packed_attention_backward(qkv, do, heads) for _ in range(2)]
    torch.cuda.synchronize()
    err = (out[0].float() - packed_attention_reference(qkv, heads).float()).abs().max().item()
    want = fa.packed_attention_backward_reference(qkv, do, heads).float()
    bwd_err = (back[0].float() - want).abs().max().item()
    rel = bwd_err / want.abs().max().item()
    same = torch.equal(*out) and torch.equal(*back)
    print(f"kernel check head dim 128 at {D3_SHAPE}: packed_attention max_abs_err={err:.3e} (tol {TOL}); "
          f"backward pair max_abs_err={bwd_err:.3e} (tol {BWD_TOL}), max_abs_err/max|want|={rel:.3e} "
          f"(tol {BWD_REL}); two runs bit-equal: {same}", flush=True)
    if not np.isfinite([err, bwd_err]).all() or err >= TOL or bwd_err >= BWD_TOL or rel >= BWD_REL:
        fail(f"kernels 1-3 disagree with their plain versions at head dim 128, {D3_SHAPE}")
    if not same:
        fail(f"kernels 1-3's bits are not repeatable at head dim 128, {D3_SHAPE}")
    return err, bwd_err


def dinov3_rope(peaks: tuple[float, float]) -> dict:
    """The RoPE kernels at the 7B micro-step's qkv for each of D3_RESCALES:
    the forward (in place) and the backward bit-equal to their plain
    versions, twice, CLS, the registers and v untouched; then each timed
    per call and back to back beside its bound and the plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    b, n, three_dim, heads = D3_SHAPE
    hd, patches = D3_DIM // heads, D3_GRID * D3_GRID
    qkv = torch.randn((b, n, three_dim), generator=g, device="cuda").to(torch.bfloat16)
    for rho in D3_RESCALES:
        cos, sin = rk.rope_tables(D3_GRID, hd, rho, "cuda")
        runs = []
        for _ in range(2):
            got = qkv.clone()
            rk.rope_fwd(got, cos, sin, heads, 1)
            runs.append((got, rk.rope_bwd(qkv, cos, sin, heads, 1)))
        torch.cuda.synchronize()
        got, back = runs[0]
        exact = (torch.equal(got, rk.rope_reference(qkv, cos, sin, heads, 1))
                 and torch.equal(back, rk.rope_backward_reference(qkv, cos, sin, heads, 1)))
        kept = (torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[:, 1 + patches:], qkv[:, 1 + patches:])
                and torch.equal(got[..., 2 * D3_DIM:], qkv[..., 2 * D3_DIM:]))
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        print(f"kernel check rope at {D3_SHAPE}, rescale {rho}: forward and backward bit-equal to the "
              f"plain versions: {exact}; CLS, registers and v untouched: {kept}; two runs bit-equal: "
              f"{same}", flush=True)
        if not (exact and kept and same):
            fail(f"the RoPE kernels disagree with their plain versions at {D3_SHAPE}, rescale {rho}")
    cos, sin = rk.rope_tables(D3_GRID, hd, 1.0, "cuda")
    x = qkv.clone()

    def fwd():
        rk.rope_fwd(x, cos, sin, heads, 1)

    def bwd():
        rk.rope_bwd(qkv, cos, sin, heads, 1)

    bound = bound_ms(*rope_work(b, patches, D3_DIM, heads), peaks)
    t = {"shape": list(D3_SHAPE), "ms": median_ms(fwd), "device_ms": stream_ms(fwd),
         "bwd_ms": median_ms(bwd), "bwd_device_ms": stream_ms(bwd),
         "plain_ms": median_ms(lambda: rk.rope_reference(qkv, cos, sin, heads, 1), iters=10),
         "bwd_plain_ms": median_ms(lambda: rk.rope_backward_reference(qkv, cos, sin, heads, 1), iters=10),
         "bound_ms": bound[0], "bound_by": bound[1]}
    t.update(pct_of_bound=100 * bound[0] / t["device_ms"], bwd_pct_of_bound=100 * bound[0] / t["bwd_device_ms"])
    print(f"rope at {D3_SHAPE}: forward {t['ms']:.4f} ms per call, {t['device_ms']:.4f} ms back to back, "
          f"{t['pct_of_bound']:.1f}% of the {bound[0]:.4f} ms bound ({bound[1]}: q and k of the patch "
          f"rows and the tables); plain {t['plain_ms']:.4f} ms. Backward {t['bwd_ms']:.4f} ms per call, "
          f"{t['bwd_device_ms']:.4f} ms back to back, {t['bwd_pct_of_bound']:.1f}% of the same bound (it "
          f"also copies v and the unrotated rows); plain {t['bwd_plain_ms']:.4f} ms", flush=True)
    return t


def dinov3_swiglu(peaks: tuple[float, float]) -> dict:
    """The SwiGLU kernels at the 7B micro-step's rows: forward and backward
    within one bf16 step of their plain versions and at least
    D3_GATE_BIT_EQUAL of their elements bit-equal, twice for equal bits;
    then each timed beside its bound and the plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 72)
    rows = D3_VIEWS * D3_TOKENS
    h = (2 * torch.randn((rows, 2 * D3_HIDDEN), generator=g, device="cuda")).to(torch.bfloat16)
    dz = torch.randn((rows, D3_HIDDEN), generator=g, device="cuda").to(torch.bfloat16)
    runs = [(sk.swiglu_fwd(h), sk.swiglu_bwd(h, dz)) for _ in range(2)]
    torch.cuda.synchronize()
    worst, share = 0.0, 1.0
    for got, want in zip(runs[0], (sk.swiglu_reference(h), sk.swiglu_backward_reference(h, dz))):
        err = (got.float() - want.float()).abs()
        if not bool((err <= 2.0 ** -7 * want.float().abs() + 1e-30).all()):
            fail(f"the SwiGLU kernels are more than one bf16 step from their plain versions at ({rows}, "
                 f"{D3_HIDDEN})")
        worst = max(worst, err.max().item())
        share = min(share, (got == want).float().mean().item())
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"kernel check swiglu at ({rows}, {D3_HIDDEN}): within one bf16 step of the plain versions, "
          f"max_abs_err={worst:.3e}; the smaller share bit-equal {share:.5f} (at least "
          f"{D3_GATE_BIT_EQUAL}); two runs bit-equal: {same}", flush=True)
    if share < D3_GATE_BIT_EQUAL or not same:
        fail(f"the SwiGLU kernels do not round as their plain versions at ({rows}, {D3_HIDDEN})")
    fb = bound_ms(*swiglu_fwd_work(rows, D3_HIDDEN), peaks)
    bb = bound_ms(*swiglu_bwd_work(rows, D3_HIDDEN), peaks)
    t = {"shape": [rows, D3_HIDDEN], "max_abs_err": worst, "bit_equal": share,
         "ms": median_ms(lambda: sk.swiglu_fwd(h)), "device_ms": stream_ms(lambda: sk.swiglu_fwd(h)),
         "bwd_ms": median_ms(lambda: sk.swiglu_bwd(h, dz)), "bwd_device_ms": stream_ms(lambda: sk.swiglu_bwd(h, dz)),
         "plain_ms": median_ms(lambda: sk.swiglu_reference(h), iters=10),
         "bwd_plain_ms": median_ms(lambda: sk.swiglu_backward_reference(h, dz), iters=10),
         "bound_ms": fb[0], "bound_by": fb[1], "bwd_bound_ms": bb[0], "bwd_bound_by": bb[1]}
    t.update(pct_of_bound=100 * fb[0] / t["device_ms"], bwd_pct_of_bound=100 * bb[0] / t["bwd_device_ms"])
    print(f"swiglu at ({rows}, {D3_HIDDEN}): forward {t['ms']:.4f} ms per call, {t['device_ms']:.4f} ms back "
          f"to back, {t['pct_of_bound']:.1f}% of the {fb[0]:.4f} ms bound ({fb[1]}); plain "
          f"{t['plain_ms']:.4f} ms. Backward {t['bwd_ms']:.4f} ms per call, {t['bwd_device_ms']:.4f} ms back "
          f"to back, {t['bwd_pct_of_bound']:.1f}% of the {bb[0]:.4f} ms bound ({bb[1]}); plain "
          f"{t['bwd_plain_ms']:.4f} ms", flush=True)
    return t


def dinov3_step() -> dict[str, int]:
    """One optimizer step of a D3_STEP_DEPTH-block vit-7b16 stack at its
    widths (scale-aware, recomputation, the student's RoPE rescale drawn)
    at batch D3_STEP_BATCH, after one warm-up step, with every counter set
    to 0 just before it: exact launches of kernels 1-3, RoPE, SwiGLU and
    the LayerNorm kernels, none of any other kernel, a finite loss."""
    mcfg = MODEL_CONFIGS["vit-7b16"].replace(depth=D3_STEP_DEPTH, scale_aware=True, use_grad_checkpoint=True)
    cfg = TrainConfig(model=mcfg, img_size=mcfg.img_size, batch_size=D3_STEP_BATCH, koleo_weight=0.1)
    state = create_train_state(cfg, seed=SEED, device="cuda")
    step_fn = build_train_step(cfg, device="cuda")
    rng = np.random.default_rng(SEED + 73)
    pixels = torch.as_tensor(rng.integers(25000, 41000, (1, D3_STEP_BATCH, 512, 512, 3)).astype(np.uint16),
                             device="cuda")
    spacing = torch.as_tensor(rng.uniform(0.4, 3.0, (1, D3_STEP_BATCH, 3)).astype(np.float32), device="cuda")
    state, _ = step_fn(state, pixels, spacing)
    torch.cuda.synchronize()
    reset_launch_counts()
    for fn in D3_COUNTERS.values():
        fn.launches = 0
    state, metrics = step_fn(state, pixels, spacing)
    loss = float(metrics["loss"])
    counts = {**launch_counts(), **{k: fn.launches for k, fn in D3_COUNTERS.items()}}
    depth = mcfg.depth
    norms = 2 * depth + 2  # the blocks', the final and the ScaleEmbedding's
    # Passes a micro-step: the student's, its recomputation (the blocks
    # alone), the teacher's; one backward.
    want = {**want_counts(packed_attention=3 * depth, packed_attention_bwd_dq=depth,
                          packed_attention_bwd_dkv=depth),
            "layer_norm_fwd": 2 * norms + 2 * depth, "layer_norm_bwd": norms, "layer_norm_bwd_params": norms,
            "rope_fwd": 3 * depth, "rope_bwd": depth, "swiglu_fwd": 3 * depth, "swiglu_bwd": depth}
    print(f"vit-7b16 at depth {depth}, bs{D3_STEP_BATCH}, one step: loss {loss:.4f}; launches "
          f"{ {k: counts[k] for k in want} } (want {want})", flush=True)
    if not np.isfinite(loss):
        fail("the vit-7b16 step's loss is not finite")
    if not held(counts, want):
        fail("the vit-7b16 step did not run its attention, RoPE, SwiGLU and LayerNorm through the "
             "kernels exactly as often as its passes make them")
    del state, step_fn
    torch.cuda.empty_cache()
    return counts


def dinov3_path(peaks: tuple[float, float]) -> list[dict]:
    """Phase 37: the DINOv3 block's kernels at the 7B cell's shapes, checked,
    timed and gated on a micro-step; their entries of the kernels line."""
    err1, err23 = check_dinov3_attention()
    fwd = time_forward(peaks, D3_SHAPE, "DINOv3 ViT-7B micro-step", SEED + 74)
    bwd = time_backward(peaks, D3_SHAPE)
    rope_t, swiglu_t = dinov3_rope(peaks), dinov3_swiglu(peaks)
    counts = dinov3_step()
    step = f"vit-7b16 depth {D3_STEP_DEPTH} bs{D3_STEP_BATCH} step"
    return [
        {"name": "packed_attention_hd128", "route": "cuda", "source": "dinox_torch/ops/csrc/packed_attention.cu",
         "replaces": "dinox_tpu/ops/flash_attention.py:200", "launches": counts["packed_attention"],
         "launches_of": step, "max_abs_err": err1, "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound"][0], "bound_by": fwd["bound"][1], "library_ms": fwd["library_ms"],
         "shape": fwd["shape"], "device_ms": fwd["device_ms"]},
        {"name": "packed_attention_bwd_hd128", "route": "cuda",
         "source": "dinox_torch/ops/csrc/packed_attention_bwd.cu", "replaces": "dinox_tpu/ops/flash_attention.py:222",
         "launches": counts["packed_attention_bwd_dq"], "launches_of": step, "max_abs_err": err23,
         "ms": bwd["dq"]["ms"], "plain_ms": bwd["dq"]["plain_ms"], "bound_ms": bwd["dq"]["bound"][0],
         "bound_by": bwd["dq"]["bound"][1], "library_ms": bwd["dq"]["library_ms"], "shape": list(D3_SHAPE),
         "device_ms": bwd["dq"]["device_ms"], "dkv": bwd["dkv"]},
        {"name": "rope", "route": "cuda", "source": "dinox_torch/ops/csrc/rope.cu", "replaces": None,
         "launches": [counts["rope_fwd"], counts["rope_bwd"]], "launches_of": step, "max_abs_err": 0.0,
         **rope_t},
        {"name": "swiglu", "route": "cuda", "source": "dinox_torch/ops/csrc/swiglu.cu", "replaces": None,
         "launches": [counts["swiglu_fwd"], counts["swiglu_bwd"]], "launches_of": step, **swiglu_t},
    ]


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
    want_ln = [(depth + 2) * forwards, 0, 0]  # norm1 is kernel 6's prologue
    print(f"fused serving (EmbedService(fused_attn=True)): {forwards} forwards; launches "
          f"fused_attn_block {counts['fused_attn_block']} (depth x forwards = {depth * forwards}), "
          f"packed_attention {counts['packed_attention']} (want 0), LayerNorm forward, dx, "
          f"parameters {ln_launches(counts)} (want {want_ln}: norm2, the final and the "
          f"ScaleEmbedding's norm a forward); CLS cosine against the unfused service min "
          f"{min(cos):.6f}; served img/s at bucket 32: {96 / served_s:.2f}", flush=True)
    if forwards != 7 or counts["fused_attn_block"] != depth * forwards or counts["packed_attention"]:
        fail("the fused serving path did not run every block through kernel 6 exactly once")
    if ln_launches(counts) != want_ln:
        fail("the fused serving path did not run every other LayerNorm through the kernel once")
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


def pretrain_path(card: str, bench_rate: float, tmp: Path) -> tuple[dict[str, int], int]:
    """The pretraining path through python -m dinox_torch.pretrain at full
    width and depth: a straight run with exact launch counts, the same run
    interrupted by SIGINT and resumed (lr bit-equal, losses after the seam
    within RESUME_TOL), the --fused-attn path, and the host loader over a
    PNG tree. Leaves the straight run in tmp/straight and the tree in
    tmp/tree for the phases after it. Returns the launch counts of the
    straight run and, under "fused_attn_block", of the fused run, and the
    step the SIGINT leg stopped at."""
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
    if not held(counts, want):
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
    if not held(fused_counts, want) or not np.isfinite([r["loss"] for r in fused.values()]).all():
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
    return counts, seam


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
    by_name = device_ops(prof)
    busy_ms = sum(t for t, _, _ in by_name)
    print(f"{label} device time (torch.profiler, {what}): {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall = {100 * busy_ms / wall_ms:.1f}% busy; top items:", flush=True)
    for t, count, key in by_name[:8]:
        print(f"  {t:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)


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
          f"= {depth * forwards}, the LayerNorm forward (2 x depth + 2) x forwards = "
          f"{(2 * depth + 2) * forwards}, every other 0); probe {res['dataset_discrimination_probe']}; "
          f"spacing r2 {res['spacing_prediction'].get('r2')}; clustering enrichment "
          f"{res['domain_clustering']['enrichment_vs_random']:.3f}; counterfactual "
          f"{res['spacing_counterfactual']['cosine_distance_real_vs_2x']}", flush=True)
    norms = 2 * depth + 2
    if not held(counts, want_counts(packed_attention=depth * forwards, layer_norm_fwd=norms * forwards,
                                    layer_norm_bwd=0, layer_norm_bwd_params=0)):
        fail("evaluate_panorgan did not run every forward's attention through kernel 1 and its "
             f"{norms} LayerNorms through the forward kernel exactly once")
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
    (kernel 1 of the unfused runs, kernel 6 of the fused, the LayerNorm
    kernels of both) and that timing."""
    depth = MODEL_CONFIGS["vit-small"].depth
    total = {"packed_attention": 0, "fused_attn_block": 0, **dict.fromkeys(LN_COUNTERS, 0)}
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
            if [r["batch_size"] for r in res] != INFER_BATCHES or not held(counts, want_counts(
                    **{kernel: depth * forwards})):
                fail("bench_inference did not run every batch size through its kernel exactly as expected")
            for k in (kernel, *LN_COUNTERS):
                total[k] += counts[k]
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
                    or not held(counts, want_counts(**{kernel: depth * forwards}))):
                fail("the --slo bench did not run every forward through its kernel exactly once")
            for k in (kernel, *LN_COUNTERS):
                total[k] += counts[k]
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
    total = dict.fromkeys(COUNTERS | LN_COUNTERS, 0)
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
        if (not held(counts, want) or len(history) != 2 or set(files) != expected
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
    total = dict.fromkeys(COUNTERS | LN_COUNTERS, 0)
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
    if not held(counts, want):
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
    if (forwards != 12 or not held(counts, want_counts(packed_attention=depth * forwards))
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
    if (vr["n"] != 512 or not np.isfinite(vr["top1"])
            or not held(counts, want_counts(packed_attention=2 * depth))):
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
            or not held(counts, want) or "decoded-slice cache" not in text):
        fail("pretraining over the preprocessed DICOM/NIfTI tree did not run as expected")
    return counts



def release_path(tmp: Path) -> dict[str, int]:
    """Release staging (module 12) of the pretraining phase's straight run:
    python -m dinox_torch.publish_release with the evaluation phase's JSONs
    and the fine-tuning phase's adapter (the staged files, WEIGHTS.sha256
    against each weight file, the card's parameter count and Hardware row,
    no launch); the staged dir and its backbone.pth loaded back on the card
    (load times) and RELEASE_SLICES slices of the PNG tree encoded through
    kernel 1 by zoo.encode_batch, CLS bit-equal to load_backbone_from_run's;
    the staged dir served by EmbedService(fused_attn=True) through kernel 6
    (CLS cosine >= 0.999). Exact launches: depth x forwards on each kernel.
    Returns the phase's launches."""
    depth = MODEL_CONFIGS["vit-small"].depth
    run, staging, snap = tmp / "straight", tmp / "release", tmp / "release_snapshot"
    reset_launch_counts()
    wall, _ = run_cli(["--backbone", str(run), "--model-name", "dinox-ct-vits-smoke", "--eval-json",
                       str(tmp / "eval.json"), "--retrieval-json", str(tmp / "vr.json"), "--adapter",
                       str(tmp / "adapter0"), "--staging-dir", str(staging), "--snapshot-dir", str(snap)],
                      "on the straight run", publish_release.main)
    staged = {p.relative_to(staging).as_posix(): p for p in staging.rglob("*") if p.is_file()}
    want_files = {"README.md", "backbone.pth", "backbone.safetensors", "config.json", "eval_results.json",
                  "training_config.json", *(f"adapter/{p.name}" for p in (tmp / "adapter0").iterdir())}
    listed = {}
    for line in (snap / "WEIGHTS.sha256").read_text().splitlines()[1:]:
        digest, size, rel = line.split()
        listed[rel] = (digest, int(size))
    weights = {rel for rel, p in staged.items() if p.suffix in publish_release.WEIGHT_SUFFIXES}
    hashed = {}
    for rel in weights:
        with staged[rel].open("rb") as fh:
            hashed[rel] = (hashlib.file_digest(fh, "sha256").hexdigest(), staged[rel].stat().st_size)
    copied = sorted(p.relative_to(snap).as_posix() for p in snap.rglob("*") if p.is_file())
    print(f"publish_release on the straight run: {wall:.1f} s (the backbone read from the run on the "
          f"card, staged as safetensors and .pth with the card, configs, evaluations and the adapter, "
          f"and a weightless snapshot); staged {sorted(staged)}, {sum(p.stat().st_size for p in staged.values())} "
          f"bytes; WEIGHTS.sha256 lists {sorted(listed)}; snapshot {copied}", flush=True)
    if set(staged) != want_files or listed != hashed or set(copied) != (want_files - weights) | {"WEIGHTS.sha256"}:
        fail("publish_release did not stage the release and its weightless snapshot as expected")
    if not held(launch_counts(), want_counts()):
        fail("staging a release launched a kernel")

    loads = {}
    t0 = time.perf_counter()
    ref = load_backbone_from_run(run, device="cuda")
    loads["run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hub = load_model(staging, device="cuda")
    loads["hub dir"] = time.perf_counter() - t0
    override = json.loads((staging / "config.json").read_text())
    t0 = time.perf_counter()
    pth = load_model(staging / "backbone.pth", config_override=override, device="cuda")
    loads["backbone.pth"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in ref.parameters())
    card = (staging / "README.md").read_text()
    print(f"staged card: {n_params} backbone parameters; Parameters row "
          f"{re.search(r'[|] Parameters [|] (.*) [|]', card).group(1)}; Hardware row "
          f"{re.search(r'[|] Hardware [|] (.*) [|]', card).group(1)}", flush=True)
    if (f"| Parameters | {round(n_params / 1e6, 1)}M |" not in card or "TPU" in card
            or f"| Hardware | {DEFAULT_HARDWARE} |" not in card):
        fail("the staged card's parameter count or hardware row is wrong")

    rows = load_index_rows(tmp / "tree" / "index.csv")[:RELEASE_SLICES]
    imgs = [read_png16(r.png_path).astype(np.float32) - HU_SHIFT for r in rows]
    sps = [(r.spacing_x, r.spacing_y, r.spacing_z) for r in rows]
    forwards = -(-len(rows) // RELEASE_BATCH)
    cls, encode_ms = {}, {}
    reset_launch_counts()
    for name, model in (("run", ref), ("hub dir", hub), ("backbone.pth", pth)):
        t0 = time.perf_counter()
        cls[name] = encode_batch(model, imgs, sps, batch_size=RELEASE_BATCH)
        torch.cuda.synchronize()
        encode_ms[name] = (time.perf_counter() - t0) * 1e3
    counts = expect_counts("encode_batch of the run, the staged dir and backbone.pth",
                           want_counts(packed_attention=3 * forwards * depth),
                           f"kernel 1 depth x {forwards} forwards for each of the three")
    equal = {name: bool(torch.equal(cls[name], cls["run"])) for name in ("hub dir", "backbone.pth")}
    print(f"release loaded back on the card: load s {', '.join(f'{k} {v:.3f}' for k, v in loads.items())}; "
          f"encode_batch of {len(rows)} 512^2 slices (host preprocessing + {forwards} forwards of "
          f"{RELEASE_BATCH}, host clock) ms {', '.join(f'{k} {v:.1f}' for k, v in encode_ms.items())}; "
          f"CLS bit-equal to the run's backbone: {equal}", flush=True)
    if not all(equal.values()):
        fail("the staged release does not give the run's backbone's CLS bits")

    service = serve.EmbedService(str(staging), BUCKETS, device="cuda", fused_attn=True)
    try:
        reset_launch_counts()
        f0 = service.stats["forwards"]
        t0 = time.perf_counter()
        got = service.embed(imgs, sps)
        served_ms = (time.perf_counter() - t0) * 1e3
        served = service.stats["forwards"] - f0
    finally:
        service.close()
    fused = expect_counts("the staged dir served with fused_attn=True",
                          want_counts(fused_attn_block=served * depth),
                          f"kernel 6 depth x {served} forwards, kernel 1 none")
    want = cls["run"].float()
    want = (want / want.norm(dim=-1, keepdim=True)).cpu().numpy()
    cos = np.sum(got * want, axis=1)
    print(f"EmbedService(staged dir, fused_attn=True): {len(rows)} slices in {served} forwards, "
          f"{served_ms:.1f} ms (host clock); CLS cosine against the unfused run's backbone min "
          f"{cos.min():.6f}", flush=True)
    if cos.min() < 0.999:
        fail("the staged release served through kernel 6 disagrees with the unfused backbone")
    return add_counts(counts, fused)


def prepare_path(tmp: Path) -> dict[str, int]:
    """Data preparation into training (module 12): python -m
    dinox_torch.preprocessing.prepare_data --dry-run (every Parquet manifest
    it wrote read back through the port's reader and held to its index
    CSV), temperature_resample at T 2.0 on the combined index (the
    composition against temperature_weights), then python -m
    dinox_torch.pretrain on the resampled index at ViT-S bs PREP_BATCH for
    PREP_STEPS steps through kernels 1 and 2/3 (exact launches); the
    Parquet writer's and reader's host rate on a PARQUET_ROWS-row manifest.
    Returns the pretraining run's launches."""
    out = tmp / "prepared"
    wall, _ = run_cli(["--out", str(out), "--dry-run"], "--dry-run", prepare_data.main)
    manifests = sorted((out / "manifests").glob("*.parquet"))
    checked = {}
    for path in manifests:
        got = [r.model_dump() for r in DataManifest.load(path).records]
        want = [SliceMetadata(dataset=path.stem, series_id=r.series_dir, slice_idx=r.slice_index,
                              pixel_spacing_x=r.spacing_x, pixel_spacing_y=r.spacing_y,
                              slice_thickness=r.spacing_z, image_path=r.png_path).model_dump()
                for r in load_index_rows(out / path.stem / "_index" / "index.csv")]
        checked[path.stem] = (len(got), got == want)
    print(f"prepare_data --dry-run: {wall:.2f} s; manifests read back through the port's Parquet "
          f"reader against their index CSVs (rows, equal): {checked}", flush=True)
    if not manifests or not all(ok for _, ok in checked.values()):
        fail("prepare_data's manifests do not hold their index CSVs")

    combined, resampled = out / "_index" / "index.csv", out / "_index" / "resampled_t2.csv"
    total = PREP_STEPS * PREP_BATCH
    run_cli(["--index", str(combined), "--out", str(resampled), "--temperature", "2.0", "--total",
             str(total)], "T=2.0", temperature_resample.main)
    raw, rows = load_index_rows(combined), load_index_rows(resampled)
    names = sorted({r.dataset for r in raw})
    target = temperature_weights([sum(r.dataset == n for r in raw) for n in names], 2.0)
    got = [sum(r.dataset == n for r in rows) / len(rows) for n in names]
    err = max(abs(a - b) for a, b in zip(target, got))
    print(f"temperature_resample T=2.0: {len(raw)} slices -> {len(rows)}; composition "
          f"{dict(zip(names, got))} against temperature_weights {dict(zip(names, target))} "
          f"(max abs err {err:.4f})", flush=True)
    if len(rows) != total or err > 1 / total:
        fail("temperature_resample's composition does not follow the temperature weights")

    depth = MODEL_CONFIGS["vit-small"].depth
    reset_launch_counts()
    wall, _ = run_cli(["--config", "vit-small", "--scale-aware", "--index-csv", str(resampled),
                       "--batch-size", str(PREP_BATCH), "--canvas", "64", "--max-steps", str(PREP_STEPS),
                       "--warmup-steps", "1", "--run-dir", str(tmp / "prep_run"), "--log-json",
                       "--no-tensorboard"], "on the resampled index")
    metrics = read_metrics(tmp / "prep_run")
    losses = [metrics[k]["loss"] for k in sorted(metrics)]
    counts = expect_counts(f"pretrain over the resampled index ({PREP_STEPS} steps of ViT-S bs{PREP_BATCH}, "
                           f"{wall:.1f} s, losses {losses})",
                           want_counts(packed_attention=PREP_STEPS * 2 * depth,
                                       packed_attention_bwd_dq=PREP_STEPS * depth,
                                       packed_attention_bwd_dkv=PREP_STEPS * depth),
                           "kernel 1 2 x depth, dq and dkv depth a step")
    if sorted(metrics) != list(range(1, PREP_STEPS + 1)) or not np.isfinite(losses).all():
        fail("pretraining on the resampled index did not run as expected")

    rng = np.random.default_rng(SEED)
    organs = [["lung"], [], ["liver", "hepatic_vessels"], ["brain"]]
    records = [SliceMetadata(dataset=f"ds{i % 7}", series_id=f"1.3.6.1.4.{i // 160}", slice_idx=i % 160,
                             pixel_spacing_x=float(sx), pixel_spacing_y=float(sx), slice_thickness=float(st),
                             image_path=f"/data/processed/ds{i % 7}/series_{i // 160:05d}/{i % 160:04d}.png",
                             organs_present=organs[i % 4], patient_id=None if i % 3 else f"P{i // 480:05d}")
               for i, (sx, st) in enumerate(zip(rng.uniform(0.3, 1.0, PARQUET_ROWS),
                                                rng.choice([0.625, 1.0, 2.5, 5.0], PARQUET_ROWS)))]
    path = tmp / "manifest_100k.parquet"
    t0 = time.perf_counter()
    DataManifest(records).save(path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = DataManifest.load(path)
    read_s = time.perf_counter() - t0
    mb = path.stat().st_size / 1e6
    print(f"Parquet codec on a {PARQUET_ROWS}-row manifest ({mb:.2f} MB, PLAIN, uncompressed; host "
          f"clock): save {write_s:.3f} s = {PARQUET_ROWS / write_s:.0f} rows/s ({mb / write_s:.1f} MB/s), "
          f"load {read_s:.3f} s = {PARQUET_ROWS / read_s:.0f} rows/s ({mb / read_s:.1f} MB/s), records "
          f"validated; round trip equal: {back.records == records}", flush=True)
    if back.records != records:
        fail("the Parquet codec did not read back what it wrote")
    return counts


def canary_path(tmp: Path) -> None:
    """python -m dinox_torch.integration_canary at its defaults (8 steps, tol
    1e-5) on the card, with --report inside tmp: all three gates pass, each
    gate's wall time (from its line's arrival), and the repository's own
    canary_report.json is left as it was. The canary's trainer runs
    --attn-impl xla, as the JAX canary's does: no kernel."""
    root = Path(__file__).resolve().parent
    repo_report = root / "canary_report.json"
    before = repo_report.read_bytes() if repo_report.exists() else None
    report = tmp / "canary_report.json"
    cmd = [sys.executable, "-m", "dinox_torch.integration_canary", "--device", "cuda", "--report",
           str(report), "--workdir", str(tmp / "canary")]
    marks: dict[int, float] = {}
    t0 = time.perf_counter()
    with subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) as proc:
        tail = []
        for line in proc.stdout:
            tail = (tail + [line])[-40:]
            m = re.match(r"\[(\d)\]", line)
            if m:
                marks[int(m.group(1))] = time.perf_counter() - t0
                print(f"  canary {line.rstrip()}", flush=True)
        rc = proc.wait(timeout=60)
    wall = time.perf_counter() - t0
    if rc != 0 or not report.exists():
        fail(f"the integration canary exited {rc}:\n{''.join(tail)}")
    res = json.loads(report.read_text())
    det, res_f, samp = res["determinism"], res["resume_fidelity"], res["sampling_distribution"]
    gates = {"determinism": marks.get(1), "resume": marks.get(2, 0) - marks.get(1, 0),
             "sampling": marks.get(3, 0) - marks.get(2, 0)}
    print(f"integration canary (8 steps, tol {det['tolerance']}, --device cuda): {wall:.1f} s in all; "
          f"per gate s {', '.join(f'{k} {v:.1f}' for k, v in gates.items())} (determinism includes the "
          f"synthetic tree); determinism max rel diff {det['max_rel_diff']:.3e} over {det['steps']} steps; "
          f"resume max rel diff {res_f['max_rel_diff']:.3e} ({res_f['steps_resumed']} steps, NaN "
          f"{res_f['any_nan']}); sampling max abs err {samp['max_abs_err']:.4f} "
          f"({samp['observed_fractions']} against {samp['target_weights']}), smoke train "
          f"{samp['smoke_train_ok']}; all passed {res['all_passed']}", flush=True)
    after = repo_report.read_bytes() if repo_report.exists() else None
    if not res["all_passed"] or len(marks) != 3:
        fail("the integration canary failed a gate")
    if after != before:
        fail("the integration canary wrote the repository's canary_report.json")


def add_counts(total: dict[str, int], counts: dict[str, int]) -> dict[str, int]:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def expect_counts(label: str, want: dict[str, int], what: str) -> dict[str, int]:
    """The launch counts since the last reset, held to *want*."""
    counts = launch_counts()
    print(f"{label}: launches {counts} (want {want}: {what})", flush=True)
    if not held(counts, want):
        fail(f"{label} did not run every attention through the kernels exactly as counted")
    return counts


def scale_path(card: str) -> tuple[dict[str, int], dict]:
    """Phase 21, optimizer memory: bench_scale's step at ViT-L and ViT-G bs
    32 (use_grad_checkpoint), each model built once and measured under each
    optimizer kind of SCALE_KINDS in turn (the optimizer made anew), with
    exact launch counts (kernel 1 3 x depth a step: student, teacher,
    recomputation; dq and dkv depth). Prints bench_scale's lines (peak
    allocated, optimizer bytes; img/s, MFU, loss) for each. Returns the
    counts and {(config, kind): result}."""
    peak = card_peaks(card)[0]
    total: dict[str, int] = {}
    results = {}
    for config in SCALE_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        depth = MODEL_CONFIGS[config].depth
        steps = len(SCALE_KINDS) * (SCALE_WARMUP + SCALE_STEPS)
        reset_launch_counts()
        t0 = time.perf_counter()
        runs = bench_scale.run_kinds(config, SCALE_BATCH, SCALE_KINDS, steps=SCALE_STEPS,
                                     warmup=SCALE_WARMUP)
        wall = time.perf_counter() - t0
        total = add_counts(total, expect_counts(
            f"bench_scale {config} bs{SCALE_BATCH}, {steps} steps over {len(SCALE_KINDS)} optimizer kinds",
            want_counts(packed_attention=steps * 3 * depth, packed_attention_bwd_dq=steps * depth,
                        packed_attention_bwd_dkv=steps * depth),
            "kernel 1 3 x depth, dq and dkv depth, per step"))
        base = None
        for kind, cfg, res in runs:
            line = bench_scale.report(config, cfg, res, peak)
            base = base or res
            print(f"bench_scale {config} optimizer {kind} (mu {cfg.mu_dtype}, nu {cfg.nu_dtype}, "
                  f"factored_nu {cfg.factored_nu}):", flush=True)
            print(json.dumps({"max_memory_allocated": res["max_memory_allocated"],
                              "optimizer_bytes": res["optimizer_bytes"]}), flush=True)
            print(json.dumps(line), flush=True)
            print(f"  peak allocated {res['max_memory_allocated'] / 1e9:.3f} GB "
                  f"({(base['max_memory_allocated'] - res['max_memory_allocated']) / 1e9:+.3f} GB "
                  f"below f32), optimizer state {res['optimizer_bytes'] / 1e9:.3f} GB "
                  f"({(base['optimizer_bytes'] - res['optimizer_bytes']) / 1e9:+.3f} GB below f32); "
                  f"img/s {res['img_s']:.2f} ({res['img_s'] / base['img_s']:.3f} x f32)", flush=True)
            if not np.isfinite(res["loss"]):
                fail(f"bench_scale {config} {kind}: non-finite loss")
            results[(config, kind)] = {**res, "mfu": line["mfu"]}
        print(f"bench_scale {config}: {wall:.1f} s for the model and {len(SCALE_KINDS)} kinds",
              flush=True)
        del runs
    return total, results


def moe_path(card: str, bench_rate: float, tmp: Path) -> tuple[dict[str, int], dict]:
    """Phase 22, MoE: a ViT-S E4 micro-step through the kernels against
    plain attention (loss, gradients, routing); the bench's moe4 arm (bs 96,
    exact launches, one profiled step); python -m dinox_torch.pretrain
    --moe-experts 4 for MODULE11_STEPS steps (exact launches, a finite
    loss_moe_aux at every step); its checkpoint exported as a hub v2 dir and
    served through EmbedService (CLS cosine against plain attention,
    launches == depth x forwards); bench_moe_sweep at SWEEP_EXPERTS x
    SWEEP_FACTORS. Returns the counts of the timed paths and the moe4
    numbers."""
    peak = card_peaks(card)[0]
    vit_s = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    depth = vit_s.depth
    moe = vit_s.replace(moe_experts=4)
    check_step((moe, moe.replace(attn_impl="xla")), "MoE E4 cf1.25, kernels vs plain attention")
    total: dict[str, int] = {}

    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, moe_experts=4,
                           profile=True)
    steps = TRAIN_WARMUP + TRAIN_STEPS + 1
    total = add_counts(total, expect_counts(
        f"bench moe4 arm, {steps} steps", want_counts(
            packed_attention=steps * 2 * depth, packed_attention_bwd_dq=steps * depth,
            packed_attention_bwd_dkv=steps * depth), "forward 2 x depth, backward depth, per step"))
    moe_cfg = bench_config(TRAIN_BATCH, moe_experts=4).model
    rate = res["slices_per_s"]
    moe4 = {"moe4_slices_per_sec": rate, "moe4_mfu": mfu(rate, moe_cfg, peak),
            "step_ms": res["step_ms"]}
    print(json.dumps(moe4), flush=True)
    print(f"moe4 arm: {res['step_ms']:.2f} ms a bs{TRAIN_BATCH} step, {rate:.2f} slices/s against "
          f"the dense tanh arm's {bench_rate:.2f} (phase 8): {100 * (bench_rate / rate - 1):.1f}% "
          f"slower", flush=True)
    report_training(res, moe_cfg, card, TRAIN_STEPS)

    run = tmp / "moe"
    reset_launch_counts()
    wall, _ = run_cli(PRETRAIN_ARGS + ["--moe-experts", "4", "--max-steps", str(MODULE11_STEPS),
                                       "--run-dir", str(run)], "--moe-experts 4")
    total = add_counts(total, expect_counts(
        f"pretrain --moe-experts 4, {MODULE11_STEPS} steps", want_counts(
            packed_attention=MODULE11_STEPS * 2 * depth,
            packed_attention_bwd_dq=MODULE11_STEPS * depth,
            packed_attention_bwd_dkv=MODULE11_STEPS * depth), "forward 2 x depth, backward depth"))
    metrics = read_metrics(run)
    aux = [metrics.get(s, {}).get("loss_moe_aux", float("nan")) for s in range(1, MODULE11_STEPS + 1)]
    loss = [metrics.get(s, {}).get("loss", float("nan")) for s in range(1, MODULE11_STEPS + 1)]
    print(f"pretrain --moe-experts 4: {MODULE11_STEPS} steps in {wall:.1f} s; loss {loss[0]:.4f} -> "
          f"{loss[-1]:.4f}, loss_moe_aux {aux[0]:.4f} -> {aux[-1]:.4f}", flush=True)
    if not np.isfinite(aux + loss).all():
        fail("the MoE pretraining run did not log a finite loss and loss_moe_aux at every step")

    hub = tmp / "moe_hub"
    export_hub_checkpoint(load_backbone_from_run(run), hub, use_safetensors=True)
    hub_cfg = json.loads((hub / "config.json").read_text())
    if hub_cfg.get("weights_format") != "jax" or hub_cfg.get("moe_experts") != 4:
        fail(f"the MoE run exported a hub dir with config {hub_cfg}")
    service = serve.EmbedService(str(hub), BUCKETS, device="cuda")
    try:
        rng = np.random.default_rng(SEED + 12)
        imgs = rng.integers(-1000, 1500, size=(8, 512, 512)).astype(np.float32)
        sps = rng.uniform(0.5, 3.0, size=(8, 3)).astype(np.float32)
        reset_launch_counts()
        f0 = service.stats["forwards"]
        with recorded_routing(service.model) as seen:  # one bucket-8 forward
            served = service.embed(list(imgs), sps)
        forwards = service.stats["forwards"] - f0
        counts = launch_counts()
        ref = LoadedModel(service.model.cfg.replace(attn_impl="xla"), "cuda")
        ref.load_state_dict(service.model.state_dict())
        xs = np.stack([_preprocess(im, 224, "hu_float", 40.0, 400.0) for im in imgs])
        with recorded_routing(ref) as own:
            free = ref(xs, sps)[:, 0, :].float().cpu().numpy()
        moes = [m for m in ref.modules() if isinstance(m, MoeMlp)]
        for m, (expert, _) in zip(moes, seen):  # the plain model takes the served routing
            m.route = functools.partial(MoeMlp.route, m, expert=expert)
        held = ref(xs, sps)[:, 0, :].float().cpu().numpy()
    finally:
        service.close()
    same = torch.cat([(a == b).flatten() for (a, _), (b, _) in zip(seen, own)]).float().mean().item()
    cos, cos_free = cls_cosine(np.asarray(served), held), cls_cosine(np.asarray(served), free)
    print(f"served the MoE run's hub v2 dir: {forwards} forwards, packed_attention launches "
          f"{counts['packed_attention']} (depth x forwards = {depth * forwards}); CLS cosine "
          f"against plain attention on the served routing min {cos.min():.6f}; on its own routing "
          f"({100 * same:.3f}% of token decisions equal) min {cos_free.min():.6f}", flush=True)
    if (not held(counts, want_counts(packed_attention=depth * forwards)) or cos.min() < 0.999
            or same < 0.99):
        fail("the served MoE backbone did not go through the kernel or disagrees with plain attention")

    reset_launch_counts()
    argv = ["--experts", *map(str, SWEEP_EXPERTS), "--capacity-factors", *map(str, SWEEP_FACTORS),
            "--steps", str(SWEEP_STEPS), "--warmup", str(SWEEP_WARMUP)]
    wall, out = run_cli(argv, "sweep", main=bench_moe_sweep.main)
    points = len(SWEEP_EXPERTS) * len(SWEEP_FACTORS) * (SWEEP_WARMUP + SWEEP_STEPS)
    total = add_counts(total, expect_counts(
        f"bench_moe_sweep E {SWEEP_EXPERTS} x cf {SWEEP_FACTORS}, {points} steps in {wall:.1f} s",
        want_counts(packed_attention=points * 2 * depth, packed_attention_bwd_dq=points * depth,
                    packed_attention_bwd_dkv=points * depth), "forward 2 x depth, backward depth"))
    return total, moe4


def mae_path(card: str, tmp: Path) -> tuple[dict[str, int], dict]:
    """Phase 23, MAE: a ViT-S MAE micro-step through the kernels against
    plain attention (same views, same mask noise); the MAE step at bs 96
    timed and profiled (its ms and busy share); python -m
    dinox_torch.pretrain --loss-type mae for MODULE11_STEPS steps, exact
    launches (kernel 1, dq and dkv each depth + 8 a step: encoder and
    decoder, no teacher). Returns the counts and the step's numbers."""
    vit_s = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
    per_step = vit_s.depth + MAE_DECODER_DEPTH
    check_step((vit_s, vit_s.replace(attn_impl="xla")), "MAE, kernels vs plain attention",
               loss_type="mae")
    total: dict[str, int] = {}
    cfg = TrainConfig(model=vit_s, batch_size=TRAIN_BATCH, loss_type="mae", warmup_steps=100,
                      max_steps=5000)
    reset_launch_counts()
    res = bench_train_step(TRAIN_BATCH, steps=FUSED_STEPS, warmup=FUSED_WARMUP, profile=True, cfg=cfg)
    steps = FUSED_WARMUP + FUSED_STEPS + 1
    total = add_counts(total, expect_counts(
        f"MAE step bs{TRAIN_BATCH}, {steps} steps", want_counts(
            packed_attention=steps * per_step, packed_attention_bwd_dq=steps * per_step,
            packed_attention_bwd_dkv=steps * per_step), "kernel 1, dq and dkv depth + 8 a step"))
    prof = res["profile"]
    step = {"step_ms": res["step_ms"], "samples_per_s": res["slices_per_s"],
            "device_ms": prof["device_ms"], "busy": prof["device_ms"] / prof["wall_ms"]}
    print(f"MAE step: {res['step_ms']:.2f} ms a bs{TRAIN_BATCH} step ({res['slices_per_s']:.2f} "
          f"samples/s, host clock over {FUSED_STEPS} steps); losses {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}", flush=True)
    report_training(res, None, card, FUSED_STEPS)

    run = tmp / "mae"
    reset_launch_counts()
    wall, _ = run_cli(PRETRAIN_ARGS + ["--loss-type", "mae", "--max-steps", str(MODULE11_STEPS),
                                       "--run-dir", str(run)], "--loss-type mae")
    n = MODULE11_STEPS * per_step
    total = add_counts(total, expect_counts(
        f"pretrain --loss-type mae, {MODULE11_STEPS} steps",
        want_counts(packed_attention=n, packed_attention_bwd_dq=n, packed_attention_bwd_dkv=n),
        "kernel 1, dq and dkv depth + 8 a step; no teacher forward"))
    metrics = read_metrics(run)
    loss = [metrics.get(s, {}).get("loss_mae", float("nan")) for s in range(1, MODULE11_STEPS + 1)]
    print(f"pretrain --loss-type mae: {MODULE11_STEPS} steps in {wall:.1f} s; loss_mae {loss[0]:.4f} "
          f"-> {loss[-1]:.4f}", flush=True)
    if not np.isfinite(loss).all():
        fail("the MAE pretraining run did not log a finite loss_mae at every step")
    return total, step


def monitor_path(tmp: Path) -> dict[str, int]:
    """Phase 24, monitoring: python -m dinox_torch.pretrain --monitor-every
    MONITOR_EVERY for MODULE11_STEPS steps (two health.jsonl lines and two
    previews; kernel 1 2 x depth a step and depth a snapshot), then python
    -m dinox_torch.monitor --run-dir on that run (one forward of its 32
    probes: depth launches). Returns the counts."""
    depth = MODEL_CONFIGS["vit-small"].depth
    run = tmp / "monitored"
    snaps = MODULE11_STEPS // MONITOR_EVERY
    reset_launch_counts()
    run_cli(PRETRAIN_ARGS + ["--monitor-every", str(MONITOR_EVERY), "--max-steps",
                             str(MODULE11_STEPS), "--run-dir", str(run)], "--monitor-every")
    total = expect_counts(
        f"pretrain --monitor-every {MONITOR_EVERY}, {MODULE11_STEPS} steps", want_counts(
            packed_attention=MODULE11_STEPS * 2 * depth + snaps * depth,
            packed_attention_bwd_dq=MODULE11_STEPS * depth,
            packed_attention_bwd_dkv=MODULE11_STEPS * depth),
        "2 x depth a step and depth a snapshot; backward depth a step")
    health = [json.loads(x) for x in (run / "monitor" / "health.jsonl").read_text().splitlines()]
    pngs = sorted((run / "monitor").glob("step_*.png"))
    shapes = [read_png16(p).shape for p in pngs]
    print(f"monitor: health.jsonl {health}; previews {[p.name for p in pngs]} {shapes}", flush=True)
    if [h["step"] for h in health] != [MONITOR_EVERY * (i + 1) for i in range(snaps)] \
            or len(pngs) != snaps or any(sh != (192, 388) for sh in shapes) \
            or not all(np.isfinite([h["embed_std"], h["gram_mean"]]).all() for h in health):
        fail("the in-loop monitor did not write its snapshots")
    reset_launch_counts()
    _, out = run_cli(["--run-dir", str(run)], "monitor", main=monitor.main)
    total = add_counts(total, expect_counts("python -m dinox_torch.monitor", want_counts(
        packed_attention=depth), "one forward of 32 probes"))
    stats = json.loads((run / "stats.json").read_text())
    if stats["step"] != MODULE11_STEPS or read_png16(run / "heatmap.png").shape != (224, 224):
        fail(f"the monitor CLI wrote {stats} and no 224 px heatmap")
    return total


def tools_path(tmp: Path, seam: int) -> dict[str, int]:
    """Phase 28, the run-dir readers on the pretraining phase's runs:
    compare_runs of the straight run against the SIGINT-resumed one (every
    step, within RESUME_TOL), soak_seam_analysis at the SIGINT seam (the lr
    ratio that of the straight run across the same step) and on the run
    resumed from step 20, log_runs over those runs (a row each, the steps
    done). Host work: no launch. Returns the phase's launches."""
    t0 = time.perf_counter()
    straight, killed, mid = tmp / "straight", tmp / "killed", tmp / "from20"
    reset_launch_counts()
    _, out = run_cli([str(straight / "metrics.jsonl"), str(killed / "metrics.jsonl")],
                     "straight vs SIGINT-resumed", compare_runs.main)
    cmp = json.loads(out)
    print(f"compare_runs straight vs the SIGINT-resumed run: overlap_steps {cmp['overlap_steps']}, "
          f"max_rel_diff {cmp['max_rel_diff']:.3e} (tol {RESUME_TOL}), max_abs_diff "
          f"{cmp['max_abs_diff']:.3e}, tail_rel_gap {cmp['tail_rel_gap']:.3e}", flush=True)
    if cmp["overlap_steps"] != PRETRAIN_STEPS or not cmp["max_rel_diff"] <= RESUME_TOL:
        fail("compare_runs does not see the resumed run continue the straight one")
    ref = read_metrics(straight)
    want_ratio = round(ref[seam + 1]["lr"] / max(ref[seam]["lr"], 1e-12), 4)
    _, out = run_cli(["--run", str(killed), "--seams", str(seam)], f"at step {seam}",
                     soak_seam_analysis.main)
    soak = json.loads(out)
    row = soak["seams"][0]
    print(f"soak_seam_analysis at the SIGINT seam (step {seam}): jump_ratio {row.get('jump_ratio')}, "
          f"{row.get('jump_in_noise_units')} noise units, lr_ratio {row.get('lr_ratio')} (the straight "
          f"run's across step {seam}: {want_ratio}), n_logged {soak['n_logged']}, "
          f"n_duplicates_dropped {soak['n_duplicates_dropped']}", flush=True)
    if "lr_ratio" not in row or abs(row["lr_ratio"] - want_ratio) > 1e-6 or soak["n_logged"] != PRETRAIN_STEPS:
        fail("soak_seam_analysis does not see the schedule continue across the SIGINT seam")
    _, out = run_cli(["--run", str(mid), "--seams", "20"], "on the run resumed from step 20",
                     soak_seam_analysis.main)
    soak20 = json.loads(out)
    print(f"soak_seam_analysis on the run resumed from step 20: n_logged {soak20['n_logged']}, "
          f"n_duplicates_dropped {soak20['n_duplicates_dropped']}, seam 20 "
          f"{soak20['seams'][0].get('status', 'analysed')} (its log starts at step 21)", flush=True)
    runs = tmp / "ledger_runs"
    runs.mkdir()
    done = {"straight": PRETRAIN_STEPS, "from20": PRETRAIN_STEPS, "killed": PRETRAIN_STEPS,
            "fused": PRETRAIN_FUSED_STEPS, "loader_off": LOADER_STEPS, "loader_build": LOADER_STEPS}
    for name in done:
        (runs / name).symlink_to(tmp / name, target_is_directory=True)
    run_cli(["--runs-dir", str(runs), "--out-dir", str(tmp / "ledger")], "over the runs", log_runs.main)
    with open(tmp / "ledger" / "experiments.csv", newline="") as f:
        ledger = {r["run"]: r for r in csv.DictReader(f)}
    print(f"log_runs: {len(ledger)} rows; steps_done "
          f"{ {k: r['steps_done'] for k, r in ledger.items()} }; samples_per_s "
          f"{ {k: r['samples_per_s'] for k, r in ledger.items()} }", flush=True)
    if {k: r["steps_done"] for k, r in ledger.items()} != {k: str(v) for k, v in done.items()}:
        fail("log_runs did not give each run its row and steps")
    counts = expect_counts("run tools", want_counts(), "none: host work")
    print(f"phase 28 (run tools): {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def diagnostics_path(tmp: Path) -> dict[str, int]:
    """Phase 29, the diagnostics on the straight run and the PNG tree:
    diagnose_scale_pathway at --n DIAG_N (exact launches: 7 forwards x
    depth; the counterfactual curve against the same weights with plain
    attention, within 1e-3), round5_patch_probe over the val series of a
    split written by make_split_manifest (exact launches: depth per batch of
    64; CLS against plain attention), round5_data_probe (host work).
    Returns the launches of the two CLIs that run the model."""
    t0 = time.perf_counter()
    depth = MODEL_CONFIGS["vit-small"].depth
    run = tmp / "straight"
    reset_launch_counts()
    wall, _ = run_cli(["--checkpoint", str(run), "--n", str(DIAG_N), "--canvas", "512", "--out",
                       str(tmp / "diag.json")], "on the straight run", diagnose_scale_pathway.main)
    counts = expect_counts("diagnose_scale_pathway", want_counts(packed_attention=7 * depth),
                           f"7 forwards x depth at ({DIAG_N}, 261, 1152, 6)")
    rep = json.loads((tmp / "diag.json").read_text())
    base = load_any_model(run, "cuda")
    plain = LoadedModel(base.cfg.replace(attn_impl="xla"), "cuda")
    plain.load_state_dict(base.state_dict())
    x, sp = diagnose_scale_pathway.make_batch(DIAG_N, 512, plain.img_size, 42, "cuda")
    want = diagnose_scale_pathway.counterfactual_curve(plain, x, sp)
    got = rep["counterfactual"]
    diff = {k: abs(v - want["cosdist_vs_multiplier"][k]) for k, v in got["cosdist_vs_multiplier"].items()}
    st = rep["scale_token"]
    print(f"diagnose_scale_pathway ({wall:.1f} s): |post_ln| {st['post_ln_norm_mean']:.4f} (LN pin "
          f"{st['ln_pin_norm']:.4f}), pre-LN {st['pre_ln_norm_mean']:.4f}, rotation x2 "
          f"{st['scale_vec_cosdist_2x']}, scale/token ratio {rep['input_mix']['scale_to_token_ratio']:.4f}; "
          f"counterfactual {got['cosdist_vs_multiplier']}, slope {got['local_slope_per_log_spacing']:.6f}; "
          f"against plain attention: largest difference {max(diff.values()):.3e} (tol 1e-3), slope "
          f"{want['local_slope_per_log_spacing']:.6f}", flush=True)
    if max(diff.values()) > 1e-3 or not np.isfinite(list(got["cosdist_vs_multiplier"].values())).all():
        fail("the scale-pathway counterfactual through kernel 1 disagrees with plain attention")

    index_csv, manifest = tmp / "tree" / "index.csv", tmp / "tree" / "split_manifest.json"
    run_cli(["--index", str(index_csv), "--out", str(manifest), "--val-fraction",
             str(PROBE_VAL_FRACTION)], "of the tree", make_split_manifest.main)
    val = val_series_set(load_split_manifest(manifest))
    rows = [r for r in load_index_rows(index_csv) if r.series_dir in val][:1200]
    reset_launch_counts()
    wall, _ = run_cli(["--checkpoint", str(run), "--index-csv", str(index_csv), "--split-manifest",
                       str(manifest), "--out", str(tmp / "patch_probe.json")], "on the tree",
                      round5_patch_probe.main)
    counts = add_counts(counts, expect_counts(
        "round5_patch_probe", want_counts(packed_attention=depth * -(-len(rows) // 64)),
        f"depth x {-(-len(rows) // 64)} batches of 64 over {len(rows)} val slices"))
    probe = json.loads((tmp / "patch_probe.json").read_text())
    sub = rows[:128]
    cls_k, patch_k = round5_patch_probe.cls_and_mean_patch(base, sub)
    cls_p, patch_p = round5_patch_probe.cls_and_mean_patch(plain, sub)
    cos, pcos = cls_cosine(cls_k, cls_p), cls_cosine(patch_k, patch_p)
    print(f"round5_patch_probe ({wall:.1f} s, {probe['n_slices']} slices): cls {probe['cls']}, "
          f"mean_patch {probe['mean_patch']}; against plain attention on {len(sub)} slices: CLS cosine "
          f"min {cos.min():.6f}, mean patch cosine min {pcos.min():.6f}", flush=True)
    if probe["n_slices"] != len(rows) or cos.min() < 0.999 or not {"accuracy", "auc"} <= set(probe["cls"]):
        fail("round5_patch_probe through kernel 1 disagrees with plain attention or gave no probe")

    reset_launch_counts()
    wall, _ = run_cli(["--trees", str(tmp / "tree"), "--out", str(tmp / "data_probe.json")], "on the tree",
                      round5_data_probe.main)
    (res,) = json.loads((tmp / "data_probe.json").read_text())["results"]
    print(f"round5_data_probe ({wall:.1f} s): {res}", flush=True)
    expect_counts("round5_data_probe", want_counts(), "none: host work")
    if not 0.0 <= res["data_probe_accuracy"] <= 1.0:
        fail("round5_data_probe gave no accuracy")
    print(f"phase 29 (diagnostics): {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def sweeps_path(tmp: Path, bench_rate: float, bench_device_ms: float) -> dict[str, int]:
    """Phase 30, the sweeps: bench_batch_sweep at its defaults with
    --profile (exact launches; every row ok; the per-slice device µs by
    kind; bs 96 within SWEEP_RATE_TOL of phase 8's bench_train_step in
    slices/s and within SWEEP_DEVICE_TOL of its profiled step's device ms;
    bench_train_step(96) timed again just before, at the sweep's step
    counts, and the host's threads and load printed beside it), tune_throughput
    --synthetic at bs TUNE_FIT_BATCH, TUNE_OOM_BATCH, TUNE_FIT_BATCH (the
    middle cell "oom", the second cell ok again, within 10% of the first
    and at its peak memory), its
    index-CSV grid over the PNG tree at bs 64 (exact launches) and
    --loader-only over the same grid.
    Returns the phase's launches."""
    t0 = time.perf_counter()
    depth = MODEL_CONFIGS["vit-small"].depth
    d = bench_batch_sweep.parse_args([])
    steps = (d.warmup + d.steps + d.profile_steps) * len(d.batch_sizes)
    # The host sets much of a bs-96 step's time: the same bench as phase 8's
    # here, and the host's state, tell this process's drift from the sweep's.
    now_rate = bench_train_step(TRAIN_BATCH, steps=d.steps, warmup=d.warmup)["slices_per_s"]
    print(f"phase 30 host: {host_state()}", flush=True)
    reset_launch_counts()
    wall, _ = run_cli(["--profile", "--trace-root", str(tmp / "sweep_traces"), "--out",
                       str(tmp / "sweep.json")], "at its defaults", bench_batch_sweep.main)
    counts = expect_counts("bench_batch_sweep", want_counts(
        packed_attention=steps * 2 * depth, packed_attention_bwd_dq=steps * depth,
        packed_attention_bwd_dkv=steps * depth),
        f"{steps} steps: forward 2 x depth, each backward kernel depth, per step")
    rows = json.loads((tmp / "sweep.json").read_text())["results"]
    print(f"bench_batch_sweep ({wall:.1f} s): " + "; ".join(
        f"bs{r['batch_size']} {r.get('slices_per_s')} slices/s, {r.get('ms_per_step')} ms, mfu "
        f"{r.get('mfu')}" if "slices_per_s" in r else f"bs{r['batch_size']} {r.get('status')}"
        for r in rows), flush=True)
    if [r["batch_size"] for r in rows] != d.batch_sizes or any("slices_per_s" not in r for r in rows):
        fail("a batch size of bench_batch_sweep failed")
    kinds = sorted({k for r in rows for k in r["categories_ms_per_step"]},
                   key=lambda k: -rows[-1]["categories_ms_per_step"].get(k, 0.0))
    print(f"bench_batch_sweep per-slice device µs by kind (bs {d.batch_sizes}; torch.profiler over "
          f"{d.profile_steps} steps):", flush=True)
    for k in kinds + ["all"]:
        vals = [(sum(r["categories_ms_per_step"].values()) if k == "all"
                 else r["categories_ms_per_step"].get(k, 0.0)) * 1e3 / r["batch_size"] for r in rows]
        print(f"  {k:<44} " + " ".join(f"{v:>8.2f}" for v in vals), flush=True)
    r96 = next(r for r in rows if r["batch_size"] == TRAIN_BATCH)
    rate_gap = r96["slices_per_s"] / bench_rate - 1
    dev_gap = sum(r96["categories_ms_per_step"].values()) / bench_device_ms - 1
    print(f"bench_batch_sweep bs{TRAIN_BATCH}: {r96['slices_per_s']} slices/s against phase 8's "
          f"bench_train_step({TRAIN_BATCH}) {bench_rate:.2f}: {100 * rate_gap:+.1f}% (tol "
          f"{100 * SWEEP_RATE_TOL:.0f}%); "
          f"{sum(r96['categories_ms_per_step'].values()):.3f} device ms a step against its "
          f"profiled step's {bench_device_ms:.3f}: {100 * dev_gap:+.1f}% (tol "
          f"{100 * SWEEP_DEVICE_TOL:.0f}%); "
          f"bench_train_step({TRAIN_BATCH}) just before the sweep {now_rate:.2f} slices/s; best "
          f"{max(rows, key=lambda r: r['slices_per_s'])['batch_size']}", flush=True)
    if abs(rate_gap) > SWEEP_RATE_TOL or abs(dev_gap) > SWEEP_DEVICE_TOL:
        fail("bench_batch_sweep's bs96 row is not the bench's step")

    tune = tune_throughput.parse_args([])
    cell = tune.warmup + TUNE_STEPS
    reset_launch_counts()
    sizes = [str(TUNE_FIT_BATCH), str(TUNE_OOM_BATCH), str(TUNE_FIT_BATCH)]
    wall, _ = run_cli(["--synthetic", "--batch-sizes", *sizes, "--steps", str(TUNE_STEPS),
                       "--out-dir", str(tmp / "tune_synthetic")],
                      "--synthetic " + " ".join(sizes), tune_throughput.main)
    got = launch_counts()
    res = json.loads((tmp / "tune_synthetic" / "results.json").read_text())
    summary = json.loads((tmp / "tune_synthetic" / "summary.json").read_text())
    for r in res:
        print(f"tune_throughput --synthetic bs{r['batch_size']}: {r['status']}, img_per_s "
              f"{r.get('img_per_s')}, bound {r.get('bound')}, device_step_s {r.get('device_step_s')}, "
              f"h2d_s {r.get('h2d_s')}, peak_bytes_in_use {r.get('peak_bytes_in_use')}, error "
              f"{r.get('error')}", flush=True)
    ok_fwd, ok_bwd = 2 * cell * 2 * depth, 2 * cell * depth  # the two cells that fit
    extra = {k: got[k] - w for k, w in (("packed_attention", ok_fwd), ("packed_attention_bwd_dq", ok_bwd),
                                        ("packed_attention_bwd_dkv", ok_bwd))}
    print(f"tune_throughput --synthetic ({wall:.1f} s): summary {summary}; launches {got}: the bs-{TUNE_FIT_BATCH} "
          f"cells {ok_fwd} / {ok_bwd} / {ok_bwd}, the out-of-memory cell {extra} before it ran out",
          flush=True)
    if ([r["status"] for r in res] != ["ok", "oom", "ok"] or summary["oom_batches"] != [TUNE_OOM_BATCH]
            or abs(res[2]["img_per_s"] / res[0]["img_per_s"] - 1) > 0.10
            or res[2]["peak_bytes_in_use"] > 1.01 * res[0]["peak_bytes_in_use"]):
        fail(f"tune_throughput did not come back from the out-of-memory cell at bs {TUNE_OOM_BATCH}")
    if (not 0 <= extra["packed_attention"] <= 2 * depth or not 0 <= extra["packed_attention_bwd_dq"] <= depth
            or not 0 <= extra["packed_attention_bwd_dkv"] <= depth
            or any(got[k] for k in COUNTERS if not k.startswith("packed_attention"))):
        fail("tune_throughput --synthetic launched other than its steps")
    counts = add_counts(counts, got)

    index_csv = tmp / "tree" / "index.csv"
    grid = ["--index-csv", str(index_csv), "--batch-sizes", "64", "--num-workers", *TUNE_WORKERS,
            "--prefetch", *TUNE_PREFETCH]
    n_cells, cell = len(TUNE_WORKERS) * len(TUNE_PREFETCH), tune.warmup + tune.steps
    reset_launch_counts()
    wall, _ = run_cli(grid + ["--out-dir", str(tmp / "tune_grid")], "over the tree", tune_throughput.main)
    counts = add_counts(counts, expect_counts("tune_throughput --index-csv", want_counts(
        packed_attention=n_cells * cell * 2 * depth, packed_attention_bwd_dq=n_cells * cell * depth,
        packed_attention_bwd_dkv=n_cells * cell * depth), f"{n_cells} cells of {cell} steps"))
    res = json.loads((tmp / "tune_grid" / "results.json").read_text())
    for r in res:
        print(f"tune_throughput --index-csv bs64 workers {r['num_workers']} prefetch {r['prefetch']}: "
              f"{r['status']}, bound {r.get('bound')}, data_wait_frac {r.get('data_wait_frac')}, img_per_s "
              f"{r.get('img_per_s')} ({r.get('img_per_s_overlapped')} overlapped), data {r.get('data_wait_s')} "
              f"s, h2d {r.get('h2d_s')} s, step {r.get('device_step_s')} s, cpu {r.get('cpu_user_s')} + "
              f"{r.get('cpu_sys_s')} s, loadavg {r.get('loadavg_1m')}", flush=True)
    print(f"tune_throughput --index-csv grid: {wall:.1f} s", flush=True)
    if len(res) != n_cells or any(r["status"] != "ok" for r in res):
        fail("a cell of tune_throughput's index-CSV grid failed")
    reset_launch_counts()
    wall, _ = run_cli(grid + ["--loader-only", "--out-dir", str(tmp / "tune_loader")], "--loader-only",
                      tune_throughput.main)
    expect_counts("tune_throughput --loader-only", want_counts(), "none: host work")
    res = json.loads((tmp / "tune_loader" / "results.json").read_text())
    for r in res:
        print(f"tune_throughput --loader-only bs64 workers {r['num_workers']} prefetch {r['prefetch']}: "
              f"{r['status']}, img_per_s {r.get('img_per_s')}, batch_ms {r.get('batch_ms')}, cpu_frac "
              f"{r.get('cpu_frac')}", flush=True)
    print(f"tune_throughput --loader-only grid: {wall:.1f} s", flush=True)
    if len(res) != n_cells or any(r["status"] != "ok" for r in res):
        fail("a cell of tune_throughput --loader-only failed")
    print(f"phase 30 (sweeps): {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def ablation_path(tmp: Path) -> dict[str, int]:
    """Phase 31, the LoRA ablation runbook: python -m
    dinox_torch.ablation_lora_lidc all on the fine-tuning phase's labelled
    CSVs and the straight run, ADAPTER_BASE in the temp dir: four adapter
    dirs, each arm's best AUROC as printed and in its history.json, exact
    launches (per epoch, kernel 1 depth x (3 steps + 2 validation
    batches), dq and dkv depth x 3). Returns the phase's launches."""
    t0 = time.perf_counter()
    depth = MODEL_CONFIGS["vit-small"].depth
    base = tmp / "ablation"
    steps, val_batches = FT_TRAIN // FT_BATCH, -(-FT_VAL // FT_BATCH)
    reset_launch_counts()
    old = os.environ.get("ADAPTER_BASE")
    os.environ["ADAPTER_BASE"] = str(base)
    try:
        wall, out = run_cli([str(tmp / "straight"), str(tmp / "train.csv"), str(tmp / "val.csv")], "all",
                            ablation_lora_lidc.main)
    finally:
        if old is None:
            os.environ.pop("ADAPTER_BASE")
        else:
            os.environ["ADAPTER_BASE"] = old
    printed = dict(re.findall(r"^(.*): best val AUROC = ([0-9.]+)$", out, re.M))
    epochs = {}
    for name in ("baseline", "rank16", "unfreeze2", "crop128"):
        hist = json.loads((base / name / "history.json").read_text())
        epochs[name] = len(hist)
        best = ablation_lora_lidc.best_auroc(base / name)
        print(f"ablation arm {name}: {len(hist)} epochs, best val AUROC {best:.4f} (printed "
              f"{printed.get(str(base / name))}), val losses {[round(h['loss'], 4) for h in hist]}",
              flush=True)
        if printed.get(str(base / name)) != f"{best:.4f}" or not np.isfinite([h["train_loss"] for h in hist]).all():
            fail(f"the ablation arm {name} did not run or report as the runbook does")
    e = sum(epochs.values())
    counts = expect_counts("ablation_lora_lidc all", want_counts(
        packed_attention=depth * (steps + val_batches) * e, packed_attention_bwd_dq=depth * steps * e,
        packed_attention_bwd_dkv=depth * steps * e),
        f"{e} epochs in all: depth x ({steps} steps + {val_batches} validation batches) forward, "
        f"depth x {steps} each backward kernel, an epoch")
    print(f"phase 31 (the LoRA ablation, {wall:.1f} s in the CLI): {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_step_worker(coord: str, out: Path) -> int:
    """Phase 32a, in a child process: a world-1 NCCL group; MESH_STEPS steps
    of the mesh step beside the step without a mesh from one seed on the
    same staged batches; metrics and state compared bit for bit; the NCCL
    all-reduce of the gradient bucket timed. Writes out/nccl.json."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://{coord}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        mcfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True)
        cfg = TrainConfig(model=mcfg, batch_size=TRAIN_BATCH, warmup_steps=10, max_steps=50,
                          koleo_weight=0.1)
        batches = DeviceSyntheticBatches(MESH_STEPS, TRAIN_BATCH, 1, 512, SEED, n_datasets=5,
                                         device="cuda")
        plain, meshed = create_train_state(cfg, SEED, "cuda"), create_train_state(cfg, SEED, mesh=mesh)
        fns = build_train_step(cfg, "cuda"), build_train_step(cfg, mesh=mesh)
        same_metrics, times, counts = True, {"plain": [], "mesh": []}, []
        for batch in itertools.islice(iter(batches), MESH_STEPS):
            got = []
            for name, state, fn in (("plain", plain, fns[0]), ("mesh", meshed, fns[1])):
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = fn(state, batch.pixels, batch.spacing)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
                got.append(m)
            counts.append(launch_counts())
            same_metrics &= sorted(got[0]) == sorted(got[1]) and all(
                torch.equal(got[0][k], got[1][k]) for k in got[0])
        a, b = state_tensors(plain), state_tensors(meshed)
        same_state = a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)
        grads = [torch.randn_like(p) for p in meshed.student.parameters()]
        reduce_ms = median_ms(lambda: all_reduce_bucket(grads, mesh.data_group, "mean"), iters=20)
        (out / "nccl.json").write_text(json.dumps({
            "metrics_bit_equal": bool(same_metrics), "state_bit_equal": bool(same_state),
            "mesh_counts": counts[-1],
            "step_s": {k: v[1:] for k, v in times.items()},
            "bucket_mb": sum(g.numel() for g in grads) * 4 / 1e6,
            "allreduce_ms": reduce_ms, "tensors": len(grads)}))
    finally:
        dist.destroy_process_group()
    return 0


def rank_worker(coord: str, world: int, rank: int, out: Path, argv: list[str]) -> int:
    """Phases 32b-36, in a child process: rank *rank* of a gloo group of
    *world* on the card, running each run of *argv* in turn in the one
    group (runs separated by RUN_SEP, which saves a process start-up a
    run): the pretraining CLI with the run's flags and the dist flags,
    writing its launch counts to launches_rank{rank}.json and its peak of
    allocated card memory to memory_rank{rank}.json in the run's --run-dir;
    or ``lora-tp DIR``, :func:`lora_tp_rank` into DIR. Stops at the first
    CLI run that does not return 0."""
    init_distributed(coord, world, rank, backend="gloo")
    try:
        runs = [list(g) for sep, g in itertools.groupby(argv, lambda a: a == RUN_SEP) if not sep]
        for run in runs:
            if run[0] == "lora-tp":
                lora_tp_rank(world, rank, Path(run[1]))
                continue
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rc = pretrain.main(run + ["--dist-coordinator", coord, "--dist-processes", str(world),
                                      "--dist-process-id", str(rank)])
            torch.cuda.synchronize()
            if rc != 0:
                return rc
            run_dir = Path(run[run.index("--run-dir") + 1])
            (run_dir / f"launches_rank{rank}.json").write_text(json.dumps(launch_counts()))
            (run_dir / f"memory_rank{rank}.json").write_text(json.dumps(
                {"max_memory_allocated": torch.cuda.max_memory_allocated()}))
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(kind: str, world: int, out: Path, argv: list[str], timeout: float = 600) -> list[str]:
    """Runs *world* children of this script (``--worker``) and waits for
    them; fails unless each exits 0. Returns their outputs."""
    coord = f"127.0.0.1:{free_port()}"
    here = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker", kind, coord,
                               str(world), str(r), str(out), *argv], cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], flush=True)
            fail(f"{kind} rank {r} of {world} exited {p.returncode}")
    return logs


def last_step(run_dir: Path) -> int:
    return max(int(d.name) for d in (run_dir / "ckpt").iterdir() if d.name.isdigit())


def final_student(run_dir: Path, step: int | None = None) -> dict[str, np.ndarray]:
    """The student of a run's checkpoint at *step* (its last by default)."""
    step = last_step(run_dir) if step is None else step
    state = load_file(run_dir / "ckpt" / str(step) / "state.safetensors")
    return {k: v for k, v in state.items() if k.startswith("student.")}


def cosine(x: np.ndarray, y: np.ndarray) -> float:
    x, y = x.ravel().astype(np.float64), y.ravel().astype(np.float64)
    return float(np.dot(x, y) / max(np.linalg.norm(x) * np.linalg.norm(y), 1e-30))


def compare_mesh_run(label: str, ranks: Path, one: Path, steps: list[int], ranks_counts: list,
                     want: dict[str, int]) -> dict:
    """The gates of phases 32b-35: the mesh run's losses at *steps* within
    MESH_LOSS_TOL of the one-process run's, its final student (every tensor,
    as one vector) at cosine >= MESH_COS against the one-process run's
    student at the same step, and each rank's exact launches *want*. The
    lowest cosine of a single tensor is printed beside it (a
    tensor that starts at zero, such as the scale embedding's output layer,
    holds only Adam's updates, whose signs follow rounding where a gradient
    is near zero)."""
    got, ref = read_metrics(ranks), read_metrics(one)
    if sorted(got) != steps or not set(steps) <= set(ref):
        fail(f"{label}: logged steps {sorted(got)} against {sorted(ref)}")
    rel = {s: abs(got[s]["loss"] - ref[s]["loss"]) / abs(ref[s]["loss"]) for s in steps}
    a, b = final_student(ranks), final_student(one, last_step(ranks))
    if {k: (v.shape, v.dtype) for k, v in a.items()} != {k: (v.shape, v.dtype) for k, v in b.items()}:
        fail(f"{label}: the mesh run's checkpoint is not a one-process checkpoint")
    cos_all = cosine(*(np.concatenate([t[k].ravel() for k in sorted(a)]) for t in (a, b)))
    cos = {k: cosine(a[k], b[k]) for k in a if a[k].any() or b[k].any()}
    worst = min(cos, key=cos.get)
    print(f"{label}: losses {[round(got[s]['loss'], 6) for s in steps]} against "
          f"{[round(ref[s]['loss'], 6) for s in steps]} (max rel {max(rel.values()):.3e}, tol "
          f"{MESH_LOSS_TOL}); final student cosine {cos_all:.6f} as one vector (tol {MESH_COS}), "
          f"lowest of one tensor {cos[worst]:.6f} ({worst}, of {len(cos)}); launches per rank "
          f"{[{k: v for k, v in c.items() if v} for c in ranks_counts]} (want {want})", flush=True)
    if not all(np.isfinite(got[s]["loss"]) for s in steps) or max(rel.values()) > MESH_LOSS_TOL:
        fail(f"{label}: the losses disagree with the one-process run")
    if cos_all < MESH_COS:
        fail(f"{label}: the final student disagrees with the one-process run")
    for r, c in enumerate(ranks_counts):
        if not held(c, want_counts(**want)):
            fail(f"{label}: rank {r} launched {c}, want {want}")
    return {"max_rel_loss": max(rel.values()), "cosine": cos_all, "min_tensor_cosine": cos[worst]}


def resume_in_one_process(label: str, argv: list[str], ranks: Path, one: Path, out: Path, seam: int,
                          total: int) -> float:
    """One process resumes the mesh run's step-*seam* checkpoint (rank 0's)
    with *argv* to step *total*; its losses after the seam within
    MESH_LOSS_TOL of the straight one-process run's. Returns the largest
    relative difference."""
    run_cli(argv + ["--resume", str(ranks), "--run-dir", str(out)], f"{label} resume")
    got, ref = read_metrics(out), read_metrics(one)
    rel = {s: abs(got[s]["loss"] - ref[s]["loss"]) / abs(ref[s]["loss"]) for s in range(seam + 1, total + 1)}
    print(f"{label}: one process resumed the mesh run's step-{seam} checkpoint: losses "
          f"{[round(got[s]['loss'], 6) for s in rel]} against the straight run's "
          f"{[round(ref[s]['loss'], 6) for s in rel]} (max rel {max(rel.values()):.3e}, tol "
          f"{MESH_LOSS_TOL})", flush=True)
    if sorted(got) != sorted(rel) or max(rel.values()) > MESH_LOSS_TOL:
        fail(f"{label}: the one-process resume of the mesh run's checkpoint disagrees with the "
             "straight run")
    return max(rel.values())


def rank_step_s(log: str, run: int = 0) -> float:
    """Rank 0's seconds a step from the closing ``done`` line of its *run*-th CLI run."""
    done = re.findall(r"done steps=(\d+) wall_s=([0-9.]+)", log)
    if len(done) <= run:
        fail(f"the rank-0 log has no done line for run {run}")
    return float(done[run][1]) / int(done[run][0])


def tp_args() -> list[str]:
    """Phase 33's flags, shared by its ranks and its one-process runs."""
    return MESH_ARGS + ["--max-steps", str(MESH_TP_STEPS + 2), "--fused-attn", "--ckpt-every",
                        str(MESH_TP_STEPS)]


def ep_args() -> list[str]:
    """Phase 34's flags, shared by its ranks and its one-process runs."""
    return MESH_ARGS + MOE_ARGS + ["--max-steps", str(MESH_CLI_STEPS + 2), "--ckpt-every", str(MESH_CLI_STEPS)]


def pp_args() -> list[str]:
    """Phase 36's flags, shared by its ranks and its one-process runs."""
    return MESH_ARGS + ["--attn-impl", "xla", "--max-steps", str(PP_STEPS + 2), "--ckpt-every", str(PP_STEPS)]


def two_rank_runs(tmp: Path) -> list[str]:
    """Phases 32b-36's two-rank runs in one spawn of two children, one after
    the other in one gloo group (one process start-up for all of them):
    32b's dp run, 33's tp + SP run, 34's ep run, the LoRA backbone at tp 2
    (beside 35) and 36's pipeline run, into tmp/{dp,tp,ep,lora_tp,pp}.
    Returns the children's outputs."""
    t0 = time.perf_counter()
    dirs = {k: tmp / k for k in ("dp", "tp", "ep", "lora_tp", "pp")}
    for d in dirs.values():
        d.mkdir()
    runs = [
        MESH_ARGS + ["--max-steps", str(MESH_CLI_STEPS), "--ckpt-every", str(MESH_CLI_STEPS)],
        tp_args() + ["--stop-after", str(MESH_TP_STEPS), "--model-parallel", "2", "--sequence-parallel"],
        ep_args() + ["--stop-after", str(MESH_CLI_STEPS), "--expert-parallel", "2"],
        pp_args() + ["--stop-after", str(PP_STEPS), "--pipeline-parallel", str(PP_STAGES), "--pp-microbatches",
                     str(PP_MICRO)],
    ]
    argv = []
    for run, name in zip(runs, ("dp", "tp", "ep", "pp")):
        if name == "pp":  # the LoRA step runs in the same children, before the pipeline
            argv += ["lora-tp", str(dirs["lora_tp"]), RUN_SEP]
        argv += run + ["--run-dir", str(dirs[name]), RUN_SEP]
    logs = spawn_ranks("rank", 2, tmp, argv[:-1])
    walls = [float(w) for w in re.findall(r"done steps=\d+ wall_s=([0-9.]+)", logs[0])]
    print(f"phases 32b-36's two-rank runs (dp, tp + SP, ep, LoRA at tp 2, pp) in one spawn of two gloo "
          f"children: {time.perf_counter() - t0:.1f} s; rank 0's CLI runs took {walls} s (done lines)",
          flush=True)
    return logs


def mesh_path(tmp: Path, logs: list[str]) -> dict:
    """Phases 32-33 (module 13a): the world-1 NCCL step, then the two-rank
    gloo runs of the CLI (data parallel; tensor + sequence parallel with
    --fused-attn, resumed in one process) of :func:`two_rank_runs`, whose
    children's outputs are *logs*, against one process. Returns the
    launches per rank and the readings."""
    t0 = time.perf_counter()
    out = tmp / "nccl"
    out.mkdir()
    spawn_ranks("nccl-step", 1, out, [])
    t32a = time.perf_counter() - t0
    nccl = json.loads((out / "nccl.json").read_text())
    step_ms = {k: 1e3 * float(np.median(v)) for k, v in nccl["step_s"].items()}
    print(f"phase 32a, world-1 NCCL mesh step (ViT-S bs{TRAIN_BATCH}, {MESH_STEPS} steps): metrics "
          f"bit-equal {nccl['metrics_bit_equal']}, state bit-equal {nccl['state_bit_equal']}; step "
          f"{step_ms['mesh']:.2f} ms on the mesh, {step_ms['plain']:.2f} ms without (host clock, "
          f"steps 2-{MESH_STEPS}); NCCL all-reduce of the {nccl['bucket_mb']:.1f} MB gradient bucket "
          f"({nccl['tensors']} tensors, one flat f32 buffer, world 1): {nccl['allreduce_ms']:.4f} ms",
          flush=True)
    if not (nccl["metrics_bit_equal"] and nccl["state_bit_equal"]):
        fail("the world-1 mesh step is not bit-equal to the step without a mesh")
    if not held(nccl["mesh_counts"], want_counts(packed_attention=24, packed_attention_bwd_dq=12,
                                                 packed_attention_bwd_dkv=12)):
        fail(f"the world-1 mesh step launched {nccl['mesh_counts']}")

    per_step = MESH_CLI_STEPS
    dp_dir, one_dp = tmp / "dp", tmp / "one_dp"
    tp_dir, one_tp, resumed = tmp / "tp", tmp / "one_tp", tmp / "tp_resumed"
    dp_counts = [json.loads((dp_dir / f"launches_rank{r}.json").read_text()) for r in range(2)]
    reset_launch_counts()
    _, one_log = run_cli(MESH_ARGS + ["--max-steps", str(per_step), "--ckpt-every", str(per_step),
                                      "--run-dir", str(one_dp)], "phase 32b one-process run")
    one_counts = launch_counts()
    if not held(one_counts, want_counts(packed_attention=24 * per_step, packed_attention_bwd_dq=12 * per_step,
                                        packed_attention_bwd_dkv=12 * per_step)):
        fail(f"the one-process run of phase 32b launched {one_counts}")
    dp = compare_mesh_run("phase 32b, dp 2 (two gloo ranks on one card) vs one process", dp_dir, one_dp,
                          list(range(1, per_step + 1)), dp_counts,
                          dict(packed_attention=24 * per_step, packed_attention_bwd_dq=12 * per_step,
                               packed_attention_bwd_dkv=12 * per_step))
    dp["step_ms"], dp["one_step_ms"] = 1e3 * rank_step_s(logs[0], RUN_DP), 1e3 * rank_step_s(one_log)
    t32b = time.perf_counter() - t0 - t32a
    print(f"phase 32b step: {dp['step_ms']:.1f} ms a step on rank 0 (gloo on CUDA tensors: every "
          f"collective staged on the host, not NCCL's time), {dp['one_step_ms']:.1f} ms in one process "
          f"(the CLI's done lines, host batches)", flush=True)

    per_step, total = MESH_TP_STEPS, MESH_TP_STEPS + 2
    tp_counts = [json.loads((tp_dir / f"launches_rank{r}.json").read_text()) for r in range(2)]
    reset_launch_counts()
    _, one_log = run_cli(tp_args() + ["--run-dir", str(one_tp)], "phase 33 one-process --fused-attn run")
    one_counts = launch_counts()
    if not held(one_counts, want_counts(fused_attn_block=24 * total, packed_attention_bwd_dq=12 * total,
                                        packed_attention_bwd_dkv=12 * total)):
        fail(f"the one-process --fused-attn run of phase 33 launched {one_counts}")
    tp = compare_mesh_run("phase 33, tp 2 + sequence parallel --fused-attn (two gloo ranks) vs one "
                          "process --fused-attn", tp_dir, one_tp, list(range(1, per_step + 1)), tp_counts,
                          dict(packed_attention=24 * per_step, packed_attention_bwd_dq=12 * per_step,
                               packed_attention_bwd_dkv=12 * per_step))
    tp["step_ms"], tp["one_step_ms"] = 1e3 * rank_step_s(logs[0], RUN_TP), 1e3 * rank_step_s(one_log)
    rel = resume_in_one_process("phase 33", tp_args(), tp_dir, one_tp, resumed, per_step, total)
    print(f"phase 33 step: {tp['step_ms']:.1f} ms a step on rank 0 (gloo on CUDA tensors, not NCCL's "
          f"time), {tp['one_step_ms']:.1f} ms in one process with kernel 6", flush=True)
    tp["resume_max_rel_loss"] = rel
    wall = time.perf_counter() - t0
    print(f"phases 32-33 (module 13a), after the shared two-rank spawn: {wall:.1f} s (32a {t32a:.1f}, 32b "
          f"{t32b:.1f}, 33 {wall - t32a - t32b:.1f})", flush=True)
    return {"nccl": nccl, "dp": dp, "tp": tp, "dp_counts": dp_counts[0], "tp_counts": tp_counts[0]}


def with_batch(argv: list[str], batch: int) -> list[str]:
    """*argv* with its --batch-size set to *batch*."""
    at = argv.index("--batch-size") + 1
    return argv[:at] + [str(batch)] + argv[at + 1:]


def lora_tp_step(mesh=None) -> dict[str, np.ndarray]:
    """A LoRA ViT-S backbone (rank LORA_TP_RANK on qkv/proj/fc1/fc2, dropout
    0.1, bf16, kernel 1) from SEED, with live adapters: the eval forward's
    CLS on a seeded batch of LORA_TP_BATCH, then a training forward and
    backward of the tokens against seeded weights, giving each LoRA
    factor's gradient. On a *mesh* the backbone is cut by its model group
    (``parallel.shard_model``) and the factors' gradient shares are summed
    over it (``parallel.model_group_share``)."""
    cfg = MODEL_CONFIGS["vit-small"].replace(scale_aware=True, lora_rank=LORA_TP_RANK, lora_alpha=16.0,
                                             lora_dropout=0.1)
    gen = torch.Generator().manual_seed(SEED + 7)
    model = PatchViT(cfg, generator=gen)
    with torch.no_grad():  # fresh lora_B is zero: make the adapters live
        for m in model.lora_layers():
            m.lora_B.weight.normal_(0.0, 0.02, generator=gen)
    model.to("cuda")
    if mesh is not None:
        shard_model(model, mesh)
    x = torch.randn((LORA_TP_BATCH, cfg.img_size, cfg.img_size, 3), generator=gen).cuda()
    sp = (torch.rand((LORA_TP_BATCH, 3), generator=gen) * 2.5 + 0.5).cuda()
    w = torch.randn((LORA_TP_BATCH, 1 + cfg.n_patches + cfg.num_registers, cfg.dim), generator=gen).cuda()
    with torch.no_grad():
        cls = model.eval()(x, sp)[:, 0].float().cpu().numpy()
    model.train().set_lora_generator(torch.Generator("cuda").manual_seed(SEED + 8))
    loss = (model(x, sp) * w).sum()
    named = [(n, p) for n, p in model.named_parameters() if ".lora_" in n]
    grads = list(torch.autograd.grad(loss, [p for _, p in named]))
    if mesh is not None:
        shares = [i for i, (n, p) in enumerate(named) if model_group_share(n, p, cfg.sequence_parallel)]
        for i, g in zip(shares, all_reduce_bucket([grads[i] for i in shares], mesh.model_group)):
            grads[i] = g
    torch.cuda.synchronize()
    return {"cls": cls, **{n: g.float().cpu().numpy() for (n, _), g in zip(named, grads)}}


def lora_tp_rank(world: int, rank: int, out: Path) -> None:
    """Beside phase 35, in a rank worker (after phase 34's run): rank *rank*
    of the gloo group of *world* on the card as the model group of the LoRA
    backbone's step (:func:`lora_tp_step`); rank 0 writes out/lora_tp.npz,
    every rank its launch counts."""
    mesh = make_mesh(model_parallel=world)
    reset_launch_counts()
    res = lora_tp_step(mesh)
    (out / f"launches_rank{rank}.json").write_text(json.dumps(launch_counts()))
    if rank == 0:
        np.savez(out / "lora_tp.npz", **res)


def expert_path(tmp: Path, logs: list[str]) -> dict:
    """Phases 34-35 (module 13b's first parts): the two-rank expert-parallel
    CLI run of :func:`two_rank_runs` (children's outputs *logs*) and the
    four-rank tensor x expert run against one process each, both resumed
    in one process from rank 0's checkpoint, and the LoRA backbone at tp 2
    of the same spawn. Returns the readings and a rank's launches."""
    t0 = time.perf_counter()
    per_rank = MESH_CLI_STEPS
    total = per_rank + 2
    ep_dir, one_ep, lora_dir = tmp / "ep", tmp / "one_ep", tmp / "lora_tp"
    ep_counts = [json.loads((ep_dir / f"launches_rank{r}.json").read_text()) for r in range(2)]
    reset_launch_counts()
    _, one_log = run_cli(ep_args() + ["--run-dir", str(one_ep)], "phase 34 one-process run")
    one_counts = launch_counts()
    if not held(one_counts, want_counts(packed_attention=24 * total, packed_attention_bwd_dq=12 * total,
                                        packed_attention_bwd_dkv=12 * total)):
        fail(f"the one-process run of phase 34 launched {one_counts}")
    ep = compare_mesh_run("phase 34, ep 2 with 4 experts (two gloo ranks on one card) vs one process",
                          ep_dir, one_ep, list(range(1, per_rank + 1)), ep_counts,
                          dict(packed_attention=24 * per_rank, packed_attention_bwd_dq=12 * per_rank,
                               packed_attention_bwd_dkv=12 * per_rank))
    ep["step_ms"], ep["one_step_ms"] = 1e3 * rank_step_s(logs[0], RUN_EP), 1e3 * rank_step_s(one_log)
    ep["resume_max_rel_loss"] = resume_in_one_process("phase 34", ep_args(), ep_dir, one_ep,
                                                      tmp / "ep_resumed", per_rank, total)
    t34 = time.perf_counter() - t0
    print(f"phase 34 step: {ep['step_ms']:.1f} ms a step on rank 0 (gloo on CUDA tensors, not NCCL's "
          f"time), {ep['one_step_ms']:.1f} ms in one process; {t34:.1f} s", flush=True)

    total = TPEP_STEPS + 2
    tpep_args = with_batch(MESH_ARGS, TPEP_BATCH) + MOE_ARGS + [
        "--sequence-parallel", "--factored-nu", "--max-steps", str(total), "--ckpt-every", str(TPEP_STEPS)]
    tpep_dir, one_tpep = tmp / "tpep", tmp / "one_tpep"
    tpep_dir.mkdir()
    logs = spawn_ranks("rank", 4, tpep_dir, tpep_args + [
        "--stop-after", str(TPEP_STEPS), "--model-parallel", "2", "--expert-parallel", "2",
        "--run-dir", str(tpep_dir)])
    tpep_counts = [json.loads((tpep_dir / f"launches_rank{r}.json").read_text()) for r in range(4)]
    reset_launch_counts()
    _, one_log = run_cli(tpep_args + ["--run-dir", str(one_tpep)], "phase 35 one-process run")
    one_counts = launch_counts()
    if not held(one_counts, want_counts(packed_attention=24 * total, packed_attention_bwd_dq=12 * total,
                                        packed_attention_bwd_dkv=12 * total)):
        fail(f"the one-process run of phase 35 launched {one_counts}")
    tpep = compare_mesh_run(
        f"phase 35, tp 2 x ep 2 + sequence parallel, factored moments, bs{TPEP_BATCH} (four gloo ranks) vs "
        "one process", tpep_dir, one_tpep, list(range(1, TPEP_STEPS + 1)), tpep_counts,
        dict(packed_attention=24 * TPEP_STEPS, packed_attention_bwd_dq=12 * TPEP_STEPS,
             packed_attention_bwd_dkv=12 * TPEP_STEPS))
    tpep["step_ms"], tpep["one_step_ms"] = 1e3 * rank_step_s(logs[0]), 1e3 * rank_step_s(one_log)
    tpep["resume_max_rel_loss"] = resume_in_one_process("phase 35", tpep_args, tpep_dir, one_tpep,
                                                        tmp / "tpep_resumed", TPEP_STEPS, total)
    t35 = time.perf_counter() - t0 - t34
    print(f"phase 35 step: {tpep['step_ms']:.1f} ms a step on rank 0 (gloo on CUDA tensors), "
          f"{tpep['one_step_ms']:.1f} ms in one process; {t35:.1f} s", flush=True)

    lora_counts = [json.loads((lora_dir / f"launches_rank{r}.json").read_text()) for r in range(2)]
    got = dict(np.load(lora_dir / "lora_tp.npz"))
    reset_launch_counts()
    want = lora_tp_step()
    cls_cos = min(cosine(a, b) for a, b in zip(got["cls"], want["cls"]))
    grad_cos = {k: cosine(got[k], want[k]) for k in want if k != "cls"}
    worst = min(grad_cos, key=grad_cos.get)
    lora_want = dict(packed_attention=24, packed_attention_bwd_dq=12, packed_attention_bwd_dkv=12)
    tlora = time.perf_counter() - t0 - t34 - t35
    print(f"phase 35, LoRA r{LORA_TP_RANK} ViT-S bs{LORA_TP_BATCH} at tp 2 (two gloo ranks) vs one process: "
          f"CLS cosine min {cls_cos:.6f} (tol {LORA_CLS_COS}); factor gradients' cosine lowest {grad_cos[worst]:.6f} "
          f"({worst}, of {len(grad_cos)}; tol {LORA_GRAD_COS}); launches per rank "
          f"{[{k: v for k, v in c.items() if v} for c in lora_counts]} (want {lora_want}); {tlora:.1f} s",
          flush=True)
    if cls_cos < LORA_CLS_COS or grad_cos[worst] < LORA_GRAD_COS or len(grad_cos) != 4 * 12 * 2:
        fail("the LoRA backbone at tp 2 disagrees with one process")
    for r, c in enumerate(lora_counts):
        if not held(c, want_counts(**lora_want)):
            fail(f"LoRA at tp 2: rank {r} launched {c}, want {lora_want}")
    wall = time.perf_counter() - t0
    print(f"phases 34-35 (module 13b): {wall:.1f} s (34 {t34:.1f}, 35 {t35:.1f}, LoRA at tp 2 {tlora:.1f})",
          flush=True)
    return {"ep": ep, "tp_ep": tpep, "lora_tp": {"cls_cosine_min": cls_cos, "grad_cosine_min": grad_cos[worst]},
            "ep_counts": ep_counts[0], "tp_ep_counts": tpep_counts[0], "lora_tp_counts": lora_counts[0]}


def pipe_path(tmp: Path, logs: list[str]) -> dict:
    """Phase 36 (module 13b-3): the two-rank pipeline-parallel CLI run of
    :func:`two_rank_runs` (children's outputs *logs*) against the
    one-process --attn-impl xla run, resumed in one process from rank 0's
    checkpoint; each rank's share of the state and its peak memory beside
    the one process's. Returns the readings and a rank's launches."""
    t0 = time.perf_counter()
    total = PP_STEPS + 2
    pp_dir, one_pp = tmp / "pp", tmp / "one_pp"
    counts = [json.loads((pp_dir / f"launches_rank{r}.json").read_text()) for r in range(PP_STAGES)]
    peaks = [json.loads((pp_dir / f"memory_rank{r}.json").read_text())["max_memory_allocated"]
             for r in range(PP_STAGES)]
    reset_launch_counts()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, one_log = run_cli(pp_args() + ["--run-dir", str(one_pp)], "phase 36 one-process --attn-impl xla run")
    one_peak = torch.cuda.max_memory_allocated() - before
    if not held(launch_counts(), want_counts()):
        fail(f"the one-process --attn-impl xla run of phase 36 launched {launch_counts()}")
    pp = compare_mesh_run(f"phase 36, pp {PP_STAGES} with {PP_MICRO} microbatches, --attn-impl xla (two "
                          "gloo ranks on one card) vs one process --attn-impl xla", pp_dir, one_pp,
                          list(range(1, PP_STEPS + 1)), counts, {})
    pp["step_ms"], pp["one_step_ms"] = 1e3 * rank_step_s(logs[0], RUN_PP), 1e3 * rank_step_s(one_log)
    pp["resume_max_rel_loss"] = resume_in_one_process("phase 36", pp_args(), pp_dir, one_pp,
                                                      tmp / "pp_resumed", PP_STEPS, total)
    # What each rank holds: its stage cut of the one-process checkpoint.
    full = load_file(pp_dir / "ckpt" / str(PP_STEPS) / "state.safetensors")

    def nbytes(arrays: dict, prefixes: tuple[str, ...]) -> int:
        return sum(a.nbytes for k, a in arrays.items() if k.startswith(prefixes))

    parts = ("student.",), ("student.", "teacher.", "optimizer.")
    ranks = [stage_tensors(full, Mesh(PP_STAGES, r, 1, 1, None, None, torch.device("cuda"), pp=PP_STAGES))
             for r in range(PP_STAGES)]
    pp["param_bytes"] = [nbytes(a, parts[0]) for a in ranks]
    pp["state_bytes"] = [nbytes(a, parts[1]) for a in ranks]
    pp["max_memory_allocated"] = peaks
    pp["one"] = {"param_bytes": nbytes(full, parts[0]), "state_bytes": nbytes(full, parts[1]),
                 "max_memory_allocated": one_peak}
    wall = time.perf_counter() - t0
    pp["seconds"] = wall
    pp["rank_run_s"] = float(re.findall(r"done steps=\d+ wall_s=([0-9.]+)", logs[0])[RUN_PP])
    print(f"phase 36 memory: parameter bytes per rank {pp['param_bytes']} against {pp['one']['param_bytes']} "
          f"in one process; state bytes (student, teacher, moments) {pp['state_bytes']} against "
          f"{pp['one']['state_bytes']}; max_memory_allocated per rank {peaks} against {one_peak} "
          f"(the one process's peak over what this process held before it)", flush=True)
    print(f"phase 36 step: {pp['step_ms']:.1f} ms a step on rank 0 (gloo on CUDA tensors: the hops "
          f"and the rest's gradient sum staged on the host, not NCCL's time), {pp['one_step_ms']:.1f} ms "
          f"in one process; phase 36 (module 13b-3): {wall:.1f} s after the shared two-rank spawn, in which "
          f"its ranks' CLI run took {pp['rank_run_s']:.1f} s (rank 0's done line)", flush=True)
    if not all(b < pp["one"]["param_bytes"] for b in pp["param_bytes"]):
        fail("a pipeline rank holds as many parameter bytes as one process")
    return {"pp": pp, "pp_counts": counts[0]}


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
        serve_counts = launch_counts()
        launches = serve_counts["packed_attention"]
        forwards = service.stats["forwards"] - forwards0

        expected = cfg.depth * forwards
        norms = 2 * cfg.depth + 2  # the blocks', the final and the ScaleEmbedding's
        want_ln = [norms * forwards, 0, 0]
        print(f"served {sum(reqs) + 96} images in {forwards} forwards; packed_attention "
              f"launches {launches} (depth x forwards = {expected}); LayerNorm forward, dx, "
              f"parameters {ln_launches(serve_counts)} (want {want_ln}: {norms} norms a forward, "
              f"no gradient)", flush=True)
        if forwards != 1 + 1 + 2 + 3 or launches != expected:
            fail("the serving path did not run every block's attention through the kernel")
        if ln_launches(serve_counts) != want_ln:
            fail("the serving path did not run every LayerNorm through the forward kernel once")
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
    train_counts, bench_rate, bench_device_ms = train(card)
    bwd = time_backward(peaks)
    time_backward(peaks, VIT_G_SHAPE)  # TPU kernel 3's shape

    # -- the fused half-block training path ----------------------------------
    exact = vit_s.replace(gelu_approx=False)
    check_step((exact.replace(fused_attn=True, fused_mlp=True), exact),
               "fused half-blocks (kernels 6-8) vs unfused, exact GELU")
    fused_counts = train_fused(card)
    fused = time_fused(peaks)
    ln_err = check_layer_norm()
    ln_times = time_layer_norm(peaks)
    mha = time_mha(peaks)

    # -- the pretraining CLI (module 8), then evaluation (module 9), the
    # inference bench and LoRA fine-tuning (module 10) on its run and tree --
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pretrain_counts, seam = pretrain_path(card, bench_rate, tmp)
        eval_counts = eval_path(tmp)
        infer_counts, infer_fwd = inference_path(peaks)
        finetune_counts = finetune_path(tmp, bench_rate)
        release_counts = release_path(tmp)
        # Module 12b on the same runs and tree, before they go.
        t12b = time.perf_counter()
        tools_counts = add_counts(tools_path(tmp, seam), diagnostics_path(tmp))
        sweep_counts = sweeps_path(tmp, bench_rate, bench_device_ms)
        ablation_counts = ablation_path(tmp)
        print(f"phases 28-31 (module 12b): {time.perf_counter() - t12b:.1f} s in all", flush=True)

    # -- the CIFAR control (module 10's rest) and DICOM/NIfTI to training
    # (module 8b) --
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cifar_counts, cifar_fwd, cifar_bwd = cifar_path(tmp, peaks)
        preprocess_counts = preprocess_path(tmp)
        prepare_counts = prepare_path(tmp)
        canary_path(tmp)

    # -- module 11: MoE, MAE, monitoring, then optimizer memory at ViT-L/G --
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        moe_counts, moe4 = moe_path(card, bench_rate, tmp)
        mae_counts, mae_step = mae_path(card, tmp)
        monitor_counts = monitor_path(tmp)
    scale_counts, scale = scale_path(card)
    mae_fwd = time_forward(peaks, MAE_DEC_SHAPE, "MAE decoder", SEED + 13)
    mae_bwd = time_backward(peaks, MAE_DEC_SHAPE)
    g_fwd = time_forward(peaks, VIT_G_TRAIN_SHAPE, "ViT-G bench_scale", SEED + 14)
    g_bwd = time_backward(peaks, VIT_G_TRAIN_SHAPE)
    print(json.dumps({"module11": {
        "moe4": moe4, "mae_step": mae_step,
        "bench_scale": {f"{c}/{k}": {key: r[key] for key in ("img_s", "step_ms", "mfu", "loss",
                                                             "max_memory_allocated", "optimizer_bytes")}
                        for (c, k), r in scale.items()}}}), flush=True)

    # -- module 13a: the (data, model) mesh, then kernel 1 and the pair at
    # the blocks its ranks run --
    # (Modules 13a-13b-3 share one temp dir and one spawn of the two-rank runs.)
    with tempfile.TemporaryDirectory() as tmp:
        tmp13 = Path(tmp)
        two_rank_logs = two_rank_runs(tmp13)
        mesh_res = mesh_path(tmp13, two_rank_logs)
        dp_fwd = time_forward(peaks, MESH_DP_SHAPE, "a dp-2 rank of the bs96 step", SEED + 15)
        dp_bwd = time_backward(peaks, MESH_DP_SHAPE)
        tp_fwd = time_forward(peaks, MESH_TP_SHAPE, "a tp-2 rank of the bs96 step", SEED + 16)
        tp_bwd = time_backward(peaks, MESH_TP_SHAPE)
        print(json.dumps({"module13a": {k: mesh_res[k] for k in ("dp", "tp")} | {
            "nccl": {k: mesh_res["nccl"][k] for k in ("metrics_bit_equal", "state_bit_equal", "step_s",
                                                        "bucket_mb", "allreduce_ms")}}}), flush=True)

        # -- module 13b's first parts: the expert axis, MoE, LoRA and factored
        # moments under tp, then kernel 1 and the pair at a tp x ep rank's block --
        ep_res = expert_path(tmp13, two_rank_logs)
        tpep_fwd = time_forward(peaks, MESH_TPEP_SHAPE, "a tp-2 x ep-2 rank of the bs32 step", SEED + 17)
        tpep_bwd = time_backward(peaks, MESH_TPEP_SHAPE)
        print(json.dumps({"module13b": {k: ep_res[k] for k in ("ep", "tp_ep", "lora_tp")}}), flush=True)

        # -- module 13b-3: the (data, pipe) mesh, GPipe over two gloo ranks --
        pp_res = pipe_path(tmp13, two_rank_logs)
    print(json.dumps({"module13b3": pp_res["pp"]}), flush=True)

    def mesh_launches(name: str) -> dict[str, int]:
        return {"dp_launches": mesh_res["dp_counts"][name], "tp_launches": mesh_res["tp_counts"][name],
                "ep_launches": ep_res["ep_counts"][name], "tp_ep_launches": ep_res["tp_ep_counts"][name],
                "lora_tp_launches": ep_res["lora_tp_counts"][name], "pp_launches": pp_res["pp_counts"][name]}

    def later_paths(name: str) -> dict[str, int]:
        return {"eval_launches": eval_counts[name],
                "bench_inference_launches": infer_counts.get(name, 0),
                "finetune_launches": finetune_counts[name],
                "cifar_launches": cifar_counts[name],
                "preprocess_launches": preprocess_counts[name],
                "moe_launches": moe_counts[name],
                "mae_launches": mae_counts[name],
                "scale_launches": scale_counts[name],
                "monitor_launches": monitor_counts[name],
                "release_launches": release_counts[name],
                "prepare_launches": prepare_counts[name],
                "tools_launches": tools_counts[name],
                "sweep_launches": sweep_counts[name],
                "ablation_launches": ablation_counts[name]}

    def fwd_timing(t: dict) -> dict:
        return {"shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"], "device_ms": t["device_ms"]}

    def pair_timing(t: dict, shape: tuple) -> dict:
        c = t["dq"]
        return {"shape": list(shape), "ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound"][0], "bound_by": c["bound"][1], "library_ms": c["library_ms"],
                "library_device_ms": c["library_device_ms"]}

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
        "mae_decoder": fwd_timing(mae_fwd),
        "vit_g": fwd_timing(g_fwd),
        **mesh_launches("packed_attention"),
        "mesh_dp": fwd_timing(dp_fwd),
        "mesh_tp": fwd_timing(tp_fwd),
        "mesh_tp_ep": fwd_timing(tpep_fwd),
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
            **mesh_launches(name),
        })
        if part == "dq":  # the pair at the CIFAR shape: time, bound and SDPA's backward
            c = cifar_bwd["dq"]
            kernels[-1]["cifar"] = {"shape": list(CIFAR_SHAPE), "ms": c["ms"], "device_ms": c["device_ms"],
                                    "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                                    "bound_by": c["bound"][1], "library_ms": c["library_ms"],
                                    "library_device_ms": c["library_device_ms"]}
            kernels[-1]["mae_decoder"] = pair_timing(mae_bwd, MAE_DEC_SHAPE)
            kernels[-1]["vit_g"] = pair_timing(g_bwd, VIT_G_TRAIN_SHAPE)
            kernels[-1]["mesh_dp"] = pair_timing(dp_bwd, MESH_DP_SHAPE)
            kernels[-1]["mesh_tp"] = pair_timing(tp_bwd, MESH_TP_SHAPE)
            kernels[-1]["mesh_tp_ep"] = pair_timing(tpep_bwd, MESH_TPEP_SHAPE)
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
            entry.update(mesh_launches("fused_attn_block"))
        if name.startswith("fused_mlp"):  # two or six launches: parts holds each one's device time
            entry["device_ms"] = t["device_ms"]
            entry["parts"] = {p: {"launches": fused_counts[f"{name}_{p}"], **v}
                              for p, v in t["parts"].items()}
        kernels.append(entry)
    # The LayerNorm kernels (no TPU kernel: XLA fuses flax's norm): the block
    # norms' path at the ViT-S rows, forward and backward; every timed shape
    # and path in "paths"; launches per path as (forward, dx, parameters),
    # the training step's under "launches".
    ln_s = ln_times[f"bf16_{LN_SHAPES[0][1]}"]
    ln_path_counts = {
        "launches": train_counts, "serving_launches": serve_counts, "head_major_launches": mha_counts,
        "fused_training_launches": fused_counts, "pretrain_launches": pretrain_counts,
        "eval_launches": eval_counts, "bench_inference_launches": infer_counts,
        "finetune_launches": finetune_counts, "cifar_launches": cifar_counts,
        "preprocess_launches": preprocess_counts, "moe_launches": moe_counts, "mae_launches": mae_counts,
        "scale_launches": scale_counts, "monitor_launches": monitor_counts,
        "release_launches": release_counts, "prepare_launches": prepare_counts,
        "tools_launches": tools_counts, "sweep_launches": sweep_counts,
        "ablation_launches": ablation_counts, "dp_launches": mesh_res["dp_counts"],
        "tp_launches": mesh_res["tp_counts"], "ep_launches": ep_res["ep_counts"],
        "tp_ep_launches": ep_res["tp_ep_counts"], "lora_tp_launches": ep_res["lora_tp_counts"],
        "pp_launches": pp_res["pp_counts"]}
    kernels.append({
        "name": "layer_norm",
        "route": "cuda",
        "source": "dinox_torch/ops/csrc/layer_norm.cu",
        "replaces": None,
        **{k: ln_launches(c) for k, c in ln_path_counts.items()},
        "max_rel_err": ln_err,
        "ms": ln_s["ms"],
        "plain_ms": ln_s["plain_ms"],
        "bound_ms": ln_s["bound_ms"],
        "bound_by": ln_s["bound_by"],
        "library_ms": ln_s["library_ms"],
        "shape": ln_s["shape"],
        "device_ms": ln_s["device_ms"],
        "backward": {k[4:]: v for k, v in ln_s.items() if k.startswith("bwd_")},
        "paths": ln_times,
    })
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
    kernels += dinov3_path(peaks)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dinov3_only() -> int:
    """``python3 chip_smoke.py --dinov3``: steps 1 and 2, then phase 37
    alone, and its kernels line."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name in ("packed_attention", "packed_attention_bwd", "rope", "swiglu"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    kernels = dinov3_path(card_peaks(card))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def worker(argv: list[str]) -> int:
    """A child of phases 32-36: ``--worker KIND COORD WORLD RANK OUT [ARGV...]``."""
    kind, coord, world, rank, out = argv[0], argv[1], int(argv[2]), int(argv[3]), Path(argv[4])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if kind == "nccl-step":
        return nccl_step_worker(coord, out)
    return rank_worker(coord, world, rank, out, argv[5:])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(dinov3_only() if sys.argv[1:2] == ["--dinov3"] else main())
