"""DINO-X pretraining CLI of the port: the twin of the JAX package's
``scripts/pretrain.py``, with the same flags plus ``--device``. It drives
the train step over the host loader or synthetic batches, with checkpoints
and resume, anomaly checks and metric sinks, on one CUDA card unless
``--device cpu``.

Examples:
    # Medical pretrain from an index CSV
    python -m dinox_torch.pretrain --config vit-small --scale-aware \\
        --index-csv data/processed/_index/index.csv --batch-size 64 \\
        --max-steps 5000 --run-dir data/runs/mvp

    # Synthetic smoke run (no data needed), on the CPU
    python -m dinox_torch.pretrain --config vit-tiny --synthetic --max-steps 20 \\
        --batch-size 8 --img-size 56 --canvas 64 --run-dir /tmp/smoke --device cpu

    # Two processes, one card each, data parallel (run each command on its
    # host; --batch-size is the global batch)
    python -m dinox_torch.pretrain --config vit-small --synthetic --batch-size 96 \
        --run-dir /tmp/dp --dist-coordinator host0:29500 --dist-processes 2 --dist-process-id 0

    # Four processes, tensor 2 x expert 2 (an MoE every second block, its 4
    # experts cut 2 to a rank); one such command per process id 0-3
    python -m dinox_torch.pretrain --config vit-small --synthetic --batch-size 32 \
        --moe-experts 4 --model-parallel 2 --expert-parallel 2 --sequence-parallel \
        --run-dir /tmp/tpep --dist-coordinator host0:29500 --dist-processes 4 --dist-process-id 0

    # Two processes, one pipeline stage of 6 blocks each (GPipe, 4
    # microbatches); one such command per process id 0-1
    python -m dinox_torch.pretrain --config vit-small --synthetic --batch-size 96 \
        --pipeline-parallel 2 --pp-microbatches 4 --run-dir /tmp/pp \
        --dist-coordinator host0:29500 --dist-processes 2 --dist-process-id 0

Multi-process runs (module 13): ``--dist-processes W`` processes, one card
each (``cuda:{rank % device_count}``), on the ``(data, model[, expert])``
mesh of ``parallel.mesh`` with ``--model-parallel`` ranks to a model group,
``--sequence-parallel``, and ``--expert-parallel`` ranks to an expert group
(``--moe-experts`` must be a multiple of it: exit 2 otherwise). They train
what one process trains on the same global batch: each rank takes its data
rank's rows, and rank 0 writes the run dir (config, metrics, checkpoints in
the one-process layout, which one process resumes). A process group
already set up by the caller with the same world size and rank is used as
it is. ``--pipeline-parallel S`` trains on the ``(data, pipe)`` mesh of
``parallel.pipeline`` instead, each rank one stage of ``depth / S`` blocks
(``train.pp_step``: GPipe over ``--pp-microbatches``, default S; DINO or
SimCLR, dense blocks, no accumulation; the stage blocks run the plain
``attn_impl="xla"`` attention whatever ``--attn-impl`` says, as the
reference's do). It excludes ``--model-parallel`` and ``--expert-parallel``
and takes no ``--monitor-every`` (exit 2).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dinox_torch.data.index import exclude_val_series, load_index_rows, load_split_manifest, z_stride_subsample
from dinox_torch.data.pipeline import Batch, TrainLoader
from dinox_torch.data.png16 import decoder_in_use
from dinox_torch.data.prefetch import DevicePrefetcher
from dinox_torch.data.slice_cache import build_slice_cache, open_slice_cache
from dinox_torch.data.synthetic import make_batch_fn, upsample
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.parallel.mesh import batch_rows, init_distributed, make_mesh
from dinox_torch.parallel.pipeline import make_pp_mesh
from dinox_torch.train.checkpoint import CheckpointManager, CheckpointWedgedError, find_latest_run
from dinox_torch.train.pp_step import build_pp_train_step, check_pp_config, create_pp_train_state
from dinox_torch.train.state import TrainConfig, create_train_state, reject_unported
from dinox_torch.train.step import build_train_step
from dinox_torch.train.trainer import train
from dinox_torch.utils.platform import resolve_device
from dinox_torch.utils.rng import seeded_generator
from dinox_torch.zoo.lineage import get_git_commit


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="vit-small",
                   choices=["vit-tiny", "vit-small", "vit-large", "vit-giant", "vit-7b16"])
    p.add_argument("--index-csv", type=Path, default=None)
    p.add_argument("--split-manifest", type=Path, default=None)
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--resume", default=None,
                   help="'auto' (latest run under run-dir's parent) or a run dir path")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' runs the kernels' plain "
                        "versions)")
    # model
    p.add_argument("--scale-aware", action="store_true")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--attn-impl", default="pallas", choices=["pallas", "xla"],
                   help="'pallas': the packed attention kernels on the card; 'xla': plain PyTorch")
    p.add_argument("--gelu", default="tanh", choices=["tanh", "exact"],
                   help="MLP GELU variant: tanh (default) or the exact erf form")
    p.add_argument("--gelu-approx", action="store_true",
                   help=argparse.SUPPRESS)  # deprecated alias for --gelu tanh
    p.add_argument("--grad-checkpoint", action="store_true")
    p.add_argument("--fused-attn", action="store_true",
                   help="fused LN->QKV->attention->proj half-block kernel (ops/fused_attn_block.py)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="Switch-style top-1 MoE MLP with N experts in every --moe-every'th block "
                        "(models/moe.py); 0 = dense")
    p.add_argument("--moe-every", type=int, default=2)
    p.add_argument("--moe-capacity", type=float, default=1.25,
                   help="expert capacity factor (tokens/expert multiplier)")
    p.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="weight of the Switch load-balance loss")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="ranks of an expert group (the MoE experts cut over them); divides "
                        "--dist-processes / --model-parallel, and --moe-experts must be a multiple")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="with --model-parallel > 1: norms and the residual stream on token chunks")
    # training
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--accumulation-steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--warmup-steps", type=int, default=2500)
    p.add_argument("--weight-decay", type=float, default=0.04)
    p.add_argument("--max-steps", type=int, default=5000,
                   help="schedule horizon AND default stop point")
    p.add_argument("--stop-after", type=int, default=None,
                   help="stop at this optimizer step while keeping the --max-steps schedule "
                        "horizon (for split/resumed runs)")
    p.add_argument("--ema", type=float, default=0.996)
    p.add_argument("--teacher-temp", type=float, default=0.04)
    p.add_argument("--student-temp", type=float, default=0.1)
    p.add_argument("--center-momentum", type=float, default=0.9)
    p.add_argument("--loss-type", default="dino", choices=["dino", "simclr", "mae"])
    p.add_argument("--gram-weight", type=float, default=1.0)
    p.add_argument("--koleo-weight", type=float, default=0.0)
    p.add_argument("--crop-scale-min", type=float, default=0.3)
    p.add_argument("--crop-scale-max", type=float, default=1.0)
    p.add_argument("--scale-lr-mult", type=float, default=1.0,
                   help="LR multiplier for the scale_embed (physics) params")
    p.add_argument("--spacing-jitter", type=float, default=0.0,
                   help="sigma of per-view multiplicative lognormal jitter on the spacing input")
    p.add_argument("--scale-gamma-init", type=float, default=1.0,
                   help="ScaleEmbedding LayerNorm gamma init")
    p.add_argument("--mu-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="Adam first-moment storage dtype")
    p.add_argument("--nu-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="Adam second-moment storage dtype")
    p.add_argument("--ckpt-timeout", type=float, default=0.0,
                   help="watchdog (seconds) on every blocking checkpoint op; 0 disables. A "
                        "wedged save is abandoned and the process exits rc=3 after training")
    p.add_argument("--factored-nu", action="store_true",
                   help="store the Adam second moment rank-1 factored (Adafactor-style row/column "
                        "EMAs) for >=2-D params")
    p.add_argument("--seed", type=int, default=0)
    # data
    p.add_argument("--z-stride", type=int, default=1)
    p.add_argument("--diverse-batches", action="store_true")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--device-prefetch", type=int, default=2,
                   help="batches staged ahead on the device for loader-fed runs (0 = copy "
                        "inline in the step)")
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--decoded-cache", choices=["auto", "build", "off"], default="auto",
                   help="write-once decoded-slice memmap beside the index (data/slice_cache.py): "
                        "auto = use if present, build = decode once then use, off = always "
                        "inflate PNGs")
    p.add_argument("--synthetic-device-batches", type=int, default=0,
                   help="pre-stage this many synthetic batches ON THE DEVICE and cycle them")
    p.add_argument("--synthetic-datasets", type=int, default=2,
                   help="synthetic dataset profiles for --synthetic-device-batches (2 = two-organ "
                        "MVP, 5 = the v2 CT-catalog profiles)")
    p.add_argument("--signature-strength", type=float, default=1.0,
                   help="v2-profile dataset-signature strength for --synthetic-datasets 5")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic on-the-fly host batches (smoke/bench)")
    # ops
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--monitor-every", type=int, default=0,
                   help="in-loop attention/health snapshots every N steps into run_dir/monitor")
    p.add_argument("--ckpt-keep-last", type=int, default=5)
    p.add_argument("--log-json", action="store_true")
    p.add_argument("--metric-flush-steps", type=int, default=64,
                   help="max steps of device metrics buffered before the anomaly check runs")
    p.add_argument("--metric-flush-secs", type=float, default=10.0,
                   help="wall-clock cadence of the metric drain")
    p.add_argument("--anomaly-spike-floor", type=float, default=0.0,
                   help="absolute loss headroom below which the relative 2x-mean spike warning "
                        "is suppressed")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace this many steps with torch.profiler into run_dir/profile")
    p.add_argument("--profile-start", type=int, default=2)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks of a model group (tensor parallel); divides --dist-processes")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="pipeline stages (GPipe, one process a stage); divides --dist-processes")
    p.add_argument("--pp-microbatches", type=int, default=None,
                   help="GPipe microbatches of a step (default: --pipeline-parallel)")
    p.add_argument("--dist-coordinator", default=None,
                   help="host:port of process 0's TCP store; with --dist-processes/--dist-process-id")
    p.add_argument("--dist-processes", type=int, default=0)
    p.add_argument("--dist-process-id", type=int, default=-1)
    return p.parse_args(argv)


def join_processes(args, device: torch.device) -> bool:
    """Join the process group of ``--dist-processes`` > 1 (nothing for one
    process). A default group the caller already started is used when its
    world size and rank are these; returns True when this call started one."""
    if args.dist_processes <= 1:
        return False
    world, rank = args.dist_processes, args.dist_process_id
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise ValueError(f"the process group has world size {dist.get_world_size()} and rank "
                             f"{dist.get_rank()}, not --dist-processes {world} --dist-process-id {rank}")
        return False
    if args.dist_coordinator is None or not 0 <= rank < world:
        raise ValueError(f"--dist-processes {world} needs --dist-coordinator host:port and a "
                         f"--dist-process-id in [0, {world})")
    init_distributed(args.dist_coordinator, world, rank, device=device)
    return True


class RankRows:
    """The rows [lo, hi) of every global batch of *batches*: a data rank's
    share of batches that every rank makes whole from the seed."""

    def __init__(self, batches, lo: int, hi: int):
        self.batches, self.lo, self.hi = batches, lo, hi

    def __iter__(self):
        for b in self.batches:
            yield Batch(pixels=b.pixels[:, self.lo:self.hi], spacing=b.spacing[:, self.lo:self.hi],
                        indices=None if b.indices is None else b.indices[self.lo:self.hi])


class SyntheticBatches:
    """Deterministic synthetic uint16 host batches (the dry-run data path),
    bit-equal to the JAX CLI's."""

    def __init__(self, batch_size, accum, canvas, seed=0):
        self.batch_size, self.accum, self.canvas, self.seed = batch_size, accum, canvas, seed
        self._start = 0

    def seek(self, step: int) -> None:
        """See DeviceSyntheticBatches.seek: resume-phase alignment."""
        self._start = step

    def __iter__(self):
        i = self._start
        while True:
            rng = np.random.default_rng((self.seed, i))
            yield Batch(
                pixels=rng.integers(25000, 41000,
                                    (self.accum, self.batch_size, self.canvas, self.canvas, 3),
                                    dtype=np.uint16),
                spacing=rng.uniform(0.4, 3.0, (self.accum, self.batch_size, 3)).astype(np.float32),
                indices=np.arange(self.batch_size, dtype=np.int64),
            )
            i += 1


class DeviceSyntheticBatches:
    """Pre-staged synthetic batches ON THE DEVICE, cycled: no per-step host
    to device copy. n_datasets=2 is the two-organ MVP generator (organ A ~
    thin-slice lung CT, organ B ~ thick-slice abdomen); n_datasets=5 samples
    the v2 CT-catalog profiles (:func:`dinox_torch.data.synthetic.make_batch_fn`).
    Batch i is drawn from a generator on *device* seeded by (seed, i)."""

    def __init__(self, n_batches, batch_size, accum, canvas, seed=0, n_datasets=2,
                 signature_strength=1.0, device=None):
        if n_datasets not in (2, 5):
            raise ValueError("--synthetic-datasets must be 2 (two-organ MVP) or 5 (v2 CT-catalog "
                             "profiles)")
        dev = resolve_device(device)
        n = accum * batch_size

        def two_organ(g: torch.Generator):
            organ = torch.rand((n,), generator=g, device=dev) < 0.5
            low = torch.randn((n, canvas // 16, canvas // 16, 3), generator=g, device=dev)
            img = upsample(low, canvas)
            # stored encoding: uint16 = HU + 32768; HU clipped to [-1000, 4000]
            # like the on-disk twin (synth_two_organ_series_np)
            mean = torch.where(organ, -600.0, 40.0)[:, None, None, None]
            std = torch.where(organ, 300.0, 120.0)[:, None, None, None]
            hu = torch.clamp(mean + img * std, -1000.0, 4000.0)
            pixels = torch.clamp(hu + 32768.0, 0.0, 65535.0).to(torch.uint16)
            lo_a, hi_a = torch.tensor([0.5, 0.5, 1.0], device=dev), torch.tensor([1.0, 1.0, 1.5], device=dev)
            lo_b, hi_b = torch.tensor([1.5, 1.5, 2.5], device=dev), torch.tensor([3.0, 3.0, 5.0], device=dev)
            sp_a = lo_a + (hi_a - lo_a) * torch.rand((n, 3), generator=g, device=dev)
            sp_b = lo_b + (hi_b - lo_b) * torch.rand((n, 3), generator=g, device=dev)
            return pixels, torch.where(organ[:, None], sp_a, sp_b)

        if n_datasets == 2:
            make = two_organ
        else:
            v2 = make_batch_fn(canvas, n, signature_strength=signature_strength, device=dev)

            def make(g: torch.Generator):
                return v2(g)[:2]

        self._batches = []
        for i in range(n_batches):
            px, sp = make(seeded_generator(seed, i, device=dev))
            self._batches.append((px.reshape(accum, batch_size, canvas, canvas, 3),
                                  sp.reshape(accum, batch_size, 3).float()))
        self._start = 0

    def seek(self, step: int) -> None:
        """Align the cycle phase with a resumed run: an uninterrupted run
        consumes batch (s-1) % n_batches at optimizer step s, so a run
        resumed at start_step begins the cycle there, and the stream after
        the seam is the uninterrupted run's."""
        self._start = step

    def __iter__(self):
        i = self._start
        while True:
            px, sp = self._batches[i % len(self._batches)]
            yield Batch(pixels=px, spacing=sp, indices=None)
            i += 1


class AccumBatches:
    """Stack accumulation_steps micro-batches from the host loader into the
    (A, B, ...) layout the step consumes."""

    def __init__(self, loader, accum):
        self.loader, self.accum = loader, accum

    def __iter__(self):
        it = iter(self.loader)
        while True:
            micro = [next(it) for _ in range(self.accum)]
            yield Batch(
                pixels=np.stack([m.pixels for m in micro]),
                spacing=np.stack([m.spacing for m in micro]),
                indices=micro[0].indices,
            )


def data_manifest_hash(index_csv: Path) -> str:
    return hashlib.sha256(index_csv.read_bytes()).hexdigest()[:16]


# Kernel/runtime choices give the same numerics and may differ between the
# original run and its resume; everything else in ModelConfig changes the
# math and must come from the run being resumed.
_RUNTIME_ONLY_MODEL_FIELDS = {"attn_impl", "fused_attn", "fused_mlp", "use_grad_checkpoint"}


def reconcile_resume_model_config(mcfg, stored: dict, say=print):
    """Resume continues the run it restores: numerics-affecting model fields
    are adopted from the run dir's stored config.json instead of the CLI
    rebuild. Runtime-only kernel choices stay CLI-controlled. Every adopted
    difference is printed."""
    for k, v in stored.items():
        if k in _RUNTIME_ONLY_MODEL_FIELDS or not hasattr(mcfg, k):
            continue
        cur = getattr(mcfg, k)
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        if cur != v:
            say(f"resume: adopting stored model.{k}={v!r} (CLI had {cur!r})", flush=True)
            mcfg = mcfg.replace(**{k: v})
    return mcfg


def monitor_hook(args, cfg: TrainConfig, loader, writes: bool = True):
    """The ``on_step`` hook of ``--monitor-every``: a TrainingMonitor on the
    first 8 slices of the loader, or 8 synthetic canvases from seed 0. Every
    rank of a mesh runs the snapshot's forward; only *writes* writes it."""
    from dinox_torch.train.monitor_hook import TrainingMonitor

    if loader is not None:
        n_probe = min(8, len(loader.source))
        probe_px = np.stack([loader.source.get(i)[0] for i in range(n_probe)])
        probe_sp = np.asarray([[r.spacing_x, r.spacing_y, r.spacing_z]
                               for r in loader.source.rows[:n_probe]], np.float32)
    else:
        rng = np.random.default_rng(0)
        probe_px = rng.integers(25000, 41000, (8, args.canvas, args.canvas, 3), dtype=np.uint16)
        probe_sp = rng.uniform(0.4, 3.0, (8, 3)).astype(np.float32)
    monitor = TrainingMonitor(args.run_dir, cfg.model.replace(img_size=cfg.img_size), probe_px,
                              probe_sp, every=args.monitor_every,
                              tensorboard=not args.no_tensorboard, writes=writes)

    def on_step(step, _metrics, state) -> None:
        monitor.maybe_snapshot(step, state.student)

    return on_step


def main(argv=None) -> int:
    t_main = time.monotonic()
    args = parse_args(argv)
    if args.expert_parallel > 1 and (args.moe_experts < 1 or args.moe_experts % args.expert_parallel):
        print(f"error: --expert-parallel {args.expert_parallel} needs --moe-experts divisible by it, "
              f"got {args.moe_experts}", file=sys.stderr)
        return 2
    if args.pipeline_parallel > 1:
        # The (data, pipe) mesh excludes the model and expert axes, and a
        # rank holds one stage, not the student the monitor's probe runs.
        for flag, value in (("--model-parallel", args.model_parallel),
                            ("--expert-parallel", args.expert_parallel),
                            ("--monitor-every", args.monitor_every)):
            if value > (0 if flag == "--monitor-every" else 1):
                print(f"error: --pipeline-parallel and {flag} are mutually exclusive", file=sys.stderr)
                return 2
    device = resolve_device(args.device)
    started = join_processes(args, device)
    try:
        return run(args, device, t_main, argv)
    finally:
        if started:
            dist.destroy_process_group()


def run(args, device: torch.device, t_main: float, argv) -> int:
    mesh = None
    pipelined = args.pipeline_parallel > 1
    if pipelined:
        mesh = make_pp_mesh(args.pipeline_parallel, device=device)
        device = mesh.device
    elif args.dist_processes > 1 or args.model_parallel > 1 or args.expert_parallel > 1:
        mesh = make_mesh(model_parallel=args.model_parallel, expert_parallel=args.expert_parallel,
                         device=device)
        device = mesh.device
    main_rank = mesh is None or mesh.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    mcfg = MODEL_CONFIGS[args.config].replace(
        scale_aware=args.scale_aware,
        attn_impl=args.attn_impl,
        use_grad_checkpoint=args.grad_checkpoint,
        fused_attn=args.fused_attn,
        gelu_approx=args.gelu_approx or args.gelu == "tanh",
        scale_gamma_init=args.scale_gamma_init,
        moe_experts=args.moe_experts,
        moe_every=args.moe_every,
        moe_capacity_factor=args.moe_capacity,
        sequence_parallel=args.sequence_parallel,
    )
    # Resolve resume BEFORE building state: the resumed run's stored model
    # config wins over CLI-rebuilt fields (reconcile_resume_model_config).
    resume_dir = None
    if args.resume == "auto":
        resume_dir = find_latest_run(args.run_dir.parent)
    elif args.resume:
        resume_dir = Path(args.resume)
    if resume_dir is not None and (resume_dir / "config.json").exists():
        stored_cfg = json.loads((resume_dir / "config.json").read_text())
        mcfg = reconcile_resume_model_config(mcfg, stored_cfg.get("model", {}), say)
    cfg = TrainConfig(
        model=mcfg,
        img_size=args.img_size,
        batch_size=args.batch_size,
        accumulation_steps=args.accumulation_steps,
        lr=args.lr,
        min_lr=args.min_lr,
        warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay,
        max_steps=args.max_steps,
        ema=args.ema,
        teacher_temp=args.teacher_temp,
        student_temp=args.student_temp,
        center_momentum=args.center_momentum,
        loss_type=args.loss_type,
        gram_weight=args.gram_weight,
        koleo_weight=args.koleo_weight,
        crop_scale_min=args.crop_scale_min,
        crop_scale_max=args.crop_scale_max,
        scale_lr_mult=args.scale_lr_mult,
        spacing_jitter=args.spacing_jitter,
        moe_aux_weight=args.moe_aux_weight,
        mu_dtype=args.mu_dtype,
        nu_dtype=args.nu_dtype,
        factored_nu=args.factored_nu,
        pipeline_parallel=args.pipeline_parallel,
        pp_microbatches=args.pp_microbatches,
        train_seed=args.seed,
    )

    (check_pp_config if pipelined else reject_unported)(cfg)
    if mesh is not None and args.batch_size % mesh.dp:
        print(f"error: --batch-size {args.batch_size} is the GLOBAL batch and must be divisible "
              f"by the data axis size {mesh.dp}", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device={device} ({name})", flush=True)
    if pipelined:
        say(f"mesh: {mesh.world} processes on {mesh.hosts} host(s), data {mesh.dp} x pipe {mesh.pp} "
            f"({mcfg.depth // mesh.pp} blocks a stage), {cfg.pp_microbatches or mesh.pp} microbatches, "
            f"{args.batch_size // mesh.dp} rows a data rank", flush=True)
    elif mesh is not None:
        say(f"mesh: {mesh.world} processes on {mesh.hosts} host(s), data {mesh.dp} x model "
            f"{mesh.tp} x expert {mesh.ep}, sequence_parallel={mcfg.sequence_parallel}, "
            f"{args.batch_size // mesh.dp} rows a data rank", flush=True)
    say(f"config={args.config} params~{mcfg.params_millions:.1f}M "
        f"eff_batch={cfg.effective_batch_size} scale_aware={mcfg.scale_aware}", flush=True)
    provenance = {
        "git_commit": get_git_commit(Path(__file__).resolve().parent.parent),
        "data_manifest_hash": data_manifest_hash(args.index_csv) if args.index_csv else "synthetic",
        "argv": sys.argv[1:] if argv is None else list(argv),
    }

    # -- data ---------------------------------------------------------------
    if args.signature_strength != 1.0 and not (
            args.synthetic_device_batches > 0 and args.synthetic_datasets == 5):
        print("error: --signature-strength only applies to --synthetic-device-batches with "
              "--synthetic-datasets 5; for on-disk data regenerate the tree at that strength "
              "instead", file=sys.stderr)
        return 2
    loader = None
    loader_position = None
    if args.synthetic_device_batches > 0:
        batches = DeviceSyntheticBatches(
            args.synthetic_device_batches, args.batch_size, args.accumulation_steps, args.canvas,
            args.seed, n_datasets=args.synthetic_datasets,
            signature_strength=args.signature_strength, device=device)
    elif args.synthetic:
        batches = SyntheticBatches(args.batch_size, args.accumulation_steps, args.canvas, args.seed)
    else:
        if args.index_csv is None:
            print("error: --index-csv required unless --synthetic", file=sys.stderr)
            return 2
        rows = load_index_rows(args.index_csv, require_spacing=args.scale_aware)
        say(f"loaded_rows={len(rows)}", flush=True)
        if args.split_manifest and args.split_manifest.exists():
            before = len(rows)
            rows = exclude_val_series(rows, load_split_manifest(args.split_manifest))
            say(f"excluded_val_rows={before - len(rows)}", flush=True)
        rows = z_stride_subsample(rows, args.z_stride)
        decoded_cache = None
        if args.decoded_cache != "off":
            index_dir = Path(args.index_csv).parent
            if args.decoded_cache == "build":
                build_slice_cache(rows, args.canvas, index_dir, workers=args.num_workers)
            decoded_cache = open_slice_cache(index_dir, args.canvas)
            if decoded_cache is not None:
                say(f"decoded-slice cache: {len(decoded_cache)} slices @{args.canvas} "
                    f"(zlib inflate off the hot path)", flush=True)
        say(f"png decoder: {decoder_in_use()}", flush=True)
        # A data rank's loader reads its block of each global batch; the
        # model group's ranks read the same rows.
        dp, dp_rank = (1, 0) if mesh is None else (mesh.dp, mesh.dp_rank)
        loader = TrainLoader(rows, args.batch_size // dp, seed=args.seed, canvas=args.canvas,
                             diverse=args.diverse_batches, num_workers=args.num_workers,
                             host_id=dp_rank, num_hosts=dp, decoded_cache=decoded_cache)
        batches = AccumBatches(loader, args.accumulation_steps)

    # -- state / resume -----------------------------------------------------
    if loader is not None and args.device_prefetch > 0:
        batches = DevicePrefetcher(batches, device=device, depth=args.device_prefetch)
    state = (create_pp_train_state if pipelined else create_train_state)(cfg, seed=args.seed,
                                                                         device=device, mesh=mesh)
    start_step = 0
    if resume_dir is not None and (resume_dir / "ckpt").exists():
        t0 = time.monotonic()
        mgr = CheckpointManager(resume_dir, keep_last=args.ckpt_keep_last, mesh=mesh)
        state, meta = mgr.restore(state)
        mgr.close()
        start_step = int(meta["step"])
        say(f"resumed from {resume_dir} at step {start_step} "
            f"(restore_s={time.monotonic() - t0:.3f})", flush=True)
        if loader is not None:
            loader.epoch = meta.get("loader_epoch", 0)
            loader.batch_in_epoch = meta.get("loader_batch", 0)
        elif isinstance(batches, (DeviceSyntheticBatches, SyntheticBatches)):
            batches.seek(start_step)
    if loader is not None:
        # The loader (and the prefetcher) run ahead of the loop, so its own
        # position counts batches not trained yet: checkpoint the position
        # after the batches the loop has taken, from the step (the step
        # updates `state` in place).
        start_epoch, start_batch = loader.position
        per_epoch = loader.batches_per_epoch

        def loader_position() -> tuple[int, int]:
            n = start_batch + (state.step - start_step) * args.accumulation_steps
            return start_epoch + n // per_epoch, n % per_epoch
    if mesh is not None and loader is None:  # synthetic batches are made whole on every rank
        batches = RankRows(batches, *batch_rows(mesh, args.batch_size))
    step_fn = (build_pp_train_step if pipelined else build_train_step)(cfg, device=device, mesh=mesh)
    on_step = None
    if args.monitor_every > 0:
        on_step = monitor_hook(args, cfg, loader, writes=main_rank)

    args.run_dir.mkdir(parents=True, exist_ok=True)
    if main_rank:
        (args.run_dir / "provenance.json").write_text(json.dumps(provenance, indent=2))

    t0 = time.monotonic()
    say(f"startup_s={t0 - t_main:.3f}", flush=True)
    stop_at = min(args.stop_after or args.max_steps, args.max_steps)
    try:
        state = train(
            cfg, state, step_fn, batches,
            run_dir=args.run_dir,
            max_steps=stop_at,
            device=device,
            start_step=start_step,
            ckpt_every=args.ckpt_every,
            ckpt_keep_last=args.ckpt_keep_last,
            ckpt_timeout_s=args.ckpt_timeout,
            log_jsonl=args.log_json,
            flush_max_steps=args.metric_flush_steps,
            flush_secs=args.metric_flush_secs,
            anomaly_spike_floor=args.anomaly_spike_floor,
            tensorboard=not args.no_tensorboard,
            loader_position=loader_position,
            on_step=on_step,
            profile_steps=args.profile_steps,
            profile_start=args.profile_start,
            mesh=mesh,
        )
    except CheckpointWedgedError as e:
        # Training finished but the final state could not be written; a daemon
        # thread is stuck in the dead channel, so a normal interpreter exit
        # could hang in teardown: force it.
        print(f"WEDGED-CHECKPOINT: {e}", flush=True)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3)
    finally:
        if loader is not None:
            loader.close()
    dt = time.monotonic() - t0
    steps_done = state.step - start_step
    if not main_rank:
        return 0
    ckpt_stats = json.loads((args.run_dir / "checkpoints.json").read_text())
    print(f"checkpoints saves={ckpt_stats['saves']} bytes={ckpt_stats['bytes']} "
          f"blocked_s={ckpt_stats['blocked_s']:.3f} alloc_s={ckpt_stats['alloc_s']:.3f} "
          f"snapshot_device_s={ckpt_stats['snapshot_device_s']:.4f} write_s={ckpt_stats['write_s']:.3f}",
          flush=True)
    if loader is not None:
        print(f"loader slices={len(loader.source)} png_decodes={loader.source.png_decodes}", flush=True)
    if steps_done > 0 and dt > 0:
        print(f"done steps={steps_done} wall_s={dt:.1f} steps_per_s={steps_done / dt:.3f} "
              f"samples_per_s={steps_done * cfg.effective_batch_size / dt:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
