"""CIFAR-10 DINO pretraining, the non-medical control of the port: the twin
of ``scripts/baseline_cifar10_pretrain.py`` (its flags plus ``--device``).
The same DINO loop (student/teacher EMA, centring, Gram anchoring, KoLeo)
on 32x32 RGB with the TwoCrops-style augmentation
(:func:`dinox_torch.ops.augment_rgb.augment_rgb_views`), PatchViT img 32,
patch 4, dim 192, depth 6, 6 heads, 4 registers (N = 69, head dim 32):
bf16 on the card, f32 on the CPU.

``--attn-impl xla`` (the reference's default) is plain PyTorch attention;
``--attn-impl pallas`` runs the packed attention kernels (kernel 1 forward,
the dq/dkv pair backward) and is the one to use on the card.

    python -m dinox_torch.baseline_cifar10_pretrain --run-dir /tmp/cifar \\
        --attn-impl pallas --max-steps 2000 [--data-dir path/to/cifar-10-batches-py]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dinox_torch.data.cifar import load_cifar10
from dinox_torch.data.pipeline import Batch
from dinox_torch.models.config import ModelConfig
from dinox_torch.ops.augment_rgb import RgbAugConfig, augment_rgb_views
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.train.trainer import train
from dinox_torch.utils.platform import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--data-dir", type=Path, default=None,
                   help="cifar-10-batches-py dir; synthetic stand-in if absent")
    p.add_argument("--img-size", type=int, default=32)
    p.add_argument("--patch", type=int, default=4)
    p.add_argument("--dim", type=int, default=192)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--heads", type=int, default=6)
    p.add_argument("--out-dim", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--accumulation-steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--ema", type=float, default=0.996)
    p.add_argument("--koleo-weight", type=float, default=0.1)
    p.add_argument("--gram-weight", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--log-json", action="store_true")
    p.add_argument("--attn-impl", default="xla", choices=["xla", "pallas"],
                   help="'xla': plain PyTorch attention; 'pallas': the packed attention kernels "
                        "on the card")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' trains in f32 with the "
                        "plain versions)")
    return p.parse_args(argv)


class CifarBatches:
    """Epochs of shuffled uint8 image batches, (accum, B, 32, 32, 3), each
    epoch's order from ``default_rng((seed, epoch))``: the JAX script's."""

    def __init__(self, images: np.ndarray, batch_size: int, accum: int, seed: int):
        self.images, self.batch_size, self.accum, self.seed = images, batch_size, accum, seed

    def __iter__(self):
        epoch = 0
        n = len(self.images)
        per_step = self.batch_size * self.accum
        while True:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
            for s in range(0, n - per_step + 1, per_step):
                idx = order[s: s + per_step].reshape(self.accum, self.batch_size)
                yield Batch(
                    pixels=self.images[idx],
                    spacing=np.ones((self.accum, self.batch_size, 3), np.float32),
                    indices=idx[0],
                )
            epoch += 1


def cifar_model_config(args, device) -> ModelConfig:
    return ModelConfig(
        name="cifar-vit", img_size=args.img_size, patch=args.patch, dim=args.dim,
        depth=args.depth, heads=args.heads, out_dim=args.out_dim,
        num_registers=4, attn_impl=args.attn_impl,
        dtype="bfloat16" if device.type != "cpu" else "float32",
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)

    x_train, _, _, _, real = load_cifar10(args.data_dir)
    print(f"cifar: {len(x_train)} train images (real={real})", flush=True)

    cfg = TrainConfig(
        model=cifar_model_config(args, device), img_size=args.img_size,
        batch_size=args.batch_size, accumulation_steps=args.accumulation_steps, lr=args.lr,
        min_lr=args.min_lr, warmup_steps=args.warmup_steps, max_steps=args.max_steps,
        ema=args.ema, gram_weight=args.gram_weight, koleo_weight=args.koleo_weight,
        train_seed=args.seed,
    )
    rgb_cfg = RgbAugConfig(img_size=args.img_size)

    def rgb_augment(pixels, generator, _aug_cfg):
        return augment_rgb_views(pixels, generator, rgb_cfg)

    state = create_train_state(cfg, seed=args.seed, device=device)
    step_fn = build_train_step(cfg, device=device, augment_fn=rgb_augment)
    batches = CifarBatches(x_train, args.batch_size, args.accumulation_steps, args.seed)
    train(
        cfg, state, step_fn, batches,
        run_dir=args.run_dir, max_steps=args.max_steps, device=device,
        ckpt_every=args.ckpt_every, log_jsonl=args.log_json, tensorboard=False,
    )
    print(f"done -> {args.run_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
