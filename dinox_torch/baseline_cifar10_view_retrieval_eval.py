"""CIFAR view retrieval of the port: the twin of
``scripts/baseline_cifar10_view_retrieval_eval.py`` (its flags plus
``--device``). Embeds two augmented views
(:func:`dinox_torch.ops.augment_rgb.augment_rgb_views`) of N test images,
top-1 nearest-neighbour match against chance; exit code 2 below the ratio
gate.

    python -m dinox_torch.baseline_cifar10_view_retrieval_eval --checkpoint /tmp/cifar
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dinox_torch.baseline_cifar10_linear_probe import normalized_cls
from dinox_torch.data.cifar import load_cifar10
from dinox_torch.evaluation.metrics import view_retrieval
from dinox_torch.ops.augment_rgb import RgbAugConfig, augment_rgb_views
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.utils.platform import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--min-ratio", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    model = load_backbone_from_run(args.checkpoint, device=device)
    _, _, x_te, _, real = load_cifar10(args.data_dir)
    rng = np.random.default_rng(args.seed)
    n = min(args.n, len(x_te))
    pick = rng.choice(len(x_te), n, replace=False)
    cfg = RgbAugConfig(img_size=model.img_size)
    views = augment_rgb_views(torch.as_tensor(x_te[pick], device=device),
                              torch.Generator().manual_seed(args.seed), cfg)

    res = view_retrieval(normalized_cls(model, views[0]), normalized_cls(model, views[1]))
    res["passed"] = bool(res["ratio_vs_random"] >= args.min_ratio)
    res["real_cifar"] = bool(real)
    if args.out:
        args.out.write_text(json.dumps(res, indent=2))
    print(json.dumps(res), flush=True)
    return 0 if res["passed"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
