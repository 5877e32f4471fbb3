"""Out-of-process training health monitor: the twin of the JAX package's
``scripts/monitor.py`` (its flags plus ``--device``). It loads the backbone
of a run directory's latest checkpoint (only its tensors), embeds a fixed
probe batch, and writes ``stats.json`` (step, embed_std, embed_norm_mean,
gram_mean, collapse_warning, timestamp) and ``heatmap.png`` (the first
probe image's patch-token L2-norm map, 224 px nearest, 8-bit grayscale)
into the run dir. On the card unless ``--device cpu``.

    python -m dinox_torch.monitor --run-dir data/runs/mvp [--index-csv idx.csv] [--watch 300]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dinox_torch.data.png8 import resize_nearest, write_png8
from dinox_torch.ops.augment import eval_transform
from dinox_torch.train.checkpoint import META_FILE
from dinox_torch.train.losses import gram_matrix
from dinox_torch.train.run_export import _checkpoint_dir, load_backbone_from_run
from dinox_torch.utils.platform import resolve_device


def probe_batch(args) -> tuple[np.ndarray, np.ndarray]:
    """Fixed probe inputs: the first rows of an index if one is given, else a
    synthetic batch from seed 0."""
    if args.index_csv and Path(args.index_csv).exists():
        from dinox_torch.data.index import load_index_rows
        from dinox_torch.data.pipeline import SliceStackSource

        rows = load_index_rows(args.index_csv)[: args.n]
        src = SliceStackSource(rows, canvas=args.canvas)
        pixels = np.stack([src.get(i)[0] for i in range(len(rows))])
        spacing = np.asarray([[r.spacing_x, r.spacing_y, r.spacing_z] for r in rows], np.float32)
        return pixels, spacing
    rng = np.random.default_rng(0)
    return (rng.integers(25000, 41000, (args.n, args.canvas, args.canvas, 3), dtype=np.uint16),
            rng.uniform(0.4, 3.0, (args.n, 3)).astype(np.float32))


@torch.no_grad()
def snapshot(args, device: torch.device) -> dict:
    run_dir = Path(args.run_dir)
    meta = json.loads((_checkpoint_dir(run_dir, None) / META_FILE).read_text())
    model = load_backbone_from_run(run_dir, device=device)
    pixels, spacing = probe_batch(args)
    x = eval_transform(torch.as_tensor(pixels, device=device), img_size=model.img_size)
    feats = model(x, spacing if model.scale_aware else None).float().cpu().numpy()

    cls = feats[:, 0]
    patches = feats[:, 1:1 + (model.img_size // model.patch) ** 2]
    gram = gram_matrix(torch.from_numpy(patches[:min(8, len(patches))])).numpy()
    stats = {
        "step": int(meta["step"]),
        "embed_std": float(cls.std(axis=0).mean()),
        "embed_norm_mean": float(np.linalg.norm(cls, axis=-1).mean()),
        "gram_mean": float(gram.mean()),
        "collapse_warning": bool(cls.std(axis=0).mean() < 0.01),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    (run_dir / "stats.json").write_text(json.dumps(stats, indent=2))

    side = model.img_size // model.patch
    energy = np.linalg.norm(patches[0], axis=-1).reshape(side, side)
    energy = (energy - energy.min()) / max(float(np.ptp(energy)), 1e-9)
    write_png8(run_dir / "heatmap.png", resize_nearest((energy * 255).astype(np.uint8), (224, 224)))
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--index-csv", type=Path, default=None)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--watch", type=int, default=0, help="re-check every N seconds (0 = once)")
    p.add_argument("--device", default="cuda",
                   help="torch device to embed on (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    while True:
        try:
            stats = snapshot(args, device)
            print(json.dumps(stats), flush=True)
            if stats["collapse_warning"]:
                print("WARNING: possible embedding collapse", flush=True)
        except FileNotFoundError as e:
            print(f"no checkpoint yet: {e}", flush=True)
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    raise SystemExit(main())
