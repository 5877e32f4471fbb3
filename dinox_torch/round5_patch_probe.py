"""Where does the dataset signal live, in the CLS token or in the mean of
the patch tokens? The twin of ``scripts/round5_patch_probe.py``, with the
same flags plus ``--device`` and the same JSON keys.

A mechanism diagnostic for the signature-strength experiment. The
six-metric probe reads the CLS embedding, the token the DINO
instance-discrimination head trains. A series-split dataset probe that is
high on the mean patch tokens and low on CLS means training kept the signal
but left it out of the instance-level summary (domain and protocol tasks
should then read the patch tokens). One forward per batch; both pools
probed with ``evaluation.metrics.dataset_discrimination_probe``.

    python -m dinox_torch.round5_patch_probe --checkpoint data/runs/sig_200 \\
        --index-csv data/synth_v2_eval_sig200/index.csv \\
        --split-manifest data/synth_v2_eval_sig200/split_manifest.json \\
        --out docs/sig_200_patch_probe.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from dinox_torch.data.index import IndexRow, load_index_rows
from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.evaluation.embedder import _l2n, _load_batches
from dinox_torch.evaluation.metrics import dataset_discrimination_probe
from dinox_torch.ops.augment import eval_transform
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.hub import DeviceViT


@torch.inference_mode()
def cls_and_mean_patch(model: DeviceViT, rows: Sequence[IndexRow], canvas: int = 512,
                       batch_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) CLS tokens and (N, D) means of the patch tokens of *rows*,
    float32 and not normalised, one forward per batch."""
    n_patches = model.cfg.n_patches
    cls_chunks, patch_chunks = [], []
    for pixels, spacing in _load_batches(rows, np.arange(len(rows)), canvas, batch_size):
        x = eval_transform(torch.from_numpy(pixels).to(model.device), img_size=model.img_size)
        feats = model(x, spacing if model.scale_aware else None)  # [CLS, patches..., registers]
        cls_chunks.append(feats[:, 0].float().cpu().numpy())
        patch_chunks.append(feats[:, 1:1 + n_patches].float().mean(dim=1).cpu().numpy())
    return np.concatenate(cls_chunks), np.concatenate(patch_chunks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--index-csv", type=Path, required=True)
    p.add_argument("--split-manifest", type=Path, required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--max-slices", type=int, default=1200)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = load_any_model(args.checkpoint, device)
    rows = load_index_rows(args.index_csv)
    val = set(json.loads(args.split_manifest.read_text())["val"]["series_dir"])
    rows = [r for r in rows if r.series_dir in val][: args.max_slices]
    print(f"eval_rows={len(rows)}", flush=True)

    result = {"checkpoint": str(args.checkpoint), "n_slices": len(rows)}
    for name, emb in zip(("cls", "mean_patch"),
                         cls_and_mean_patch(model, rows, args.canvas, args.batch_size)):
        probe = dataset_discrimination_probe(_l2n(emb), rows, seed=42)
        result[name] = {k: probe[k] for k in
                        ("accuracy", "auc", "knn_accuracy") if k in probe}
        print(f"{name}: {result[name]}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
