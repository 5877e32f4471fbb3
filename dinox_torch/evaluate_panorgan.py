"""Pan-organ 6-metric evaluation of the port: the twin of
``scripts/evaluate_panorgan.py``, with the same flags plus ``--device``
and the same JSON keys. Per-dataset view retrieval, dataset discrimination
probe, spacing counterfactual, domain clustering, spacing prediction R^2
and embedding statistics; writes a JSON artifact.

    python -m dinox_torch.evaluate_panorgan --checkpoint runs/mvp \\
        --index-csv data/index.csv --split-manifest splits.json \\
        --out eval_results.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from dinox_torch.data.index import load_index_rows, load_split_manifest, select_val_series
from dinox_torch.evaluation import metrics as M
from dinox_torch.evaluation.embedder import embed_rows, embed_two_views
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.hub import LoadedModel, load_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="run dir (the port's safetensors checkpoints), hub dir, or reference .pth")
    p.add_argument("--index-csv", type=Path, required=True)
    p.add_argument("--split-manifest", type=Path, default=None,
                   help="evaluate on the val series only")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--max-slices", type=int, default=4096,
                   help="cap on deterministic-embedding slice count")
    p.add_argument("--n-retrieval", type=int, default=512)
    p.add_argument("--n-counterfactual", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip-counterfactual", action="store_true",
                   help="for scale-blind baselines")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def load_any_model(path: str | Path, device: torch.device | str | None = None) -> LoadedModel:
    """A run dir (it has ``ckpt/``) through ``run_export``, else a hub dir or
    a training ``.pth`` through ``zoo.hub.load_model``."""
    p = Path(path)
    if (p / "ckpt").is_dir():
        return load_backbone_from_run(p, device=device)
    return load_model(path, device=device)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rows = load_index_rows(args.index_csv)
    if args.split_manifest and args.split_manifest.exists():
        rows = select_val_series(rows, load_split_manifest(args.split_manifest))
    if not rows:
        print("error: no evaluation rows", file=sys.stderr)
        return 2
    print(f"eval_rows={len(rows)}", flush=True)

    model = load_any_model(args.checkpoint, device)
    rng = np.random.default_rng(args.seed)

    results: dict = {
        "checkpoint": str(args.checkpoint),
        "val_slices": len(rows),
        "seed": args.seed,
        "scale_aware": model.scale_aware,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "metrics": {},
    }

    # [1] per-dataset view retrieval (random augmentation)
    by_ds: dict[str, list] = defaultdict(list)
    for r in rows:
        by_ds[r.dataset or "unknown"].append(r)
    vr = {}
    for name in sorted(by_ds):
        ds_rows = by_ds[name]
        n = min(args.n_retrieval, len(ds_rows))
        idxs = rng.choice(len(ds_rows), size=n, replace=False)
        q, k = embed_two_views(model, ds_rows, idxs, seed=args.seed, batch_size=args.batch_size)
        vr[name] = M.view_retrieval(q, k)
        print(f"view_retrieval[{name}]: top1={vr[name]['top1']:.4f} "
              f"ratio={vr[name]['ratio_vs_random']:.1f}x", flush=True)
    results["metrics"]["view_retrieval_per_dataset"] = vr

    # deterministic embeddings for metrics 2/4/5/6
    if len(rows) > args.max_slices:
        keep = rng.choice(len(rows), size=args.max_slices, replace=False)
        det_rows = [rows[i] for i in sorted(keep)]
    else:
        det_rows = rows
    emb, spacings = embed_rows(model, det_rows, batch_size=args.batch_size)

    results["metrics"]["dataset_discrimination_probe"] = M.dataset_discrimination_probe(
        emb, det_rows, seed=args.seed)
    results["metrics"]["domain_clustering"] = M.domain_clustering(emb, det_rows)
    results["metrics"]["spacing_prediction"] = M.spacing_prediction(
        emb, spacings, det_rows, seed=args.seed)
    results["metrics"]["embedding_stats"] = M.embedding_stats(emb, spacings, det_rows)

    # [3] spacing counterfactual (same pixels, x2 / x0.5 spacing)
    if model.scale_aware and not args.skip_counterfactual:
        n = min(args.n_counterfactual, len(rows))
        pick = rng.choice(len(rows), size=n, replace=False)
        cf_rows = [rows[i] for i in pick]
        e_real, _ = embed_rows(model, cf_rows, batch_size=args.batch_size)
        e_2x, _ = embed_rows(model, cf_rows, batch_size=args.batch_size, spacing_scale=2.0)
        e_half, _ = embed_rows(model, cf_rows, batch_size=args.batch_size, spacing_scale=0.5)
        results["metrics"]["spacing_counterfactual"] = (
            M.spacing_counterfactual_from_embeddings(e_real, e_2x, e_half))
    else:
        results["metrics"]["spacing_counterfactual"] = {
            "skipped": "baseline model (no scale embedding)" if not model.scale_aware
            else "--skip-counterfactual",
        }

    out = args.out or Path(f"panorgan_eval_{int(time.time())}.json")
    out.write_text(json.dumps(results, indent=2))
    print(f"results -> {out}", flush=True)
    probe = results["metrics"]["dataset_discrimination_probe"]
    print(f"summary: probe_acc={probe.get('accuracy')} "
          f"spacing_r2={results['metrics']['spacing_prediction'].get('r2')}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
