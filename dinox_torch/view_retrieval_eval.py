"""Label-free view-retrieval gate of the port: the twin of
``scripts/view_retrieval_eval.py`` (its flags plus ``--device``). Embeds
two augmented views of N rows, top-1/top-k nearest-neighbour match, PASS
iff top1 >= min_ratio * (1/N); exit code 2 on failure or no rows.

    python -m dinox_torch.view_retrieval_eval --checkpoint runs/mvp --index-csv index.csv
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from dinox_torch.data.index import load_index_rows, load_split_manifest, select_val_series
from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.evaluation.embedder import embed_two_views
from dinox_torch.evaluation.metrics import view_retrieval
from dinox_torch.utils.platform import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--index-csv", type=Path, required=True)
    p.add_argument("--split-manifest", type=Path, default=None)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--min-ratio", type=float, default=10.0,
                   help="pass gate: top1 >= min_ratio / N")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rows = load_index_rows(args.index_csv)
    if args.split_manifest and args.split_manifest.exists():
        rows = select_val_series(rows, load_split_manifest(args.split_manifest))
    if not rows:
        print("error: no rows", file=sys.stderr)
        return 2

    model = load_any_model(args.checkpoint, device)
    rng = np.random.default_rng(args.seed)
    n = min(args.n, len(rows))
    idxs = rng.choice(len(rows), size=n, replace=False)
    q, k = embed_two_views(model, rows, idxs, seed=args.seed, batch_size=args.batch_size)
    res = view_retrieval(q, k)
    res["pass_threshold_ratio"] = args.min_ratio
    res["passed"] = bool(res["ratio_vs_random"] >= args.min_ratio)

    out = args.out or Path(f"view_retrieval_N{n}_{int(time.time())}.json")
    out.write_text(json.dumps(res, indent=2))
    print(json.dumps(res), flush=True)
    print(f"{'PASS' if res['passed'] else 'FAIL'}: top1={res['top1']:.4f} "
          f"ratio={res['ratio_vs_random']:.1f}x (gate {args.min_ratio}x)", flush=True)
    return 0 if res["passed"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
