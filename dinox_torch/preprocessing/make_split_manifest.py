"""Deterministic train/val split at series granularity -> JSON manifest (no
slice leakage across the split): the twin of
``scripts/preprocessing/make_split_manifest.py``.

    python -m dinox_torch.preprocessing.make_split_manifest --index idx.csv \\
        --out split_manifest.json --val-fraction 0.1 --seed 0
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from dinox_torch.data.index import load_index_rows, make_split_manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    manifest = make_split_manifest(rows, val_fraction=args.val_fraction, seed=args.seed)
    args.out.write_text(json.dumps(manifest, indent=2))
    n_series = len({r.series_dir for r in rows})
    print(f"{n_series} series -> {len(manifest['val']['series_dir'])} val "
          f"-> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
