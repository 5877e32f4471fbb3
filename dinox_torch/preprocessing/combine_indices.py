"""Merge per-dataset index CSVs into one combined index with a dataset
column, optionally subsampling series per dataset: the twin of
``scripts/preprocessing/combine_indices.py`` (the same ``random`` draws).

    python -m dinox_torch.preprocessing.combine_indices --out combined.csv \\
        lidc=/d/lidc/_index/index.csv pancreas=/d/panc/_index/index.csv \\
        [--max-series-per-dataset 50]
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

from dinox_torch.data.index import load_index_rows, write_index_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sources", nargs="+", help="name=path/to/index.csv entries")
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--max-series-per-dataset", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    combined = []
    for spec in args.sources:
        if "=" not in spec:
            print(f"error: expected name=path, got {spec}", file=sys.stderr)
            return 2
        name, path = spec.split("=", 1)
        rows = load_index_rows(path)
        for r in rows:
            r.dataset = name
        if args.max_series_per_dataset:
            series = sorted({r.series_dir for r in rows})
            keep = set(rng.sample(series, min(args.max_series_per_dataset, len(series))))
            rows = [r for r in rows if r.series_dir in keep]
        print(f"{name}: {len(rows)} slices", flush=True)
        combined.extend(rows)

    write_index_rows(combined, args.out)
    print(f"{len(combined)} total slices -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
