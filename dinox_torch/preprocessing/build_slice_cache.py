"""Build the write-once decoded-slice memmap cache for an index tree
(:mod:`dinox_torch.data.slice_cache`; the same file the JAX package
builds): the twin of ``scripts/preprocessing/build_slice_cache.py``.

    python -m dinox_torch.preprocessing.build_slice_cache \\
        --index-csv data/synth_v2_train512/index.csv --canvas 512
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from dinox_torch.data.index import load_index_rows
from dinox_torch.data.slice_cache import build_slice_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index-csv", type=Path, required=True)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--force", action="store_true",
                   help="rebuild even if a cache is already present")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    rows = load_index_rows(args.index_csv)
    path = build_slice_cache(rows, args.canvas, args.index_csv.parent,
                             workers=args.workers, force=args.force)
    print(f"cache: {path} ({path.stat().st_size / 1e9:.2f} GB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
