"""Backfill spacing columns into an existing index.csv by reading ONE DICOM
header per series (the ``stop_before_pixels`` fast path): the twin of
``scripts/preprocessing/extract_dicom_spacing.py``.

    python -m dinox_torch.preprocessing.extract_dicom_spacing \\
        --index data/index.csv --dicom-root /data/raw --out index_with_spacing.csv
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dinox_torch.data.dicom import read_dicom
from dinox_torch.data.index import load_index_rows, write_index_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--dicom-root", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    cache: dict[str, tuple[float, float, float]] = {}
    missing = 0
    for r in rows:
        if r.series_dir not in cache:
            dcm_dir = args.dicom_root / r.series_dir
            dcms = sorted(dcm_dir.glob("*.dcm")) if dcm_dir.is_dir() else []
            if not dcms:
                cache[r.series_dir] = (1.0, 1.0, 1.0)
                missing += 1
            else:
                ds = read_dicom(dcms[0], stop_before_pixels=True)
                sx, sy = ds.pixel_spacing
                cache[r.series_dir] = (sx, sy, ds.slice_thickness)
        r.spacing_x, r.spacing_y, r.spacing_z = cache[r.series_dir]

    write_index_rows(rows, args.out)
    print(f"{len(rows)} rows -> {args.out} "
          f"({len(cache) - missing}/{len(cache)} series resolved)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
