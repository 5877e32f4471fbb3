"""DICOM series -> 16-bit HU PNG slice tree + index.csv: the twin of
``scripts/preprocessing/preprocess_dicom.py`` (the same flags and outputs),
on the port's DICOM reader and PNG writer.

HU clip [-1000, 4000]; storage ``uint16 = round(HU) + 32768``; z-sort by
ImagePositionPatient with median-delta z-spacing (more reliable than the
SliceThickness tag); RescaleSlope/Intercept applied; incremental
skip-if-exists; ``--dry-run`` writes a synthetic volume instead of reading
DICOM.

    python -m dinox_torch.preprocessing.preprocess_dicom --src /data/raw/LIDC \\
        --out data/processed/lidc --dataset lidc-idri
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

from dinox_torch.data.dicom import read_dicom
from dinox_torch.data.hu import HU_CLIP, encode_hu16
from dinox_torch.data.index import IndexRow, write_index_rows
from dinox_torch.data.png16 import write_png16


def find_series(src: Path) -> dict[str, list[Path]]:
    """Group .dcm files by SeriesInstanceUID (header-only reads)."""
    series: dict[str, list[Path]] = defaultdict(list)
    for f in sorted(src.rglob("*.dcm")):
        try:
            ds = read_dicom(f, stop_before_pixels=True)
        except Exception as e:  # noqa: BLE001
            print(f"skip {f}: {e}", file=sys.stderr)
            continue
        series[ds.series_uid or f.parent.name].append(f)
    return series


def process_series(uid: str, files: list[Path], out_root: Path, dataset: str,
                   rows: list[IndexRow]) -> None:
    slices = []
    for f in files:
        ds = read_dicom(f)
        slices.append((ds.image_position_z, ds))
    slices.sort(key=lambda t: t[0])

    # median z-delta beats the SliceThickness tag for spacing_z
    zs = [z for z, _ in slices]
    dz = float(np.median(np.abs(np.diff(zs)))) if len(zs) > 1 else slices[0][1].slice_thickness
    if dz <= 0:
        dz = slices[0][1].slice_thickness

    series_dir = out_root / dataset / uid.replace(".", "_")
    series_dir.mkdir(parents=True, exist_ok=True)
    for idx, (_z, ds) in enumerate(slices):
        png = series_dir / f"{idx:04d}.png"
        if not png.exists():
            write_png16(png, encode_hu16(np.clip(ds.hu(), *HU_CLIP)))
        sx, sy = ds.pixel_spacing
        rows.append(IndexRow(
            png_path=str(png), series_dir=str(series_dir.relative_to(out_root)),
            slice_index=idx, encoding="hu16",
            spacing_x=sx, spacing_y=sy, spacing_z=dz, dataset=dataset,
        ))


def synthetic_series(out_root: Path, dataset: str, rows: list[IndexRow], seed=0) -> None:
    rng = np.random.default_rng(seed)
    series_dir = out_root / dataset / "dryrun_series"
    series_dir.mkdir(parents=True, exist_ok=True)
    for idx in range(8):
        hu = np.clip(rng.normal(-100, 300, (64, 64)), *HU_CLIP)
        png = series_dir / f"{idx:04d}.png"
        write_png16(png, encode_hu16(hu))
        rows.append(IndexRow(
            png_path=str(png), series_dir=str(series_dir.relative_to(out_root)),
            slice_index=idx, encoding="hu16",
            spacing_x=0.7, spacing_y=0.7, spacing_z=1.0, dataset=dataset,
        ))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", type=Path, default=None, help="DICOM tree root")
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--dry-run", action="store_true", help="synthetic volume, no DICOM needed")
    p.add_argument("--max-series", type=int, default=None)
    args = p.parse_args(argv)

    rows: list[IndexRow] = []
    if args.dry_run:
        synthetic_series(args.out, args.dataset, rows)
    else:
        if args.src is None:
            print("error: --src required unless --dry-run", file=sys.stderr)
            return 2
        series = find_series(args.src)
        print(f"found {len(series)} series", flush=True)
        for i, (uid, files) in enumerate(sorted(series.items())):
            if args.max_series and i >= args.max_series:
                break
            process_series(uid, files, args.out, args.dataset, rows)
            print(f"[{i + 1}/{len(series)}] {uid}: {len(files)} slices", flush=True)

    index = args.out / "_index" / "index.csv"
    write_index_rows(rows, index)
    print(f"{len(rows)} slices -> {index}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
