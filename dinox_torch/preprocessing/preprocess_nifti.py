"""NIfTI volumes -> 16-bit HU PNG slice tree + index.csv: the twin of
``scripts/preprocessing/preprocess_nifti.py`` (the MSD-dataset path; the
same flags and outputs as preprocess_dicom, spacing from the NIfTI pixdim),
on the port's NIfTI reader and PNG writer.

    python -m dinox_torch.preprocessing.preprocess_nifti \\
        --src Task10_Colon/imagesTr --out data/processed/msd_colon \\
        --dataset msd-colon
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from dinox_torch.data.hu import HU_CLIP, encode_hu16
from dinox_torch.data.index import IndexRow, write_index_rows
from dinox_torch.data.nifti import read_nifti
from dinox_torch.data.png16 import write_png16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--max-volumes", type=int, default=None)
    args = p.parse_args(argv)

    vols = sorted(f for f in args.src.rglob("*.nii*") if not f.name.startswith("._"))
    if args.max_volumes:
        vols = vols[: args.max_volumes]
    print(f"found {len(vols)} volumes", flush=True)

    rows: list[IndexRow] = []
    for i, f in enumerate(vols):
        try:
            vol = read_nifti(f)
        except Exception as e:  # noqa: BLE001
            print(f"skip {f}: {e}", file=sys.stderr)
            continue
        stem = f.name.split(".")[0]
        series_dir = args.out / args.dataset / stem
        series_dir.mkdir(parents=True, exist_ok=True)
        sx, sy, sz = vol.spacing
        for z in range(vol.n_slices):
            png = series_dir / f"{z:04d}.png"
            if not png.exists():
                write_png16(png, encode_hu16(np.clip(vol.slice_hu(z), *HU_CLIP)))
            rows.append(IndexRow(
                png_path=str(png), series_dir=str(series_dir.relative_to(args.out)),
                slice_index=z, encoding="hu16",
                spacing_x=sx, spacing_y=sy, spacing_z=sz, dataset=args.dataset,
            ))
        print(f"[{i + 1}/{len(vols)}] {stem}: {vol.n_slices} slices", flush=True)

    index = args.out / "_index" / "index.csv"
    write_index_rows(rows, index)
    print(f"{len(rows)} slices -> {index}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
