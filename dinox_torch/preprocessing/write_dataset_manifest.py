"""Convert an index.csv into a Parquet DataManifest, the provenance layer's
entry point for merge and lineage tooling: the twin of
``scripts/preprocessing/write_dataset_manifest.py``, on the port's own
Parquet writer.

    python -m dinox_torch.preprocessing.write_dataset_manifest --index idx.csv \\
        --dataset lidc-idri --out manifests/lidc.parquet [--organs lung]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dinox_torch.data.index import load_index_rows
from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.schemas import SliceMetadata


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--organs", nargs="*", default=[])
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    manifest = DataManifest(
        [
            SliceMetadata(
                dataset=args.dataset,
                series_id=r.series_dir,
                slice_idx=r.slice_index,
                pixel_spacing_x=r.spacing_x,
                pixel_spacing_y=r.spacing_y,
                slice_thickness=r.spacing_z,
                image_path=r.png_path,
                organs_present=list(args.organs),
            )
            for r in rows
        ]
    )
    manifest.save(args.out)
    stats = manifest.spacing_stats()
    print(f"{len(manifest)} records -> {args.out} "
          f"(spacing_x {stats.pixel_spacing_x_min:.3f}-{stats.pixel_spacing_x_max:.3f} mm)",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
