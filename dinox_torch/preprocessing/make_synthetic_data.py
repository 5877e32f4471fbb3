"""Generate a synthetic HU16-PNG slice tree + index.csv (+ split manifest):
the twin of ``scripts/preprocessing/make_synthetic_data.py`` (the same
flags, volumes, files and index).

Each synthetic series is a smooth 3-D blob field with per-dataset intensity
statistics and per-series random spacing, written in the standard encoding
``uint16 = HU + 32768``.

    python -m dinox_torch.preprocessing.make_synthetic_data --out /tmp/synth \\
        --datasets dsa dsb --series-per-dataset 4 --slices-per-series 12
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dinox_torch.data.hu import encode_hu16
from dinox_torch.data.index import IndexRow, make_split_manifest, write_index_rows
from dinox_torch.data.png16 import write_png16
from dinox_torch.data.synthetic import (
    draw_spacing,
    scaled_profiles_v2,
    synth_series_np,
    synth_two_organ_series_np,
)


def synth_series(rng: np.random.Generator, n_slices: int, size: int, base_hu: float):
    """Smooth blobby volume in HU: random 3D gaussian bumps on a soft-tissue
    background, air outside a circular 'body'."""
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, n_slices), np.linspace(-1, 1, size), np.linspace(-1, 1, size),
        indexing="ij",
    )
    vol = np.full(zz.shape, base_hu, np.float32)
    for _ in range(6):
        c = rng.uniform(-0.6, 0.6, 3)
        w = rng.uniform(0.1, 0.4)
        amp = rng.uniform(-400, 900)
        vol += amp * np.exp(
            -(((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / (2 * w * w))
        ).astype(np.float32)
    body = (yy**2 + xx**2) < 0.81
    vol = np.where(body, vol, -1000.0)
    vol += rng.normal(0, 25, vol.shape).astype(np.float32)
    return np.clip(vol, -1000, 4000)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="dataset names. Names matching a v2 profile "
                        "(lidc_like, mayo_like, pancreas_like, cq500_like, "
                        "colon_like) use that profile's structural signature; "
                        "other names fall back to the legacy intensity-offset "
                        "generator. Default: dsa dsb (legacy) or the five v2 "
                        "profiles with --five-datasets.")
    p.add_argument("--five-datasets", action="store_true",
                   help="generate the five v2 CT-catalog-like profiles "
                        "(dinox_torch/data/synthetic.py) — the same "
                        "distribution the on-device staged generator "
                        "trains on, for same-domain eval sets")
    p.add_argument("--signature-strength", type=float, default=1.0,
                   help="scale the per-dataset v2 signatures around their "
                        "cross-profile common point (scaled_profiles_v2): "
                        "0 = indistinguishable datasets, 1 = v2 default, "
                        ">1 = grosser (more real-CT-like) signatures. Only "
                        "affects v2-profile dataset names.")
    p.add_argument("--series-per-dataset", type=int, default=4)
    p.add_argument("--slices-per-series", type=int, default=12)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val-fraction", type=float, default=0.25)
    args = p.parse_args(argv)

    profiles_by_name = {prof.name: prof for prof in scaled_profiles_v2(args.signature_strength)}
    if args.datasets is None:
        args.datasets = list(profiles_by_name) if args.five_datasets else ["dsa", "dsb"]

    rng = np.random.default_rng(args.seed)
    rows: list[IndexRow] = []
    for di, ds in enumerate(args.datasets):
        prof = profiles_by_name.get(ds)
        base_hu = -100.0 + 120.0 * di  # legacy: distinct intensity stats only
        for s in range(args.series_per_dataset):
            if ds in ("organa", "organb"):
                # same-domain twin of the device two-organ MVP generator
                vol, spacing = synth_two_organ_series_np(ds, rng, args.slices_per_series, args.size)
            elif prof is not None:
                spacing = draw_spacing(prof, rng)
                vol = synth_series_np(prof, rng, args.slices_per_series, args.size)
            else:
                spacing = (
                    float(rng.uniform(0.4, 1.0)),
                    float(rng.uniform(0.4, 1.0)),
                    float(rng.uniform(0.6, 5.0)),
                )
                vol = synth_series(rng, args.slices_per_series, args.size, base_hu)
            series_dir = f"{ds}/series{s:03d}"
            for z in range(args.slices_per_series):
                path = args.out / series_dir / f"{z:04d}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png16(path, encode_hu16(vol[z]))
                rows.append(IndexRow(
                    png_path=str(path), series_dir=series_dir, slice_index=z,
                    encoding="hu16", spacing_x=spacing[0], spacing_y=spacing[1],
                    spacing_z=spacing[2], dataset=ds,
                ))
    index_csv = args.out / "index.csv"
    write_index_rows(rows, index_csv)
    manifest = make_split_manifest(rows, val_fraction=args.val_fraction, seed=args.seed)
    (args.out / "split_manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"wrote {len(rows)} slices -> {index_csv}")
    print(f"split manifest: {len(manifest['val']['series_dir'])} val series")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
