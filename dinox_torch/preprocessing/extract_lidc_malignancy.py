"""Build the LIDC nodule-malignancy LoRA benchmark: the twin of
``scripts/preprocessing/extract_lidc_malignancy.py`` (the same flags,
crops, CSVs and splits). Clusters per-annotator nodule marks into physical
nodules, computes the multi-rater malignancy consensus, extracts
nodule-centred uint16 crops sized to the nodule (2x bbox, minimum
--crop; written with ``write_png16``), and writes label-stratified
patient-level train/val/test CSVs for ``python -m dinox_torch.finetune_lora``.

Annotation sources (``--annotations-format``):

* ``raw`` (default): CSV of per-annotator marks — one row per radiologist
  per nodule — with columns
  ``series_dir,patient_id,annotator,slice_index,center_x,center_y,malignancy[,width,height]``.
  Marks are clustered into nodules by 3-D proximity
  (:mod:`dinox_torch.data.lidc`) and aggregated: mean malignancy, rating
  std as rater agreement, >= --min-raters required.
* ``consensus``: legacy pre-aggregated CSV
  (``series_dir,slice_index,center_x,center_y,malignancy,patient_id``),
  one row per nodule; malignancy==3 rows are dropped (indeterminate).
* ``pylidc``: the pylidc annotation database. The port does not read it
  (it does not depend on pylidc): it raises, asking for the raw CSV.

Output CSVs carry the columns
``image_path,label,spacing_x,spacing_y,spacing_z,patient_id,avg_malignancy,n_raters,rater_agreement``.

    python -m dinox_torch.preprocessing.extract_lidc_malignancy \\
        --index idx.csv --annotations marks.csv --out data/malignancy \\
        --threshold 3.0 --min-raters 2 --crop 64
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

from dinox_torch.data.index import SeriesMap, load_index_rows
from dinox_torch.data.lidc import (
    NoduleConsensus,
    RawAnnotation,
    build_nodules,
    stratified_patient_split,
)
from dinox_torch.data.pipeline import _read_png_u16
from dinox_torch.data.png16 import write_png16

CSV_FIELDS = [
    "image_path", "label", "spacing_x", "spacing_y", "spacing_z",
    "patient_id", "avg_malignancy", "n_raters", "rater_agreement",
]


def _load_raw_annotations(path: Path) -> list[RawAnnotation]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [
        RawAnnotation(
            series_dir=r["series_dir"],
            patient_id=r.get("patient_id") or r["series_dir"],
            annotator=r.get("annotator", str(i)),
            slice_index=int(r["slice_index"]),
            center_x=float(r["center_x"]),
            center_y=float(r["center_y"]),
            malignancy=float(r["malignancy"]),
            width=float(r.get("width") or 8.0),
            height=float(r.get("height") or 8.0),
        )
        for i, r in enumerate(rows)
    ]


def _load_consensus_csv(path: Path) -> list[NoduleConsensus]:
    """Legacy pre-aggregated format: one row per nodule, single rating."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = []
    for r in rows:
        mal = float(r["malignancy"])
        if mal == 3:  # indeterminate — dropped (legacy behavior)
            continue
        cx, cy = float(r["center_x"]), float(r["center_y"])
        out.append(NoduleConsensus(
            series_dir=r["series_dir"],
            patient_id=r.get("patient_id") or r["series_dir"],
            slice_index=int(r["slice_index"]),
            center_x=cx, center_y=cy,
            avg_malignancy=mal, rater_agreement=0.0, n_raters=1,
            bbox=(int(cy - 4), int(cy + 4), int(cx - 4), int(cx + 4)),
        ))
    return out


def _load_pylidc(min_raters: int) -> list[NoduleConsensus]:
    raise NotImplementedError(
        "--annotations-format pylidc reads the pylidc database, which dinox_torch does not: "
        "export the per-annotator marks as the raw CSV (--annotations-format raw)")


def _adaptive_crop(img: np.ndarray, nod: NoduleConsensus, min_size: int) -> np.ndarray:
    """Nodule-centered crop at 2x the bbox extent, floored at min_size and
    clamped inside the slice (reference _save_nodule_crop:97-138)."""
    imin, imax, jmin, jmax = nod.bbox
    crop_h = max(2 * (imax - imin), min_size)
    crop_w = max(2 * (jmax - jmin), min_size)
    ci, cj = (imin + imax) // 2, (jmin + jmax) // 2
    h, w = img.shape
    i0 = max(0, min(ci - crop_h // 2, h - crop_h))
    j0 = max(0, min(cj - crop_w // 2, w - crop_w))
    return img[i0:i0 + min(crop_h, h), j0:j0 + min(crop_w, w)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--annotations", type=Path,
                   help="annotation CSV (not needed for --annotations-format pylidc)")
    p.add_argument("--annotations-format", default="raw",
                   choices=["raw", "consensus", "pylidc"])
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--threshold", type=float, default=3.0,
                   help="avg malignancy >= threshold -> label 1")
    p.add_argument("--min-raters", type=int, default=2)
    p.add_argument("--cluster-distance-mm", type=float, default=10.0)
    p.add_argument("--crop", type=int, default=64, help="minimum crop size (px)")
    p.add_argument("--whole-slice", action="store_true",
                   help="skip cropping; label whole slices")
    p.add_argument("--train-ratio", type=float, default=0.70)
    p.add_argument("--val-fraction", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    smap = SeriesMap.build(rows)

    if args.annotations_format == "pylidc":
        nodules = _load_pylidc(args.min_raters)
    elif args.annotations_format == "consensus":
        nodules = _load_consensus_csv(args.annotations)
    else:
        annos = _load_raw_annotations(args.annotations)
        # cluster in physical mm using the index's median spacing
        med = (
            float(np.median([r.spacing_x for r in rows])),
            float(np.median([r.spacing_y for r in rows])),
            float(np.median([r.spacing_z for r in rows])),
        )
        nodules = build_nodules(
            annos, spacing=med, distance_mm=args.cluster_distance_mm,
            min_raters=args.min_raters,
        )
    print(f"nodules after consensus: {len(nodules)}", flush=True)

    samples: list[dict] = []
    args.out.mkdir(parents=True, exist_ok=True)
    skipped = 0
    indeterminate = 0
    for i, nod in enumerate(nodules):
        row = smap.by_series.get(nod.series_dir, {}).get(nod.slice_index)
        if row is None:
            skipped += 1
            continue
        if nod.is_indeterminate(args.threshold):
            # consensus exactly at threshold (malignancy==3): dropped, same
            # as the consensus-CSV path above
            indeterminate += 1
            continue
        if args.whole_slice:
            image_path = row.png_path
        else:
            img = _read_png_u16(row.png_path)
            crop = _adaptive_crop(img, nod, args.crop)
            out_png = args.out / "crops" / f"nodule_{i:05d}.png"
            out_png.parent.mkdir(parents=True, exist_ok=True)
            write_png16(out_png, np.ascontiguousarray(crop))
            image_path = str(out_png)
        samples.append(dict(
            image_path=image_path,
            label=nod.label(args.threshold),
            spacing_x=row.spacing_x, spacing_y=row.spacing_y, spacing_z=row.spacing_z,
            patient_id=nod.patient_id,
            avg_malignancy=round(nod.avg_malignancy, 2),
            n_raters=nod.n_raters,
            rater_agreement=round(nod.rater_agreement, 2),
        ))
    if skipped:
        print(f"skipped {skipped} nodules without a matching index slice", flush=True)
    if indeterminate:
        print(f"dropped {indeterminate} indeterminate nodules (consensus == threshold)",
              flush=True)
    if not samples:
        print("no nodules matched the index", file=sys.stderr)
        return 1

    train, val, test = stratified_patient_split(
        samples,
        patient_of=lambda s: s["patient_id"],
        label_of=lambda s: s["label"],
        train_ratio=args.train_ratio,
        val_ratio=args.val_fraction,
        seed=args.seed,
    )
    for split, recs in (("train", train), ("val", val), ("test", test), ("all", samples)):
        with open(args.out / f"{split}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_FIELDS, extrasaction="ignore")
            w.writeheader()
            w.writerows(recs)
        pos = sum(r["label"] for r in recs)
        pats = len({r["patient_id"] for r in recs})
        print(f"{split}: {len(recs)} nodules ({pos} malignant) from {pats} patients",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
