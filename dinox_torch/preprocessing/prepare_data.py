"""End-to-end data preparation in one command: per-dataset preprocess ->
Parquet manifest -> combined index -> split manifest -> QA samples. The
twin of ``scripts/preprocessing/prepare_data.py``, which runs its sibling
scripts; this one runs the port's CLIs (``dinox_torch.preprocessing.*``)
through their ``main(argv)`` in this process.

    python -m dinox_torch.preprocessing.prepare_data --out data/processed \\
        --dicom lidc=/raw/LIDC --nifti colon=/raw/Task10/imagesTr \\
        [--dry-run]
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path


def run(name: str, *args) -> None:
    """``python -m dinox_torch.preprocessing.<name> args`` in this process."""
    argv = list(map(str, args))
    print("+", sys.executable, "-m", f"dinox_torch.preprocessing.{name}", *argv, flush=True)
    rc = importlib.import_module(f"dinox_torch.preprocessing.{name}").main(argv)
    if rc != 0:
        raise RuntimeError(f"dinox_torch.preprocessing.{name} exited {rc}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--dicom", nargs="*", default=[], help="name=src pairs")
    p.add_argument("--nifti", nargs="*", default=[], help="name=src pairs")
    p.add_argument("--dry-run", action="store_true",
                   help="synthetic volumes instead of real sources")
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    sources = [("dicom", s) for s in args.dicom] + [("nifti", s) for s in args.nifti]
    if args.dry_run and not sources:
        sources = [("dicom", "dryrun_a="), ("dicom", "dryrun_b=")]
    if not sources:
        print("error: no sources (use --dicom/--nifti name=path or --dry-run)",
              file=sys.stderr)
        return 2

    index_specs = []
    for kind, spec in sources:
        name, _, src = spec.partition("=")
        ds_out = args.out / name
        if kind == "dicom":
            cmd_args = ["--out", ds_out, "--dataset", name]
            if args.dry_run or not src:
                cmd_args.append("--dry-run")
            else:
                cmd_args += ["--src", src]
            run("preprocess_dicom", *cmd_args)
        else:
            run("preprocess_nifti", "--src", src, "--out", ds_out, "--dataset", name)
        index_specs.append(f"{name}={ds_out / '_index' / 'index.csv'}")
        run("write_dataset_manifest", "--index", ds_out / "_index" / "index.csv",
            "--dataset", name, "--out", args.out / "manifests" / f"{name}.parquet")

    combined = args.out / "_index" / "index.csv"
    combined.parent.mkdir(parents=True, exist_ok=True)
    run("combine_indices", *index_specs, "--out", combined)
    run("make_split_manifest", "--index", combined,
        "--out", args.out / "split_manifest.json",
        "--val-fraction", args.val_fraction, "--seed", args.seed)
    run("validate_samples", "--index", combined, "--out", args.out / "qa", "--n", "8")
    print(f"data ready: {combined}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
