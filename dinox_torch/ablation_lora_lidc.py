"""LoRA ablation scan on the LIDC malignancy benchmark: the twin of the
runbook ``scripts/ablation_lora_lidc.sh``, with its arguments, environment
and output lines.

Given a pretrained backbone, sweeps the adapter knobs that closed its AUROC
gap (rank, partial unfreezing, crop size) against a pinned-seed baseline,
one adapter directory per arm: each arm runs ``python -m
dinox_torch.finetune_lora``'s ``main`` in this process (on the card through
kernels 1 and 2/3), then prints the best validation AUROC of the arm's
``history.json``.

    python -m dinox_torch.ablation_lora_lidc <backbone> <train.csv> <val.csv> [arm]
    arm: all (default) | baseline | rank | unfreeze | crop128

``ADAPTER_BASE`` (default ``adapters/ablation-lidc``) and ``SEED`` (default
42) come from the environment. The CSVs come from ``python -m
dinox_torch.preprocessing.extract_lidc_malignancy`` (columns
image_path,label[,spacing_*]; patient-stratified splits). Exits 2 on too
few arguments or an unknown arm.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

from dinox_torch import finetune_lora

ARMS = {
    "baseline": ("baseline", ["--rank", "8"]),
    "rank": ("rank16", ["--rank", "16"]),
    "unfreeze": ("unfreeze2", ["--rank", "8", "--unfreeze-blocks", "2", "--backbone-lr", "1e-5"]),
    "crop128": ("crop128", ["--rank", "8", "--canvas", "128"]),
}


def common_args(backbone: str, train_csv: str, val_csv: str, seed: str) -> list[str]:
    """The flags every arm shares: the lung window in scaled deci-HU (level
    -300 HU, width 1200 HU), 50 epochs of bs 32, early stopping on AUROC."""
    return ["--backbone", backbone,
            "--train-csv", train_csv, "--val-csv", val_csv,
            "--task", "classification", "--num-classes", "2",
            "--window-level", "-30", "--window-width", "120",
            "--epochs", "50", "--batch-size", "32",
            "--es-metric", "auroc", "--es-patience", "10",
            "--warmup-steps", "100", "--seed", seed]


def best_auroc(out_dir: str | Path) -> float:
    """The largest validation AUROC of an arm's ``history.json`` (0 for an
    epoch without one)."""
    hist = json.loads((Path(out_dir) / "history.json").read_text())
    return max(h.get("auroc", 0.0) for h in hist)


def run_arm(common: list[str], base: str, name: str, extra: list[str]) -> int:
    print(f"==== arm: {name} ====", flush=True)
    out = f"{base}/{name}"
    rc = finetune_lora.main(common + ["--out", out] + extra)
    if rc:
        return rc
    print(f"{out}: best val AUROC = {best_auroc(out):.4f}", flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print("usage: python -m dinox_torch.ablation_lora_lidc <backbone> <train.csv> "
              "<val.csv> [arm]", file=sys.stderr)
        return 2
    backbone, train_csv, val_csv = argv[:3]
    arm = argv[3] if len(argv) > 3 else "all"
    if arm != "all" and arm not in ARMS:
        print(f"unknown arm: {arm}", file=sys.stderr)
        return 2
    base = os.environ.get("ADAPTER_BASE", "adapters/ablation-lidc")
    common = common_args(backbone, train_csv, val_csv, os.environ.get("SEED", "42"))
    for key in (ARMS if arm == "all" else [arm]):
        rc = run_arm(common, base, *ARMS[key])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
