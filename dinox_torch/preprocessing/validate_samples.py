"""Visual QA of preprocessed slices: the twin of
``scripts/preprocessing/validate_samples.py``. Samples N slices from an
index, verifies decode + value statistics, and writes windowed 8-bit
previews (``write_png16`` on uint8) and ``qa_report.json``; exit code 1
if any sample is bad.

    python -m dinox_torch.preprocessing.validate_samples --index idx.csv \\
        --out qa/ --n 16
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dinox_torch.data.hu import decode_hu16, window
from dinox_torch.data.index import load_index_rows
from dinox_torch.data.pipeline import _read_png_u16
from dinox_torch.data.png16 import write_png16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    rng = np.random.default_rng(args.seed)
    pick = rng.choice(len(rows), min(args.n, len(rows)), replace=False)
    args.out.mkdir(parents=True, exist_ok=True)

    report = []
    bad = 0
    for i in pick:
        r = rows[int(i)]
        try:
            u16 = _read_png_u16(r.png_path)
            hu = decode_hu16(u16)  # deci-HU
            stats = {
                "png_path": r.png_path,
                "shape": list(u16.shape),
                "hu_deci_min": float(hu.min()),
                "hu_deci_max": float(hu.max()),
                "hu_deci_mean": float(hu.mean()),
                "nonconstant": bool(hu.std() > 1e-6),
                "in_encodable_range": bool(-110.0 <= hu.min() and hu.max() <= 410.0),
            }
            ok = stats["nonconstant"] and stats["in_encodable_range"]
            stats["ok"] = ok
            bad += not ok
            preview = (window(hu, 40.0, 400.0) * 255).astype(np.uint8)
            write_png16(args.out / f"{Path(r.png_path).parent.name}_{Path(r.png_path).name}", preview)
        except Exception as e:  # noqa: BLE001
            stats = {"png_path": r.png_path, "ok": False, "error": str(e)}
            bad += 1
        report.append(stats)

    (args.out / "qa_report.json").write_text(json.dumps(report, indent=2))
    print(f"checked {len(report)} samples, {bad} bad -> {args.out}/qa_report.json", flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
