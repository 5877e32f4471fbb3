"""Resume-seam continuity analysis of a chained-restart run: the twin of
``scripts/soak_seam_analysis.py``, with the same flags and JSON keys plus
``n_duplicates_dropped``.

Reads a run's ``metrics.jsonl`` and, for each declared seam step, compares
the last K logged losses before the seam with the first K after it, and the
lr on both sides. A seam is clean when the loss jump ratio is ~1 within the
trailing noise and the lr continues the same schedule (a per-leg
``--max-steps`` breaks the schedule).

One difference from the JAX script: a step logged more than once counts
once, with its last record. A leg that resumes from a checkpoint older than
its predecessor's last logged step logs those steps again; the JAX script
keeps both copies, so they weigh twice in the means and in the trailing
stdev. ``n_duplicates_dropped`` says how many records were dropped.

    python -m dinox_torch.soak_seam_analysis --run data/runs/soak_30k \\
        --seams 10000 20000 --out docs/soak_analysis.json
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path


def load_records(run: Path) -> tuple[list[dict], int]:
    """The records of ``run/metrics.jsonl`` that hold a loss and a step, one
    per step (the last one logged), in step order; and how many earlier
    records of a step were dropped."""
    by_step: dict[int, dict] = {}
    n = 0
    for line in (run / "metrics.jsonl").read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "loss" in r and "step" in r:
            by_step[int(r["step"])] = r
            n += 1
    return [by_step[s] for s in sorted(by_step)], n - len(by_step)


def analyze(run: Path, seams: list[int], k: int = 5) -> dict:
    recs, dropped = load_records(run)
    losses = [(int(r["step"]), float(r["loss"])) for r in recs]
    lrs = [(int(r["step"]), float(r["lr"])) for r in recs if "lr" in r]

    out: dict = {"n_logged": len(recs), "n_duplicates_dropped": dropped, "seams": []}
    for seam in seams:
        before = [l for s, l in losses if s <= seam][-k:]
        after = [l for s, l in losses if s > seam][:k]
        if not before or not after:
            out["seams"].append({"step": seam, "status": "missing data"})
            continue
        mb, ma = statistics.mean(before), statistics.mean(after)
        # trailing noise scale: stdev of the 50 losses before the seam, so
        # the jump is judged against the run's own converged jitter
        trail = [l for s, l in losses if s <= seam][-50:]
        noise = statistics.stdev(trail) if len(trail) > 1 else 0.0
        lr_b = [v for s, v in lrs if s <= seam][-1:]
        lr_a = [v for s, v in lrs if s > seam][:1]
        row = {
            "step": seam,
            "mean_loss_before": round(mb, 5),
            "mean_loss_after": round(ma, 5),
            "jump_ratio": round(ma / max(mb, 1e-9), 4),
            "jump_in_noise_units": round((ma - mb) / max(noise, 1e-9), 2),
            "trailing_noise_std": round(noise, 5),
        }
        if lr_b and lr_a:
            row["lr_before"] = lr_b[0]
            row["lr_after"] = lr_a[0]
            row["lr_ratio"] = round(lr_a[0] / max(lr_b[0], 1e-12), 4)
        out["seams"].append(row)
    if losses:
        out["final_step"], out["final_loss"] = losses[-1]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", type=Path, required=True)
    p.add_argument("--seams", type=int, nargs="+", default=[10000, 20000])
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    text = json.dumps(analyze(args.run, args.seams, args.k), indent=2)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
