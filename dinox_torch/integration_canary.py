"""Infrastructure canary: prove the trainer is deterministic, resumable and
sampling correctly before burning real compute. The twin of
``scripts/integration_canary.py``: the same three gates, tolerance and
trainer flags, plus ``--device`` (default ``cuda``), passed to the trainer.

Runs the port's trainer (``python -m dinox_torch.pretrain``) as a
subprocess on ViT-Tiny over a synthetic slice tree
(``python -m dinox_torch.preprocessing.make_synthetic_data``):

  [1] determinism: two identically-seeded runs must match per-step losses
      (gate: max rel diff <= --tol)
  [2] resume fidelity: 2N steps straight vs N + resume + N: continuity,
      no NaN, and final-loss agreement
  [3] sampling audit: the merged index composition matches T=2.0
      temperature weights, and the trainer trains on it

Writes the report where ``--report`` says (canary_report.json in the
working directory by default); exit 0 iff all gates pass.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from dinox_torch.data.index import load_index_rows, write_index_rows
from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.merge import DatasetMerger, temperature_weights
from dinox_torch.zoo.schemas import SliceMetadata

REPO = Path(__file__).resolve().parent.parent


def run_trainer(run_dir: Path, index_csv: Path, steps: int, seed: int, device: str,
                resume: str | None = None, horizon: int | None = None) -> list[dict]:
    cmd = [
        sys.executable, "-m", "dinox_torch.pretrain",
        "--config", "vit-tiny", "--index-csv", str(index_csv),
        "--run-dir", str(run_dir),
        "--max-steps", str(horizon if horizon is not None else steps),
        "--stop-after", str(steps),
        "--batch-size", "4", "--img-size", "56", "--canvas", "64",
        "--warmup-steps", "2", "--lr", "5e-4", "--seed", str(seed),
        "--scale-aware", "--log-json", "--no-tensorboard",
        "--ckpt-every", "5", "--num-workers", "2", "--attn-impl", "xla",
        "--device", device,
    ]
    if resume:
        cmd += ["--resume", resume]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], file=sys.stderr)
        print(proc.stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"trainer failed rc={proc.returncode}")
    metrics_path = run_dir / "metrics.jsonl"
    return [json.loads(line) for line in metrics_path.read_text().splitlines()]


def gate_determinism(work: Path, index_csv: Path, steps: int, tol: float, device: str) -> dict:
    a = run_trainer(work / "det_a", index_csv, steps, seed=7, device=device)
    b = run_trainer(work / "det_b", index_csv, steps, seed=7, device=device)
    la = np.asarray([m["loss"] for m in a])
    lb = np.asarray([m["loss"] for m in b])
    rel = np.abs(la - lb) / np.maximum(np.abs(la), 1e-9)
    out = {
        "steps": len(la),
        "max_rel_diff": float(rel.max()),
        "tolerance": tol,
        "passed": bool(len(la) == steps and rel.max() <= tol),
    }
    print(f"[1] determinism: max_rel_diff={out['max_rel_diff']:.2e} "
          f"{'PASS' if out['passed'] else 'FAIL'}", flush=True)
    return out


def gate_resume(work: Path, index_csv: Path, steps: int, tol: float, device: str) -> dict:
    straight = run_trainer(work / "resume_straight", index_csv, 2 * steps, seed=11, device=device)
    # part 1 stops early but keeps the FULL schedule horizon, so the cosine
    # decay matches the straight run; part 2 resumes to the end.
    run_trainer(work / "resume_split", index_csv, steps, seed=11, device=device, horizon=2 * steps)
    part2 = run_trainer(
        work / "resume_split", index_csv, 2 * steps, seed=11, device=device,
        resume=str(work / "resume_split"),
    )
    # metrics.jsonl is append-mode, so after the resumed run the split dir's
    # file holds both halves; key by optimizer step (last write wins).
    by_step = {int(m["step"]): m["loss"] for m in part2}
    ls = np.asarray([m["loss"] for m in straight])
    lr = np.asarray([by_step[s] for s in sorted(by_step)])
    n = min(len(ls), len(lr))
    rel = np.abs(ls[:n] - lr[:n]) / np.maximum(np.abs(ls[:n]), 1e-9)
    out = {
        "steps_straight": len(ls),
        "steps_resumed": len(lr),
        "max_rel_diff": float(rel.max()),
        "any_nan": bool(np.isnan(lr).any() or np.isnan(ls).any()),
        "tolerance": tol,
        "passed": bool(
            len(lr) >= len(ls) and rel.max() <= tol and not np.isnan(lr).any()
        ),
    }
    print(f"[2] resume: max_rel_diff={out['max_rel_diff']:.2e} "
          f"{'PASS' if out['passed'] else 'FAIL'}", flush=True)
    return out


def make_synthetic(out: Path, *args: str) -> None:
    subprocess.run([sys.executable, "-m", "dinox_torch.preprocessing.make_synthetic_data",
                    "--out", str(out), *args], check=True, cwd=REPO, capture_output=True)


def gate_sampling(work: Path, steps: int, device: str, tol: float = 0.02) -> dict:
    """End-to-end sampling audit: build a merged index FILE from imbalanced
    on-disk datasets via DatasetMerger (T=2.0), audit the composition of the
    *written artifact* (not the in-process objects) against the temperature
    weights, then smoke-train the real trainer on that file as a
    subprocess."""
    # Imbalanced on-disk datasets (series x 8 slices): the 96-slice quota
    # forces dsb to subsample and dsc to oversample with replacement, so the
    # audit exercises both draw paths.
    sizes = {"dsa": 12, "dsb": 4, "dsc": 2}
    samp = work / "samp"
    merger = DatasetMerger()
    rows_by_path = {}
    for ds, n_series in sizes.items():
        make_synthetic(samp / ds, "--datasets", ds, "--series-per-dataset", str(n_series),
                       "--slices-per-series", "8", "--size", "64")
        rows = load_index_rows(samp / ds / "index.csv")
        rows_by_path.update({r.png_path: r for r in rows})
        merger.add(DataManifest([
            SliceMetadata(dataset=ds, series_id=r.series_dir,
                          slice_idx=r.slice_index,
                          pixel_spacing_x=r.spacing_x,
                          pixel_spacing_y=r.spacing_y,
                          slice_thickness=r.spacing_z,
                          image_path=r.png_path)
            for r in rows
        ]))

    total = 96
    merged, _usage = merger.build(seed=3, total_slices=total,
                                  strategy="temperature")
    merged_csv = samp / "merged_index.csv"
    write_index_rows([rows_by_path[rec.image_path] for rec in merged.records],
                     merged_csv)

    # audit the WRITTEN index file
    audit_rows = load_index_rows(merged_csv)
    counts = {ds: 0 for ds in sizes}
    for r in audit_rows:
        counts[r.dataset] += 1
    want = temperature_weights([n * 8 for n in sizes.values()], 2.0)
    got = [counts[ds] / len(audit_rows) for ds in sizes]
    err = max(abs(w - g) for w, g in zip(want, got))

    # smoke-train the real trainer on the merged artifact
    smoke_ok, smoke_error = False, None
    try:
        metrics = run_trainer(samp / "smoke", merged_csv, steps, seed=5, device=device)
        losses = np.asarray([m["loss"] for m in metrics])
        smoke_ok = bool(len(losses) == steps and np.isfinite(losses).all())
    except RuntimeError as e:
        smoke_error = str(e)

    out = {
        "target_weights": dict(zip(sizes, [round(w, 4) for w in want])),
        "observed_fractions": dict(zip(sizes, [round(g, 4) for g in got])),
        "max_abs_err": err,
        "total_written": len(audit_rows),
        "smoke_train_ok": smoke_ok,
        "smoke_train_error": smoke_error,
        "passed": bool(err <= tol and len(audit_rows) == total and smoke_ok),
    }
    print(f"[3] sampling: max_abs_err={err:.4f} smoke_train={'ok' if smoke_ok else 'FAIL'} "
          f"{'PASS' if out['passed'] else 'FAIL'}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--tol", type=float, default=1e-5,
                   help="relative loss tolerance (bit-determinism expected)")
    p.add_argument("--workdir", type=Path, default=None)
    p.add_argument("--report", type=Path, default=Path("canary_report.json"))
    p.add_argument("--device", default="cuda",
                   help="the trainer's torch device (default cuda; 'cpu' for the plain versions)")
    args = p.parse_args(argv)

    work = args.workdir or Path(tempfile.mkdtemp(prefix="dinox_canary_"))
    work.mkdir(parents=True, exist_ok=True)

    # synthetic data substrate
    make_synthetic(work / "data", "--series-per-dataset", "3", "--slices-per-series", "8",
                   "--size", "64")
    index_csv = work / "data" / "index.csv"

    report = {
        "determinism": gate_determinism(work, index_csv, args.steps, args.tol, args.device),
        "resume_fidelity": gate_resume(work, index_csv, args.steps, args.tol, args.device),
        "sampling_distribution": gate_sampling(work, args.steps, args.device),
    }
    report["all_passed"] = all(g["passed"] for g in report.values())
    args.report.write_text(json.dumps(report, indent=2))
    print(f"report -> {args.report} all_passed={report['all_passed']}", flush=True)
    return 0 if report["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
