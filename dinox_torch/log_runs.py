"""Scrape run directories into an experiment ledger: the twin of
``scripts/log_runs.py``, with the same flags, columns and files.
``RUNS/*/config.json`` + ``metrics.jsonl`` (as ``python -m
dinox_torch.pretrain`` writes them) -> ``OUT/experiments.csv`` and
``OUT/EXPERIMENTS.md``. The notes column of runs already in the CSV, the
rows of run dirs that are gone and the text below the ``<!-- manual -->``
line of the markdown survive a regeneration. Host work only.

    python -m dinox_torch.log_runs --runs-dir data/runs --out-dir docs
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

FIELDS = ["run", "model", "scale_aware", "batch", "accum", "lr", "max_steps",
          "steps_done", "final_loss", "samples_per_s", "notes"]
MANUAL_MARK = "<!-- manual -->"


def scrape_run(run: Path) -> dict | None:
    """One ledger row from a run dir, or None without ``config.json``: the
    last logged step and loss, and the mean samples/s of the last 50 rows."""
    cfg_path = run / "config.json"
    if not cfg_path.exists():
        return None
    cfg = json.loads(cfg_path.read_text())
    model = cfg.get("model", {})
    rec = {
        "run": run.name,
        "model": model.get("name", "?"),
        "scale_aware": model.get("scale_aware", False),
        "batch": cfg.get("batch_size"),
        "accum": cfg.get("accumulation_steps"),
        "lr": cfg.get("lr"),
        "max_steps": cfg.get("max_steps"),
        "steps_done": "",
        "final_loss": "",
        "samples_per_s": "",
        "notes": "",
    }
    metrics = run / "metrics.jsonl"
    if metrics.exists():
        lines = metrics.read_text().splitlines()
        if lines:
            last = json.loads(lines[-1])
            rec["steps_done"] = last.get("step")
            rec["final_loss"] = round(last.get("loss", float("nan")), 4)
            rates = [json.loads(ln).get("samples_per_s") for ln in lines[-50:]]
            rates = [r for r in rates if r]
            if rates:
                rec["samples_per_s"] = round(sum(rates) / len(rates), 1)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs-dir", type=Path, default=Path("data/runs"))
    p.add_argument("--out-dir", type=Path, default=Path("docs"))
    args = p.parse_args(argv)

    csv_path = args.out_dir / "experiments.csv"
    existing_rows: dict[str, dict] = {}
    if csv_path.exists():
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                existing_rows[row["run"]] = row

    runs = sorted(d for d in args.runs_dir.iterdir() if d.is_dir()) \
        if args.runs_dir.is_dir() else []
    records = []
    seen = set()
    for run in runs:
        rec = scrape_run(run)
        if rec:
            rec["notes"] = existing_rows.get(rec["run"], {}).get("notes", "")
            records.append(rec)
            seen.add(rec["run"])
    # Rows of runs whose dirs were cleaned from disk survive verbatim: the
    # ledger is the record of finished experiments, the run dirs are scratch.
    records += [row for name, row in existing_rows.items() if name not in seen]
    records.sort(key=lambda r: str(r["run"]))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(records)

    # Hand-written content below the MANUAL_MARK line survives regeneration verbatim.
    md_path = args.out_dir / "EXPERIMENTS.md"
    manual_tail = ""
    if md_path.exists():
        prev = md_path.read_text()
        if MANUAL_MARK in prev:
            manual_tail = prev[prev.index(MANUAL_MARK):]

    md = ["| " + " | ".join(FIELDS) + " |", "|" + "---|" * len(FIELDS)]
    md += ["| " + " | ".join(str(r[k]) for k in FIELDS) + " |" for r in records]
    md_path.write_text(
        "# Experiment ledger\n\nAuto-generated by scripts/log_runs.py — edit only "
        "the notes column (preserved across regenerations) and anything below "
        "the manual-marker line.\n\n" + "\n".join(md) + "\n"
        + ("\n" + manual_tail if manual_tail else "")
    )
    print(f"{len(records)} runs -> {csv_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
