"""The run-dir readers of the port (``compare_runs``, ``log_runs``,
``soak_seam_analysis``) against the JAX scripts, each loaded by path with
importlib, on the same files.

The soak-seam twin keeps one record per step (the last one logged); the JAX
script counts a re-logged step twice. The last test shows the difference on
a log with a re-logged leg."""

import csv
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from dinox_torch import compare_runs, log_runs, pretrain, soak_seam_analysis

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_cli", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_metrics(path, steps, seed, lr0=1e-4, extra_lines=()):
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for s in steps:
            f.write(json.dumps({"step": int(s), "loss": float(8.0 - 0.01 * s + rng.normal(0, 0.05)),
                                "lr": lr0 * min(1.0, s / 50), "samples_per_s": float(rng.uniform(90, 110)),
                                "embed_std": float(rng.uniform(0.1, 0.2))}) + "\n")
        for line in extra_lines:
            f.write(line + "\n")


def _run_both(capsys, port_main, jax_main, argv):
    assert port_main(argv) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    return port, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("key,tail", [("loss", 100), ("embed_std", 7)])
def test_compare_runs_equals_the_jax_script(tmp_path, capsys, key, tail):
    a, b = tmp_path / "a" / "metrics.jsonl", tmp_path / "b" / "metrics.jsonl"
    _write_metrics(a, range(1, 41), seed=1, extra_lines=["not json", '{"step": 41}'])
    _write_metrics(b, range(21, 61), seed=2)
    argv = [str(a), str(b), "--key", key, "--tail", str(tail), "--out", str(tmp_path / "cmp.json")]
    port, jax = _run_both(capsys, compare_runs.main, _load("compare_runs").main, argv)
    assert port == jax
    assert port["overlap_steps"] == 20 and port["first_step"] == 21 and port["last_step"] == 40
    assert json.loads((tmp_path / "cmp.json").read_text()) == jax


def _mk_run(runs, name, steps=3, loss=1.5):
    d = runs / name
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({
        "model": {"name": "vit-tiny", "scale_aware": True},
        "batch_size": 8, "accumulation_steps": 1, "lr": 1e-4, "max_steps": steps,
    }))
    _write_metrics(d / "metrics.jsonl", range(1, steps + 1), seed=steps)


def test_log_runs_equals_the_jax_script(tmp_path):
    jax_cli = _load("log_runs")
    runs = tmp_path / "runs"
    _mk_run(runs, "alpha")
    _mk_run(runs, "beta", steps=60)
    (runs / "not_a_run").mkdir()
    outs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}

    def regen():
        assert log_runs.main(["--runs-dir", str(runs), "--out-dir", str(outs["port"])]) == 0
        assert jax_cli.main(["--runs-dir", str(runs), "--out-dir", str(outs["jax"])]) == 0
        return {k: ((v / "experiments.csv").read_bytes(), (v / "EXPERIMENTS.md").read_text())
                for k, v in outs.items()}

    first = regen()
    assert first["port"] == first["jax"]

    # A note in the CSV and a hand-written tail in the markdown, in both dirs.
    for out in outs.values():
        rows = list(csv.DictReader(open(out / "experiments.csv")))
        for r in rows:
            if r["run"] == "alpha":
                r["notes"] = "the alpha note"
        with open(out / "experiments.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        md = (out / "EXPERIMENTS.md").read_text()
        (out / "EXPERIMENTS.md").write_text(md + "\n" + log_runs.MANUAL_MARK + "\nHistorical:\n\n| gone | run |\n")
    shutil.rmtree(runs / "alpha")  # the run dir is gone, its row stays
    _mk_run(runs, "gamma", loss=0.1)
    for _ in range(2):
        got = regen()
    assert got["port"] == got["jax"]
    md = got["port"][1]
    assert "the alpha note" in md and md.count(log_runs.MANUAL_MARK) == 1 and "| gone | run |" in md
    rows = {r["run"]: r for r in csv.DictReader(open(outs["port"] / "experiments.csv"))}
    assert set(rows) == {"alpha", "beta", "gamma"} and rows["alpha"]["notes"] == "the alpha note"
    assert rows["beta"]["steps_done"] == "60"


def test_log_runs_scrapes_a_run_dir_of_the_port(tmp_path):
    runs = tmp_path / "runs"
    assert pretrain.main(["--config", "vit-tiny", "--batch-size", "4", "--img-size", "56",
                          "--canvas", "64", "--warmup-steps", "1", "--scale-aware", "--log-json",
                          "--no-tensorboard", "--synthetic-device-batches", "1", "--max-steps", "2",
                          "--ckpt-every", "0", "--run-dir", str(runs / "tiny"), "--device", "cpu"]) == 0
    out = tmp_path / "docs"
    assert log_runs.main(["--runs-dir", str(runs), "--out-dir", str(out)]) == 0
    jax_out = tmp_path / "jax_docs"
    assert _load("log_runs").main(["--runs-dir", str(runs), "--out-dir", str(jax_out)]) == 0
    assert (out / "experiments.csv").read_bytes() == (jax_out / "experiments.csv").read_bytes()
    (row,) = csv.DictReader(open(out / "experiments.csv"))
    assert row["run"] == "tiny" and row["model"] == "vit-tiny" and row["scale_aware"] == "True"
    assert row["batch"] == "4" and row["accum"] == "1" and row["max_steps"] == "2"
    assert row["steps_done"] == "2" and np.isfinite(float(row["final_loss"]))


def _soak(capsys, run, seams, jax_run=None):
    argv = ["--run", str(run), "--seams", *map(str, seams), "--k", "5"]
    assert soak_seam_analysis.main(argv) == 0
    port = json.loads(capsys.readouterr().out)
    jax_argv = ["--run", str(jax_run or run), "--seams", *map(str, seams), "--k", "5"]
    assert _load("soak_seam_analysis").main(jax_argv) == 0
    return port, json.loads(capsys.readouterr().out)


def test_soak_seam_analysis_equals_the_jax_script_on_a_clean_log(tmp_path, capsys):
    _write_metrics(tmp_path / "run" / "metrics.jsonl", range(1, 121), seed=3)
    port, jax = _soak(capsys, tmp_path / "run", [60, 118, 500])
    assert port.pop("n_duplicates_dropped") == 0
    assert port == jax
    assert [s.get("status") for s in port["seams"]] == [None, None, "missing data"]


def test_soak_seam_analysis_counts_a_relogged_step_once(tmp_path, capsys):
    # Leg 1 logs steps 1-80, then a leg resumed from the step-70 checkpoint
    # logs 71-120 again: steps 71-80 appear twice, the second time with
    # other losses (another data order).
    leg1, leg2 = tmp_path / "leg1.jsonl", tmp_path / "leg2.jsonl"
    _write_metrics(leg1, range(1, 81), seed=4)
    _write_metrics(leg2, range(71, 121), seed=5, lr0=1e-4)
    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text(leg1.read_text() + leg2.read_text())
    # The deduped file: the last record of each step.
    dedup = tmp_path / "dedup"
    dedup.mkdir()
    last = {json.loads(l)["step"]: l for l in (run / "metrics.jsonl").read_text().splitlines()}
    (dedup / "metrics.jsonl").write_text("\n".join(last[s] for s in sorted(last)) + "\n")

    port, jax_dedup = _soak(capsys, run, [70, 80], jax_run=dedup)
    assert port.pop("n_duplicates_dropped") == 10
    assert port == jax_dedup
    _, jax_raw = _soak(capsys, run, [70, 80])
    assert jax_raw["n_logged"] == 130 and port["n_logged"] == 120
    assert jax_raw["seams"] != port["seams"]
