"""Shared pieces of the benchmark's own tests: the benchmark's folder on
the import path, and a copy of the benchmark with tiny cells added as data
files (a configuration, two mixes, their cells and limits), run on the
CPU through the program's plain versions."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

TINY_MODEL = dict(dim=64, depth=2, heads=2, img_size=28, out_dim=256)
TINY_MIXES = {
    "pretrain.b128x2": dict(batch_size=4, accumulation_steps=2, canvas=64, trace_steps=1),
    "embed.series": dict(lengths=[3, 5, 7, 9], batch_size=4, canvas=64, check_requests=2, trace_requests=1),
}
# Limits of the tiny cells, from their readings on the CPU (seeds 1-3:
# program loss_koleo_gap 0.0003-0.0058, loss_gram_gap 0.0007-0.0012,
# update_gap 0.009-0.032, teacher_gap 0.0002-0.0005, emb_gap 0.009; the
# float8 control's loss_koleo_gap 0.020-0.051 and loss_gram_gap 0.035-0.051;
# the EMA left out reads teacher_gap 1), not the real cells'.
TINY_LIMITS = {"tiny.pretrain.b128x2": {"loss_koleo_gap": 0.01, "loss_gram_gap": 0.01, "update_gap": 0.08,
                                        "teacher_gap": 0.01},
               "tiny.embed.series": {"emb_gap": 0.03}}
TINY_SEED = 1


def add_tiny_cells(root: Path) -> None:
    """Add the tiny configuration, mixes, cells and limits to the benchmark at *root*."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/vit-s14-scale.json").read_text())
    config["name"] = "tiny"
    config["model"].update(TINY_MODEL)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for mix, sizes in TINY_MIXES.items():
        data = json.loads((root / f"benchmark/mixes/{mix}.json").read_text())
        data.update(sizes)
        (root / f"benchmark/mixes/tiny-{mix}.json").write_text(json.dumps(data))
        cell = f"tiny.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": f"tiny-{mix}", "chips": 1,
                                   "why": "test"})
        (root / f"benchmark/limits/{cell}.json").write_text(json.dumps(TINY_LIMITS[cell]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            kind = mix.split(".")[0]
            if "workloads" in m and any(f".{kind}." in w for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark (BENCHMARK.json and the benchmark folder) with the tiny cells."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_tiny_cells(tmp_path)
    return tmp_path


def run_copy(root: Path, *args: str, device: str = "cpu", timeout: float = 240) -> subprocess.CompletedProcess:
    """``python3 benchmark/run.py ARGS --device DEVICE`` in the copy at
    *root*, with the program importable."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "benchmark/run.py", *args, "--device", device], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
