"""Finding a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics. The files of one name sit apart:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``mixes/<traffic>.json``, whose ``kind`` names the general
  driver in ``harness/drivers/<kind>.py`` that reads it;
- a per-layer metric: its reader, ``metrics/<name>.py``, with a function
  ``read(run)`` that returns the value or None;
- a cell's correctness limits: ``limits/<cell>.json``.

So a new configuration, mix, metric or cell is new files and entries, and
no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict[str, Any]
    mix: dict[str, Any]
    end_to_end: list[dict[str, Any]]
    per_layer: list[dict[str, Any]]
    limits: Optional[dict[str, Any]] = None
    entry: dict[str, Any] = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell *name* of ``BENCHMARK.json`` with its configuration, mix,
    metrics and (if there) limits. Raises KeyError for an unknown name."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None
    return Cell(name, int(entry["chips"]), config, mix, e2e, per_layer, limits, entry)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``metrics/<name>.py`` (its ``read(run)`` gives the value)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
