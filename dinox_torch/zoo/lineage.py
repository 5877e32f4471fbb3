"""Training lineage and provenance records: the port's copy of
``dinox_tpu.zoo.lineage``. A ``lineage.json`` written by either package
loads in the other."""

from __future__ import annotations

import hashlib
import json
import logging
import subprocess
from pathlib import Path

from dinox_torch.zoo.schemas import DatasetUsage, SpacingStats, TrainingLineage

log = logging.getLogger(__name__)

TOOL_VERSION = "dinox-torch-zoo-0.1.0"


def compute_catalog_hash(catalog_dir: str | Path) -> str:
    """sha256 over the sorted YAML files of a catalog dir, truncated to 16
    hex chars; "unknown" if the dir is missing."""
    root = Path(catalog_dir)
    if not root.is_dir():
        return "unknown"
    digest = hashlib.sha256()
    for f in sorted(root.glob("*.yaml")):
        digest.update(f.read_bytes())
    return digest.hexdigest()[:16]


def get_git_commit(repo_path: str | Path | None = None) -> str:
    """``git rev-parse HEAD`` in *repo_path*, or "unknown" outside a git
    checkout or without git."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo_path, capture_output=True,
                             text=True, check=True)
        return out.stdout.strip()
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return "unknown"


def record_lineage(
    *,
    model_name: str,
    architecture: str,
    modality: str,
    datasets: list[DatasetUsage],
    spacing_stats: SpacingStats,
    scale_aware: bool = False,
    training_config: dict | None = None,
    random_seed: int = 42,
    catalog_dir: str | Path | None = None,
    training_code_dir: str | Path | None = None,
    output_path: str | Path | None = None,
) -> TrainingLineage:
    """Assemble a TrainingLineage record and optionally write lineage.json."""
    lineage = TrainingLineage(
        model_name=model_name,
        architecture=architecture,
        modality=modality,
        datasets=datasets,
        total_slices=sum(d.slices_used for d in datasets),
        spacing_stats=spacing_stats,
        scale_aware=scale_aware,
        training_config=training_config or {},
        random_seed=random_seed,
        tool_version=TOOL_VERSION,
        training_code_commit=get_git_commit(training_code_dir),
        data_catalog_hash="unknown" if catalog_dir is None else compute_catalog_hash(catalog_dir),
    )
    if output_path is not None:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(lineage.model_dump_json(indent=2))
        log.info("lineage -> %s", out)
    return lineage


def load_lineage(path: str | Path) -> TrainingLineage:
    return TrainingLineage.model_validate(json.loads(Path(path).read_text()))
