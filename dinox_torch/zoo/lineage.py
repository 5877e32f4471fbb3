"""Training provenance: the commit the code ran from (the part of the JAX
package's ``zoo/lineage.py`` that the pretraining CLI needs)."""

from __future__ import annotations

import subprocess
from pathlib import Path


def get_git_commit(repo_path: str | Path | None = None) -> str:
    """``git rev-parse HEAD`` in *repo_path*, or "unknown" outside a git
    checkout or without git."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo_path, capture_output=True,
                             text=True, check=True)
        return out.stdout.strip()
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return "unknown"
