"""Training index: CSV rows, split manifests, z-stride, per-host sharding.

The port's copy of ``dinox_tpu.data.index`` (pure Python): the same rows,
CSV columns, series-level split manifests, z-stride subsampling, strided
per-host shards and the clamped 2.5D neighbour lookup.
"""

from __future__ import annotations

import csv
import json
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class IndexRow:
    png_path: str
    series_dir: str
    slice_index: int
    encoding: str = "hu16"
    spacing_x: float = 1.0
    spacing_y: float = 1.0
    spacing_z: float = 1.0
    dataset: str = ""


_SPACING_COLS = ("spacing_x", "spacing_y", "spacing_z")


def load_index_rows(index_csv: str | Path, require_spacing: bool = False) -> list[IndexRow]:
    """Read an index CSV (png_path, series_dir, slice_index, encoding
    [, spacing_x, spacing_y, spacing_z][, dataset]).

    Missing spacing columns default to 1.0 with a warning when
    *require_spacing* (i.e. scale-aware training) is set — matching the
    reference's behavior (scripts/phase5_big_run.py:446-452).
    """
    rows: list[IndexRow] = []
    with open(index_csv, newline="") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        with_spacing = all(c in cols for c in _SPACING_COLS)
        with_dataset = "dataset" in cols
        if require_spacing and not with_spacing:
            warnings.warn(
                f"scale-aware training requested but {index_csv} has no spacing columns; "
                "defaulting to (1.0, 1.0, 1.0) — no real scale awareness will be learned."
            )
        for rec in reader:
            row = IndexRow(
                png_path=rec["png_path"],
                series_dir=rec["series_dir"],
                slice_index=int(rec["slice_index"]),
                encoding=rec.get("encoding", "hu16"),
            )
            if with_spacing:
                row.spacing_x = float(rec["spacing_x"])
                row.spacing_y = float(rec["spacing_y"])
                row.spacing_z = float(rec["spacing_z"])
            if with_dataset:
                row.dataset = rec["dataset"]
            rows.append(row)
    return rows


def write_index_rows(rows: list[IndexRow], index_csv: str | Path) -> None:
    """Inverse of :func:`load_index_rows` (always writes all columns)."""
    path = Path(index_csv)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["png_path", "series_dir", "slice_index", "encoding", *_SPACING_COLS, "dataset"])
        for r in rows:
            w.writerow(
                [r.png_path, r.series_dir, r.slice_index, r.encoding,
                 r.spacing_x, r.spacing_y, r.spacing_z, r.dataset]
            )


# -- split manifests (series granularity, no slice leakage) -----------------


def make_split_manifest(
    rows: list[IndexRow], val_fraction: float = 0.1, seed: int = 0
) -> dict:
    """Deterministic train/val split at series_dir granularity
    (reference: scripts/preprocessing/phase4_make_split_manifest.py)."""
    import random

    series = sorted({r.series_dir for r in rows})
    rng = random.Random(seed)
    rng.shuffle(series)
    n_val = max(1, int(len(series) * val_fraction)) if series else 0
    return {"val": {"series_dir": series[:n_val]}, "seed": seed, "val_fraction": val_fraction}


def load_split_manifest(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def val_series_set(manifest: dict) -> set[str]:
    return {str(s) for s in manifest.get("val", {}).get("series_dir", [])}


def exclude_val_series(rows: list[IndexRow], manifest: dict) -> list[IndexRow]:
    """Drop rows whose series is in the manifest's val split
    (reference: scripts/phase5_big_run.py:1518-1524)."""
    val = val_series_set(manifest)
    return [r for r in rows if str(r.series_dir) not in val]


def select_val_series(rows: list[IndexRow], manifest: dict) -> list[IndexRow]:
    val = val_series_set(manifest)
    return [r for r in rows if str(r.series_dir) in val]


# -- subsampling / sharding -------------------------------------------------


def z_stride_subsample(rows: list[IndexRow], stride: int) -> list[IndexRow]:
    """Keep every *stride*-th slice per series (z-sorted) to decorrelate the
    z axis (reference: scripts/phase5_big_run.py:1527-1537)."""
    if stride <= 1:
        return rows
    by_series: dict[str, list[IndexRow]] = defaultdict(list)
    for r in rows:
        by_series[r.series_dir].append(r)
    out: list[IndexRow] = []
    for s in sorted(by_series):
        out.extend(sorted(by_series[s], key=lambda r: r.slice_index)[::stride])
    return out


def shard_rows(rows: list[IndexRow], host_id: int, num_hosts: int) -> list[IndexRow]:
    """Deterministic disjoint per-host shard (strided so every host sees all
    series). The caller shuffles with a shared seed first, making this the
    multi-host analog of the reference's single-host seeded shuffle."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} out of range for {num_hosts} hosts")
    return rows[host_id::num_hosts]


@dataclass
class SeriesMap:
    """series_dir -> {slice_index -> row} lookup with min/max bounds, used for
    2.5D (z-1, z, z+1) context with boundary clamping
    (reference: scripts/phase5_big_run.py:497-510, 527-561)."""

    by_series: dict[str, dict[int, IndexRow]] = field(default_factory=dict)
    minmax: dict[str, tuple[int, int]] = field(default_factory=dict)

    @classmethod
    def build(cls, rows: list[IndexRow]) -> "SeriesMap":
        m = cls()
        for r in rows:
            m.by_series.setdefault(r.series_dir, {})[r.slice_index] = r
        for s, d in m.by_series.items():
            ks = sorted(d)
            m.minmax[s] = (ks[0], ks[-1])
        return m

    def neighbors(self, row: IndexRow) -> tuple[IndexRow, IndexRow, IndexRow]:
        """(z-1, z, z+1) rows with clamping to the series' slice range; falls
        back to the center row when a neighbor index is missing."""
        lo, hi = self.minmax.get(row.series_dir, (row.slice_index, row.slice_index))
        d = self.by_series.get(row.series_dir, {})

        def get(k: int) -> IndexRow:
            return d.get(min(max(k, lo), hi), row)

        return get(row.slice_index - 1), get(row.slice_index), get(row.slice_index + 1)
