"""Parquet-backed per-slice metadata manifest: the port's copy of
``dinox_tpu.zoo.manifest`` on the port's own Parquet codec
(:mod:`dinox_torch.zoo._parquet`). Files written by either package load in
the other; sampling draws the same indices as the JAX package for the same
seed."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from dinox_torch.zoo import _parquet
from dinox_torch.zoo.schemas import SliceMetadata, SpacingStats

log = logging.getLogger(__name__)

# The JAX manifest's pyarrow schema, column by column.
SCHEMA = [
    ("dataset", "string"),
    ("series_id", "string"),
    ("slice_idx", "int64"),
    ("pixel_spacing_x", "double"),
    ("pixel_spacing_y", "double"),
    ("slice_thickness", "double"),
    ("image_path", "string"),
    ("organs_present", "list<string>"),
    ("patient_id", "string"),
    ("study_date", "string"),
]


class DataManifest:
    """Ordered collection of :class:`SliceMetadata` with Parquet I/O."""

    def __init__(self, records: list[SliceMetadata] | None = None) -> None:
        self._records: list[SliceMetadata] = list(records) if records else []

    # -- I/O ------------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """Serialize to Parquet (the JAX schema; the empty manifest too)."""
        _parquet.write_table(path, SCHEMA, (r.model_dump() for r in self._records))
        log.info("wrote %d manifest records -> %s", len(self._records), path)

    @classmethod
    def load(cls, path: str | Path) -> "DataManifest":
        _, rows = _parquet.read_table(path)
        return cls([SliceMetadata.model_validate(row) for row in rows])

    # -- accessors ------------------------------------------------------

    @property
    def records(self) -> list[SliceMetadata]:
        return self._records

    def __len__(self) -> int:
        return len(self._records)

    def add(self, record: SliceMetadata) -> None:
        self._records.append(record)

    def extend(self, records: list[SliceMetadata]) -> None:
        self._records.extend(records)

    def datasets(self) -> list[str]:
        return sorted({r.dataset for r in self._records})

    # -- filtering & sampling ------------------------------------------

    def filter(
        self, *, dataset: str | None = None, organs: list[str] | None = None
    ) -> "DataManifest":
        out = self._records
        if dataset is not None:
            out = [r for r in out if r.dataset == dataset]
        if organs is not None:
            want = set(organs)
            out = [r for r in out if want & set(r.organs_present)]
        return DataManifest(out)

    def sample(self, n: int, *, seed: int = 42, strategy: str = "uniform") -> "DataManifest":
        """Draw *n* records without replacement.

        ``strategy="spacing-stratified"`` stratifies over 10 equal-width
        pixel_spacing_x bins; a top-up pass fills any shortfall uniformly
        from the unselected remainder.
        """
        if strategy not in ("uniform", "spacing-stratified"):
            raise ValueError(f"Unknown sampling strategy: {strategy}")
        n = min(n, len(self._records))
        rng = np.random.default_rng(seed)
        if strategy == "uniform" or not self._records:
            idx = rng.choice(len(self._records), size=n, replace=False)
            return DataManifest([self._records[i] for i in idx])

        sx = np.asarray([r.pixel_spacing_x for r in self._records])
        lo, hi = float(sx.min()), float(sx.max())
        if lo == hi:
            idx = rng.choice(len(self._records), size=n, replace=False)
            return DataManifest([self._records[i] for i in idx])

        n_bins = 10
        bin_of = np.minimum(((sx - lo) / (hi - lo) * n_bins).astype(int), n_bins - 1)
        chosen: list[int] = []
        occupied = [b for b in range(n_bins) if (bin_of == b).any()]
        per_bin = max(1, n // len(occupied))
        for b in occupied:
            members = np.flatnonzero(bin_of == b)
            take = min(per_bin, members.size)
            chosen.extend(rng.choice(members, size=take, replace=False).tolist())
        if len(chosen) < n:
            rest = np.setdiff1d(np.arange(len(self._records)), np.asarray(chosen))
            extra = rng.choice(rest, size=min(n - len(chosen), rest.size), replace=False)
            chosen.extend(extra.tolist())
        return DataManifest([self._records[i] for i in chosen[:n]])

    # -- statistics -----------------------------------------------------

    def spacing_stats(self) -> SpacingStats:
        if not self._records:
            return SpacingStats()
        sx = np.asarray([r.pixel_spacing_x for r in self._records])
        sy = np.asarray([r.pixel_spacing_y for r in self._records])
        st = np.asarray([r.slice_thickness for r in self._records])
        return SpacingStats(
            pixel_spacing_x_min=float(sx.min()),
            pixel_spacing_x_max=float(sx.max()),
            pixel_spacing_x_mean=float(sx.mean()),
            pixel_spacing_y_min=float(sy.min()),
            pixel_spacing_y_max=float(sy.max()),
            pixel_spacing_y_mean=float(sy.mean()),
            slice_thickness_min=float(st.min()),
            slice_thickness_max=float(st.max()),
            slice_thickness_mean=float(st.mean()),
        )
