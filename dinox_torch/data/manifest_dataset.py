"""From the provenance layer (DataManifest) to the training loader's rows:
the port's copy of ``dinox_tpu.data.manifest_dataset``. A manifest (e.g. a
temperature-weighted ``DatasetMerger.build``) becomes ``IndexRow``s for
``TrainLoader`` and the evaluation embedder."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from dinox_torch.data.index import IndexRow
from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.schemas import SliceMetadata


def record_to_row(rec: SliceMetadata, data_root: Optional[str | Path] = None) -> IndexRow:
    path = Path(rec.image_path)
    if data_root is not None and not path.is_absolute():
        path = Path(data_root) / path
    return IndexRow(
        png_path=str(path),
        series_dir=f"{rec.dataset}:{rec.series_id}",
        slice_index=rec.slice_idx,
        encoding="hu16",
        spacing_x=rec.pixel_spacing_x,
        spacing_y=rec.pixel_spacing_y,
        spacing_z=rec.slice_thickness,
        dataset=rec.dataset,
    )


def manifest_rows(
    manifest: DataManifest, data_root: Optional[str | Path] = None
) -> list[IndexRow]:
    """All manifest records as loader rows, in the manifest's order (an
    oversampled slice appears as many times as the merger emitted it)."""
    return [record_to_row(r, data_root) for r in manifest.records]


def load_manifest_rows(
    parquet_path: str | Path, data_root: Optional[str | Path] = None
) -> list[IndexRow]:
    return manifest_rows(DataManifest.load(parquet_path), data_root)
