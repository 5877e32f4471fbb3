"""The dataset catalog: one YAML file per dataset (the port's copy of
``dinox_tpu.zoo.registry``, on the port's own YAML reader)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, Optional

from dinox_torch.zoo import _yaml
from dinox_torch.zoo.schemas import DatasetEntry

log = logging.getLogger(__name__)

_DEFAULT_CATALOG = Path(__file__).parent / "datasets"


class DatasetRegistry:
    """Catalog of medical-imaging datasets, one YAML file per dataset.

    Usage::

        reg = DatasetRegistry.bundled()    # the catalog shipped with the package
        reg = DatasetRegistry("my/dir")    # a custom catalog tree
        ct = reg.query(modality="ct")
        lidc = reg.get("lidc-idri")
    """

    def __init__(self, catalog_dir: str | Path | None = None) -> None:
        self._by_name: dict[str, DatasetEntry] = {}
        if catalog_dir is not None:
            self.load(catalog_dir)

    @classmethod
    def bundled(cls) -> "DatasetRegistry":
        """Registry over the catalog shipped with this package."""
        return cls(_DEFAULT_CATALOG)

    def load(self, catalog_dir: str | Path) -> int:
        """Recursively load every ``*.yaml`` under *catalog_dir*; returns the
        number of entries parsed. A file the YAML reader or the schema
        refuses is logged and skipped."""
        root = Path(catalog_dir)
        if not root.is_dir():
            raise FileNotFoundError(f"Catalog directory not found: {root}")
        n = 0
        for f in sorted(root.rglob("*.yaml")):
            try:
                entry = DatasetEntry.model_validate(_yaml.safe_load(f.read_text()))
            except (OSError, UnicodeDecodeError, ValueError):
                log.exception("Skipping malformed catalog entry %s", f)
                continue
            self._by_name[entry.name] = entry
            n += 1
        return n

    def register(self, entry: DatasetEntry) -> None:
        self._by_name[entry.name] = entry

    def get(self, name: str) -> Optional[DatasetEntry]:
        return self._by_name.get(name)

    def list_all(self) -> list[DatasetEntry]:
        return list(self._by_name.values())

    def query(
        self,
        *,
        modality: str | None = None,
        organs: list[str] | None = None,
        license_prefix: str | None = None,
    ) -> list[DatasetEntry]:
        """Filter by modality, any-of-organs overlap, and/or license prefix."""
        wanted_organs = set(organs) if organs is not None else None

        def keep(e: DatasetEntry) -> bool:
            if modality is not None and e.modality != modality:
                return False
            if wanted_organs is not None and not (wanted_organs & set(e.organs)):
                return False
            if license_prefix is not None and not e.license.startswith(license_prefix):
                return False
            return True

        return [e for e in self._by_name.values() if keep(e)]

    @property
    def names(self) -> list[str]:
        return sorted(self._by_name)

    def __iter__(self) -> Iterator[DatasetEntry]:
        return iter(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name
