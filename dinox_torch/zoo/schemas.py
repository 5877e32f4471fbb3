"""Records of the provenance layer: catalog entries, manifest rows, dataset
usage and training lineage.

The port's copy of ``dinox_tpu.zoo.schemas`` without pydantic: dataclasses
that keep pydantic's names (``model_validate``, ``model_dump``,
``model_dump_json``) and validate as pydantic's lax mode does on these
fields. Missing required fields and values of the wrong kind raise
:class:`ValidationError` (a ``ValueError``); ints become floats, integral
floats and numeric strings become ints, lists become the ``*_range``
tuples, nested records are built from dicts, and unknown keys (the catalog
files' ``redistribution``, ``attribution_required``, ``attribution``) are
ignored. So catalog YAML, Parquet manifest rows and ``lineage.json`` files
written by either package load in the other.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import types
import typing
from dataclasses import dataclass, field
from datetime import UTC, datetime
from typing import Any, Literal, Optional

Modality = Literal["ct", "mri", "xray"]

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """A record that pydantic's lax mode would refuse."""


def _int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValidationError(f"{v!r} is not a finite number")
        if v != int(v):
            raise ValidationError(f"{v!r} has a fractional part")
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            pass
        try:
            f = float(s)
        except ValueError:
            raise ValidationError(f"unable to parse {v!r} as an integer") from None
        return _int(f)
    raise ValidationError(f"{v!r} is not a valid integer")


def _float(v: Any) -> float:
    if isinstance(v, (bool, float)):
        return float(v)
    if isinstance(v, int):
        try:
            return float(v)
        except OverflowError:
            raise ValidationError(f"{v!r} is not a valid number") from None
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            raise ValidationError(f"unable to parse {v!r} as a number") from None
    raise ValidationError(f"{v!r} is not a valid number")


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
        return v.strip().lower() in _TRUE
    raise ValidationError(f"{v!r} is not a valid boolean")


def _str(v: Any) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode()
    raise ValidationError(f"{v!r} is not a valid string")


def _validate(tp: Any, v: Any) -> Any:
    """*v* validated against the annotation *tp*, pydantic's lax rules."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is Literal:
        if not any(type(v) is type(a) and v == a for a in args):
            raise ValidationError(f"{v!r} is not one of {args}")
        return v
    if origin in (typing.Union, types.UnionType):
        if v is None and type(None) in args:
            return None
        (inner,) = [a for a in args if a is not type(None)]
        return _validate(inner, v)
    if origin is list:
        if not isinstance(v, (list, tuple, set, frozenset)):
            raise ValidationError(f"{v!r} is not a valid list")
        return [_validate(args[0], x) for x in v]
    if origin is tuple:
        if not isinstance(v, (list, tuple)):
            raise ValidationError(f"{v!r} is not a valid tuple")
        if len(v) != len(args):
            raise ValidationError(f"{v!r} should have {len(args)} items")
        return tuple(_validate(a, x) for a, x in zip(args, v))
    if tp is dict or origin is dict:
        if not isinstance(v, dict):
            raise ValidationError(f"{v!r} is not a valid dictionary")
        return dict(v)
    if isinstance(tp, type) and issubclass(tp, _Record):
        return v if isinstance(v, tp) else tp.model_validate(v)
    return {int: _int, float: _float, bool: _bool, str: _str}[tp](v)


def _dump(v: Any) -> Any:
    if isinstance(v, _Record):
        return v.model_dump()
    if isinstance(v, list):
        return [_dump(x) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x) for k, x in v.items()}
    return v


@functools.cache
def _hints(cls: type) -> dict[str, Any]:
    return {f.name: typing.get_type_hints(cls)[f.name] for f in dataclasses.fields(cls)}


@functools.cache
def _fields(cls: type) -> tuple[tuple[str, bool], ...]:
    """(name, required) of each field of the record class *cls*."""
    return tuple((f.name, f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING)
                 for f in dataclasses.fields(cls))


class _Record:
    """pydantic's ``BaseModel`` interface on a dataclass."""

    @classmethod
    def model_validate(cls, obj: Any):
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise ValidationError(f"{cls.__name__}: input should be a dictionary, got {obj!r}")
        kw = {}
        for name, required in _fields(cls):
            if name in obj:
                kw[name] = obj[name]
            elif required:
                raise ValidationError(f"{cls.__name__}.{name}: field required")
        return cls(**kw)

    def __post_init__(self) -> None:
        # Construction validates, as a pydantic model's does.
        for name, tp in _hints(type(self)).items():
            try:
                setattr(self, name, _validate(tp, getattr(self, name)))
            except ValidationError as e:
                raise ValidationError(f"{type(self).__name__}.{name}: {e}") from None

    def model_dump(self) -> dict[str, Any]:
        return {f.name: _dump(getattr(self, f.name)) for f in dataclasses.fields(self)}

    def model_dump_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.model_dump(), indent=indent, ensure_ascii=False,
                          separators=None if indent is not None else (",", ":"))


@dataclass
class PreprocessingConfig(_Record):
    """Raw-data -> training-format conversion parameters: the 16-bit PNG
    stores ``uint16 = round(HU) + hu_shift``."""

    format: Literal["png_16bit", "png_8bit", "npy", "nifti"] = "png_16bit"
    hu_shift: int = 32768
    scale: int = 10
    index_csv: str = ""


@dataclass
class DatasetEntry(_Record):
    """One catalogued dataset, one YAML file under ``zoo/datasets/<modality>/``."""

    name: str
    modality: Modality
    organs: list[str]
    source_url: str = ""
    license: str = ""
    total_slices: int = 0
    total_series: int = 0
    pixel_spacing_range: tuple[float, float] = (0.0, 0.0)
    slice_thickness_range: tuple[float, float] = (0.0, 0.0)
    hu_range: tuple[int, int] = (-1024, 3071)
    annotations: list[str] = field(default_factory=list)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    citation: str = ""
    notes: str = ""


@dataclass
class SliceMetadata(_Record):
    """Per-slice physical metadata, one row of the Parquet manifest; the
    three spacings feed the ScaleEmbedding."""

    dataset: str
    series_id: str
    slice_idx: int
    pixel_spacing_x: float
    pixel_spacing_y: float
    slice_thickness: float
    image_path: str
    organs_present: list[str] = field(default_factory=list)
    patient_id: Optional[str] = None
    study_date: Optional[str] = None


@dataclass
class DatasetUsage(_Record):
    """How one dataset contributed to a training run."""

    name: str
    slices_used: int
    weight: float
    pixel_spacing_min: float = 0.0
    pixel_spacing_max: float = 0.0
    slice_thickness_min: float = 0.0
    slice_thickness_max: float = 0.0


@dataclass
class SpacingStats(_Record):
    """Corpus-level spacing aggregates."""

    pixel_spacing_x_min: float = 0.0
    pixel_spacing_x_max: float = 0.0
    pixel_spacing_x_mean: float = 0.0
    pixel_spacing_y_min: float = 0.0
    pixel_spacing_y_max: float = 0.0
    pixel_spacing_y_mean: float = 0.0
    slice_thickness_min: float = 0.0
    slice_thickness_max: float = 0.0
    slice_thickness_mean: float = 0.0


@dataclass
class TrainingLineage(_Record):
    """Full provenance of a training run, saved as ``lineage.json``."""

    model_name: str
    architecture: str = "vit-small"
    modality: Modality = "ct"
    datasets: list[DatasetUsage] = field(default_factory=list)
    total_slices: int = 0
    spacing_stats: SpacingStats = field(default_factory=SpacingStats)
    scale_aware: bool = False
    training_config: dict = field(default_factory=dict)
    random_seed: int = 42
    timestamp: str = field(default_factory=lambda: datetime.now(UTC).isoformat())
    tool_version: str = ""
    training_code_commit: str = ""
    data_catalog_hash: str = ""

    def total_weight(self) -> float:
        return sum(d.weight for d in self.datasets)
