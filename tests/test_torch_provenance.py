"""The port's provenance layer (module 12) against the JAX package's and the
libraries it stands on, all in process: the schemas against pydantic
(equal dumps of seeded random records; the same accepts and rejects), the
YAML reader against PyYAML's safe_load (the seven catalog files, hand cases
and refused constructs), the bundled registry and its queries, the catalog
hash, lineage.json across packages both ways, manifest sampling (both
strategies) index-equal, DatasetMerger.build's records, order and usage,
and manifest_rows."""

import dataclasses
import json
import logging
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import yaml

from dinox_torch.data import manifest_dataset as t_md
from dinox_torch.zoo import _yaml
from dinox_torch.zoo import lineage as t_lineage
from dinox_torch.zoo import merge as t_merge
from dinox_torch.zoo import schemas as t_schemas
from dinox_torch.zoo.manifest import DataManifest as TManifest
from dinox_torch.zoo.registry import DatasetRegistry as TRegistry
from dinox_tpu.data import manifest_dataset as j_md
from dinox_tpu.zoo import lineage as j_lineage
from dinox_tpu.zoo import merge as j_merge
from dinox_tpu.zoo import schemas as j_schemas
from dinox_tpu.zoo.manifest import DataManifest as JManifest
from dinox_tpu.zoo.registry import DatasetRegistry as JRegistry

ROOT = Path(__file__).resolve().parent.parent
PORT_CATALOG = ROOT / "dinox_torch" / "zoo" / "datasets"
JAX_CATALOG = ROOT / "dinox_tpu" / "zoo" / "datasets"
CATALOG_FILES = sorted((PORT_CATALOG / "ct").glob("*.yaml"))
RECORDS = ("PreprocessingConfig", "DatasetEntry", "SliceMetadata", "DatasetUsage", "SpacingStats",
           "TrainingLineage")


def slice_dicts(n, seed=0, datasets=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ds = datasets[i % len(datasets)]
        out.append(dict(
            dataset=ds, series_id=f"{ds}-s{i // 7}", slice_idx=i % 7,
            pixel_spacing_x=float(rng.uniform(0.3, 1.0)), pixel_spacing_y=float(rng.uniform(0.3, 1.0)),
            slice_thickness=float(rng.choice([0.625, 1.0, 2.5, 5.0])), image_path=f"{ds}/s{i // 7}/{i % 7:04d}.png",
            organs_present=[["lung"], [], ["liver", "pancreas"]][i % 3],
            patient_id=None if i % 2 else f"P{i}", study_date=None if i % 5 else "20200101"))
    return out


def _both(name, obj):
    """(port result, JAX result) of model_validate(obj).model_dump(), each
    "raises" if it raises a ValueError (pydantic's ValidationError is one)."""
    out = []
    for mod in (t_schemas, j_schemas):
        try:
            d = getattr(mod, name).model_validate(obj).model_dump()
        except ValueError:
            out.append("raises")
            continue
        if name == "TrainingLineage" and "timestamp" not in obj:  # now, to the microsecond
            assert d.pop("timestamp").endswith("+00:00")
        out.append(d)
    return tuple(out)


# -- schemas ----------------------------------------------------------------

def test_random_records_dump_like_pydantic():
    rng = np.random.default_rng(3)
    for d in slice_dicts(40, seed=3):
        assert _both("SliceMetadata", d)[0] == _both("SliceMetadata", d)[1]
    for i in range(20):
        entry = dict(name=f"ds{i}", modality=str(rng.choice(["ct", "mri", "xray"])),
                     organs=[f"o{j}" for j in range(int(rng.integers(0, 4)))],
                     total_slices=int(rng.integers(0, 10**6)), pixel_spacing_range=list(rng.uniform(0, 1, 2)),
                     slice_thickness_range=(int(rng.integers(1, 5)), float(rng.uniform(5, 9))),
                     hu_range=[int(rng.integers(-2000, 0)), float(rng.integers(0, 4000))],
                     preprocessing={"format": "npy", "hu_shift": int(rng.integers(0, 9)), "index_csv": "x"},
                     annotations=("a", "b"), license="CC", extra_key=i)
        got, want = _both("DatasetEntry", entry)
        assert got == want and got != "raises"
        usage = [dict(name=f"u{j}", slices_used=int(rng.integers(0, 99)), weight=float(rng.random()))
                 for j in range(3)]
        lin = dict(model_name="m", datasets=usage, total_slices=7, spacing_stats={"pixel_spacing_x_min": 1},
                   scale_aware=bool(i % 2), training_config={"lr": 1e-4, "nested": {"a": [1, 2]}},
                   random_seed=i, timestamp="2026-01-01T00:00:00+00:00")
        assert _both("TrainingLineage", lin)[0] == _both("TrainingLineage", lin)[1]
        assert (t_schemas.TrainingLineage.model_validate(lin).total_weight()
                == j_schemas.TrainingLineage.model_validate(lin).total_weight())


BASE_SLICE = slice_dicts(1)[0]
BASE_ENTRY = dict(name="x", modality="ct", organs=["lung"])
CASES = [
    ("DatasetEntry", {**BASE_ENTRY, "modality": "mri"}),
    ("DatasetEntry", {**BASE_ENTRY, "modality": "xray"}),
    ("DatasetEntry", {**BASE_ENTRY, "modality": "CT"}),
    ("DatasetEntry", {**BASE_ENTRY, "modality": "pet"}),
    ("DatasetEntry", {**BASE_ENTRY, "modality": b"ct"}),
    ("DatasetEntry", {"name": "x", "modality": "ct"}),
    ("DatasetEntry", {"modality": "ct", "organs": []}),
    ("DatasetEntry", {**BASE_ENTRY, "organs": "lung"}),
    ("DatasetEntry", {**BASE_ENTRY, "organs": [1]}),
    ("DatasetEntry", {**BASE_ENTRY, "pixel_spacing_range": [1, 2]}),
    ("DatasetEntry", {**BASE_ENTRY, "pixel_spacing_range": [1, 2, 3]}),
    ("DatasetEntry", {**BASE_ENTRY, "hu_range": [1.0, "2"]}),
    ("DatasetEntry", {**BASE_ENTRY, "hu_range": [1.5, 2]}),
    ("DatasetEntry", {**BASE_ENTRY, "total_slices": "12"}),
    ("DatasetEntry", {**BASE_ENTRY, "total_slices": 12.0}),
    ("DatasetEntry", {**BASE_ENTRY, "total_slices": None}),
    ("DatasetEntry", {**BASE_ENTRY, "preprocessing": {"scale": 3.0, "unknown": 1}}),
    ("DatasetEntry", {**BASE_ENTRY, "preprocessing": {"format": "jpeg"}}),
    ("DatasetEntry", {**BASE_ENTRY, "preprocessing": None}),
    ("DatasetEntry", {**BASE_ENTRY, "redistribution": "prohibited", "attribution_required": True,
                      "attribution": "text\n"}),
    ("DatasetEntry", {**BASE_ENTRY, "citation": 12}),
    ("DatasetEntry", None),
    ("DatasetEntry", ["name", "x"]),
    ("SliceMetadata", {**BASE_SLICE, "slice_idx": "3"}),
    ("SliceMetadata", {**BASE_SLICE, "pixel_spacing_x": 1}),
    ("SliceMetadata", {**BASE_SLICE, "pixel_spacing_x": "0.5"}),
    ("SliceMetadata", {**BASE_SLICE, "pixel_spacing_x": None}),
    ("SliceMetadata", {**BASE_SLICE, "patient_id": 7}),
    ("SliceMetadata", {**BASE_SLICE, "organs_present": None}),
    ("SliceMetadata", {k: v for k, v in BASE_SLICE.items() if k != "image_path"}),
    ("TrainingLineage", {"model_name": "m", "scale_aware": "yes"}),
    ("TrainingLineage", {"model_name": "m", "scale_aware": 2}),
    ("TrainingLineage", {"model_name": "m", "training_config": [("a", 1)]}),
    ("TrainingLineage", {"model_name": "m", "datasets": [{"name": "a", "slices_used": 1}]}),
    ("TrainingLineage", {"model_name": "m", "modality": "xray", "timestamp": "t"}),
    ("DatasetUsage", {"name": "a", "slices_used": 1, "weight": 1}),
]


@pytest.mark.parametrize("name,obj", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_accepts_and_rejects_like_pydantic(name, obj):
    got, want = _both(name, obj)
    assert got == want


def test_defaults_and_json_like_pydantic():
    for name in RECORDS:
        kw = {"TrainingLineage": {"model_name": "m", "timestamp": "2026-01-01T00:00:00+00:00"},
              "DatasetEntry": BASE_ENTRY, "SliceMetadata": BASE_SLICE,
              "DatasetUsage": {"name": "a", "slices_used": 1, "weight": 0.5}}.get(name, {})
        t, j = getattr(t_schemas, name)(**kw), getattr(j_schemas, name)(**kw)
        assert t.model_dump() == j.model_dump()
        assert json.loads(t.model_dump_json(indent=2)) == json.loads(j.model_dump_json(indent=2))
    with pytest.raises(ValueError):
        t_schemas.SliceMetadata(**{**BASE_SLICE, "slice_idx": 1.5})
    stamp = t_schemas.TrainingLineage(model_name="m").timestamp  # now, in UTC
    assert datetime.fromisoformat(stamp).utcoffset() == timedelta(0)


# -- YAML and the catalog ------------------------------------------------------

@pytest.mark.parametrize("path", CATALOG_FILES, ids=lambda p: p.name)
def test_catalog_files_parse_like_pyyaml(path):
    text = path.read_text()
    assert _yaml.safe_load(text) == yaml.safe_load(text)
    assert path.read_bytes() == (JAX_CATALOG / "ct" / path.name).read_bytes()


HAND_YAML = [
    "a: >\n  folded\n  lines\n\n  new paragraph\n\n\nb: 1\n",
    "a: >\n\n  leading blank\nb: >\n  last\n",
    "a: 'quoted # not a comment'  # a comment\nb: \"dq # \\u00e9\\t\\\\\"\nc: 'it''s'\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: true\nf: FALSE\ng: y\nh: n\n",
    "a: ~\nb:\nc: null\nd: 010\ne: 0x1F\nf: 0b101\ng: 1_000\nh: -12\ni: +3\n",
    "a: 1.5\nb: 1.\nc: .5\nd: 1.5e+3\ne: 1e3\nf: -.inf\ng: 6.02e-23\nh: 1_0.5\n",
    "top:\n  nested: 1\n  deeper:\n    x: [1, 'a', {b: c}]\n  back: [a b, \"c, d\"]\nz: {}\ny: []\n",
    "# comment\nurl: https://example.org/a#frag\nt: {k: v, k2: [1, 2], k3: 'x'}\n'q k': 1\n1: one\n",
]


@pytest.mark.parametrize("text", HAND_YAML, ids=range(len(HAND_YAML)))
def test_hand_cases_parse_like_pyyaml(text):
    assert _yaml.safe_load(text) == yaml.safe_load(text)


UNSUPPORTED = ["- a\n- b\n", "a:\n  - x\n", "a: |\n  literal\n", "a: >-\n  x\n", "a: >2\n  x\n",
               "a: &anchor 1\nb: *anchor\n", "a: !!str 1\n", "---\na: 1\n", "a: 2001-12-14\n",
               "a: 1:30\n", "a: [1,\n  2]\n", "a: 'multi\n  line'\n", "a: plain\n  continued\n",
               "<<: {a: 1}\n", "a: b: c\n", "a: >\n  x\n    more indented\n"]


@pytest.mark.parametrize("text", UNSUPPORTED, ids=range(len(UNSUPPORTED)))
def test_unsupported_constructs_raise(text):
    with pytest.raises(ValueError):
        _yaml.safe_load(text)


def test_registry_matches_jax_and_skips_what_it_cannot_read(tmp_path, caplog):
    t, j = TRegistry.bundled(), JRegistry.bundled()
    assert len(t) == 7 and t.names == j.names and "lidc-idri" in t
    assert [e.model_dump() for e in t] == [e.model_dump() for e in j]
    assert t.get("lidc-idri").model_dump() == j.get("lidc-idri").model_dump() and t.get("none") is None
    for q in (dict(modality="ct"), dict(modality="mri"), dict(organs=["brain", "liver"]),
              dict(license_prefix="CC-BY-SA"), dict(modality="ct", organs=["lung"], license_prefix="CC-BY-NC")):
        assert [e.name for e in t.query(**q)] == [e.name for e in j.query(**q)], q
    (tmp_path / "good.yaml").write_text((PORT_CATALOG / "ct" / "cq500.yaml").read_text())
    (tmp_path / "anchor.yaml").write_text("name: &n x\nmodality: ct\norgans: [a]\n")
    (tmp_path / "schema.yaml").write_text("name: y\nmodality: pet\norgans: [a]\n")
    with caplog.at_level(logging.ERROR):
        reg = TRegistry(tmp_path)
    assert reg.names == ["cq500"] and caplog.text.count("Skipping malformed") == 2
    reg.register(t.get("msd-colon"))
    assert len(reg.list_all()) == 2
    with pytest.raises(FileNotFoundError):
        TRegistry(tmp_path / "missing")


def test_catalog_hash_equal_across_packages():
    assert (t_lineage.compute_catalog_hash(PORT_CATALOG / "ct")
            == j_lineage.compute_catalog_hash(JAX_CATALOG / "ct") != "unknown")
    assert t_lineage.compute_catalog_hash(PORT_CATALOG / "none") == "unknown"


def test_lineage_json_loads_across_packages(tmp_path):
    usage = [dict(name="a", slices_used=10, weight=0.25, pixel_spacing_min=0.5),
             dict(name="b", slices_used=30, weight=0.75)]
    kw = dict(model_name="m", architecture="vit-tiny", modality="ct", scale_aware=True,
              training_config={"lr": 1e-4, "steps": [1, 2]}, random_seed=3)
    for writer, reader, mod in ((t_lineage, j_lineage, t_schemas), (j_lineage, t_lineage, j_schemas)):
        path = tmp_path / f"{writer.__name__}.json"
        wrote = writer.record_lineage(
            **kw, datasets=[mod.DatasetUsage(**u) for u in usage],
            spacing_stats=mod.SpacingStats(pixel_spacing_x_min=0.5, slice_thickness_max=5),
            catalog_dir=(PORT_CATALOG if writer is t_lineage else JAX_CATALOG) / "ct",
            training_code_dir=ROOT, output_path=path)
        got = reader.load_lineage(path)
        assert got.model_dump() == wrote.model_dump()
        assert got.total_slices == 40 and got.total_weight() == 1.0 and got.tool_version == writer.TOOL_VERSION


# -- manifests, sampling, merging ------------------------------------------------

def _manifests(n, seed=0):
    rows = slice_dicts(n, seed)
    return (TManifest([t_schemas.SliceMetadata(**r) for r in rows]),
            JManifest([j_schemas.SliceMetadata(**r) for r in rows]))


def _dumps(m):
    return [r.model_dump() for r in m.records]


@pytest.mark.parametrize("strategy", ["uniform", "spacing-stratified"])
def test_sampling_index_equal(strategy):
    t, j = _manifests(97, seed=1)
    for n, seed in ((10, 0), (50, 7), (97, 3), (200, 1)):
        assert _dumps(t.sample(n, seed=seed, strategy=strategy)) == _dumps(j.sample(n, seed=seed, strategy=strategy))
    assert _dumps(t.filter(dataset="a", organs=["lung"])) == _dumps(j.filter(dataset="a", organs=["lung"]))
    assert t.datasets() == j.datasets()
    assert t.spacing_stats().model_dump() == j.spacing_stats().model_dump()
    with pytest.raises(ValueError):
        t.sample(3, strategy="other")


@pytest.mark.parametrize("how", [dict(strategy="manual"), dict(strategy="manual", total_slices=60),
                                 dict(strategy="temperature", total_slices=90, temperature=2.0),
                                 dict(strategy="temperature", total_slices=400),
                                 dict(strategy="temperature", total_slices=2)],
                         ids=["manual", "manual-total", "temperature", "oversample", "total<datasets"])
def test_merger_build_equal(how):
    sources = [(40, 0, 1.0), (9, 1, 3.0), (3, 2, 0.5)]
    t_merger, j_merger = t_merge.DatasetMerger(), j_merge.DatasetMerger()
    for n, seed, w in sources:
        t, j = _manifests(n, seed)
        t_merger.add(t, weight=w)
        j_merger.add(j, weight=w)
    (t_out, t_usage), (j_out, j_usage) = t_merger.build(seed=5, **how), j_merger.build(seed=5, **how)
    assert _dumps(t_out) == _dumps(j_out)
    assert [u.model_dump() for u in t_usage] == [u.model_dump() for u in j_usage]
    assert t_merge.temperature_weights([10, 40, 90], 2.0) == j_merge.temperature_weights([10, 40, 90], 2.0)
    assert t_merge._allocate_quotas(7, [0.5, 0.3, 0.2]) == j_merge._allocate_quotas(7, [0.5, 0.3, 0.2])


def test_manifest_rows_equal():
    t, j = _manifests(20)
    for root in (None, "/data/root"):
        got = [dataclasses.asdict(r) for r in t_md.manifest_rows(t, root)]
        want = [dataclasses.asdict(r) for r in j_md.manifest_rows(j, root)]
        assert got == want
