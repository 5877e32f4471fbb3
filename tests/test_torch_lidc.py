"""The port's LIDC consensus (dinox_torch.data.lidc) against the JAX
package's on tests/test_lidc_consensus.py's cases and on a random cohort:
the same clusters in the same order, the same consensus records, the same
patient splits (``random`` and numpy orders equal), exactly."""

import dataclasses

import numpy as np
import pytest

from dinox_torch.data import lidc as t_lidc
from dinox_tpu.data import lidc as j_lidc


def _marks(pkg, rows):
    return [pkg.RawAnnotation(series_dir=s, patient_id=p or f"pat-{s}", annotator=a, slice_index=z,
                              center_x=x, center_y=y, malignancy=m, width=10, height=10)
            for s, a, z, x, y, m, p in rows]


def _row(series, annotator, z, x, y, mal, patient=None):
    return (series, annotator, z, x, y, mal, patient)


def _cohort(seed=0, n_patients=30):
    """Random marks: 1-3 nodules a patient, 1-4 raters a nodule, jittered
    a few voxels, malignancy 1-5."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in range(n_patients):
        for nod in range(int(rng.integers(1, 4))):
            z, x, y = int(rng.integers(5, 100)), float(rng.uniform(50, 450)), float(rng.uniform(50, 450))
            for r in range(int(rng.integers(1, 5))):
                rows.append(_row(f"s{p}", f"r{r}", z + int(rng.integers(-1, 2)),
                                 x + float(rng.normal(0, 2)), y + float(rng.normal(0, 2)),
                                 float(rng.integers(1, 6)), f"p{p}"))
    return rows


CASES = {
    "separate": [_row("s1", "r1", 10, 100, 100, 4), _row("s1", "r2", 10, 102, 101, 5),
                 _row("s1", "r3", 11, 99, 103, 4), _row("s1", "r1", 10, 300, 300, 2),
                 _row("s1", "r2", 10, 303, 298, 1), _row("s2", "r1", 10, 100, 100, 3)],
    "chain": [_row("s", "r1", 10, 100, 100, 4), _row("s", "r2", 10, 108, 100, 4),
              _row("s", "r3", 10, 116, 100, 4)],
    "consensus": [_row("s", "r1", 10, 100, 100, 5), _row("s", "r2", 10, 104, 100, 3),
                  _row("s", "r3", 12, 102, 102, 4), _row("s", "r1", 10, 100, 100, 5)],
    "indeterminate": [_row("s", "r1", 10, 100, 100, 2), _row("s", "r2", 10, 101, 101, 4)],
    "cohort": _cohort(),
}


def _as_dicts(objs):
    return [dataclasses.asdict(o) for o in objs]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("spacing,distance", [((0.7, 0.7, 1.5), 10.0), ((1.0, 1.0, 1.0), 9.0)])
def test_clusters_and_nodules_equal_jax(case, spacing, distance):
    t_marks, j_marks = _marks(t_lidc, CASES[case]), _marks(j_lidc, CASES[case])
    got = t_lidc.cluster_annotations(t_marks, spacing=spacing, distance_mm=distance)
    want = j_lidc.cluster_annotations(j_marks, spacing=spacing, distance_mm=distance)
    assert [_as_dicts(c) for c in got] == [_as_dicts(c) for c in want]
    for min_raters in (1, 2, 3):
        a = [t_lidc.consensus_from_cluster(c, min_raters=min_raters) for c in got]
        b = [j_lidc.consensus_from_cluster(c, min_raters=min_raters) for c in want]
        assert [x and dataclasses.asdict(x) for x in a] == [x and dataclasses.asdict(x) for x in b]
        assert [x and (x.label(), x.is_indeterminate()) for x in a] == \
            [x and (x.label(), x.is_indeterminate()) for x in b]
    got_n = t_lidc.build_nodules(t_marks, spacing=spacing, distance_mm=distance)
    want_n = j_lidc.build_nodules(j_marks, spacing=spacing, distance_mm=distance)
    assert _as_dicts(got_n) == _as_dicts(want_n)


@pytest.mark.parametrize("seed,ratios", [(1, (0.7, 0.15)), (42, (0.5, 0.25)), (7, (0.8, 0.1))])
def test_stratified_split_equals_jax(seed, ratios):
    rng = np.random.default_rng(seed)
    items = [{"patient": f"p{p}", "label": int(rng.integers(0, 2)), "i": i}
             for i, p in enumerate(rng.integers(0, 25, 80))]
    kw = dict(patient_of=lambda s: s["patient"], label_of=lambda s: s["label"],
              train_ratio=ratios[0], val_ratio=ratios[1], seed=seed)
    got = t_lidc.stratified_patient_split(items, **kw)
    want = j_lidc.stratified_patient_split(items, **kw)
    assert got == want
    sets = [{s["patient"] for s in split} for split in got]
    assert not (sets[0] & sets[1]) and not (sets[0] & sets[2]) and not (sets[1] & sets[2])
    assert sum(map(len, got)) == len(items)
