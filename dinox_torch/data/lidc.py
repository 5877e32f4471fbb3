"""LIDC nodule annotation consensus: cluster per-annotator marks into
physical nodules, aggregate malignancy across raters, and split by patient.
The port's copy of ``dinox_tpu.data.lidc`` (the same ``random`` and numpy
orders, so the same nodules and splits).

The library half of the malignancy-benchmark extraction (``python -m
dinox_torch.preprocessing.extract_lidc_malignancy``; the analog of what the
reference delegates to pylidc): ``pylidc.Scan.cluster_annotations()`` groups the 4 radiologists'
independent annotations into nodules by spatial proximity; consensus is the
mean malignancy with the rating std as an agreement measure; splits are
patient-level and stratified by the patient's majority label so no patient
straddles train/val/test.

Pure host-side Python — runs anywhere, tested on synthetic annotation
fixtures (no pylidc or LIDC data needed).
"""

from __future__ import annotations

import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class RawAnnotation:
    """One radiologist's mark on one nodule (pylidc Annotation analog)."""

    series_dir: str
    patient_id: str
    annotator: str
    slice_index: int
    center_x: float  # pixel coords
    center_y: float
    malignancy: float  # 1-5
    width: float = 8.0   # bbox extent in pixels
    height: float = 8.0


@dataclass
class NoduleConsensus:
    """A physical nodule: the agreement of >= min_raters annotations."""

    series_dir: str
    patient_id: str
    slice_index: int          # consensus centroid slice
    center_x: float
    center_y: float
    avg_malignancy: float
    rater_agreement: float    # std of malignancy ratings
    n_raters: int
    bbox: tuple[int, int, int, int]  # (imin, imax, jmin, jmax) rows/cols
    annotations: list[RawAnnotation] = field(default_factory=list)

    def label(self, threshold: float = 3.0) -> int:
        return 1 if self.avg_malignancy > threshold else 0

    def is_indeterminate(self, threshold: float = 3.0) -> bool:
        """Exactly-at-threshold consensus (the classic malignancy==3 case) is
        indeterminate and must be dropped, matching the consensus-CSV path and
        standard LIDC binarization."""
        return self.avg_malignancy == threshold


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def cluster_annotations(
    annotations: list[RawAnnotation],
    *,
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0),
    distance_mm: float = 10.0,
) -> list[list[RawAnnotation]]:
    """Group annotations into physical nodules by 3-D centroid proximity.

    Connected components over pairs closer than *distance_mm* in physical
    (mm) space — the same idea as pylidc's annotation clustering: different
    radiologists marking the same nodule land within a nodule diameter of
    each other; distinct nodules are centimeters apart. Clustering never
    crosses series boundaries.
    """
    sx, sy, sz = spacing
    by_series: dict[str, list[RawAnnotation]] = defaultdict(list)
    for a in annotations:
        by_series[a.series_dir].append(a)

    clusters: list[list[RawAnnotation]] = []
    for series in sorted(by_series):
        group = by_series[series]
        uf = _UnionFind(len(group))
        pts = np.asarray(
            [[a.center_x * sx, a.center_y * sy, a.slice_index * sz] for a in group]
        )
        for i in range(len(group)):
            d = np.linalg.norm(pts[i + 1:] - pts[i], axis=1)
            for off in np.nonzero(d <= distance_mm)[0]:
                uf.union(i, i + 1 + int(off))
        comp: dict[int, list[RawAnnotation]] = defaultdict(list)
        for i, a in enumerate(group):
            comp[uf.find(i)].append(a)
        clusters.extend(comp[r] for r in sorted(comp))
    return clusters


def consensus_from_cluster(
    cluster: list[RawAnnotation], *, min_raters: int = 2
) -> Optional[NoduleConsensus]:
    """Aggregate one cluster: mean malignancy (std = agreement), centroid
    slice, and the union bounding box of every annotator's mark — the
    reference's consensus recipe (extract_lidc_malignancy.py:190-258).
    Returns None when fewer than *min_raters* marked the nodule."""
    # One rating per annotator: a rater marking twice is still one opinion.
    by_rater: dict[str, RawAnnotation] = {}
    for a in cluster:
        by_rater.setdefault(a.annotator, a)
    if len(by_rater) < min_raters:
        return None
    marks = list(by_rater.values())
    mals = [a.malignancy for a in marks]
    cx = float(np.mean([a.center_x for a in marks]))
    cy = float(np.mean([a.center_y for a in marks]))
    k = int(round(float(np.mean([a.slice_index for a in marks]))))
    imin = int(min(a.center_y - a.height / 2 for a in marks))
    imax = int(max(a.center_y + a.height / 2 for a in marks))
    jmin = int(min(a.center_x - a.width / 2 for a in marks))
    jmax = int(max(a.center_x + a.width / 2 for a in marks))
    return NoduleConsensus(
        series_dir=marks[0].series_dir,
        patient_id=marks[0].patient_id,
        slice_index=k,
        center_x=cx,
        center_y=cy,
        avg_malignancy=float(np.mean(mals)),
        rater_agreement=float(np.std(mals)),
        n_raters=len(marks),
        bbox=(imin, imax, jmin, jmax),
        annotations=marks,
    )


def build_nodules(
    annotations: list[RawAnnotation],
    *,
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0),
    distance_mm: float = 10.0,
    min_raters: int = 2,
) -> list[NoduleConsensus]:
    out = []
    for cluster in cluster_annotations(
        annotations, spacing=spacing, distance_mm=distance_mm
    ):
        c = consensus_from_cluster(cluster, min_raters=min_raters)
        if c is not None:
            out.append(c)
    return out


def stratified_patient_split(
    items: list,
    *,
    patient_of,
    label_of,
    train_ratio: float = 0.70,
    val_ratio: float = 0.15,
    seed: int = 42,
) -> tuple[list, list, list]:
    """Patient-level split, stratified by the patient's majority label
    (reference extract_lidc_malignancy.py:279-345): patients — never
    individual nodules — are the split unit, and positive/negative-majority
    patients are partitioned separately so label balance carries across
    splits."""
    by_patient: dict[str, list] = defaultdict(list)
    for it in items:
        by_patient[patient_of(it)].append(it)
    patient_label = {
        p: 1 if sum(label_of(it) for it in recs) > len(recs) / 2 else 0
        for p, recs in by_patient.items()
    }
    rng = random.Random(seed)
    buckets = {0: [], 1: []}
    for p in sorted(by_patient):
        buckets[patient_label[p]].append(p)
    train_p, val_p, test_p = set(), set(), set()
    for lab in (1, 0):
        ps = buckets[lab]
        rng.shuffle(ps)
        n_train = int(len(ps) * train_ratio)
        n_val = int(len(ps) * val_ratio)
        train_p.update(ps[:n_train])
        val_p.update(ps[n_train:n_train + n_val])
        test_p.update(ps[n_train + n_val:])
    pick = lambda pset: [it for it in items if patient_of(it) in pset]  # noqa: E731
    return pick(train_p), pick(val_p), pick(test_p)
