"""Weighted multi-dataset merging, the pan-organ training mechanism: the
port's copy of ``dinox_tpu.zoo.merge``.

Manual or temperature-scaled weights (``w_i ∝ n_i^(1/T)``, T=2.0
recommended), exact per-dataset quota allocation, subsample without
replacement / oversample with replacement (every slice appears at least
once), a final shuffle and DatasetUsage records. Draws come from
``random.Random(seed)`` in the JAX package's order, so the merged order and
the usage are the same for the same inputs.
"""

from __future__ import annotations

import logging
import random

from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.schemas import DatasetUsage, SliceMetadata

log = logging.getLogger(__name__)


def temperature_weights(sizes: list[int], temperature: float = 2.0) -> list[float]:
    """Normalized sampling weights ``n_i^(1/T) / Σ n_j^(1/T)``.

    T=1 -> proportional to size, T=2 -> square-root (recommended), T→∞ ->
    uniform.
    """
    if temperature <= 0:
        raise ValueError(f"Temperature must be positive, got {temperature}")
    if not sizes or min(sizes) <= 0:
        raise ValueError(f"All sizes must be positive, got {sizes}")
    scaled = [float(n) ** (1.0 / temperature) for n in sizes]
    z = sum(scaled)
    return [s / z for s in scaled]


def _allocate_quotas(total: int, weights: list[float]) -> list[int]:
    """Integer per-dataset targets summing exactly to *total*: floor each
    share (min 1), then hand out a positive remainder largest-weight-first, or
    — when the min-1 floors overshoot (many tiny-weight datasets) — claw back
    the excess smallest-weight-first, keeping every quota >= 1 unless
    total < len(weights) forces some to 0."""
    quotas = [max(1, int(total * w)) for w in weights]
    leftover = total - sum(quotas)
    if leftover > 0:
        for i in sorted(range(len(weights)), key=lambda j: weights[j], reverse=True):
            if leftover <= 0:
                break
            quotas[i] += 1
            leftover -= 1
    elif leftover < 0:
        # Claw back smallest-weight-first, keeping every quota >= 1 while
        # possible; when total < number of datasets the floors themselves
        # overshoot, so a second pass drops smallest-weight quotas to 0 to
        # honor the caller's slice budget.
        order = sorted(range(len(weights)), key=lambda j: weights[j])
        for floor in (1, 0):
            for i in order:
                while leftover < 0 and quotas[i] > floor:
                    quotas[i] -= 1
                    leftover += 1
            if leftover >= 0:
                break
    return quotas


def _draw(records: list[SliceMetadata], n: int, rng: random.Random) -> list[SliceMetadata]:
    """n <= len: sample without replacement. n > len: every record once per
    full pass, remainder sampled without replacement — guarantees each slice
    appears at least once."""
    avail = len(records)
    if n <= avail:
        return rng.sample(records, n)
    passes, rem = divmod(n, avail)
    out = list(records) * passes
    if rem:
        out += rng.sample(records, rem)
    log.info("oversampling %d -> %d (%.1fx)", avail, n, n / avail)
    return out


class DatasetMerger:
    """Accumulate manifests, then build one merged training manifest.

    Example::

        merger = DatasetMerger()
        merger.add(lidc)          # weights ignored under "temperature"
        merger.add(pancreas)
        merged, usage = merger.build(seed=42, total_slices=500_000,
                                     strategy="temperature", temperature=2.0)
    """

    def __init__(self) -> None:
        self._sources: list[tuple[DataManifest, float]] = []

    def add(self, manifest: DataManifest, *, weight: float = 1.0) -> None:
        if weight <= 0:
            raise ValueError(f"Weight must be positive, got {weight}")
        self._sources.append((manifest, weight))

    def build(
        self,
        *,
        seed: int = 42,
        total_slices: int | None = None,
        strategy: str = "manual",
        temperature: float = 2.0,
    ) -> tuple[DataManifest, list[DatasetUsage]]:
        if not self._sources:
            raise ValueError("No datasets added to merger")

        manifests = [m for m, _ in self._sources]
        if strategy == "temperature":
            weights = temperature_weights([len(m) for m in manifests], temperature)
        elif strategy == "manual":
            z = sum(w for _, w in self._sources)
            weights = [w / z for _, w in self._sources]
        else:
            raise ValueError(f"Unknown strategy: '{strategy}'. Use 'manual' or 'temperature'.")

        quotas: list[int | None]
        if total_slices is not None:
            quotas = list(_allocate_quotas(total_slices, weights))
        else:
            quotas = [None] * len(manifests)

        rng = random.Random(seed)
        merged: list[SliceMetadata] = []
        usage: list[DatasetUsage] = []
        for manifest, weight, quota in zip(manifests, weights, quotas):
            picked = (
                list(manifest.records) if quota is None else _draw(manifest.records, quota, rng)
            )
            merged.extend(picked)
            stats = DataManifest(picked).spacing_stats()
            names = manifest.datasets()
            usage.append(
                DatasetUsage(
                    name=names[0] if len(names) == 1 else "+".join(names),
                    slices_used=len(picked),
                    weight=weight,
                    pixel_spacing_min=stats.pixel_spacing_x_min,
                    pixel_spacing_max=stats.pixel_spacing_x_max,
                    slice_thickness_min=stats.slice_thickness_min,
                    slice_thickness_max=stats.slice_thickness_max,
                )
            )

        rng.shuffle(merged)
        log.info(
            "merged %d datasets -> %d slices (strategy=%s)",
            len(manifests), len(merged), strategy,
        )
        return DataManifest(merged), usage
