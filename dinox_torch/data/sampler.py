"""Deterministic epoch ordering: seeded shuffle and series-diverse batches.

The port's copy of ``dinox_tpu.data.sampler``: orders are pure functions of
(seed, epoch), bit-equal to the JAX package's, so every host computes the
same order. The diverse order interleaves series round-robin, so a batch
holds at most one slice per series.
"""

from __future__ import annotations

import numpy as np

from dinox_torch.data.index import IndexRow


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))


def shuffled_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """Plain seeded permutation of range(n)."""
    return epoch_rng(seed, epoch).permutation(n)


def diverse_order(rows: list[IndexRow], seed: int, epoch: int) -> np.ndarray:
    """Series-diverse sample order: shuffle within each series, shuffle the
    series list, then emit one index per series round-robin until all queues
    drain. Chunked into batches afterwards, consecutive windows of size
    <= n_series contain at most one slice from any series."""
    rng = epoch_rng(seed, epoch)
    groups: dict[str, list[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault(r.series_dir, []).append(i)
    queues = [rng.permutation(np.asarray(g)).tolist() for g in groups.values()]
    rng.shuffle(queues)
    out = np.empty(len(rows), dtype=np.int64)
    pos = 0
    while queues:
        still_alive = []
        for q in queues:
            out[pos] = q.pop()
            pos += 1
            if q:
                still_alive.append(q)
        queues = still_alive
    return out


def batched(order: np.ndarray, batch_size: int, drop_last: bool = True) -> list[np.ndarray]:
    """Chunk an index order into batches."""
    n_full = len(order) // batch_size
    chunks = [order[i * batch_size : (i + 1) * batch_size] for i in range(n_full)]
    if not drop_last and len(order) % batch_size:
        chunks.append(order[n_full * batch_size :])
    return chunks
