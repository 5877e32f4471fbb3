"""Batched embedding of index rows for evaluation: the port's copy of
``dinox_tpu.evaluation.embedder``.

The deterministic path (fixed window, short-side resize, centre crop) feeds
metrics 2-6; the two-view path (the training augmentation) feeds view
retrieval. Both embed the L2-normalised backbone CLS token (not the
projection head). The host decodes each batch on a thread pool (the native
PNG decoder releases the GIL) while the previous batch runs on the model's
device; the forward runs there, and the embeddings come back as float32
numpy arrays.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from dinox_torch.data.index import IndexRow
from dinox_torch.data.pipeline import SliceStackSource
from dinox_torch.ops.augment import AugConfig, augment_views, eval_transform
from dinox_torch.utils.rng import seeded_generator
from dinox_torch.zoo.hub import DeviceViT


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def prefetched_batches(load: Callable[[int], np.ndarray], chunks: Iterable[np.ndarray]
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(chunk, ``np.stack([load(i) for i in chunk])``) for each chunk of indices: a
    decode pool fans out the items of a batch, and a one-thread prefetcher
    assembles batch i+1 while batch i is consumed. Separate pools, so an
    assemble never occupies a decode worker. *chunks* may be endless."""
    workers = min(8, max(2, os.cpu_count() or 2))

    def assemble(chunk: np.ndarray, pool: ThreadPoolExecutor) -> tuple[np.ndarray, np.ndarray]:
        return chunk, np.stack(list(pool.map(load, chunk.tolist())))

    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="dinox-decode") as pool, \
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="dinox-prefetch") as prefetcher:
        pending = None
        for chunk in chunks:
            fut = prefetcher.submit(assemble, chunk, pool)
            if pending is not None:
                yield pending.result()
            pending = fut
        if pending is not None:
            yield pending.result()


def _load_batches(rows: Sequence[IndexRow], idxs: np.ndarray, canvas: int, batch_size: int
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(pixels (B, canvas, canvas, 3) uint16, spacing (B, 3) float32) for each
    chunk of *idxs*, the 2.5D stacks decoded by :func:`prefetched_batches`."""
    src = SliceStackSource(list(rows), canvas=canvas)
    chunks = (idxs[s:s + batch_size] for s in range(0, len(idxs), batch_size))
    for chunk, pixels in prefetched_batches(lambda i: src.get(i)[0], chunks):
        yield pixels, np.asarray([[rows[i].spacing_x, rows[i].spacing_y, rows[i].spacing_z]
                                  for i in chunk], np.float32)


@torch.inference_mode()
def _cls(model: DeviceViT, x: torch.Tensor, spacing: Optional[np.ndarray]) -> np.ndarray:
    return model(x, spacing)[:, 0].float().cpu().numpy()


def embed_rows(model: DeviceViT, rows: Sequence[IndexRow], *, batch_size: int = 64,
               canvas: int = 512, spacing_scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic embeddings: (N, D) L2-normalised CLS and (N, 3) spacings.

    ``spacing_scale`` serves the counterfactual metric (x2 / x0.5 spacing,
    the same pixels)."""
    embs, sps = [], []
    for pixels, spacing in _load_batches(rows, np.arange(len(rows)), canvas, batch_size):
        x = eval_transform(torch.from_numpy(pixels).to(model.device), img_size=model.img_size)
        embs.append(_cls(model, x, spacing * spacing_scale if model.scale_aware else None))
        sps.append(spacing)
    return _l2n(np.concatenate(embs)), np.concatenate(sps)


def embed_two_views(model: DeviceViT, rows: Sequence[IndexRow], idxs: np.ndarray, *,
                    seed: int = 42, batch_size: int = 64, canvas: int = 512,
                    aug: Optional[AugConfig] = None) -> tuple[np.ndarray, np.ndarray]:
    """Two independently augmented views of each row of *idxs* -> (q, k)
    L2-normalised CLS embeddings for view retrieval. Batch i's views draw
    from a CPU generator seeded with (seed, i)."""
    aug = aug or AugConfig(img_size=model.img_size)
    q_chunks, k_chunks = [], []
    for bi, (pixels, spacing) in enumerate(_load_batches(rows, idxs, canvas, batch_size)):
        views = augment_views(torch.from_numpy(pixels).to(model.device), seeded_generator(seed, bi), aug)
        sp = spacing if model.scale_aware else None
        q_chunks.append(_cls(model, views[0], sp))
        k_chunks.append(_cls(model, views[1], sp))
    return _l2n(np.concatenate(q_chunks)), _l2n(np.concatenate(k_chunks))
