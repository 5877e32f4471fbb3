"""Host-side input pipeline: PNG decode -> fixed-canvas uint16 batches.

The port's copy of ``dinox_tpu.data.pipeline``. The host decodes 16-bit
PNGs (:mod:`dinox_torch.data.png16`: the native decoder, else the stdlib
one, where the JAX package falls back to PIL) and assembles 2.5D (z-1, z,
z+1) stacks on a fixed canvas; augmentation runs on the card
(``dinox_torch.ops.augment``). A slice of another size is resized to the
canvas as PIL's ``Image.resize(BILINEAR)`` does on a float image (a
triangle filter widened by the scale when it shrinks), with PIL's
coefficients and order of sums, then rounded and clipped as the JAX
package does, so both packages give the same canvases.

A failed decode retries up to 10 times with a random substitute index.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from dinox_torch.data.index import IndexRow, SeriesMap
from dinox_torch.data.png16 import read_png16
from dinox_torch.data.sampler import batched, diverse_order, shuffled_order

log = logging.getLogger(__name__)

MAX_RETRIES = 10


def _read_png_u16(path: str) -> np.ndarray:
    """Decode a 16-bit grey PNG to a uint16 (H, W) array."""
    return read_png16(path)


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's bilinear resampling taps from *in_size* to *out_size*
    (``precompute_coeffs`` of its Resample.c): the triangle's support
    widens by the scale when shrinking, each output's taps are normalised
    to sum 1. Returns (first input index (out,), weights (out, taps)),
    float64, weights past an output's last tap 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    x = np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((taps[None, :] < xmax[:, None]) & (x < 1.0), 1.0 - x, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # PIL's order of the sum
        total += w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return xmin, w


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample the last axis of float32 *img* to *out_size*: each output a
    float64 sum over its taps in order, stored as float32 (PIL's
    ``ImagingResampleHorizontal_32bpc``)."""
    n = img.shape[-1]
    xmin, w = _bilinear_coeffs(n, out_size)
    acc = np.zeros(img.shape[:-1] + (out_size,), np.float64)
    for j in range(w.shape[1]):
        acc += img[..., np.minimum(xmin + j, n - 1)].astype(np.float64) * w[:, j]
    return acc.astype(np.float32)


def _to_canvas(arr: np.ndarray, size: int) -> np.ndarray:
    """Bring a (H, W) uint16 slice to (size, size): unchanged at that size,
    else PIL's float bilinear resize (width first, then height), rounded
    and clipped to uint16."""
    if arr.shape == (size, size):
        return arr
    out = arr.astype(np.float32)
    if out.shape[1] != size:
        out = _resample_rows(out, size)
    if out.shape[0] != size:
        out = _resample_rows(out.T, size).T
    return np.clip(np.round(out), 0, 65535).astype(np.uint16)


@dataclass
class Batch:
    """One host-assembled batch, pre-augmentation.

    pixels: (B, canvas, canvas, 3) uint16 — channels-last 2.5D stack, raw
            PNG encoding (deci-HU decode happens on device).
    spacing: (B, 3) float32 — (spacing_x, spacing_y, slice_thickness) mm.
    indices: (B,) int64 — global row indices (for deterministic device RNG).
    """

    pixels: np.ndarray
    spacing: np.ndarray
    indices: np.ndarray


class SliceStackSource:
    """Random-access source of canvas-sized 2.5D stacks.

    A bounded LRU cache sits over the decode: every slice is read up to three
    times as the (z-1, z, z+1) context of its neighbors, and small datasets
    are re-read every epoch — caching the decoded canvases removes most of
    that repeated PNG inflate work (the 2.5D analog of the reference's
    reliance on OS page cache + many DataLoader processes). ``png_decodes``
    counts the slices decoded from their PNG (neither cache held them)."""

    def __init__(self, rows: list[IndexRow], canvas: int = 512, cache_slices: int = 512,
                 decoded_cache=None):
        if not rows:
            raise ValueError("empty index")
        self.rows = rows
        self.canvas = canvas
        self.series = SeriesMap.build(rows)
        self._cache: "dict[str, np.ndarray]" = {}
        self._cache_lock = threading.Lock()
        self._cache_slices = cache_slices
        # Optional write-once on-disk decoded cache (data/slice_cache.py):
        # a hit is a page-cache memcpy instead of a zlib inflate — the
        # production fix for the 1-core decode ceiling (round-5).
        self._disk_cache = decoded_cache
        self.png_decodes = 0

    def __len__(self) -> int:
        return len(self.rows)

    def _decode(self, path: str) -> np.ndarray:
        if self._disk_cache is not None:
            plane = self._disk_cache.get(path)
            if plane is not None:
                return plane  # memmap view; np.stack copies downstream
        with self._cache_lock:
            cached = self._cache.pop(path, None)
            if cached is not None:
                self._cache[path] = cached  # re-insert as most recent
                return cached
        plane = _to_canvas(_read_png_u16(path), self.canvas)
        with self._cache_lock:
            self.png_decodes += 1
            self._cache[path] = plane
            while len(self._cache) > self._cache_slices:
                self._cache.pop(next(iter(self._cache)))
        return plane

    def _load_one(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        row = self.rows[idx]
        zm1, z0, zp1 = self.series.neighbors(row)
        planes = [self._decode(r.png_path) for r in (zm1, z0, zp1)]
        pixels = np.stack(planes, axis=-1)  # (H, W, 3) channels-last
        spacing = np.asarray([row.spacing_x, row.spacing_y, row.spacing_z], np.float32)
        return pixels, spacing

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> tuple[np.ndarray, np.ndarray, int]:
        """Load stack *idx*; on failure retry a random substitute up to
        MAX_RETRIES times. Returns (pixels, spacing, actual_idx)."""
        rng = rng or np.random.default_rng()
        for attempt in range(MAX_RETRIES):
            try:
                pixels, spacing = self._load_one(idx)
                return pixels, spacing, idx
            except Exception as e:  # noqa: BLE001 - substitute-and-retry by design
                log.warning("data load error at %d (%s): %s", idx, self.rows[idx].png_path, e)
                idx = int(rng.integers(0, len(self.rows)))
        raise RuntimeError(f"Failed to load data after {MAX_RETRIES} attempts")


class TrainLoader:
    """Infinite, deterministic, prefetching batch iterator.

    Epoch order is a pure function of (seed, epoch) — identical on every
    host — and each host takes a disjoint strided shard of it, so the global
    batch is a deterministic function of the step (the multi-host analog of
    the reference's seeded single-host shuffle). Position (epoch, batch
    offset) is exposed for checkpointing — a capability the reference lacks
    (acknowledged at scripts/integration_canary.py:192-197).
    """

    def __init__(
        self,
        rows: list[IndexRow],
        batch_size: int,
        *,
        seed: int = 0,
        canvas: int = 512,
        diverse: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        host_id: int = 0,
        num_hosts: int = 1,
        start_epoch: int = 0,
        start_batch: int = 0,
        cache_slices: int = 512,
        decoded_cache=None,
    ):
        self.source = SliceStackSource(rows, canvas, cache_slices=cache_slices,
                                       decoded_cache=decoded_cache)
        self.batch_size = batch_size
        self.seed = seed
        self.diverse = diverse
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.epoch = start_epoch
        self.batch_in_epoch = start_batch
        self._pool = ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="dinox-data")
        self._prefetch = prefetch

    def _epoch_batches(self, epoch: int) -> list[np.ndarray]:
        rows = self.source.rows
        order = (
            diverse_order(rows, self.seed, epoch)
            if self.diverse
            else shuffled_order(len(rows), self.seed, epoch)
        )
        # Each host takes a CONTIGUOUS block of every global batch: global
        # batch b = order[b*G : (b+1)*G], host h owns rows [h*B, (h+1)*B) of
        # it. put_global_batch places process shards in process order, so the
        # assembled global array equals a single-host run's batch
        # position-for-position — and since per-sample augmentation RNG is
        # keyed by batch position, single- and multi-host runs produce
        # IDENTICAL training streams (testable loss parity, not just
        # statistical equivalence).
        global_bs = self.batch_size * self.num_hosts
        gbatches = batched(order, global_bs, drop_last=True)
        lo = self.host_id * self.batch_size
        return [g[lo:lo + self.batch_size] for g in gbatches]

    def _assemble(self, idxs: np.ndarray, epoch: int) -> Batch:
        # One Generator per slot: np.random.Generator is not thread-safe, and
        # the pool workers would otherwise share one through the retry path.
        # Deterministic per (seed, epoch, row): retry substitutes don't depend
        # on thread scheduling.
        def load(i):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, int(i)]))
            return self.source.get(int(i), rng)

        results = list(self._pool.map(load, idxs))
        pixels = np.stack([r[0] for r in results])
        spacing = np.stack([r[1] for r in results])
        actual = np.asarray([r[2] for r in results], np.int64)
        return Batch(pixels=pixels, spacing=spacing, indices=actual)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue[Batch]" = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        self._stop = stop

        def put_or_stop(item: Batch) -> bool:
            # Bounded put that stays responsive to `stop`: a plain q.put()
            # would block forever once the consumer goes away with the
            # queue full, leaking the producer thread and its batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            epoch, offset = self.epoch, self.batch_in_epoch
            try:
                while not stop.is_set():
                    chunks = self._epoch_batches(epoch)
                    for b, idxs in enumerate(chunks):
                        if b < offset:
                            continue
                        if stop.is_set():
                            return
                        if not put_or_stop(self._assemble(idxs, epoch)):
                            return
                    offset = 0
                    epoch += 1
            except (CancelledError, RuntimeError):
                # close() shuts the pool down with cancel_futures=True while
                # an _assemble may be mid-map: the resulting CancelledError
                # (or "cannot schedule new futures after shutdown") is the
                # expected teardown path, not a worker crash. Anything that
                # fires while the loader is still live is a real error.
                if not stop.is_set():
                    raise

        t = threading.Thread(target=producer, daemon=True, name="dinox-producer")
        t.start()
        batches_per_epoch = len(self._epoch_batches(self.epoch))
        try:
            while True:
                item = q.get()
                # Advance the checkpointable position *before* handing the
                # batch out, so `position` reflects the next batch to train.
                self.batch_in_epoch += 1
                if self.batch_in_epoch >= batches_per_epoch:
                    self.epoch += 1
                    self.batch_in_epoch = 0
                yield item
        finally:
            stop.set()

    def close(self) -> None:
        if hasattr(self, "_stop"):
            self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    @property
    def batches_per_epoch(self) -> int:
        return len(self._epoch_batches(self.epoch))

    @property
    def position(self) -> tuple[int, int]:
        """(epoch, batch_in_epoch) — checkpointable loader position."""
        return self.epoch, self.batch_in_epoch
