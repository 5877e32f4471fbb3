"""Host -> device batch prefetch: the copy of the next batch overlaps the
current step. The port's ``dinox_tpu.data.prefetch``.

A producer thread takes host batches (numpy), and on the card copies each
from pinned host memory with a non-blocking copy on a side CUDA stream,
recording an event there; a bounded queue holds at most ``depth`` staged
batches. The consumer makes its own stream wait on that event before it
hands the batch out, and marks each staged tensor as used on its stream
(``record_stream``), so the caching allocator does not give the memory to a
later copy while the step still reads it. Without the wait the step could
read pixels the copy has not written yet. An error in the producer is
raised in the consumer. On the CPU the batch is only converted to tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from dinox_torch.data.pipeline import Batch
from dinox_torch.utils.platform import resolve_device


class DevicePrefetcher:
    """Wrap a host batch iterator; yield Batches whose pixels (A, B, H, W, 3)
    and spacing (A, B, 3) are tensors on *device* (the card unless
    ``"cpu"``). (B, ...) batches are lifted to A = 1. *depth* bounds the
    batches staged on the device beyond the one in use."""

    def __init__(self, batches, device: torch.device | str | None = None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._src, self._depth = batches, depth
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _place(self, b: Batch) -> tuple[Batch, object]:
        """Stage *b* on the device; returns it and the copy's CUDA event."""
        px, sp = np.asarray(b.pixels), np.asarray(b.spacing, np.float32)
        if px.ndim == 4:  # lift (B, ...) -> (1, B, ...)
            px, sp = px[None], sp[None]
        px, sp = torch.from_numpy(np.ascontiguousarray(px)), torch.from_numpy(np.ascontiguousarray(sp))
        if self._stream is None:
            return Batch(pixels=px, spacing=sp, indices=b.indices), None
        with torch.cuda.stream(self._stream):
            # Pinned staging buffers from the caching host allocator, which
            # keeps each one until its non-blocking copy has run.
            px = px.pin_memory().to(self.device, non_blocking=True)
            sp = sp.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return Batch(pixels=px, spacing=sp, indices=b.indices), done

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        self._stop = stop
        _END = object()

        def producer() -> None:
            try:
                for b in self._src:
                    if stop.is_set():
                        return
                    item = self._place(b)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                if not stop.is_set():
                    q.put(e)

        t = threading.Thread(target=producer, daemon=True, name="dinox-device-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, done = item
                if done is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    batch.pixels.record_stream(stream)
                    batch.spacing.record_stream(stream)
                yield batch
        finally:
            stop.set()

    def close(self) -> None:
        if hasattr(self, "_stop"):
            self._stop.set()
