"""Checkpoints with rotation, resume and emergency saves: the port's
``dinox_tpu.train.checkpoint``, on safetensors where the JAX package uses
Orbax.

Layout: one directory per step under ``run_dir/ckpt/``, written under a
temporary name and renamed into place (a crash leaves no half checkpoint):

    ckpt/<step>/state.safetensors   every tensor of the TrainState:
                                    student.<name>, teacher.<name>, center,
                                    step, optimizer.<name>.<key> for each
                                    entry of the optimizer's state (step,
                                    exp_avg, exp_avg_sq; a factored nu's
                                    exp_avg_sq_r and exp_avg_sq_c, the r
                                    and c of the parameter's JAX-package
                                    layout, see train.optim), keyed by the
                                    student's parameter names, each in its
                                    own dtype (bfloat16 moments as BF16)
    ckpt/<step>/meta.json           {"step", "config", "loader_epoch",
                                    "loader_batch"}

Saves are asynchronous. The training step updates the state in place
(``optimizer.step()``, the teacher EMA), so :meth:`CheckpointManager.save`
takes a snapshot before it returns: a copy of every tensor on the card, in
stream order, into snapshot buffers on the card. A background thread copies
the snapshot into pinned host memory on a side stream, while the next steps
run, and writes the file; a save first waits for the one before it. Both
buffers are allocated at the first save and reused by every later one, so
no later save allocates 2 x the state's bytes (device and pinned) while
steps are queued. Augmentation randomness is a
pure function of (seed, step, micro-batch), so no RNG state is saved.

*save_timeout_s* arms a watchdog on every blocking checkpoint operation: on
timeout the operation is abandoned on a daemon thread, ``wedged`` is set and
every later checkpoint operation is a logged no-op, so a run's metrics
survive a state that cannot be written.

On a mesh (``parallel.mesh``) every rank calls :meth:`save` and
:meth:`restore`. Rank 0 writes the full state (``gather_state``: the model
group's shards put back together): the same files, keys, shapes and dtypes
a one-process run writes, so ``check_checkpoint``, ``run_export`` and a
one-process resume read them unchanged. Every rank restores the full file
and cuts its shard. A barrier of every process comes after the write is
waited for (:meth:`wait`, :meth:`close`) and before a restore reads.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from dinox_torch.parallel.mesh import Mesh, gather_tensors, host_barrier, shard_tensors
from dinox_torch.train.state import TrainState
from dinox_torch.zoo.safetensors_io import load_file, save_file, torch_to_numpy

log = logging.getLogger(__name__)

STATE_FILE = "state.safetensors"
META_FILE = "meta.json"


class CheckpointWedgedError(RuntimeError):
    """A checkpoint save exceeded its watchdog timeout and was abandoned."""


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of *state* by its checkpoint name (the live tensors, not
    copies). Optimizer state is keyed by the student's parameter names."""
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in state.teacher.state_dict().items()})
    out["center"] = state.center
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    for name, p in state.student.named_parameters():
        for key, value in state.optimizer.state.get(p, {}).items():
            out[f"optimizer.{name}.{key}"] = torch.as_tensor(value)
    return out


def load_state_tensors(state: TrainState, arrays: dict) -> TrainState:
    """Copy a checkpoint's *arrays* (numpy, by :func:`state_tensors` names)
    into *state*, in place, exactly: each optimizer entry in the dtype the
    optimizer stores it in (``state_dtype``; bfloat16 reads back exactly
    from its float32 widening). The optimizer's ``step`` counts stay on the
    CPU, where ``torch.optim.AdamW`` keeps them unless capturable or
    fused."""
    def part(prefix: str) -> dict[str, torch.Tensor]:
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith(prefix)}

    state.student.load_state_dict(part("student."), strict=True)
    state.teacher.load_state_dict(part("teacher."), strict=True)
    state.center = torch.from_numpy(arrays["center"]).to(state.center.device)
    state.step = int(arrays["step"])
    opt = part("optimizer.")
    on_device = any(g.get("capturable") or g.get("fused") for g in state.optimizer.param_groups)
    dtype_of = getattr(state.optimizer, "state_dtype", lambda key: None)
    state.optimizer.state.clear()
    for name, p in state.student.named_parameters():
        keys = [k for k in opt if k.rsplit(".", 1)[0] == name]
        if keys:
            entry = {}
            for k in keys:
                key, value = k.rsplit(".", 1)[1], opt.pop(k)
                if key == "step" and not on_device:
                    entry[key] = value.clone()
                else:
                    entry[key] = value.to(p.device, dtype_of(key) or value.dtype)
            state.optimizer.state[p] = entry
    if opt:
        raise KeyError(f"checkpoint holds optimizer state of unknown parameters: {sorted(opt)[:4]}")
    return state


class CheckpointManager:
    """Checkpoints of one run directory: async saves, rotation to
    *keep_last*, restore, emergency saves, and the save watchdog.

    ``stats`` counts the saves written, the bytes of the last, the seconds
    the caller was blocked in :meth:`save` (in all and for each save), the
    part of them spent allocating snapshot buffers on the card, the device
    time of the snapshot copies, and the seconds the writes took (device ->
    host copy, serialisation, rename)."""

    def __init__(self, run_dir: str | Path, keep_last: int = 5, async_save: bool = True,
                 save_timeout_s: Optional[float] = None, mesh: Optional[Mesh] = None):
        self.run_dir = Path(run_dir).absolute()
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self.ckpt_dir = self.run_dir / "ckpt"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self.save_timeout_s = save_timeout_s or 0.0
        self.wedged = False
        self.stats = {"saves": 0, "bytes": 0, "blocked_s": 0.0, "blocked_each_s": [], "alloc_s": 0.0,
                      "snapshot_device_s": 0.0, "write_s": 0.0}
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream: Optional[torch.cuda.Stream] = None  # the device -> host copies
        self._snap: dict[str, torch.Tensor] = {}  # snapshot buffers on the card, reused
        self._pinned: Optional[torch.Tensor] = None  # the pinned host buffer, reused

    def _guarded(self, fn: Callable[[], None], what: str) -> bool:
        """Run *fn*; with a watchdog armed, abandon it after save_timeout_s.
        Returns False when skipped (already wedged) or timed out."""
        if self.wedged:
            log.error("checkpoint channel wedged earlier; skipping %s", what)
            return False
        if not self.save_timeout_s:
            fn()
            return True
        errs: list[BaseException] = []

        def target() -> None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised on the caller's thread below
                errs.append(e)

        t = threading.Thread(target=target, daemon=True, name=f"ckpt-{what}")
        t.start()
        t.join(self.save_timeout_s)
        if t.is_alive():
            self.wedged = True
            log.error("%s exceeded the %.0f s checkpoint watchdog; continuing WITHOUT this "
                      "checkpoint, later checkpoint operations are skipped", what,
                      self.save_timeout_s)
            return False
        if errs:
            raise errs[0]
        return True

    def _join(self) -> None:
        """Wait for the write in flight; raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _snapshot(self, state: TrainState):
        """Every tensor of *state* as it stands now in stream order, so
        in-place updates enqueued later do not reach it: CPU tensors
        cloned, tensors on the card copied on the current stream into the
        manager's snapshot buffers (allocated when the state's tensors
        change, so at the first save), in one multi-tensor copy between two
        timing events (on the H100, chip_smoke: ViT-S's 646 tensors took
        7-18 ms of device time a save as single copies, 0.6-1.1 ms as one
        multi-tensor copy). Returns
        (CPU clones, device snapshot, (start, end) events or None)."""
        tensors = {k: v.detach() for k, v in state_tensors(state).items()}
        if self.mesh is not None:
            tensors = gather_tensors(tensors, self.mesh)
        host = {k: v.clone() for k, v in tensors.items() if not v.is_cuda}
        on_card = {k: v for k, v in tensors.items() if v.is_cuda}
        if not on_card:
            return host, {}, None
        t0 = time.perf_counter()
        if {k: (v.shape, v.dtype, v.device) for k, v in self._snap.items()} != \
                {k: (v.shape, v.dtype, v.device) for k, v in on_card.items()}:
            self._snap = {}  # free the old buffers before taking new ones
            self._snap = {k: torch.empty_like(v) for k, v in on_card.items()}
        self.stats["alloc_s"] += time.perf_counter() - t0
        stream = torch.cuda.current_stream(next(iter(on_card.values())).device)
        events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        events[0].record(stream)
        torch._foreach_copy_([self._snap[k] for k in on_card], list(on_card.values()))
        events[1].record(stream)
        return host, self._snap, events

    def _to_host(self, snap: dict[str, torch.Tensor], events) -> dict[str, torch.Tensor]:
        """Copy the device snapshot into the pinned host buffer on a side
        stream, which overlaps the training steps, and wait for the copy."""
        device = next(iter(snap.values())).device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        sizes = [v.numel() * v.element_size() for v in snap.values()]
        starts = np.cumsum([0] + [-(-n // 64) * 64 for n in sizes])  # 64-byte aligned views
        if self._pinned is None or self._pinned.numel() != int(starts[-1]):
            self._pinned = None
            self._pinned = torch.empty(int(starts[-1]), dtype=torch.uint8, pin_memory=True)
        out = {}
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(events[1])
            for (k, v), at, n in zip(snap.items(), starts, sizes):
                out[k] = self._pinned[int(at):int(at) + n].view(v.dtype).view(v.shape)
                out[k].copy_(v, non_blocking=True)
        self._stream.synchronize()
        self.stats["snapshot_device_s"] += events[0].elapsed_time(events[1]) / 1e3
        return out

    def _write(self, step: int, snapshot, meta: dict[str, Any]) -> None:
        t0 = time.perf_counter()
        host, snap, events = snapshot
        if snap:
            host = {**host, **self._to_host(snap, events)}
        arrays = {k: torch_to_numpy(v) for k, v in host.items()}
        tmp = self.ckpt_dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        final = self.ckpt_dir / str(step)
        try:
            save_file(arrays, tmp / STATE_FILE)
            (tmp / META_FILE).write_text(json.dumps(meta, default=str))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if self.keep_last > 0:
            for old in self.all_steps()[:-self.keep_last]:
                shutil.rmtree(self.ckpt_dir / str(old), ignore_errors=True)
        self.stats["saves"] += 1
        self.stats["bytes"] = (final / STATE_FILE).stat().st_size
        self.stats["write_s"] += time.perf_counter() - t0

    def _save(self, step: int, state: TrainState, meta: dict[str, Any]) -> None:
        t0 = time.perf_counter()
        self._join()
        if not self.writes:  # the other ranks take part in the gather, then go on
            gather_tensors(state_tensors(state), self.mesh)
            return
        snapshot = self._snapshot(state)
        if self.async_save:
            def write() -> None:
                try:
                    self._write(step, snapshot, meta)
                except BaseException as e:  # noqa: BLE001 - raised by the next _join
                    self._error = e

            self._writer = threading.Thread(target=write, daemon=True, name=f"ckpt-write-{step}")
            self._writer.start()
        else:
            self._write(step, snapshot, meta)
        blocked = time.perf_counter() - t0
        self.stats["blocked_s"] += blocked
        self.stats["blocked_each_s"].append(blocked)

    def save(self, step: int, state: TrainState, *, config: Optional[dict[str, Any]] = None,
             loader_position: Optional[tuple[int, int]] = None) -> bool:
        """Save *state* as step *step*. Returns False when the watchdog
        skipped or abandoned it. The state may change once this returns."""
        meta = {
            "step": int(step),
            "config": config or {},
            "loader_epoch": loader_position[0] if loader_position else 0,
            "loader_batch": loader_position[1] if loader_position else 0,
        }
        return self._guarded(lambda: self._save(step, state, meta), f"save(step={step})")

    def all_steps(self) -> list[int]:
        """Steps with a complete checkpoint, ascending."""
        return sorted(int(d.name) for d in self.ckpt_dir.iterdir()
                      if d.name.isdigit() and (d / META_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None
                ) -> tuple[TrainState, dict[str, Any]]:
        """Restore into *state_template* (in place; its devices are kept) the
        checkpoint of *step* (the latest by default). Returns (state, meta)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.run_dir}")
        d = self.ckpt_dir / str(step)
        arrays = load_file(d / STATE_FILE)
        if self.mesh is not None:
            arrays = shard_tensors(arrays, self.mesh)
        state = load_state_tensors(state_template, arrays)
        return state, json.loads((d / META_FILE).read_text())

    def wait(self) -> None:
        """Wait for the write in flight; on a mesh of more than one rank,
        then a barrier of every process, so no rank reads or goes on before
        the file is in place."""
        self._guarded(self._join, "wait_until_finished")
        if self.mesh is not None and self.mesh.multi:
            host_barrier("dinox_torch:checkpoint")

    def close(self) -> None:
        self.wait()

    def emergency_save(self, step: int, state: TrainState, reason: str) -> None:
        """Synchronous save on an anomaly (NaN/Inf), with an EMERGENCY.txt
        beside the checkpoints."""
        log.error("EMERGENCY checkpoint at step %d: %s", step, reason)
        if self.writes:
            (self.run_dir / "EMERGENCY.txt").write_text(f"step={step}\nreason={reason}\n")
        self.save(step, state)
        self.wait()


def find_latest_run(base_dir: str | Path) -> Optional[Path]:
    """The most recently modified run directory under *base_dir* holding
    checkpoints (``--resume auto``)."""
    base = Path(base_dir)
    if not base.is_dir():
        return None
    candidates = [d for d in base.iterdir() if d.is_dir() and (d / "ckpt").is_dir()]
    if not candidates:
        return None
    return max(candidates, key=lambda d: d.stat().st_mtime)
