"""The training loop: batches -> train step -> metric sinks, checkpoints and
anomaly checks. The port's ``dinox_tpu.train.trainer``, single-process, on
one device.

It keeps the JAX loop's behaviour: periodic checkpoints with rotation; on a
NaN/Inf loss an emergency checkpoint of the live state, then a raise;
loss-spike and collapse warnings; on SIGINT the current step finishes, a
final checkpoint is written and the loop returns; samples/s and the share of
wall time spent waiting for data. The step's metrics stay on the device and
are drained to the host in one transfer per flush (``torch.stack``, then
``.cpu()``), on a step-count or wall-clock trigger, so the loop does not
wait for the card every step.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import torch

from dinox_torch.train.anomaly import AnomalyDetector
from dinox_torch.train.checkpoint import CheckpointManager, CheckpointWedgedError
from dinox_torch.train.state import TrainConfig, TrainState
from dinox_torch.utils.logging import MetricLogger


class GracefulStop:
    """SIGINT -> finish the current step, checkpoint, return."""

    def __init__(self) -> None:
        self.stop = False
        self._prev = signal.signal(signal.SIGINT, self._handler)

    def _handler(self, signum, frame) -> None:  # noqa: ANN001
        print("interrupt=received, finishing step and checkpointing", flush=True)
        self.stop = True

    def restore(self) -> None:
        signal.signal(signal.SIGINT, self._prev)


def config_dict(cfg: TrainConfig) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    cfg: TrainConfig,
    state: TrainState,
    step_fn: Callable,
    batches: Iterable,
    *,
    run_dir: str | Path,
    max_steps: int,
    device: torch.device | str = "cuda",
    start_step: int = 0,
    ckpt_every: int = 100,
    ckpt_keep_last: int = 5,
    ckpt_timeout_s: float = 0.0,
    log_jsonl: bool = False,
    flush_max_steps: int = 64,
    flush_secs: float = 10.0,
    anomaly_spike_floor: float = 0.0,
    tensorboard: bool = True,
    loader_position: Optional[Callable[[], tuple[int, int]]] = None,
    on_step: Optional[Callable[[int, dict, TrainState], None]] = None,
    profile_steps: int = 0,
    profile_start: int = 2,
) -> TrainState:
    """Run the loop until *max_steps* optimizer steps (or SIGINT).

    *batches* yields objects with ``.pixels`` (accum, B, H, W, 3) uint16 and
    ``.spacing`` (accum, B, 3) float32, numpy arrays or tensors ((B, ...)
    arrays are lifted to accum = 1). *device* is the device *step_fn* runs
    on. With *profile_steps*, steps [start + profile_start, + profile_steps)
    run under ``torch.profiler`` and its trace lands in ``run_dir/profile``.
    Writes ``config.json``, ``metrics.jsonl`` (with *log_jsonl*),
    checkpoints under ``ckpt/`` and ``checkpoints.json`` (the checkpoint
    manager's ``stats``)."""
    device = torch.device(device)
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(config_dict(cfg), indent=2, default=str))

    ckpt = CheckpointManager(run_dir, keep_last=ckpt_keep_last, save_timeout_s=ckpt_timeout_s)
    logger = MetricLogger(run_dir, jsonl=log_jsonl, tensorboard=tensorboard)
    detector = AnomalyDetector(spike_floor=anomaly_spike_floor)
    stop = GracefulStop()

    it = iter(batches)
    samples_per_step = cfg.effective_batch_size
    t_last, n_since = time.monotonic(), 0
    data_wait_since = 0.0  # host time blocked in next(it) since the last flush
    step = start_step
    last_saved = -1
    pending: list[tuple[int, dict]] = []

    def save() -> None:
        nonlocal last_saved
        ckpt.save(step, state, config=config_dict(cfg),
                  loader_position=loader_position() if loader_position else None)
        last_saved = step

    def flush() -> None:
        nonlocal t_last, n_since, last_saved, data_wait_since
        if not pending:
            return
        try:
            keys = sorted(pending[0][1])
            for s, m in pending:
                if sorted(m) != keys:
                    raise RuntimeError(f"metric key set changed mid-buffer at step {s}: "
                                       f"{sorted(m)} vs {keys}")
            # One device -> host transfer for the whole buffer.
            stacked = torch.stack([torch.stack([torch.as_tensor(m[k], dtype=torch.float32,
                                                                 device=device) for k in keys])
                                   for _, m in pending]).cpu().numpy()
            for i, ((s, _m), row) in enumerate(zip(pending, stacked)):
                host = dict(zip(keys, row.tolist()))
                is_last = i == len(pending) - 1
                if is_last:
                    now = time.monotonic()  # after the transfer, which waited for the card
                    host["samples_per_s"] = n_since / max(now - t_last, 1e-9)
                    host["data_wait_frac"] = data_wait_since / max(now - t_last, 1e-9)
                    t_last, n_since, data_wait_since = now, 0, 0.0
                logger.log(s, host, force_stdout=is_last)
                severity, msg = detector.check(host["loss"], host.get("embed_std", 1.0))
                if severity == "fatal":
                    # The live state is at `step`, not at the buffered step s:
                    # save it under its own step, so a resume replays nothing.
                    ckpt.emergency_save(step, state, f"{msg} (detected at step {s})")
                    last_saved = step  # the final save must not collide
                    raise FloatingPointError(f"training anomaly at step {s}: {msg}")
                if severity == "warn":
                    print(f"anomaly_warn step={s} {msg}", flush=True)
        finally:
            # Cleared even on a raise: the final drain must not replay the
            # buffer (duplicate rows, a second emergency save).
            pending.clear()

    profile_at = step + profile_start if profile_steps > 0 else -1
    profiler = None

    try:
        while step < max_steps and not stop.stop:
            t_fetch = time.monotonic()
            batch = next(it)
            data_wait_since += time.monotonic() - t_fetch
            pixels, spacing = batch.pixels, batch.spacing
            if pixels.ndim == 4:  # lift (B, H, W, 3) -> (1, B, H, W, 3)
                pixels, spacing = pixels[None], spacing[None]

            if step == profile_at and profiler is None:
                _sync(device)  # trace only steady-state work
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.__enter__()
            state, metrics = step_fn(state, pixels, spacing)
            step += 1
            n_since += samples_per_step
            pending.append((step, metrics))

            if profiler is not None and step >= profile_at + profile_steps:
                _sync(device)
                profiler.__exit__(None, None, None)
                (run_dir / "profile").mkdir(exist_ok=True)
                profiler.export_chrome_trace(str(run_dir / "profile" / f"trace_step{profile_at}.json"))
                profiler = None
                print(f"profile trace written to {run_dir / 'profile'}", flush=True)

            if on_step is not None:
                on_step(step, metrics, state)

            due_ckpt = bool(ckpt_every and step % ckpt_every == 0)
            # Flush on the wall-clock cadence or when the buffer holds
            # flush_max_steps, which bounds how many steps a divergence can
            # run before the NaN check sees it.
            if (due_ckpt or step == max_steps or stop.stop or len(pending) >= flush_max_steps
                    or time.monotonic() - t_last >= flush_secs):
                flush()
            if due_ckpt:
                save()
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        try:
            flush()  # drain buffered metrics (may raise on a late anomaly)
        finally:
            if last_saved != step:  # the final checkpoint, unless one covered it
                save()
            ckpt.close()
            logger.close()
            stop.restore()
            (run_dir / "checkpoints.json").write_text(json.dumps(ckpt.stats))
    if ckpt.wedged:
        raise CheckpointWedgedError(f"checkpoint save watchdog fired; state at step {step} NOT saved")
    return state

