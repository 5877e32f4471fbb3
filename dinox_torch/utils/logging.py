"""Metric sinks: key=value stdout on a cadence, per-step JSON lines
(``metrics.jsonl``) and TensorBoard scalars (dropped quietly where
TensorBoard is absent). The port's copy of ``dinox_tpu.utils.logging``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(
        self,
        run_dir: str | Path,
        *,
        jsonl: bool = False,
        tensorboard: bool = True,
        stdout_every_s: float = 10.0,
        stdout: bool = True,
    ):
        self._stdout = stdout
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a") if jsonl else None
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.run_dir))
            except Exception:
                self._tb = None
        self._stdout_every = stdout_every_s
        self._last_stdout = 0.0

    def log(self, step: int, metrics: dict[str, Any], *, force_stdout: bool = False) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"train/{k}", v, step)
        now = time.monotonic()
        if self._stdout and (force_stdout or now - self._last_stdout >= self._stdout_every):
            kv = " ".join(f"{k}={v:.5g}" for k, v in sorted(scalars.items()))
            print(f"step={step} {kv}", flush=True)
            self._last_stdout = now

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
