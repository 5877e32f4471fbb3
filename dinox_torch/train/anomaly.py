"""Training anomaly detection: the port's ``dinox_tpu.train.anomaly``.

- NaN/Inf loss       -> fatal (the caller saves an emergency checkpoint and
                        raises)
- loss spike         -> warning when loss > spike_factor x the trailing mean
                        over ``window`` steps AND loss - mean > spike_floor
                        (an absolute headroom: at a converged loss scale a
                        relative threshold alone fires on small jitter)
- embedding collapse -> warning when the CLS embedding std < collapse_std

The trailing window holds ``window`` losses (the JAX detector keeps 10
whatever ``window`` says; at ``window=10`` the two agree).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field


@dataclass
class AnomalyDetector:
    window: int = 10
    spike_factor: float = 2.0
    spike_floor: float = 0.0
    collapse_std: float = 0.01
    _history: deque = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._history = deque(maxlen=self.window)

    def check(self, loss: float, embed_std: float) -> tuple[str, str]:
        """Returns (severity, message); severity in {"ok", "warn", "fatal"}."""
        if not math.isfinite(loss):
            return "fatal", f"non-finite loss: {loss}"
        verdict: tuple[str, str] = ("ok", "")
        if len(self._history) >= self.window:
            mean = sum(self._history) / len(self._history)
            if (mean > 0 and loss > self.spike_factor * mean
                    and loss - mean > self.spike_floor):
                verdict = ("warn", f"loss spike: {loss:.4f} > {self.spike_factor}x mean {mean:.4f}")
        if embed_std < self.collapse_std:
            verdict = ("warn", f"possible collapse: embed_std {embed_std:.5f} < {self.collapse_std}")
        self._history.append(loss)
        return verdict
