"""What the drivers share: synchronising the device, freeing it, and the
set-up's phase times."""

from __future__ import annotations

import gc
import sys
import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """Seconds of each named phase of set-up, printed to standard error."""

    def __init__(self, device: torch.device):
        self.device, self.at, self.seen = device, time.perf_counter(), []

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seen.append(f"{name} {now - self.at:.3f}")
        self.at = now

    def report(self) -> None:
        print("setup phases (s): " + ", ".join(self.seen), file=sys.stderr)
