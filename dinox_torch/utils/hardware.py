"""Hardware detection and per-device tuning presets: the port's copy of
``dinox_tpu.utils.hardware`` on ``torch.cuda``. ``backend`` is "gpu" on the
card (``device_kind`` its name) and "cpu" when the caller asks for the CPU;
the loader-worker and batch-size rules are the JAX package's (gpu 64, cpu
8). On a mesh (``parallel.mesh``) the device and host counts are the
mesh's: one device per process, and the hosts its processes run on."""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from dinox_torch.utils.platform import resolve_device


@dataclass(frozen=True)
class HardwareConfig:
    backend: str  # "gpu" | "cpu"
    device_kind: str
    num_devices: int
    num_hosts: int
    host_cpus: int
    num_workers: int
    batch_size_recommendation: int


def detect_hardware(device: torch.device | str | None = None, mesh=None) -> HardwareConfig:
    """The preset for *device* (``cuda`` unless the caller asks for the CPU;
    raises without a card), or for *mesh* (its device, its process and host
    counts)."""
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    cpus = os.cpu_count() or 1
    if dev.type == "cuda":
        backend, kind, count, batch = "gpu", torch.cuda.get_device_name(dev), torch.cuda.device_count(), 64
    else:
        backend, kind, count, batch = "cpu", "cpu", 1, 8
    hosts = 1
    if mesh is not None:
        count, hosts = mesh.world, mesh.hosts
    return HardwareConfig(
        backend=backend,
        device_kind=kind,
        num_devices=count,
        num_hosts=hosts,
        host_cpus=cpus,
        num_workers=max(2, min(16, cpus - 1)),
        batch_size_recommendation=batch,
    )
