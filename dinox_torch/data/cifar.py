"""CIFAR-10 data access for the non-medical control experiments: the
port's copy of ``dinox_tpu.data.cifar`` (numpy only; the same arrays, bit
for bit, for the same seed).

Loads the standard ``cifar-10-batches-py`` pickle layout if present (there
is no downloader); otherwise generates a deterministic synthetic 10-class
stand-in (coloured geometric textures), so the CIFAR control (pretrain ->
linear probe -> view retrieval, ``python -m
dinox_torch.baseline_cifar10_*``) runs end to end anywhere.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def _load_pickle_batches(root: Path) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    def read(name: str):
        with open(root / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d[b"labels"], np.int64)
        return x.astype(np.uint8), y

    xs, ys = zip(*(read(f"data_batch_{i}") for i in range(1, 6)))
    x_test, y_test = read("test_batch")
    return np.concatenate(xs), np.concatenate(ys), x_test, y_test


def synthetic_cifar(
    n_train: int = 5000, n_test: int = 1000, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """10 visually distinct classes: class-colored gradients + oriented
    stripes + noise. Learnable by a linear probe on decent features."""
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, 10, n)
        yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
        imgs = np.empty((n, 32, 32, 3), np.uint8)
        for i in range(n):
            c = int(y[i])
            hue = np.asarray([(c * 37) % 255, (c * 91) % 255, (c * 151) % 255], np.float32)
            angle = c * np.pi / 10 + rng.normal(0, 0.15)
            phase = rng.uniform(0, 2 * np.pi)
            stripes = np.sin((np.cos(angle) * xx + np.sin(angle) * yy) * (0.3 + 0.08 * c) + phase)
            img = hue[None, None, :] * (0.55 + 0.45 * stripes[..., None])
            img += rng.normal(0, 18, img.shape)
            imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        return imgs, y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return x_tr, y_tr, x_te, y_te


def load_cifar10(
    data_dir: str | Path | None = None, synthetic_sizes: tuple[int, int] = (5000, 1000)
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """(x_train, y_train, x_test, y_test, is_real)."""
    if data_dir is not None:
        root = Path(data_dir)
        if (root / "data_batch_1").exists():
            return *_load_pickle_batches(root), True
        nested = root / "cifar-10-batches-py"
        if (nested / "data_batch_1").exists():
            return *_load_pickle_batches(nested), True
    return *synthetic_cifar(*synthetic_sizes), False
