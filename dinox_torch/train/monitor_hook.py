"""In-loop training monitor: attention-energy previews and collapse stats,
the port's ``dinox_tpu.train.monitor_hook``.

Every ``every`` optimizer steps :meth:`TrainingMonitor.maybe_snapshot`
embeds a fixed probe batch with the *current* student backbone (the MAE
student's encoder), under ``torch.no_grad()`` on the backbone's device
(one forward: kernel 1 depth times on the card), and writes into
``run_dir/monitor/``:

* ``health.jsonl``: ``step``, ``embed_std`` (mean per-dim std of CLS over
  the probe), ``gram_mean`` (mean of the first four images' patch Gram
  matrices), ``collapse_warning`` (``embed_std < 0.01``), ``timestamp``;
* ``step_%07d.png``: the first probe image's channel 1 (min-max scaled to
  8 bits, resized to 192 px with PIL's default bicubic) next to its patch
  tokens' L2-norm map (min-max scaled, resized to 192 px nearest), with a
  4 px white gap: a mode "L" PNG of the port's own writer
  (``data.png8``).

TensorBoard images and scalars are written when ``torch.utils.tensorboard``
imports; it is imported here, lazily, and its absence is quiet.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from dinox_torch.data.png8 import resize_bicubic, resize_nearest, write_png8
from dinox_torch.models.config import ModelConfig
from dinox_torch.ops.augment import eval_transform
from dinox_torch.train.losses import gram_matrix

PREVIEW = 192  # px per half of the preview
GAP = 4


def _unit_range(x: np.ndarray) -> np.ndarray:
    return (x - x.min()) / max(float(np.ptp(x)), 1e-9)


def preview(pixels: np.ndarray, patch_tokens: np.ndarray, side: int) -> np.ndarray:
    """(H, W, 3) uint16 probe image and its (side^2, D) patch tokens -> the
    (192, 388) uint8 preview: input | attention energy."""
    energy = _unit_range(np.linalg.norm(patch_tokens, axis=-1).reshape(side, side))
    heat = resize_nearest((energy * 255).astype(np.uint8), (PREVIEW, PREVIEW))
    raw = _unit_range(np.asarray(pixels[:, :, 1], np.float32))
    inp = resize_bicubic((raw * 255).astype(np.uint8), (PREVIEW, PREVIEW))
    combo = np.full((PREVIEW, 2 * PREVIEW + GAP), 255, np.uint8)
    combo[:, :PREVIEW] = inp
    combo[:, PREVIEW + GAP:] = heat
    return combo


def backbone_of(student: nn.Module) -> Optional[nn.Module]:
    """The PatchViT of a DINO student (``backbone``) or an MAE one (``encoder``)."""
    return getattr(student, "backbone", getattr(student, "encoder", None))


class TrainingMonitor:
    def __init__(self, run_dir: str | Path, model_cfg: ModelConfig, probe_pixels: np.ndarray,
                 probe_spacing: np.ndarray, every: int = 1000, tensorboard: bool = True,
                 writes: bool = True):
        """*writes* False: the snapshot's forward runs (a rank of a mesh
        takes part in its collectives) and nothing is written."""
        self.dir = Path(run_dir) / "monitor"
        self.writes = writes
        if writes:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._tb = None
        if tensorboard and writes:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(Path(run_dir)))
            except Exception:
                self._tb = None
        self.cfg = model_cfg
        self.every = every
        self._pixels = np.asarray(probe_pixels)
        self._spacing = np.asarray(probe_spacing, np.float32)

    @torch.no_grad()
    def embed(self, backbone: nn.Module) -> np.ndarray:
        """All tokens of the probe batch, float32 numpy."""
        dev = next(backbone.parameters()).device
        x = eval_transform(torch.as_tensor(self._pixels, device=dev), img_size=self.cfg.img_size)
        sp = torch.as_tensor(self._spacing, device=dev) if backbone.cfg.scale_aware else None
        return backbone(x, sp).float().cpu().numpy()

    def maybe_snapshot(self, step: int, student: nn.Module) -> Optional[dict]:
        if self.every <= 0 or step % self.every:
            return None
        backbone = backbone_of(student)
        if backbone is None:
            return None
        feats = self.embed(backbone)
        if not self.writes:
            return None
        cls = feats[:, 0]
        n_patches = (self.cfg.img_size // self.cfg.patch) ** 2
        patches = feats[:, 1:1 + n_patches]
        gram = gram_matrix(torch.from_numpy(patches[:min(4, len(patches))])).numpy()
        stats = {
            "step": step,
            "embed_std": float(cls.std(axis=0).mean()),
            "gram_mean": float(gram.mean()),
            "collapse_warning": bool(cls.std(axis=0).mean() < 0.01),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        with open(self.dir / "health.jsonl", "a") as f:
            f.write(json.dumps(stats) + "\n")
        combo = preview(self._pixels[0], patches[0], self.cfg.img_size // self.cfg.patch)
        write_png8(self.dir / f"step_{step:07d}.png", combo)
        if self._tb is not None:
            self._tb.add_image("monitor/input_vs_attention", combo, step, dataformats="HW")
            g0 = _unit_range(gram[0])
            self._tb.add_image("monitor/gram", (g0 * 255).astype(np.uint8), step, dataformats="HW")
            self._tb.add_scalar("monitor/embed_std", stats["embed_std"], step)
            self._tb.add_scalar("monitor/gram_mean", stats["gram_mean"], step)
            self._tb.flush()
        return stats
