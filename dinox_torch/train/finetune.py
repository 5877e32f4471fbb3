"""Downstream supervised fine-tuning: a LoRA backbone and a task head. The
port's ``dinox_tpu.train.finetune``.

Labeled-CSV data (16-bit PNGs through the port's own decoder and canvas
resize), one training view per sample (the fixed window, RandomResizedCrop
0.7-1.0, flip) and the eval transform for prediction, a classification or
regression head on the CLS token kept outside the adapter, optional
unfreezing of the last K blocks at their own LR, rank AUROC / macro-F1 /
R^2 metrics, early stopping, and the saved files of the JAX package.

The optimizer is ``torch.optim.AdamW`` with optax ``adamw``'s update, in two
parameter groups: the adapter factors and the head at ``lr``, the unfrozen
blocks at ``backbone_lr``. Every other parameter has ``requires_grad=False``,
so no weight gradient of a frozen layer is computed (the JAX package
computes them and zeroes the updates). Both groups follow optax's
``warmup_cosine_decay_schedule(0, peak, warmup, total)`` evaluated at the
update count before the update, so the first update has LR 0.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

from dinox_torch.data.hu import EVAL_LEVEL, EVAL_WIDTH
from dinox_torch.data.pipeline import _read_png_u16, _to_canvas
from dinox_torch.evaluation.embedder import prefetched_batches
from dinox_torch.evaluation.linear import rank_auroc
from dinox_torch.ops.augment import AugConfig, augment_views, eval_transform
from dinox_torch.utils.rng import seeded_generator
from dinox_torch.zoo.peft import LoraModel, save_adapter

# -- labeled data -----------------------------------------------------------


@dataclass
class LabeledRow:
    image_path: str
    label: float
    spacing_x: float = 1.0
    spacing_y: float = 1.0
    spacing_z: float = 1.0


def load_labeled_csv(path: str | Path, task: str = "classification") -> list[LabeledRow]:
    """CSV with columns image_path,label[,spacing_x,spacing_y,spacing_z].

    Classification labels must be integers >= 0; regression labels floats."""
    rows: list[LabeledRow] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        if "image_path" not in cols or "label" not in cols:
            raise ValueError(f"{path}: need image_path,label columns, got {cols}")
        has_spacing = all(c in cols for c in ("spacing_x", "spacing_y", "spacing_z"))
        for rec in reader:
            label = float(rec["label"])
            if task == "classification" and label != int(label):
                raise ValueError(f"non-integer classification label: {rec['label']}")
            row = LabeledRow(image_path=rec["image_path"], label=label)
            if has_spacing:
                row.spacing_x = float(rec["spacing_x"])
                row.spacing_y = float(rec["spacing_y"])
                row.spacing_z = float(rec["spacing_z"])
            rows.append(row)
    return rows


def iter_labeled_batches(rows: list[LabeledRow], batch_size: int, *, shuffle: bool, seed: int,
                         canvas: int = 512, epochs: Optional[int] = None
                         ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yields (pixels uint16 (B, canvas, canvas, 3), spacing (B, 3), labels (B,)).

    A single slice replicated to 3 channels; the epoch order is a
    permutation from (seed, epoch); a partial last batch wraps around. A
    thread pool decodes the slices a batch ahead
    (``evaluation.embedder.prefetched_batches``)."""

    def chunks() -> Iterator[np.ndarray]:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = (np.random.default_rng((seed, epoch)).permutation(len(rows)) if shuffle
                     else np.arange(len(rows)))
            for start in range(0, len(order), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) < batch_size:
                    idx = np.concatenate([idx, order[:batch_size - len(idx)]])
                yield idx
            epoch += 1

    def load(i: int) -> np.ndarray:
        plane = _to_canvas(_read_png_u16(rows[i].image_path), canvas)
        return np.stack([plane, plane, plane], axis=-1)

    for idx, pixels in prefetched_batches(load, chunks()):
        spacing = np.asarray([[rows[i].spacing_x, rows[i].spacing_y, rows[i].spacing_z]
                              for i in idx], np.float32)
        labels = np.asarray([rows[i].label for i in idx], np.float32)
        yield pixels, spacing, labels


def finetune_train_aug(img_size: int, level: float = EVAL_LEVEL, width: float = EVAL_WIDTH
                       ) -> AugConfig:
    """The fixed HU window (scaled deci-HU; the L=40/W=400 soft-tissue window
    by default), RandomResizedCrop(0.7-1.0) and flip, one view."""
    return AugConfig(img_size=img_size, level_min=level, level_max=level, width_min=width,
                     width_max=width, crop_scale_min=0.7, crop_scale_max=1.0, n_views=1)


# -- model + step -----------------------------------------------------------


@dataclass(frozen=True)
class FinetuneConfig:
    task: str = "classification"  # classification | regression
    num_classes: int = 2
    rank: int = 8
    alpha: float = 16.0
    lora_dropout: float = 0.05
    lr: float = 1e-4
    backbone_lr: float = 1e-5  # for unfrozen blocks
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    unfreeze_blocks: int = 0
    batch_size: int = 32
    seed: int = 0
    es_metric: str = "loss"  # loss | accuracy | auroc | macro_f1 | r2
    es_patience: int = 5
    window_level: float = EVAL_LEVEL  # scaled deci-HU (lung: -30)
    window_width: float = EVAL_WIDTH  # scaled deci-HU (lung: 120)


class Head(nn.Module):
    """The task head on the CLS token: float32 ``cls @ W^T + b``; W (out, dim)
    is the layout of ``head.pth``."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, dim))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, cls: torch.Tensor) -> torch.Tensor:
        return cls.float() @ self.weight.t() + self.bias


def init_head(cfg: FinetuneConfig, dim: int, generator: Optional[torch.Generator] = None,
              device: torch.device | str | None = None) -> Head:
    """A head with flax's ``lecun_normal`` kernel (a normal truncated at two
    standard deviations, scaled to variance 1 / dim), drawn on the CPU from
    *generator* (seed 0 when None), and a zero bias."""
    head = Head(dim, 1 if cfg.task == "regression" else cfg.num_classes)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    std = math.sqrt(1.0 / dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(head.weight, std=std, a=-2 * std, b=2 * std, generator=g)
    return head.to(device) if device is not None else head


def unfrozen_block_start(cfg: FinetuneConfig, depth: int) -> int:
    """Index of the first block that trains at ``backbone_lr`` (``depth`` when none)."""
    return depth - min(cfg.unfreeze_blocks, depth) if cfg.unfreeze_blocks > 0 else depth


def _in_unfrozen_block(name: str, start: int) -> bool:
    parts = name.split(".")
    return parts[0] == "blocks" and int(parts[1]) >= start


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int, total_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps)`` at update *count*, in float32 and in optax's order of
    operations: ``-peak * (1 - count / warmup) + peak`` over the warmup, then
    ``peak * 0.5 * (1 + cos(pi * t / decay))`` with t the count past the
    warmup, capped at ``decay = total_steps - warmup_steps`` (> 0)."""
    f32 = np.float32
    if count < warmup_steps:
        frac = f32(1.0) - f32(count) / f32(warmup_steps)
        return float(f32(-peak) * frac + f32(peak))
    decay = f32(total_steps - warmup_steps)
    t = min(f32(count - warmup_steps), decay)
    cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / decay))
    return float(f32(peak) * cosine)


def make_finetune_optimizer(cfg: FinetuneConfig, model: LoraModel, head: Head
                            ) -> torch.optim.AdamW:
    """AdamW over the adapter factors and the head (``lr``) and the last
    ``unfreeze_blocks`` blocks' other parameters (``backbone_lr``); sets
    ``requires_grad=False`` on every other backbone parameter."""
    start = unfrozen_block_start(cfg, model.cfg.depth)
    adapter, unfrozen = [], []
    for name, p in model.named_parameters():
        if name.endswith((".lora_A.weight", ".lora_B.weight")):
            adapter.append(p)
        elif _in_unfrozen_block(name, start):
            unfrozen.append(p)
        else:
            p.requires_grad_(False)
            continue
        p.requires_grad_(True)
    groups = [{"params": adapter + list(head.parameters()), "peak_lr": cfg.lr}]
    if unfrozen:
        groups.append({"params": unfrozen, "peak_lr": cfg.backbone_lr})
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _total_steps(cfg: FinetuneConfig) -> int:
    return max(cfg.total_steps, cfg.warmup_steps + 1)


def finetune_loss(model: LoraModel, head: Head, x: torch.Tensor, spacing, labels: torch.Tensor,
                  task: str) -> torch.Tensor:
    """Mean softmax cross-entropy (classification) or MSE (regression) of
    the head on the CLS token of *x*'s differentiable forward."""
    feats = model(x, spacing if model.scale_aware else None)
    logits = head(feats[:, 0])
    if task == "classification":
        return torch.nn.functional.cross_entropy(logits, labels.long())
    return torch.mean((logits[:, 0] - labels) ** 2)


@dataclass
class FinetuneState:
    model: LoraModel
    head: Head
    optimizer: torch.optim.AdamW
    step: int = 0


def build_finetune_step(state: FinetuneState, cfg: FinetuneConfig,
                        augment_fn: Optional[Callable] = None
                        ) -> tuple[Callable, Callable]:
    """(step_fn, predict_fn) on the model's device.

    ``step_fn(pixels, spacing, labels) -> loss`` (0-d float32 tensor on the
    device) makes one update of *state* in place: the training view of
    pixels (uint16 (B, H, W, 3)) from a generator of (seed, step), LoRA
    dropout from another on the device, the loss, its gradients, AdamW at
    the schedule's LR. ``predict_fn(pixels, spacing) -> logits`` (float32,
    on the device) runs the eval transform and the forward without
    gradients.

    *augment_fn(pixels, generator, aug_cfg) -> (n_views, B, S, S, 3)*
    defaults to :func:`augment_views`."""
    model, head = state.model, state.head
    dev = model.device
    aug = finetune_train_aug(model.img_size, cfg.window_level, cfg.window_width)
    augment = augment_views if augment_fn is None else augment_fn
    total = _total_steps(cfg)

    def step_fn(pixels, spacing, labels) -> torch.Tensor:
        pixels = torch.as_tensor(pixels, device=dev)
        spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=dev)
        model.train()
        model.set_lora_generator(seeded_generator(cfg.seed, state.step, 1, device=dev))
        x = augment(pixels, seeded_generator(cfg.seed, state.step, 0), aug)[0]
        loss = finetune_loss(model, head, x, spacing, labels, cfg.task)
        for group in state.optimizer.param_groups:
            group["lr"] = warmup_cosine_lr(state.step, group["peak_lr"], cfg.warmup_steps, total)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        model.eval()
        return loss.detach()

    @torch.no_grad()
    def predict_fn(pixels, spacing) -> torch.Tensor:
        pixels = torch.as_tensor(pixels, device=dev)
        x = eval_transform(pixels, img_size=model.img_size, level=cfg.window_level,
                           width=cfg.window_width)
        sp = torch.as_tensor(spacing, dtype=torch.float32, device=dev) if model.scale_aware else None
        model.eval()
        return head(model(x, sp)[:, 0])

    return step_fn, predict_fn


# -- metrics ----------------------------------------------------------------


def compute_metrics(logits: np.ndarray, targets: np.ndarray, task: str, num_classes: int
                    ) -> dict[str, float]:
    out: dict[str, float] = {}
    if task == "classification":
        t = targets.astype(np.int64)
        pred = logits.argmax(axis=-1)
        out["accuracy"] = float((pred == t).mean()) if len(t) else 0.0
        if num_classes == 2:
            z = logits - logits.max(axis=-1, keepdims=True)
            probs = np.exp(z)
            probs /= probs.sum(axis=-1, keepdims=True)
            out["auroc"] = rank_auroc(probs[:, 1], t)
        f1s = []
        for c in range(num_classes):
            if not (t == c).any():
                continue
            tp = float(((pred == c) & (t == c)).sum())
            fp = float(((pred == c) & (t != c)).sum())
            fn = float(((pred != c) & (t == c)).sum())
            prec = tp / (tp + fp + 1e-8)
            rec = tp / (tp + fn + 1e-8)
            f1s.append(2 * prec * rec / (prec + rec + 1e-8))
        out["macro_f1"] = float(np.mean(f1s)) if f1s else 0.0
    else:
        p = logits[:, 0]
        mse = float(np.mean((p - targets) ** 2))
        out["mse"] = mse
        out["rmse"] = float(np.sqrt(mse))
        ss_tot = float(((targets - targets.mean()) ** 2).sum())
        out["r2"] = 1.0 - float(((p - targets) ** 2).sum()) / ss_tot if ss_tot > 1e-8 else 0.0
    return out


# -- early stopping ---------------------------------------------------------


@dataclass
class EarlyStopper:
    metric: str = "loss"
    patience: int = 5
    best: float = field(default=float("inf"))
    bad_epochs: int = 0

    def _score(self, metrics: dict[str, float]) -> float:
        v = metrics[self.metric]
        return v if self.metric in ("loss", "mse", "rmse") else -v  # lower better

    def update(self, metrics: dict[str, float]) -> tuple[bool, bool]:
        """Returns (improved, should_stop)."""
        s = self._score(metrics)
        if s < self.best - 1e-9:
            self.best = s
            self.bad_epochs = 0
            return True, False
        self.bad_epochs += 1
        return False, self.bad_epochs >= self.patience


# -- save -------------------------------------------------------------------


def save_finetune(model: LoraModel, head: Head, cfg: FinetuneConfig, output_dir: str | Path
                  ) -> Path:
    """The adapter (HF peft format), ``head.pth`` ({"weight" (out, dim),
    "bias"}), ``unfrozen_blocks.pth`` (the unfrozen blocks' weights without
    their factors, timm-style keys, when any) and ``finetune_config.json``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_adapter(model, out)

    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32).contiguous().clone()

    torch.save({"weight": cpu(head.weight), "bias": cpu(head.bias)}, out / "head.pth")
    start = unfrozen_block_start(cfg, model.cfg.depth)
    if start < model.cfg.depth:
        torch.save({k: cpu(v) for k, v in model.state_dict().items()
                    if _in_unfrozen_block(k, start) and ".lora_" not in k},
                   out / "unfrozen_blocks.pth")
    (out / "finetune_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    return out
