"""Training configuration, train state and optimizer: the counterpart of
``dinox_tpu.train.state``.

The state is the student, the teacher (a frozen copy of the student, moved
by EMA), the AdamW optimizer with its moments, the DINO centre and the step
counter. AdamW is ``torch.optim.AdamW`` with optax ``adamw``'s update:
b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled weight decay
on every parameter, and the LR of the schedule at the optimizer step (0 for
the first update). ``scale_lr_mult`` scales the LR, and so the decay, of
the ``scale_embed.*`` parameter group, as the JAX package's masked scale of
the final update does.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS, ModelConfig
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.ops.augment import AugConfig
from dinox_torch.train.schedule import get_lr
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.interop import jax_to_torch_student


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the same fields and defaults as the JAX
    package's TrainConfig (see there for what each means)."""

    model: ModelConfig = MODEL_CONFIGS["vit-small"]
    img_size: int = 224
    batch_size: int = 64  # global, per micro-batch
    accumulation_steps: int = 1
    lr: float = 1e-4
    min_lr: float = 1e-6
    warmup_steps: int = 2500
    weight_decay: float = 0.04
    max_steps: Optional[int] = None
    # DINO
    ema: float = 0.996
    teacher_temp: float = 0.04
    student_temp: float = 0.1
    center_momentum: float = 0.9
    loss_type: str = "dino"  # dino | simclr | mae
    gram_weight: float = 1.0
    koleo_weight: float = 0.0
    mae_mask_ratio: float = 0.75
    moe_aux_weight: float = 0.01
    # Augmentation
    crop_scale_min: float = 0.3
    crop_scale_max: float = 1.0
    # Scale pathway: LR multiplier of scale_embed, per-view lognormal spacing jitter.
    scale_lr_mult: float = 1.0
    spacing_jitter: float = 0.0
    pipeline_parallel: int = 1
    pp_microbatches: Optional[int] = None
    train_seed: int = 0
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"
    factored_nu: bool = False

    @property
    def effective_batch_size(self) -> int:
        return self.batch_size * self.accumulation_steps

    @property
    def aug(self) -> AugConfig:
        return AugConfig(img_size=self.img_size, crop_scale_min=self.crop_scale_min,
                         crop_scale_max=self.crop_scale_max)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def lr_at(self, step: int) -> float:
        return get_lr(step, self.max_steps, self.warmup_steps, self.lr, self.min_lr)


def reject_unported(cfg: TrainConfig) -> None:
    """Raise for the options the port does not have yet, naming the module
    of the port's plan that brings each."""
    for field, unported, module in (
            ("mu_dtype", cfg.mu_dtype != "float32", 11),
            ("nu_dtype", cfg.nu_dtype != "float32", 11),
            ("factored_nu", cfg.factored_nu, 11),
            ("loss_type", cfg.loss_type == "mae", 11),
            ("pipeline_parallel", cfg.pipeline_parallel > 1, 13)):
        if unported:
            raise NotImplementedError(f"{field}={getattr(cfg, field)!r} is not ported to dinox_torch "
                                      f"yet: module {module}")
    if cfg.loss_type not in ("dino", "simclr"):
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")


@dataclass
class TrainState:
    """The whole training state. ``step`` counts optimizer steps."""

    step: int
    student: DinoStudentTeacher
    teacher: DinoStudentTeacher
    optimizer: torch.optim.AdamW
    center: torch.Tensor


def make_optimizer(cfg: TrainConfig, student: DinoStudentTeacher) -> torch.optim.AdamW:
    """AdamW over the student's parameters in two groups: ``scale_embed.*``
    (``lr_mult = scale_lr_mult``) and the rest (``lr_mult = 1``). The train
    step sets each group's ``lr`` to the schedule's LR times its multiplier."""
    scale, rest = [], []
    for name, p in student.named_parameters():
        (scale if ".scale_embed." in f".{name}" else rest).append(p)
    groups = [{"params": rest, "lr_mult": 1.0}]
    if scale:
        groups.append({"params": scale, "lr_mult": cfg.scale_lr_mult})
    return torch.optim.AdamW(groups, lr=cfg.lr_at(0), betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def apply_gradients(cfg: TrainConfig, optimizer: torch.optim.AdamW,
                    params: list[torch.Tensor], grads: list[torch.Tensor], step: int) -> None:
    """One AdamW update of *params* (the optimizer's, in order) from *grads*
    at the schedule's LR for optimizer step *step*."""
    lr = cfg.lr_at(step)
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


def _model_config(cfg: TrainConfig) -> ModelConfig:
    return cfg.model.replace(img_size=cfg.img_size)


def _teacher_of(student: DinoStudentTeacher) -> DinoStudentTeacher:
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    return teacher.eval()


def create_train_state(cfg: TrainConfig, seed: int = 0,
                       device: torch.device | str | None = None) -> TrainState:
    """A fresh state: the student's parameters from *seed*, the teacher a
    frozen copy of it, the centre zeros (1, out_dim). On the card unless
    *device* is ``"cpu"``."""
    reject_unported(cfg)
    dev = resolve_device(device)
    student = DinoStudentTeacher(_model_config(cfg), generator=torch.Generator().manual_seed(seed),
                                 device=dev).train()
    return TrainState(step=0, student=student, teacher=_teacher_of(student),
                      optimizer=make_optimizer(cfg, student),
                      center=torch.zeros((1, cfg.model.out_dim), dtype=torch.float32, device=dev))


def _tensors(tree: Mapping[str, Any], dev: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v, device=dev) for k, v in jax_to_torch_student(tree).items()}


def state_from_jax(cfg: TrainConfig, tree: Mapping[str, Any],
                   device: torch.device | str | None = None) -> TrainState:
    """The port's state from a JAX-package state given as numpy: a mapping
    with ``step``, ``student`` and ``teacher`` (parameter trees), ``center``,
    and the AdamW moments ``mu`` and ``nu`` (trees shaped like the student)
    with their ``count``. Both packages then start from the same state."""
    reject_unported(cfg)
    dev = resolve_device(device)
    student = DinoStudentTeacher(_model_config(cfg), device=dev).train()
    student.load_state_dict(_tensors(tree["student"], dev), strict=True)
    teacher = _teacher_of(student)
    teacher.load_state_dict(_tensors(tree["teacher"], dev), strict=True)
    opt = make_optimizer(cfg, student)
    mu, nu = _tensors(tree["mu"], dev), _tensors(tree["nu"], dev)
    count = int(np.asarray(tree["count"]))
    for name, p in student.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
    center = torch.tensor(np.asarray(tree["center"], np.float32), device=dev)
    return TrainState(step=int(np.asarray(tree["step"])), student=student, teacher=teacher,
                      optimizer=opt, center=center)
