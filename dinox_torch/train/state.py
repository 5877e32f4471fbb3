"""Training configuration, train state and optimizer: the counterpart of
``dinox_tpu.train.state``.

The state is the student, the teacher (a frozen copy of the student, moved
by EMA), the AdamW optimizer with its moments, the DINO centre and the step
counter. AdamW is ``torch.optim.AdamW`` with optax ``adamw``'s update:
b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled weight decay
on every parameter, and the LR of the schedule at the optimizer step (0 for
the first update). ``scale_lr_mult`` scales the LR, and so the decay, of
the ``scale_embed.*`` parameter group, as the JAX package's masked scale of
the final update does. ``mu_dtype``/``nu_dtype`` other than float32 and
``factored_nu`` take the optimizers of ``train.optim`` (the JAX package's
choice of optax chain for each), with the same groups.

For ``loss_type="mae"`` the student is a ``models.mae.MaeModel``
({encoder, decoder}); the teacher is its unused frozen copy, kept so that
the state has one shape for every objective, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch

from dinox_torch.models.config import MODEL_CONFIGS, ModelConfig
from dinox_torch.models.mae import MaeModel
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.ops.augment import AugConfig
from dinox_torch.parallel.mesh import Mesh, shard_state
from dinox_torch.parallel.pipeline import merge_model_params
from dinox_torch.train.optim import DTYPES, build_adam
from dinox_torch.train.schedule import get_lr
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.interop import jax_layout, jax_to_torch_mae, jax_to_torch_student


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
    """Raise for unknown option values (every option of the JAX package's
    TrainConfig is ported)."""
    if cfg.loss_type not in ("dino", "simclr", "mae"):
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
    for field in ("mu_dtype", "nu_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise ValueError(f"{field} must be one of {sorted(DTYPES)}, got {getattr(cfg, field)!r}")


Student = DinoStudentTeacher | MaeModel


@dataclass
class TrainState:
    """The whole training state. ``step`` counts optimizer steps."""

    step: int
    student: Student
    teacher: Student
    optimizer: torch.optim.Optimizer
    center: torch.Tensor


def make_optimizer(cfg: TrainConfig, student: Student) -> torch.optim.Optimizer:
    """The optimizer over the student's parameters in two groups:
    ``scale_embed.*`` (``lr_mult = scale_lr_mult``) and the rest
    (``lr_mult = 1``). The train step sets each group's ``lr`` to the
    schedule's LR times its multiplier. ``torch.optim.AdamW`` for float32
    moments; ``train.optim`` 's optimizers for the moment options (the
    factored one over each parameter's JAX-package layout)."""
    scale, rest = [], []
    for name, p in student.named_parameters():
        (scale if ".scale_embed." in f".{name}" else rest).append(p)
    groups = [{"params": rest, "lr_mult": 1.0}]
    if scale:
        groups.append({"params": scale, "lr_mult": cfg.scale_lr_mult})
    layouts = {p: jax_layout(name, p.ndim) for name, p in student.named_parameters()}
    return build_adam(groups, cfg.lr_at(0), cfg.weight_decay, cfg.mu_dtype, cfg.nu_dtype,
                      cfg.factored_nu, layouts)


def apply_gradients(cfg: TrainConfig, optimizer: torch.optim.Optimizer,
                    params: list[torch.Tensor], grads: list[torch.Tensor], step: int) -> None:
    """One update of *params* (the optimizer's, in order) from *grads* at
    the schedule's LR for optimizer step *step*."""
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


def _teacher_of(student: Student) -> Student:
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    return teacher.eval()


def _student(cfg: TrainConfig, dev: torch.device, seed: int = 0) -> Student:
    g = torch.Generator().manual_seed(seed)
    if cfg.loss_type == "mae":
        return MaeModel(_model_config(cfg), mask_ratio=cfg.mae_mask_ratio, generator=g,
                        device=dev).train()
    return DinoStudentTeacher(_model_config(cfg), generator=g, device=dev).train()


def _device(device: torch.device | str | None, mesh: Optional[Mesh]) -> torch.device:
    return resolve_device(mesh.device if device is None and mesh is not None else device)


def create_train_state(cfg: TrainConfig, seed: int = 0,
                       device: torch.device | str | None = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state: the student's parameters from *seed*, the teacher a
    frozen copy of it, the centre zeros (1, out_dim). On the card unless
    *device* is ``"cpu"`` (the mesh's device by default). On a *mesh* the
    full state is built from the seed on every rank, as one process builds
    it, then cut to this rank's shard (``parallel.mesh.shard_state``)."""
    reject_unported(cfg)
    dev = _device(device, mesh)
    student = _student(cfg, dev, seed)
    state = TrainState(step=0, student=student, teacher=_teacher_of(student),
                       optimizer=make_optimizer(cfg, student),
                       center=torch.zeros((1, cfg.model.out_dim), dtype=torch.float32, device=dev))
    return state if mesh is None else shard_state(state, mesh)


def _to_torch(cfg: TrainConfig):
    """The interop of the student's tree: the MAE model's or the DINO student's."""
    return jax_to_torch_mae if cfg.loss_type == "mae" else jax_to_torch_student


def _tensors(cfg: TrainConfig, tree: Mapping[str, Any], dev: torch.device,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v, device=dev).to(dtype) for k, v in _to_torch(cfg)(tree).items()}


def state_from_jax(cfg: TrainConfig, tree: Mapping[str, Any],
                   device: torch.device | str | None = None,
                   mesh: Optional[Mesh] = None) -> TrainState:
    """The port's state from a JAX-package state given as numpy: a mapping
    with ``step``, ``student`` and ``teacher`` (parameter trees), ``center``,
    and the Adam moments ``mu`` and ``nu`` (trees shaped like the student)
    with their ``count``. Both packages then start from the same state.

    For ``factored_nu`` the ``nu`` tree holds JAX's ``{"r", "c"}`` for a
    parameter of two or more axes: they become ``exp_avg_sq_r`` and
    ``exp_avg_sq_c`` unchanged, since the port factors each parameter over
    the trailing axes of its JAX layout (``train.optim.AdamFactored``; for a
    dense weight the port's ``(out, in)`` rows are JAX's columns, so JAX's
    ``r`` runs along the port's input axis). Moments are stored in
    ``mu_dtype``/``nu_dtype``. On a *mesh* the state is then cut to this
    rank's shard, as :func:`create_train_state` cuts it.

    A JAX pipeline-parallel state (``dinox_tpu.train.pp_step``: each tree
    ``{"rest", "blocks"}`` with ``(S, blocks_per_stage, ...)`` block leaves)
    is merged into the one-device layout first
    (``parallel.pipeline.merge_model_params``). Its factored nu is refused:
    the JAX PP state factors each stacked block leaf, so a stage's 1-D
    parameters get ``r``/``c`` factors across its blocks where the
    one-device state keeps them whole (a fault of that package)."""
    reject_unported(cfg)
    if isinstance(tree["student"], Mapping) and set(tree["student"]) == {"rest", "blocks"}:
        if cfg.factored_nu:
            raise ValueError("the JAX pipeline-parallel state's factored nu is factored across the "
                             "stacked (S, blocks_per_stage, ...) block leaves, so a stage's 1-D "
                             "parameters carry r/c factors over its blocks where the one-device "
                             "state keeps each moment whole; dinox_torch does not carry it across")
        tree = {**tree, **{k: merge_model_params(tree[k]) for k in ("student", "teacher", "mu", "nu")}}
    dev = _device(device, mesh)
    student = _student(cfg, dev)
    student.load_state_dict(_tensors(cfg, tree["student"], dev), strict=True)
    teacher = _teacher_of(student)
    teacher.load_state_dict(_tensors(cfg, tree["teacher"], dev), strict=True)
    opt = make_optimizer(cfg, student)
    mu = _tensors(cfg, tree["mu"], dev, DTYPES[cfg.mu_dtype])
    count = torch.tensor(float(int(np.asarray(tree["count"]))))
    if cfg.factored_nu:
        nu, factors = _factored_nu(cfg, tree["nu"], dev)
    else:
        nu, factors = _tensors(cfg, tree["nu"], dev, DTYPES[cfg.nu_dtype]), {}
    for name, p in student.named_parameters():
        st = {"step": count.clone(), "exp_avg": mu[name]}
        if name in factors:
            st["exp_avg_sq_r"], st["exp_avg_sq_c"] = factors[name]
        else:
            st["exp_avg_sq"] = nu[name]
        opt.state[p] = st
    center = torch.tensor(np.asarray(tree["center"], np.float32), device=dev)
    state = TrainState(step=int(np.asarray(tree["step"])), student=student, teacher=teacher,
                       optimizer=opt, center=center)
    return state if mesh is None else shard_state(state, mesh)


def _factored_nu(cfg: TrainConfig, tree: Mapping[str, Any], dev: torch.device
                 ) -> tuple[dict[str, torch.Tensor], dict[str, tuple[torch.Tensor, torch.Tensor]]]:
    """A JAX factored nu tree -> (the full nu of the other parameters, {name:
    (r, c)} of the factored ones), by the port's parameter names. The names
    come from the interop run on a tree whose leaves are their indices
    (arrays of ones in every axis, which every transpose leaves as they are)."""
    leaves: list[Any] = []

    def mark(node: Any) -> Any:
        if isinstance(node, Mapping) and set(node) != {"r", "c"}:
            return {k: mark(v) for k, v in node.items()}
        leaves.append(node)
        ndim = np.ndim(node["r"]) + 1 if isinstance(node, Mapping) else np.ndim(node)
        return np.full((1,) * ndim, len(leaves) - 1, np.float32)

    full, factors = {}, {}
    for name, index in _to_torch(cfg)(mark(tree)).items():
        leaf = leaves[int(index.reshape(-1)[0])]
        if isinstance(leaf, Mapping):
            factors[name] = tuple(torch.tensor(np.asarray(leaf[k], np.float32), device=dev)
                                  for k in ("r", "c"))
        else:
            full[name] = torch.tensor(np.asarray(leaf, np.float32), device=dev)
    return full, factors
