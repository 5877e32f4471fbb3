"""The pipeline-parallel training step on a ``(data, pipe)`` mesh: the
counterpart of ``dinox_tpu.train.pp_step``.

The semantics of ``train.step``: on-card two-view augmentation, student
and teacher forwards, DINO + Gram + KoLeo (or SimCLR), AdamW, the teacher
EMA. The block stack runs as ``parallel.pipeline``'s GPipe schedule over
one process per stage; stage 0 embeds its data rank's rows (the patch
embedding, CLS, positions, the scale token, registers) and the last stage
finalizes them (the final norm and the head) and takes the losses on the
whole batch, with the global-batch statistics of ``train.losses`` over its
data group, exactly as the step without a pipe axis.

Each rank holds the rest whole and its stage's blocks, in the student, the
teacher and the optimizer (``parallel.mesh.shard_state``). After the
backward a rank's rest gradients are summed over the pipe group (the
embedding's come from stage 0, the norm's and head's from the last stage,
zeros elsewhere), then every gradient is averaged over the stage's data
group. ``grad_norm`` counts each block once and the rest once. The centre
and the metrics come from the last stage, broadcast over the pipe group.
AdamW and the EMA run on each rank's own tensors.

Scope, as the reference's: DINO and SimCLR, ``accumulation_steps == 1``
(the microbatches play accumulation's memory role), no LoRA, dense blocks;
the stage blocks run ``attn_impl="xla"`` without the fused half-blocks
(``parallel.pipeline.cut_to_stage``) whatever the model config says.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dinox_torch.ops.augment import augment_views
from dinox_torch.parallel.collectives import all_reduce, all_reduce_bucket, broadcast
from dinox_torch.parallel.mesh import Mesh, shard_state
from dinox_torch.parallel.pipeline import (
    check_microbatches,
    pipeline_run_blocks,
    pp_param_spec,
    stage_blocks,
)
from dinox_torch.train.schedule import get_lr_tensor
from dinox_torch.train.state import (
    Student,
    TrainConfig,
    TrainState,
    apply_gradients,
    create_train_state,
    reject_unported,
)
from dinox_torch.train.step import METRICS, objective, view_spacing
from dinox_torch.utils.platform import resolve_device
from dinox_torch.utils.rng import seeded_generator

# The objective's metrics, which the last stage broadcasts (grad_norm and
# lr are every rank's own).
LOSS_METRICS = tuple(k for k in METRICS if k not in ("grad_norm", "lr"))


def check_pp_config(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for what the pipeline step does not train: the
    reference's refusals (accumulation, the objectives, LoRA) and MoE
    blocks, which its stage block does not have."""
    reject_unported(cfg)
    if cfg.accumulation_steps != 1:
        raise ValueError("pipeline step folds accumulation into microbatches; "
                         "set accumulation_steps=1")
    if cfg.loss_type not in ("dino", "simclr"):
        raise ValueError(f"pipeline step supports dino/simclr, not {cfg.loss_type}")
    if cfg.model.lora_rank:
        raise ValueError("LoRA fine-tunes are single-stage; PP is for pretrain")
    if cfg.model.moe_experts:
        raise ValueError("pipeline stages run dense blocks (the reference's stage block has no "
                         f"experts); set moe_experts=0, not {cfg.model.moe_experts}")


def create_pp_train_state(cfg: TrainConfig, seed: int = 0, device: torch.device | str | None = None,
                          mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state on a ``(data, pipe)`` *mesh*: built from *seed* on the
    CPU as one process builds it, cut to this rank's stage, then moved to
    *device* (the mesh's by default), so the card never holds the other
    stages' blocks."""
    if mesh is None or mesh.pp < 2:
        raise ValueError("create_pp_train_state needs a (data, pipe) mesh with pp >= 2 "
                         "(parallel.pipeline.make_pp_mesh)")
    check_pp_config(cfg)
    dev = resolve_device(mesh.device if device is None else device)
    state = shard_state(create_train_state(cfg, seed, device="cpu"), mesh)
    state.student.to(dev)
    state.teacher.to(dev)
    state.center = state.center.to(dev)
    return state


def make_pp_loss(cfg: TrainConfig, mesh: Mesh):
    """The loss over the pipelined forward, with its backward: ``loss_fn(
    student, teacher, center, batch, spacing, rows, jitter=None) ->
    (grads, new_center, metrics)``. *batch* is the (2b, S, S, 3) views of
    the rank's rows on stage 0 (``None`` elsewhere), *rows* ``(lo, hi,
    global_batch)`` of the data rank. *grads* are this rank's gradients of
    the student's parameters (``parameters()`` order), before
    :func:`reduce_pp_grads`; the centre and the metrics are the last
    stage's, on every rank."""
    check_pp_config(cfg)
    # The views of a global batch: the step's 2 x batch_size rows.
    n_micro = check_microbatches(2 * cfg.batch_size, cfg.pp_microbatches, mesh)
    remat = cfg.model.use_grad_checkpoint
    first, last = mesh.stage == 0, mesh.stage == mesh.pp - 1

    def forward(model: Student, batch, sp2, shape, dev):
        dtype = model.backbone.compute_dtype
        tokens = model.embed(batch, sp2) if first else torch.empty(shape, dtype=dtype, device=dev)
        return tokens, pipeline_run_blocks(stage_blocks(model), tokens, mesh, n_micro,
                                           remat=remat and model.training)

    def loss_fn(student: Student, teacher: Student, center: torch.Tensor, batch: Optional[torch.Tensor],
                spacing: Optional[torch.Tensor], rows: tuple[int, int, int],
                jitter: Optional[torch.Generator] = None):
        dev = center.device
        mcfg = student.cfg
        shape = (2 * (rows[1] - rows[0]), 1 + mcfg.n_patches + mcfg.num_registers, mcfg.dim)
        sp2 = view_spacing(spacing, cfg, jitter, rows) if first else None
        params = list(student.parameters())
        for p in params:
            p.grad = None
        tokens, run = forward(student, batch, sp2, shape, dev)
        if cfg.loss_type == "dino":
            with torch.no_grad():
                _, t_run = forward(teacher, batch, sp2, shape, dev)
        grad_out = None
        # The last stage's metrics and centre, broadcast to every stage.
        vec = torch.empty(len(LOSS_METRICS) + center.numel(), device=dev)
        if last:
            s_out, s_feats = student.finalize(run.output)
            loss, new_center, metrics = objective(
                s_out, s_feats, lambda: teacher.finalize(t_run.output), center, cfg, mesh.data_group)
            loss.backward()
            grad_out = run.output.grad
            vec = torch.cat([torch.stack([metrics[k] for k in LOSS_METRICS]).float(), new_center.reshape(-1)])
        dx = run.backward(grad_out)
        if first:
            tokens.backward(dx)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        vec = broadcast(vec, mesh.pp - 1, mesh.pipe_group)
        metrics = dict(zip(LOSS_METRICS, vec[:len(LOSS_METRICS)].unbind(0)))
        return grads, vec[len(LOSS_METRICS):].view(center.shape), metrics

    return loss_fn


def reduce_pp_grads(student: Student, grads: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The step's gradients from a rank's own: the rest summed over the pipe
    group, then everything averaged over the stage's data group."""
    rest = [i for i, (name, _) in enumerate(student.named_parameters()) if pp_param_spec(name) is None]
    grads = list(grads)
    for i, g in zip(rest, all_reduce_bucket([grads[i] for i in rest], mesh.pipe_group)):
        grads[i] = g
    return all_reduce_bucket(grads, mesh.data_group, "mean")


def pp_grad_norm(student: Student, grads: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The norm of the full parameters' gradient: the stages' block squares
    summed over the pipe group, the rest (the same on every stage) once."""
    sq = {True: [], False: []}
    for (name, _), g in zip(student.named_parameters(), grads):
        sq[pp_param_spec(name) is not None].append(g)

    def squares(gs: list[torch.Tensor]) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(gs)).pow(2).sum()

    return torch.sqrt(all_reduce(squares(sq[True]), mesh.pipe_group) + squares(sq[False]))


def build_pp_train_step(cfg: TrainConfig, device: torch.device | str | None = None,
                        augment_fn: Optional[Callable] = None, mesh: Optional[Mesh] = None
                        ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                      tuple[TrainState, dict[str, torch.Tensor]]]:
    """The optimizer step on a ``(data, pipe)`` *mesh*, with the signature of
    ``train.step.build_train_step``: ``step_fn(state, pixels, spacing) ->
    (state, metrics)``, pixels (1, b, H, W, 3) uint16 and spacing (1, b, 3),
    the data rank's rows (``parallel.mesh.batch_rows``), every stage given
    them; *state* from :func:`create_pp_train_state`. Stage 0 augments
    (*augment_fn* with ``rows=``, :func:`augment_views` by default), with
    the generators of ``build_train_step``."""
    if mesh is None or mesh.pp < 2:
        raise ValueError("build_pp_train_step needs a (data, pipe) mesh with pp >= 2 "
                         "(parallel.pipeline.make_pp_mesh)")
    loss_fn = make_pp_loss(cfg, mesh)
    dev = resolve_device(mesh.device if device is None else device)
    augment = augment_views if augment_fn is None else augment_fn
    aug_cfg = cfg.aug

    def step_fn(state: TrainState, pixels, spacing):
        b = pixels.shape[1]
        rows = (mesh.dp_rank * b, (mesh.dp_rank + 1) * b, b * mesh.dp)
        state.student.train()
        batch = sp = None
        if mesh.stage == 0:
            pixels = torch.as_tensor(pixels, device=dev)
            sp = torch.as_tensor(spacing, dtype=torch.float32, device=dev)[0]
            views = augment(pixels[0], seeded_generator(cfg.train_seed, state.step, 0, 0), aug_cfg,
                            rows=rows)
            batch = views.reshape((-1,) + tuple(views.shape[2:]))
        grads, center, metrics = loss_fn(state.student, state.teacher, state.center, batch, sp, rows,
                                         seeded_generator(cfg.train_seed, state.step, 0, 1))
        grads = reduce_pp_grads(state.student, grads, mesh)
        keys = sorted(metrics)
        means = all_reduce(torch.stack([metrics[k] for k in keys]), mesh.data_group, "mean")
        metrics = dict(zip(keys, means.unbind(0)))
        metrics["grad_norm"] = pp_grad_norm(state.student, grads, mesh)

        params = list(state.student.parameters())
        apply_gradients(cfg, state.optimizer, params, grads, state.step)
        if cfg.loss_type == "dino":  # EMA from the updated student
            with torch.no_grad():
                t_params = list(state.teacher.parameters())
                torch._foreach_mul_(t_params, cfg.ema)
                torch._foreach_add_(t_params, params, alpha=1.0 - cfg.ema)
        metrics["lr"] = get_lr_tensor(torch.tensor(state.step, device=dev), cfg.max_steps,
                                      cfg.warmup_steps, cfg.lr, cfg.min_lr)
        state.center = center
        state.step += 1
        return state, metrics

    return step_fn
