"""The training step: augmentation -> forward -> losses -> backward -> update.
The counterpart of ``dinox_tpu.train.step``, run eagerly.

One call of the step function is one optimizer step over ``accum``
micro-batches. For each: two-view augmentation on the card, the student
forward over the 2B views (with the per-view spacing and the optional
lognormal ``spacing_jitter``), the teacher forward without gradients, DINO
with the centre update, Gram anchoring and KoLeo, and the gradients. The
gradients are averaged over the micro-batches and the centre chains
through them. Then the global gradient norm (a metric; nothing is clipped),
AdamW at the schedule's LR, and the teacher EMA from the *updated* student.
SimCLR trains the student alone against a frozen teacher. With MoE
(``moe_experts > 0``) the student's mean load-balance loss over its MoE
blocks is added with weight ``moe_aux_weight`` (metric ``loss_moe_aux``);
the teacher routes too, but its loss is not used. MAE
(``loss_type="mae"``) runs the ``MaeModel`` student alone on the views
(no teacher forward, no EMA), with ``embed_std`` the std of its
prediction.

Each phase runs under a profiler span (``utils.tracing``):
``dinox.train.step`` around the whole step; per micro-step ``augment``,
``student``, ``loss`` (the teacher's forward nested in it as ``teacher``)
and ``backward``; ``update`` at each accumulation and after the
micro-steps, with ``reduce`` nested in it on a mesh.

Randomness: a CPU ``torch.Generator`` per (train_seed, step, micro-batch)
for the augmentation, another for the spacing jitter and a third for the
MAE mask noise. A DINOv3-block model with ``rope_rescale`` > 1 (DINOv3's
``rescale_coords``) takes a fourth: the student forward's coordinate factor,
``exp(log(rescale) * (2u - 1))`` of one uniform u (:func:`rope_rescale`);
the teacher's is 1. The choice is made once, when the step is built.

On a mesh (``parallel.mesh.Mesh``; the counterpart of the JAX step's
``mesh``) each rank takes its rows ``[lo, hi)`` of the global batch (cut
over the data axis only), and every draw is made at the global shape and
the rank's rows taken (rows ``[lo:hi]`` and ``[B+lo:B+hi]`` of the
``[view1; view2]`` layout), so the ranks see the views of the one-process
run. The losses reduce over the data group (``train.losses``); after
accumulation one bucketed all-reduce gives the data group's mean gradient
(an expert stack's over the ranks that hold the same experts); with tp > 1
the replicated parameters of which each rank holds a share of the gradient
(``parallel.mesh.model_group_share``: under sequence parallelism those of
the blocks but the MoE's, which runs whole on every rank; the LoRA factors
of the cut layers) are also summed over the model group. ``grad_norm`` is
the full parameters' (a tensor-parallel shard's squares summed over the
model group, an expert shard's over the expert group, a replicated
tensor's counted once), and the metrics are the data group's means, so
every rank holds the same values. With one rank the step is the one
without a mesh, to the bit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from dinox_torch.models.mae import mae_loss
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.ops.augment import augment_views
from dinox_torch.parallel.collectives import Group, all_reduce, all_reduce_bucket, gather_rows
from dinox_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS, Mesh, model_group_share, param_cut
from dinox_torch.train.losses import dino_loss, gram_anchoring_loss, koleo_loss, simclr_loss
from dinox_torch.train.schedule import get_lr_tensor
from dinox_torch.train.state import (
    Student,
    TrainConfig,
    TrainState,
    apply_gradients,
    reject_unported,
)
from dinox_torch.utils.platform import resolve_device
from dinox_torch.utils.rng import seeded_generator
from dinox_torch.utils.tracing import span

METRICS = ("loss", "loss_dino", "loss_gram", "loss_koleo", "loss_simclr", "loss_mae",
           "teacher_entropy", "student_entropy", "embed_std", "grad_norm", "lr")


def _view_rows(rows: tuple[int, int, int]) -> torch.Tensor:
    """Indices of a rank's rows [lo, hi) in the global [view1; view2] layout."""
    lo, hi, total = rows
    return torch.cat([torch.arange(lo, hi), torch.arange(total + lo, total + hi)])


def _global_std(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The population std of every element of *x* over the group (equal
    shapes on every rank), in two passes as ``torch.std`` takes it."""
    if group is None:
        return torch.std(x, correction=0)
    mean = all_reduce(x.mean(), group, "mean")
    return torch.sqrt(all_reduce(((x - mean) ** 2).mean(), group, "mean"))


def view_spacing(spacing: Optional[torch.Tensor], cfg: TrainConfig,
                 jitter: Optional[torch.Generator] = None,
                 rows: Optional[tuple[int, int, int]] = None) -> Optional[torch.Tensor]:
    """The (2B, 3) spacing of the ``[view1; view2]`` batch with the lognormal
    ``spacing_jitter`` drawn from *jitter* (at the global shape on a mesh,
    *rows* the rank's), or ``None`` for a model that is not scale-aware."""
    sp2 = torch.cat([spacing, spacing], dim=0) if cfg.model.scale_aware else None
    if sp2 is not None and cfg.spacing_jitter > 0:
        if rows is None:
            noise = torch.randn(sp2.shape, generator=jitter)
        else:
            noise = torch.randn((2 * rows[2], 3), generator=jitter)[_view_rows(rows)]
        sp2 = sp2 * torch.exp(cfg.spacing_jitter * noise.to(sp2.device))
    return sp2


def objective(s_out: torch.Tensor, s_feats: torch.Tensor,
              teacher_fn: Callable[[], tuple[torch.Tensor, torch.Tensor]], center: torch.Tensor,
              cfg: TrainConfig, group: Group = None, moe_aux: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The DINO (+ Gram + KoLeo) or SimCLR loss of the student's head output
    and tokens: (loss, new centre, metrics). *teacher_fn()* gives the
    teacher's (head output, tokens), asked for DINO only. The losses'
    batch statistics reduce over *group*."""
    zero = torch.zeros((), dtype=torch.float32, device=s_out.device)
    if cfg.loss_type == "simclr":
        b = s_out.shape[0] // 2
        loss = simclr_loss(s_out[:b], s_out[b:], cfg.student_temp, group)
        new_center = center
        metrics = dict(loss_simclr=loss, loss_dino=zero, loss_gram=zero, loss_koleo=zero,
                       loss_mae=zero, teacher_entropy=zero, student_entropy=zero)
    else:
        t_out, t_feats = teacher_fn()
        d = dino_loss(s_out, t_out, center, student_temp=cfg.student_temp,
                      teacher_temp=cfg.teacher_temp, center_momentum=cfg.center_momentum,
                      group=group)
        g = gram_anchoring_loss(s_feats, t_feats, group)
        k = koleo_loss(s_out, group=group) if cfg.koleo_weight > 0 else zero
        loss = d.loss + cfg.gram_weight * g + cfg.koleo_weight * k
        new_center = d.new_center
        metrics = dict(loss_dino=d.loss, loss_gram=g, loss_koleo=k, loss_simclr=zero,
                       loss_mae=zero, teacher_entropy=d.teacher_entropy,
                       student_entropy=d.student_entropy)
    if moe_aux is not None:
        loss = loss + cfg.moe_aux_weight * moe_aux
        metrics["loss_moe_aux"] = moe_aux
    # Collapse telemetry: per-dim std of the CLS embedding over the batch.
    cls = gather_rows(s_feats[:, 0].detach().float(), group)
    metrics["embed_std"] = torch.mean(torch.std(cls, dim=0, correction=0))
    metrics["loss"] = loss
    return loss, new_center, {k: v.detach() for k, v in metrics.items()}


def micro_loss(student: Student, teacher: Student, center: torch.Tensor,
               batch: torch.Tensor, spacing: Optional[torch.Tensor], cfg: TrainConfig,
               jitter: Optional[torch.Generator] = None,
               mask_noise: Optional[torch.Tensor | torch.Generator] = None,
               group: Group = None, rows: Optional[tuple[int, int, int]] = None
               ) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Loss over one augmented (2B, S, S, 3) micro-batch with spacing (B, 3).
    *mask_noise* is MAE's (2B, L) noise or a generator to draw it from.
    *group* is the data-parallel group the losses reduce over and *rows*
    ``(lo, hi, global_batch)`` the rank's rows, at whose global shape the
    jitter and the mask noise are drawn. Returns (loss, new centre, metrics)."""
    if cfg.loss_type == "mae":
        with span("dinox.train.student"):
            if rows is not None and isinstance(mask_noise, torch.Generator):
                n = 2 * rows[2], student.cfg.n_patches
                mask_noise = torch.rand(n, generator=mask_noise)[_view_rows(rows)]
            pred, mask = student(batch, mask_noise)
        with span("dinox.train.loss"):
            zero = torch.zeros((), dtype=torch.float32, device=batch.device)
            loss = mae_loss(pred, batch, mask, cfg.model.patch, group)
            metrics = dict(loss_mae=loss, loss_dino=zero, loss_gram=zero, loss_koleo=zero,
                           loss_simclr=zero, teacher_entropy=zero, student_entropy=zero,
                           embed_std=_global_std(pred.detach().float(), group), loss=loss)
            return loss, center, {k: v.detach() for k, v in metrics.items()}
    with span("dinox.train.student"):
        sp2 = view_spacing(spacing, cfg, jitter, rows)
        s_out, s_feats, moe_aux = student.forward_features_aux(batch, sp2)

    def teacher_fn() -> tuple[torch.Tensor, torch.Tensor]:
        with span("dinox.train.teacher"), torch.no_grad():
            return teacher.forward_features(batch, sp2)

    with span("dinox.train.loss"):
        return objective(s_out, s_feats, teacher_fn, center, cfg, group, moe_aux)


def micro_loss_and_grads(state: TrainState, center: torch.Tensor, batch: torch.Tensor,
                         spacing: Optional[torch.Tensor], cfg: TrainConfig,
                         jitter: Optional[torch.Generator] = None,
                         mask_noise: Optional[torch.Tensor | torch.Generator] = None,
                         group: Group = None, rows: Optional[tuple[int, int, int]] = None
                         ) -> tuple[list[torch.Tensor], torch.Tensor, dict[str, torch.Tensor]]:
    """One micro-step: the gradients of :func:`micro_loss` with respect to
    the student's parameters (in ``named_parameters()`` order; zeros for a
    parameter the loss does not reach), the new centre and the metrics.
    The gradients are this rank's: the step takes their data-group mean."""
    params = list(state.student.parameters())
    loss, new_center, metrics = micro_loss(state.student, state.teacher, center, batch, spacing,
                                           cfg, jitter, mask_noise, group, rows)
    with span("dinox.train.backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, new_center.detach(), metrics


def _model_group_shares(student: Student, sequence_parallel: bool) -> list[int]:
    """Indices (in ``parameters()`` order) of the replicated parameters whose
    gradient each rank of a model group holds a share of."""
    return [i for i, (name, p) in enumerate(student.named_parameters())
            if model_group_share(name, p, sequence_parallel)]


def _grad_norm(student: Student, grads: list[torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """The norm of the full parameters' gradient: a shard's squares summed
    over the group that cuts it, a replicated tensor's counted once."""
    if mesh is None or (mesh.tp == 1 and mesh.ep == 1):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    sq = {MODEL_AXIS: [], EXPERT_AXIS: [], None: []}
    for (name, _), g in zip(student.named_parameters(), grads):
        c = param_cut(name, g, mesh)
        sq[None if c is None else c[1]].append(g.float().pow(2).sum())
    sharded = sum(all_reduce(torch.stack(sq[axis]).sum(), mesh.axis(axis)[2])
                  for axis in (MODEL_AXIS, EXPERT_AXIS) if sq[axis])
    return torch.sqrt(sharded + torch.stack(sq[None]).sum())


def rope_rescale(cfg: TrainConfig, step: int, micro: int) -> float:
    """The RoPE coordinate factor of the student's forward at optimizer
    step *step*, micro-batch *micro*: log-uniform in [1/r, r], r =
    ``rope_rescale``, from stream 3 of (train_seed, step, micro)."""
    u = float(torch.rand((), generator=seeded_generator(cfg.train_seed, step, micro, 3)))
    return math.exp(math.log(cfg.model.rope_rescale) * (2.0 * u - 1.0))


def build_train_step(cfg: TrainConfig, device: torch.device | str | None = None,
                     augment_fn: Optional[Callable] = None, mesh: Optional[Mesh] = None
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                   tuple[TrainState, dict[str, torch.Tensor]]]:
    """The optimizer step ``step_fn(state, pixels, spacing) -> (state,
    metrics)``, with pixels (accum, B, H, W, 3) uint16 and spacing
    (accum, B, 3) float32 (numpy arrays or tensors). It updates *state* in
    place and returns it; metrics are 0-d float32 tensors on the device.
    Runs on the card unless *device* is ``"cpu"`` (the mesh's device by
    default).

    *augment_fn(pixels, generator, aug_cfg) -> (n_views, B, S, S, 3)*
    defaults to :func:`augment_views`; on a *mesh* it is also given
    ``rows=(lo, hi, global_batch)``. On a *mesh*, *pixels* and *spacing*
    are the rank's rows of the global batch (``parallel.mesh.batch_rows``)
    and *state* is on the mesh (``create_train_state(..., mesh=)``)."""
    reject_unported(cfg)
    if mesh is not None and mesh.pp > 1:
        raise ValueError("a (data, pipe) mesh trains through train.pp_step.build_pp_train_step")
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    augment = augment_views if augment_fn is None else augment_fn
    aug_cfg = cfg.aug
    group = None if mesh is None else mesh.data_group
    rescale = cfg.model.rope_rescale != 1.0 and cfg.loss_type != "mae"

    def step_fn(state: TrainState, pixels, spacing):
        with span("dinox.train.step"):
            return _step(state, pixels, spacing)

    def _reduce(state: TrainState, grads: list[torch.Tensor], metrics: dict[str, torch.Tensor]):
        grads = all_reduce_bucket(grads, group, "mean")
        shares = _model_group_shares(state.student, cfg.model.sequence_parallel) if mesh.tp > 1 else []
        if shares:
            for i, g in zip(shares, all_reduce_bucket([grads[i] for i in shares], mesh.model_group)):
                grads[i] = g
        keys = sorted(metrics)
        means = all_reduce(torch.stack([metrics[k] for k in keys]), group, "mean")
        return grads, dict(zip(keys, means.unbind(0)))

    def _step(state: TrainState, pixels, spacing):
        accum, b = pixels.shape[:2]
        rows = None if mesh is None else (mesh.dp_rank * b, (mesh.dp_rank + 1) * b, b * mesh.dp)
        state.student.train()
        grads, center, seq = None, state.center, []
        for a in range(accum):
            with span("dinox.train.augment"):
                gen, jitter, noise = (seeded_generator(cfg.train_seed, state.step, a, k) for k in range(3))
                views = augment(torch.as_tensor(pixels[a], device=dev), gen, aug_cfg,
                                **({} if rows is None else {"rows": rows}))
                batch = views.reshape((-1,) + tuple(views.shape[2:]))
                sp = torch.as_tensor(spacing[a], dtype=torch.float32, device=dev)
                if rescale:
                    state.student.backbone.set_rope_rescale(rope_rescale(cfg, state.step, a))
            g, center, metrics = micro_loss_and_grads(state, center, batch, sp, cfg, jitter, noise, group, rows)
            seq.append(metrics)
            if grads is None:
                grads = g
            else:
                with span("dinox.train.update"):
                    grads = torch._foreach_add(grads, g)
        with span("dinox.train.update"):
            if accum > 1:
                grads = torch._foreach_div(grads, float(accum))
                metrics = {k: torch.stack([m[k] for m in seq]).mean() for k in seq[0]}
            if mesh is not None:
                with span("dinox.train.reduce"):
                    grads, metrics = _reduce(state, grads, metrics)
            metrics["grad_norm"] = _grad_norm(state.student, grads, mesh)

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
