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
SimCLR trains the student alone against a frozen teacher.

Randomness: a CPU ``torch.Generator`` per (train_seed, step, micro-batch)
for the augmentation and another for the spacing jitter.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.ops.augment import augment_views
from dinox_torch.train.losses import dino_loss, gram_anchoring_loss, koleo_loss, simclr_loss
from dinox_torch.train.schedule import get_lr_tensor
from dinox_torch.train.state import TrainConfig, TrainState, apply_gradients, reject_unported
from dinox_torch.utils.platform import resolve_device

METRICS = ("loss", "loss_dino", "loss_gram", "loss_koleo", "loss_simclr", "loss_mae",
           "teacher_entropy", "student_entropy", "embed_std", "grad_norm", "lr")


def _generator(seed: int, step: int, micro: int, stream: int) -> torch.Generator:
    words = np.random.SeedSequence([seed, step, micro, stream]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


def micro_loss(student: DinoStudentTeacher, teacher: DinoStudentTeacher, center: torch.Tensor,
               batch: torch.Tensor, spacing: Optional[torch.Tensor], cfg: TrainConfig,
               jitter: Optional[torch.Generator] = None
               ) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Loss over one augmented (2B, S, S, 3) micro-batch with spacing (B, 3).
    Returns (loss, new centre, metrics)."""
    zero = torch.zeros((), dtype=torch.float32, device=batch.device)
    sp2 = torch.cat([spacing, spacing], dim=0) if cfg.model.scale_aware else None
    if sp2 is not None and cfg.spacing_jitter > 0:
        noise = torch.randn(sp2.shape, generator=jitter).to(sp2.device)
        sp2 = sp2 * torch.exp(cfg.spacing_jitter * noise)

    s_out, s_feats = student.forward_features(batch, sp2)
    if cfg.loss_type == "simclr":
        b = s_out.shape[0] // 2
        loss = simclr_loss(s_out[:b], s_out[b:], cfg.student_temp)
        new_center = center
        metrics = dict(loss_simclr=loss, loss_dino=zero, loss_gram=zero, loss_koleo=zero,
                       loss_mae=zero, teacher_entropy=zero, student_entropy=zero)
    else:
        with torch.no_grad():
            t_out, t_feats = teacher.forward_features(batch, sp2)
        d = dino_loss(s_out, t_out, center, student_temp=cfg.student_temp,
                      teacher_temp=cfg.teacher_temp, center_momentum=cfg.center_momentum)
        g = gram_anchoring_loss(s_feats, t_feats)
        k = koleo_loss(s_out) if cfg.koleo_weight > 0 else zero
        loss = d.loss + cfg.gram_weight * g + cfg.koleo_weight * k
        new_center = d.new_center
        metrics = dict(loss_dino=d.loss, loss_gram=g, loss_koleo=k, loss_simclr=zero,
                       loss_mae=zero, teacher_entropy=d.teacher_entropy,
                       student_entropy=d.student_entropy)
    # Collapse telemetry: per-dim std of the CLS embedding over the batch.
    metrics["embed_std"] = torch.mean(torch.std(s_feats[:, 0].float(), dim=0, correction=0))
    metrics["loss"] = loss
    return loss, new_center, {k: v.detach() for k, v in metrics.items()}


def micro_loss_and_grads(state: TrainState, center: torch.Tensor, batch: torch.Tensor,
                         spacing: Optional[torch.Tensor], cfg: TrainConfig,
                         jitter: Optional[torch.Generator] = None
                         ) -> tuple[list[torch.Tensor], torch.Tensor, dict[str, torch.Tensor]]:
    """One micro-step: the gradients of :func:`micro_loss` with respect to
    the student's parameters (in ``named_parameters()`` order; zeros for a
    parameter the loss does not reach), the new centre and the metrics."""
    params = list(state.student.parameters())
    loss, new_center, metrics = micro_loss(state.student, state.teacher, center, batch, spacing,
                                           cfg, jitter)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return grads, new_center.detach(), metrics


def build_train_step(cfg: TrainConfig, device: torch.device | str | None = None,
                     augment_fn: Optional[Callable] = None
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                   tuple[TrainState, dict[str, torch.Tensor]]]:
    """The optimizer step ``step_fn(state, pixels, spacing) -> (state,
    metrics)``, with pixels (accum, B, H, W, 3) uint16 and spacing
    (accum, B, 3) float32 (numpy arrays or tensors). It updates *state* in
    place and returns it; metrics are 0-d float32 tensors on the device.
    Runs on the card unless *device* is ``"cpu"``.

    *augment_fn(pixels, generator, aug_cfg) -> (n_views, B, S, S, 3)*
    defaults to :func:`augment_views`."""
    reject_unported(cfg)
    dev = resolve_device(device)
    augment = augment_views if augment_fn is None else augment_fn
    aug_cfg = cfg.aug

    def step_fn(state: TrainState, pixels, spacing):
        pixels = torch.as_tensor(pixels, device=dev)
        spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
        accum = pixels.shape[0]
        state.student.train()
        grads, center, seq = None, state.center, []
        for a in range(accum):
            views = augment(pixels[a], _generator(cfg.train_seed, state.step, a, 0), aug_cfg)
            batch = views.reshape((-1,) + tuple(views.shape[2:]))
            g, center, metrics = micro_loss_and_grads(
                state, center, batch, spacing[a], cfg, _generator(cfg.train_seed, state.step, a, 1))
            grads = g if grads is None else torch._foreach_add(grads, g)
            seq.append(metrics)
        if accum > 1:
            grads = torch._foreach_div(grads, float(accum))
            metrics = {k: torch.stack([m[k] for m in seq]).mean() for k in seq[0]}
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

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
