"""The DINO training step in float32: the views, the student's forward
with gradients and the teacher's without, the losses, the gradients
averaged over the micro-batches, AdamW and the teacher's EMA.

The objective (DINOv2, arXiv:2304.07193, with Gram anchoring and KoLeo):
the cross-view DINO cross-entropy ``(H(t1, s2) + H(t2, s1)) / 2`` between
the teacher's centred, sharpened softmax (temperature ``teacher_temp``,
centre subtracted) and the student's (``student_temp``); the mean squared
difference of the student's and the teacher's Gram matrices of the
L2-normalised tokens after CLS, weighted ``gram_weight``; KoLeo,
``-mean log`` of each L2-normalised head output's distance to its nearest
neighbour in the batch, weighted ``koleo_weight``. The centre moves to the
teacher's batch mean by ``1 - center_momentum`` after each micro-batch.

AdamW: b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, the decay
``lr * weight_decay * p`` on every parameter, the learning rate of a linear
warm-up over ``warmup_steps`` (``lr * (step + 1) / warmup_steps``) and a
cosine to ``min_lr`` by ``max_steps``. The teacher then moves to
``ema * teacher + (1 - ema) * student``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F

from reference import augment, vit
from reference.vit import Mm


def lr_at(step: int, r: Mapping[str, Any]) -> float:
    warm = r["warmup_steps"]
    if warm > 0 and step < warm:
        return r["lr"] * (step + 1) / warm
    if r.get("max_steps") is None:
        return r["lr"]
    if step >= r["max_steps"]:
        return r["min_lr"]
    frac = (step - warm) / max(r["max_steps"] - warm, 1)
    return r["min_lr"] + 0.5 * (1.0 + math.cos(math.pi * frac)) * (r["lr"] - r["min_lr"])


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def dino(s_out: torch.Tensor, t_out: torch.Tensor, center: torch.Tensor, r: Mapping[str, Any]):
    t = torch.softmax((t_out - center) / r["teacher_temp"], dim=-1)
    s = F.log_softmax(s_out / r["student_temp"], dim=-1)
    b = s_out.shape[0] // 2
    loss = -((t[:b] * s[b:]).sum(-1).mean() + (t[b:] * s[:b]).sum(-1).mean()) / 2.0
    new_center = center * r["center_momentum"] + t_out.mean(0, keepdim=True) * (1.0 - r["center_momentum"])
    return loss, new_center


def gram(s_feats: torch.Tensor, t_feats: torch.Tensor) -> torch.Tensor:
    s, t = l2n(s_feats[:, 1:]), l2n(t_feats[:, 1:])
    return ((s @ s.transpose(1, 2) - t @ t.transpose(1, 2)) ** 2).mean()


def koleo(out: torch.Tensor) -> torch.Tensor:
    x = l2n(out)
    sq = (2.0 - 2.0 * x @ x.t()).clamp_min(0.0) + torch.eye(len(x), device=x.device) * 1e18
    return -torch.log(sq.amin(1).sqrt() + 1e-8).mean()


def micro_loss(student: Mapping[str, torch.Tensor], teacher: Mapping[str, torch.Tensor],
               center: torch.Tensor, views: torch.Tensor, spacing: torch.Tensor,
               model: Mapping[str, Any], r: Mapping[str, Any], mm: Mm):
    ckpt = bool(model.get("use_grad_checkpoint"))
    s_feats = vit.tokens(views, spacing, vit.strip(student, "backbone."), model, mm, ckpt)
    s_out = vit.head(s_feats[:, 0], student, mm)
    with torch.no_grad():
        t_feats = vit.tokens(views, spacing, vit.strip(teacher, "backbone."), model, mm)
        t_out = vit.head(t_feats[:, 0], teacher, mm)
    d, new_center = dino(s_out, t_out, center, r)
    k = koleo(s_out)
    g = gram(s_feats, t_feats)
    loss = d + r["gram_weight"] * g
    if r["koleo_weight"] > 0:
        loss = loss + r["koleo_weight"] * k
    return loss, new_center, {"loss_koleo": float(k), "loss_gram": float(g)}


def train(params: Mapping[str, torch.Tensor], teacher_params: Mapping[str, torch.Tensor],
          model: Mapping[str, Any], recipe: Mapping[str, Any],
          batches: Sequence[tuple[torch.Tensor, torch.Tensor]], start: int = 0, mm: Mm = torch.matmul,
          half_batch: bool = False) -> dict[str, Any]:
    """Optimizer steps *start*, *start* + 1, ... (the schedule's and the
    views' step; the moments are fresh, so Adam's bias correction counts
    from one) from the student's *params* and the teacher's
    *teacher_params*, a zero centre, over *batches*, each (pixels (accum,
    B, H, W, 3) uint16, spacing (accum, B, 3)). Returns each step's loss
    (the mean over its micro-batches), the first step's gradient per leaf
    as the optimizer gets it (``grad1``), each leaf's change after the last
    step, the student's (``change``) and the teacher's
    (``teacher_change``), and the first step's KoLeo and Gram terms
    (``first``, each the mean over its micro-batches). *half_batch* is a
    fault for the checks: each micro-batch's second half is left out."""
    student = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
    teacher = {k: v.detach().clone().float() for k, v in teacher_params.items()}
    names = list(student)
    m = {k: torch.zeros_like(v) for k, v in teacher.items()}
    v2 = {k: torch.zeros_like(v) for k, v in teacher.items()}
    center = torch.zeros((1, model["out_dim"]), device=next(iter(teacher.values())).device)
    losses, grad1, firsts = [], None, []
    b1, b2, eps = 0.9, 0.999, 1e-8
    for n, (pixels, spacing) in enumerate(batches):
        step = start + n
        accum, b = pixels.shape[:2]
        keep = b // 2 if half_batch else b
        grads = {k: torch.zeros_like(v) for k, v in teacher.items()}
        micro = []
        for a in range(accum):
            u = torch.rand((2, b, 25), generator=augment.stream(recipe["train_seed"], step, a, 0))
            views = augment.training_views(pixels[a, :keep], u[:, :keep], model["img_size"],
                                           tuple(recipe["crop_scale"]))
            sp = spacing[a, :keep].float()
            sp2 = torch.cat([sp, sp]) if model.get("scale_aware") else None
            loss, center, info = micro_loss(student, teacher, center, views, sp2, model, recipe, mm)
            if n == 0:
                firsts.append(info)
            for k, g in zip(names, torch.autograd.grad(loss, [student[k] for k in names],
                                                       allow_unused=True)):
                if g is not None:
                    grads[k] += g
            micro.append(loss.detach())
            center = center.detach()
        grads = {k: g / accum for k, g in grads.items()}
        losses.append(float(torch.stack(micro).mean()))
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        lr, t = lr_at(step, recipe), n + 1
        with torch.no_grad():
            for k in names:
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m[k] / (1 - b1 ** t)) / ((v2[k] / (1 - b2 ** t)).sqrt() + eps)
                p = student[k]
                p.sub_(lr * recipe["weight_decay"] * p + lr * update)
                teacher[k].mul_(recipe["ema"]).add_(p, alpha=1.0 - recipe["ema"])
    change = {k: student[k].detach() - params[k].float() for k in names}
    teacher_change = {k: teacher[k] - teacher_params[k].float() for k in names}
    first = {k: sum(f[k] for f in firsts) / len(firsts) for k in firsts[0]}
    return {"losses": losses, "grad1": grad1, "change": change, "teacher_change": teacher_change,
            "first": first}
