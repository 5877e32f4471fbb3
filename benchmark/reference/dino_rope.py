"""The DINO training step of a DINOv3-block model (``reference/vit_rope.py``)
in float32: ``reference/dino.py``'s step, its losses by import, with the
student's RoPE coordinates rescaled in each training forward as DINOv3's
``rescale_coords`` does.

The factor of micro-batch *a* of optimizer step *s*: one uniform u from the
stream ``(train_seed, s, a, 3)`` (``reference.augment.stream``, the
augmentation's seeding with a fourth word), ``rho = exp(log(r) (2u - 1))``,
log-uniform in [1/r, r] for r = ``rope_rescale``; the teacher's is 1.

The state stays lean enough for a 1.7 B-parameter stage on one card: the
student and teacher dicts it is given are taken over and updated in place
(no copies), the gradients accumulate in ``.grad``, each block is recomputed
in the backward where the model says ``use_grad_checkpoint``, and the first
step's gradient is kept on the host. It returns the final student and
teacher beside the losses, the first gradient and the first step's KoLeo
and Gram terms; the caller takes the changes against the weights it made.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, MutableMapping, Sequence

import torch

from reference import augment, vit_rope
from reference.dino import dino, gram, koleo, lr_at
from reference.vit import Mm


def rescale_at(recipe: Mapping[str, Any], model: Mapping[str, Any], step: int, micro: int) -> float:
    r = float(model.get("rope_rescale", 1.0))
    if r == 1.0:
        return 1.0
    u = float(torch.rand((), generator=augment.stream(recipe["train_seed"], step, micro, 3)))
    return math.exp(math.log(r) * (2.0 * u - 1.0))


def micro_loss(student: Mapping[str, torch.Tensor], teacher: Mapping[str, torch.Tensor],
               center: torch.Tensor, views: torch.Tensor, spacing: torch.Tensor,
               model: Mapping[str, Any], r: Mapping[str, Any], mm: Mm, rescale: float):
    ckpt = bool(model.get("use_grad_checkpoint"))
    s_feats = vit_rope.tokens(views, spacing, vit_rope.strip(student, "backbone."), model, mm, ckpt, rescale)
    s_out = vit_rope.head(s_feats[:, 0], student, mm)
    with torch.no_grad():
        t_feats = vit_rope.tokens(views, spacing, vit_rope.strip(teacher, "backbone."), model, mm)
        t_out = vit_rope.head(t_feats[:, 0], teacher, mm)
    d, new_center = dino(s_out, t_out, center, r)
    k = koleo(s_out)
    g = gram(s_feats, t_feats)
    loss = d + r["gram_weight"] * g
    if r["koleo_weight"] > 0:
        loss = loss + r["koleo_weight"] * k
    return loss, new_center, {"loss_koleo": float(k), "loss_gram": float(g)}


def train(student: MutableMapping[str, torch.Tensor], teacher: MutableMapping[str, torch.Tensor],
          model: Mapping[str, Any], recipe: Mapping[str, Any],
          batches: Sequence[tuple[torch.Tensor, torch.Tensor]], start: int = 0, mm: Mm = torch.matmul,
          half_batch: bool = False) -> dict[str, Any]:
    """Optimizer steps *start*, *start* + 1, ... over *batches* (each
    pixels (accum, B, H, W, 3) uint16 and spacing (accum, B, 3)), from the
    float32 *student* and *teacher* (updated in place), fresh AdamW moments
    and a zero centre. Returns each step's loss, the first step's gradient
    per leaf on the host (``grad1``), the first step's KoLeo and Gram terms
    (``first``), and the final ``student`` and ``teacher``. *half_batch*
    leaves out each micro-batch's second half (a fault for the checks)."""
    names = list(student)
    for k in names:
        student[k] = student[k].detach().float().requires_grad_(True)
        teacher[k] = teacher[k].detach().float()
    m = {k: torch.zeros_like(v) for k, v in teacher.items()}
    v2 = {k: torch.zeros_like(v) for k, v in teacher.items()}
    center = torch.zeros((1, model["out_dim"]), device=next(iter(teacher.values())).device)
    losses, grad1, firsts = [], None, []
    b1, b2, eps = 0.9, 0.999, 1e-8
    for n, (pixels, spacing) in enumerate(batches):
        step = start + n
        accum, b = pixels.shape[:2]
        keep = b // 2 if half_batch else b
        micro = []
        for a in range(accum):
            u = torch.rand((2, b, 25), generator=augment.stream(recipe["train_seed"], step, a, 0))
            views = augment.training_views(pixels[a, :keep], u[:, :keep], model["img_size"],
                                           tuple(recipe["crop_scale"]))
            sp = spacing[a, :keep].float()
            sp2 = torch.cat([sp, sp]) if model.get("scale_aware") else None
            loss, center, info = micro_loss(student, teacher, center, views, sp2, model, recipe, mm,
                                            rescale_at(recipe, model, step, a))
            if n == 0:
                firsts.append(info)
            loss.backward()
            micro.append(loss.detach())
            center = center.detach()
            del loss, views
        losses.append(float(torch.stack(micro).mean()))
        lr, t = lr_at(step, recipe), n + 1
        with torch.no_grad():
            if grad1 is None:
                grad1 = {k: (student[k].grad / accum).cpu() if student[k].grad is not None
                         else torch.zeros(student[k].shape) for k in names}
            for k in names:
                p = student[k]
                g = p.grad / accum if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m[k] / (1 - b1 ** t)) / ((v2[k] / (1 - b2 ** t)).sqrt() + eps)
                p.sub_(lr * recipe["weight_decay"] * p + lr * update)
                teacher[k].mul_(recipe["ema"]).add_(p, alpha=1.0 - recipe["ema"])
                del g, update
    del m, v2
    first = {k: sum(f[k] for f in firsts) / len(firsts) for k in firsts[0]}
    return {"losses": losses, "grad1": grad1, "student": {k: student[k].detach() for k in names},
            "teacher": teacher, "first": first}
