"""Self-supervised losses: DINO (centre + sharpen, cross-view), Gram
anchoring, KoLeo and SimCLR/NT-Xent. The counterpart of
``dinox_tpu.train.losses``, with the same arithmetic.

Everything runs in float32. The matmuls are full float32 (the JAX package
asks for ``Precision.HIGHEST``): on CUDA that needs TF32 off, which
``utils.platform.resolve_device`` sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DinoLossOut(NamedTuple):
    loss: torch.Tensor
    new_center: torch.Tensor
    teacher_entropy: torch.Tensor
    student_entropy: torch.Tensor


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor, center: torch.Tensor, *,
              student_temp: float = 0.1, teacher_temp: float = 0.04,
              center_momentum: float = 0.999) -> DinoLossOut:
    """Cross-view DINO cross-entropy with teacher centring and sharpening.

    Inputs are the two-view head outputs ``[view1; view2]`` (2B, K). The loss
    is ``(H(t1, s2) + H(t2, s1)) / 2``; the centre moves towards the teacher
    batch mean by ``1 - center_momentum``. Returns the loss, the new centre
    and both entropies."""
    student_out = student_out.float()
    teacher_out = teacher_out.float().detach()

    t_logprob = F.log_softmax((teacher_out - center) / teacher_temp, dim=-1)
    t_prob = torch.exp(t_logprob)
    s_logprob = F.log_softmax(student_out / student_temp, dim=-1)

    b = teacher_out.shape[0] // 2
    ce_12 = -torch.mean(torch.sum(t_prob[:b] * s_logprob[b:], dim=-1))
    ce_21 = -torch.mean(torch.sum(t_prob[b:] * s_logprob[:b], dim=-1))
    loss = (ce_12 + ce_21) / 2.0

    batch_center = torch.mean(teacher_out, dim=0, keepdim=True)
    new_center = center * center_momentum + batch_center * (1.0 - center_momentum)

    t_entropy = -torch.mean(torch.sum(t_prob * t_logprob, dim=-1))
    s_entropy = -torch.mean(torch.sum(torch.exp(s_logprob) * s_logprob, dim=-1))
    return DinoLossOut(loss, new_center, t_entropy.detach(), s_entropy.detach())


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def gram_matrix(tokens: torch.Tensor) -> torch.Tensor:
    """(B, N, D) -> L2-normalised token Gram matrices (B, N, N), float32."""
    t = _l2_normalize(tokens.float())
    return torch.matmul(t, t.transpose(-1, -2))


def gram_anchoring_loss(student_feats: torch.Tensor, teacher_feats: torch.Tensor) -> torch.Tensor:
    """MSE between the student's and the teacher's Gram matrices of
    ``feats[:, 1:]``: CLS is dropped, the registers (last) are kept."""
    g_s = gram_matrix(student_feats[:, 1:])
    g_t = gram_matrix(teacher_feats[:, 1:].detach())
    return torch.mean((g_s - g_t) ** 2)


def koleo_loss(features: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Kozachenko-Leonenko regulariser: -mean log(nearest-neighbour distance)
    over the L2-normalised batch, from the cosine Gram (d^2 = 2 - 2 cos)."""
    x = _l2_normalize(features.float())
    sq = torch.clamp_min(2.0 - 2.0 * torch.matmul(x, x.t()), 0.0)
    sq = sq + torch.eye(x.shape[0], dtype=sq.dtype, device=sq.device) * 1e18  # mask self
    nn_dist = torch.sqrt(torch.amin(sq, dim=1))
    return -torch.mean(torch.log(nn_dist + eps))


def simclr_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """NT-Xent over the 2B-sample batch; positives are the cross-view pairs."""
    feats = torch.cat([_l2_normalize(z1.float()), _l2_normalize(z2.float())], dim=0)
    b = z1.shape[0]
    logits = torch.matmul(feats, feats.t()) / temperature
    eye = torch.eye(2 * b, dtype=torch.bool, device=logits.device)
    logits = torch.where(eye, torch.full_like(logits, -9e15), logits)
    targets = torch.cat([torch.arange(b, 2 * b), torch.arange(0, b)]).to(logits.device)
    logprob = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logprob, 1, targets[:, None]))
