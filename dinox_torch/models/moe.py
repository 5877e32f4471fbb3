"""Switch-style top-1 Mixture-of-Experts MLP: the counterpart of
``dinox_tpu.models.moe.MoeMlp``. Under data parallelism the load-balance
loss's two means are the global batch's (the token fractions all-reduced,
the mean probabilities through ``parallel.collectives.mean_over_group``);
routing is per image and needs nothing more.

Expert parallelism (:meth:`MoeMlp.set_mesh`, ep > 1), written out where the
JAX package leaves it to GSPMD's constraints: a rank holds the expert
stacks' rows ``[ep_rank * E / ep, (ep_rank + 1) * E / ep)``
(``parallel.mesh.ep_param_spec``). The router, the routing, the capacity,
the dispatch and the load-balance loss are computed whole on every rank of
the expert group; the rank runs its experts' slots of the dispatch buffer
and combines them into a partial output, and the partials are summed over
the expert group (``reduce_from_group``: all-reduce forward, identity
backward). A token has one expert, so one partial holds its output and the
others zeros: the sum is exact. The input that enters the dispatch and the
gate that enters the combine pass ``copy_to_group`` (identity forward,
all-reduce backward), so their gradients are the sums of the ranks'
shares; the router's own input does not, so the load-balance loss's
gradient, the same on every rank, is counted once.

Dense dispatch, as in the JAX package: routing is one-hot einsums onto a
fixed-capacity (B, E, C, D) buffer, grouped per image. The router is a
float32 dense layer on ``x.float()``; each token goes to the argmax of the
softmax; an expert takes at most ``C = max(1, int(N / E * capacity))``
tokens of an image (a floor, as the JAX code computes it), in token order,
and the overflow is dropped (its MLP output is zero, so the residual
carries it). The Switch load-balance loss ``E * sum_e mean(onehot_e) *
mean(p_e)`` over all tokens is returned beside the output. Dispatch, the
experts and the combine run in the compute dtype; the combine weights
``dispatch * gate`` are rounded to it before the einsum, as in the JAX
package. The expert stacks keep the JAX package's layout: ``w1`` (E, D, H),
``b1`` (E, 1, H), ``w2`` (E, H, D), ``b2`` (E, 1, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dinox_torch.parallel.collectives import all_reduce, copy_to_group, mean_over_group, reduce_from_group


class MoeMlp(nn.Module):
    """(B, N, D) -> ((B, N, D) in x's dtype, the float32 aux loss)."""

    def __init__(self, dim: int, n_experts: int, mlp_ratio: float = 4.0,
                 capacity_factor: float = 1.25, gelu_approx: bool = True):
        super().__init__()
        from dinox_torch.models.vit import Linear

        hidden = int(dim * mlp_ratio)
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.approximate = "tanh" if gelu_approx else "none"
        self.router = Linear(dim, n_experts)
        self.w1 = nn.Parameter(torch.empty(n_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_experts, 1, hidden))
        self.w2 = nn.Parameter(torch.empty(n_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(n_experts, 1, dim))
        self.data_group = None  # set by set_mesh: the aux's batch means go global
        self.expert_group, self.ep, self.ep_rank = None, 1, 0

    def set_mesh(self, mesh) -> None:
        """Run on *mesh* (``parallel.mesh.Mesh``): the load-balance means over
        its data group and, with ep > 1, this rank's experts of the expert
        stacks that ``parallel.mesh.shard_model`` cuts. Raises when the
        experts do not divide by the expert axis."""
        if self.n_experts % mesh.ep:
            raise ValueError(f"moe_experts={self.n_experts} not divisible by expert axis size {mesh.ep}")
        self.data_group = mesh.data_group
        self.expert_group, self.ep, self.ep_rank = mesh.expert_group, mesh.ep, mesh.ep_rank

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(n_tokens / self.n_experts * self.capacity_factor))

    def route(self, x: torch.Tensor, expert: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(probs (B, N, E) f32, expert (B, N), dispatch (B, N, E, C) f32, aux).
        *expert*, when given, replaces the router's argmax (to hold two runs
        to one routing); the gates stay the router's probabilities."""
        e = self.n_experts
        cap = self.capacity(x.shape[1])
        probs = torch.softmax(self.router(x.float()), dim=-1)
        if expert is None:
            expert = torch.argmax(probs, dim=-1)
        onehot = F.one_hot(expert, e).float()
        frac, prob = onehot.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
        if self.data_group is not None:  # the means over the global batch
            frac, prob = all_reduce(frac, self.data_group, "mean"), mean_over_group(prob, self.data_group)
        aux = e * torch.sum(frac * prob)
        pos = torch.einsum("bte,bte->bt", torch.cumsum(onehot, dim=1) - 1.0, onehot)
        pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).float()  # 0 past C
        dispatch = onehot[..., None] * pos_oh[:, :, None, :]
        return probs, expert, dispatch, aux

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dt = x.dtype
        probs, expert, dispatch, aux = self.route(x)
        gate = torch.gather(probs, -1, expert[..., None])[..., 0]
        if self.ep > 1:  # this rank's experts' slots; x and the gate enter them as shares
            local = self.n_experts // self.ep
            dispatch = dispatch[:, :, self.ep_rank * local:(self.ep_rank + 1) * local]
            x, gate = copy_to_group(x, self.expert_group), copy_to_group(gate, self.expert_group)
        xe = torch.einsum("btec,btd->becd", dispatch.to(dt), x)
        h = torch.einsum("becd,edh->bech", xe, self.w1.to(dt)) + self.b1.to(dt)
        h = F.gelu(h, approximate=self.approximate)
        ye = torch.einsum("bech,ehd->becd", h, self.w2.to(dt)) + self.b2.to(dt)
        combine = (dispatch * gate[..., None, None]).to(dt)
        y = torch.einsum("btec,becd->btd", combine, ye)
        return (reduce_from_group(y, self.expert_group) if self.ep > 1 else y), aux
