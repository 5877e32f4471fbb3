"""Collectives over a process group, plain and differentiable.

The JAX package has no counterpart: under GSPMD, XLA inserts these
collectives itself. Here they are explicit:

* :func:`all_reduce` (sum or mean), :func:`all_gather` and
  :func:`reduce_scatter` on tensors, without autograd;
* :func:`all_reduce_bucket` of a list of tensors through one flat bucket
  (the data-parallel gradient mean);
* :func:`gather_rows`, an all-gather whose backward is a reduce-scatter
  (sum), and its reverse :func:`scatter_rows` (both along any axis: the
  sequence-parallel pair runs them on the token axis);
* the Megatron pair :func:`copy_to_group` (identity forward, all-reduce
  backward) and :func:`reduce_from_group` (all-reduce forward, identity
  backward);
* :func:`split_to_group` (this rank's chunk forward, all-gather backward)
  and :func:`gather_from_group` (all-gather forward, this rank's chunk
  backward), which enter and leave a region sharded along an axis whose
  inputs and outputs are the same on every rank of the group;
* :func:`mean_over_group`, whose value is the group's mean and whose
  gradient is the rank's own term;
* :func:`broadcast` from one rank of the group, and the pipeline's hop
  between the two ranks of a stage pair, :func:`send` and :func:`recv`.

The group's backend decides how the gathers and scatters are built: NCCL
runs its native ops; for gloo they are composed from ``all_reduce``, which
is exact for floats (an all-gather adds zeros to each rank's slot, a
reduce-scatter reduces everything and keeps the rank's chunk; a broadcast,
and so a hop, sums the tensor's bytes as uint8, the source's and zeros,
which delivers every bit pattern as the source sent it). Gloo has no
reduce-scatter for CUDA tensors, and the composition is what lets two gloo
ranks share one card; the CPU tests run the same composed code. Sums of
reduced-precision tensors are taken in float32 and rounded once; a gather
keeps the tensor's dtype (adding zeros is exact in any).

A group of ``None`` is one rank with no process group: every collective is
the identity.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[Any]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _native(group: Group) -> bool:
    """True where the group's backend has a reduce-scatter for every tensor (NCCL)."""
    return dist.get_backend(group) == "nccl"


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="mean"``) of *x* over the group, a new tensor in x's dtype."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if group is None:
        return x.clone()
    y = _wide(x).clone()
    dist.all_reduce(y, group=group)
    if op == "mean":
        y = y / group_size(group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along *dim*, in rank order."""
    if group is None:
        return x.clone()
    n, r = group_size(group), group_rank(group)
    xs = x.movedim(dim, 0).contiguous()
    if _native(group):
        out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xs, group=group)
    else:
        buf = torch.zeros((n, *xs.shape), dtype=x.dtype, device=x.device)
        buf[r] = xs
        dist.all_reduce(buf, group=group)
        out = buf.reshape(n * xs.shape[0], *xs.shape[1:])
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along *dim* of the sum of the ranks' tensors; the
    axis must divide by the group size."""
    if group is None:
        return x.clone()
    n, r = group_size(group), group_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not divide by the group's {n} ranks")
    xs = _wide(x).movedim(dim, 0).contiguous()
    if _native(group):
        out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=xs.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xs, group=group)
    else:
        dist.all_reduce(xs, group=group)
        out = xs.chunk(n)[r]
    return out.to(x.dtype).movedim(0, dim).contiguous()


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, a uint8 view of its storage."""
    return x.reshape(-1).view(torch.uint8)


def broadcast(x: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Group rank *src*'s *x* on every rank of the group, a new tensor; the
    other ranks' *x* gives only the shape, dtype and device."""
    if group is None:
        return x.clone()
    out = x.clone(memory_format=torch.contiguous_format)
    if _native(group):
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out
    if group_rank(group) != src:
        out.zero_()
    dist.all_reduce(_bytes(out), group=group)
    return out


def send(x: torch.Tensor, group: Group, peer: int) -> None:
    """Send *x* to group rank *peer* of a two-rank group, which calls
    :func:`recv`: NCCL's point-to-point send; on gloo a :func:`broadcast`."""
    if _native(group):
        op = dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, peer), group)
        for req in dist.batch_isend_irecv([op]):
            req.wait()
    else:
        broadcast(x, group_rank(group), group)


def recv(shape, dtype: torch.dtype, device, group: Group, peer: int) -> torch.Tensor:
    """The tensor group rank *peer* of a two-rank group sends (:func:`send`)."""
    if _native(group):
        out = torch.empty(shape, dtype=dtype, device=device)
        op = dist.P2POp(dist.irecv, out, dist.get_global_rank(group, peer), group)
        for req in dist.batch_isend_irecv([op]):
            req.wait()
        return out
    out = torch.zeros(shape, dtype=dtype, device=device)
    dist.all_reduce(_bytes(out), group=group)
    return out


def chunk(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk of *x* along *dim*."""
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not divide by the group's {n} ranks")
    return x.chunk(n, dim)[group_rank(group)].contiguous()


def all_reduce_bucket(tensors: Sequence[torch.Tensor], group: Group, op: str = "sum"
                      ) -> list[torch.Tensor]:
    """The group sums (or ``op="mean"``) of *tensors* through one flat
    float32 bucket: one collective. Returns new tensors shaped and typed
    like the inputs."""
    if group is None:
        return [t.clone() for t in tensors]
    flat = torch.cat([_wide(t).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if op == "mean":
        flat = flat / group_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.group, ctx.dim), None, None


def gather_rows(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """All-gather along *dim*; the backward sums the gradient over the group
    and keeps this rank's chunk (reduce-scatter)."""
    return x if group is None else _GatherRows.apply(x, group, dim)


def scatter_rows(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Reduce-scatter (sum) along *dim*; the backward all-gathers."""
    return x if group is None else _ScatterRows.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward: the input of a
    column-parallel layer."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward: the output of a
    row-parallel layer."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def split_to_group(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk along *dim* of a tensor that every rank holds; the
    backward all-gathers the chunks' gradients."""
    return x if group is None else _SplitToGroup.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """All-gather along *dim* into a tensor every rank then uses alike; the
    backward keeps this rank's chunk of the (equal) gradients."""
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


def mean_over_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x + (mean_group(x) - x)`` with the bracket detached: the value is
    the group mean of *x*, the gradient that of this rank's *x*. After the
    data-parallel gradient mean it gives the gradient of the group mean.
    With one rank it is *x* to the bit."""
    if group is None:
        return x
    d = x.detach()
    return x + (all_reduce(d, group, "mean") - d)
