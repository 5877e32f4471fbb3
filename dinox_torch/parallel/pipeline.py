"""Pipeline parallelism over a ``pipe`` axis (GPipe, one process per
stage): the counterpart of ``dinox_tpu.parallel.pipeline``.

The JAX package runs the schedule as one SPMD program: stacked
``(S, blocks_per_stage, ...)`` block parameters sharded over ``pipe``, a
``lax.scan`` of clock ticks with ``ppermute`` hops, and autodiff through
the scan for the backward. The port keeps the math and not the rotation:

* The world is a ``(data, pipe)`` mesh (:func:`make_pp_mesh`), pipe the
  minor axis: ``rank = dp_rank * pp + stage``. Each rank holds its stage's
  ``depth / S`` contiguous blocks as modules, and the rest (embeddings, the
  scale MLP, the final norm, the head) whole (:func:`cut_to_stage`, which
  ``parallel.mesh.shard_model`` calls): the memory PP exists for. Parameter
  and checkpoint names stay the one-process ones, so a checkpoint gathered
  over the pipe group (:func:`gather_stages`) is a one-process checkpoint.
* :func:`pipeline_run_blocks` is the GPipe fill-drain schedule on this
  rank's rows of the batch: stage 0 splits them into M microbatches, each
  stage runs its blocks on each microbatch in turn and sends the result to
  the next stage; the last stage puts the M outputs back together in
  order. All M forwards, then all M backwards (:meth:`StageRun.backward`,
  microbatches in reverse order): each stage gets its output's gradient
  from the next stage, runs autograd through its blocks and sends its
  input's gradient back.
* A hop is ``collectives.send``/``recv`` over the stage pair's two-rank
  group: NCCL's point-to-point ops, or on gloo a broadcast composed from
  ``all_reduce`` of the bytes (exact: the receiver adds zeros), which lets
  two gloo ranks share one card and the CPU tests run the same code.

:func:`split_backbone_params`/:func:`merge_backbone_params` and
:func:`split_model_params`/:func:`merge_model_params` are the JAX
package's layout functions on numpy trees: the port's own copies, which
carry a JAX pipeline-parallel state's weights across
(``train.state.state_from_jax``).
"""

from __future__ import annotations

import re
import socket
from collections.abc import Mapping
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from dinox_torch.parallel.collectives import broadcast, recv, send
from dinox_torch.parallel.mesh import PIPE_AXIS, Mesh
from dinox_torch.utils.platform import resolve_device

__all__ = ["PIPE_AXIS", "OtherStage", "StageRun", "check_microbatches", "cut_to_stage", "gather_stages",
           "make_pp_mesh", "merge_backbone_params", "merge_model_params", "pipeline_run_blocks",
           "pp_param_spec", "split_backbone_params", "split_model_params", "stage_block_range",
           "stage_blocks", "stage_tensors"]


def make_pp_mesh(pipeline_parallel: int, device: torch.device | str | None = None) -> Mesh:
    """The ``(data, pipe)`` mesh of this process group (a world of one
    without one): ``rank = dp_rank * pp + stage``. Every process calls it,
    in the same order as its other collectives; it makes every group on
    every rank in one order. *device* is the card unless ``"cpu"``; a card
    without an index is ``cuda:{rank % device_count}``. Raises
    ``ValueError`` when the world does not divide by *pipeline_parallel*."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    pp = pipeline_parallel
    if pp < 1 or world % pp:
        raise ValueError(f"{world} processes not divisible by pp={pp}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dp = world // pp
    if not dist.is_initialized():
        return Mesh(world, rank, dp, 1, None, None, dev, pp=pp)
    d_me, s_me = divmod(rank, pp)
    data = [dist.new_group([d * pp + s for d in range(dp)]) for s in range(pp)]
    pipe = [dist.new_group([d * pp + s for s in range(pp)]) for d in range(dp)]
    pairs = [[dist.new_group([d * pp + s, d * pp + s + 1]) for s in range(pp - 1)] for d in range(dp)]
    names: list = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    mine = pairs[d_me]
    return Mesh(world, rank, dp, 1, data[s_me], None, dev, hosts=len(set(names)), pp=pp,
                pipe_group=pipe[d_me],
                pipe_pairs=(mine[s_me - 1] if s_me > 0 else None, mine[s_me] if s_me < pp - 1 else None))


# -- the JAX package's parameter layout, on numpy trees -------------------------


def _tree_map(fn: Callable, *trees: Any) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree: Any) -> list:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def split_backbone_params(backbone: Mapping, n_stages: int) -> tuple[dict, Any]:
    """A JAX backbone tree -> (rest, stacked): ``rest`` without the
    ``blocks_i`` subtrees, ``stacked`` one block's tree whose leaves carry
    leading (n_stages, blocks_per_stage) axes, leaf ``[s, j]`` block
    ``s * blocks_per_stage + j``."""
    block_keys = sorted((k for k in backbone if k.startswith("blocks_")), key=lambda k: int(k.split("_")[1]))
    depth = len(block_keys)
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by {n_stages} stages")
    bps = depth // n_stages
    rest = {k: v for k, v in backbone.items() if not k.startswith("blocks_")}
    stacked = _tree_map(lambda *leaves: np.stack([np.asarray(a) for a in leaves]).reshape(
        (n_stages, bps) + np.shape(leaves[0])), *(backbone[k] for k in block_keys))
    return rest, stacked


def merge_backbone_params(rest: Mapping, stacked: Any) -> dict:
    """Inverse of :func:`split_backbone_params`."""
    n_stages, bps = np.shape(_leaves(stacked)[0])[:2]
    out = dict(rest)
    for s in range(n_stages):
        for j in range(bps):
            out[f"blocks_{s * bps + j}"] = _tree_map(lambda a: np.asarray(a)[s, j], stacked)
    return out


def split_model_params(params: Mapping, n_stages: int) -> dict:
    """A DinoStudentTeacher tree -> ``{"rest": ..., "blocks": stacked}``."""
    rest_bb, blocks = split_backbone_params(params["backbone"], n_stages)
    rest = {k: v for k, v in params.items() if k != "backbone"}
    rest["backbone"] = rest_bb
    return {"rest": rest, "blocks": blocks}


def merge_model_params(pp_params: Mapping) -> dict:
    """Inverse of :func:`split_model_params`."""
    rest = dict(pp_params["rest"])
    rest["backbone"] = merge_backbone_params(rest["backbone"], pp_params["blocks"])
    return rest


# -- the stage cut ----------------------------------------------------------------

# A stage's tensor by the port's names: a parameter (``backbone.blocks.3.*``),
# a checkpoint entry (``student.``/``teacher.``/``optimizer.`` before it).
_BLOCK = re.compile(r"(?:^|\.)backbone\.blocks\.(\d+)\.")


def stage_block_range(depth: int, n_stages: int, stage: int) -> tuple[int, int]:
    """The blocks ``[lo, hi)`` of *stage*; raises when *depth* does not
    divide into *n_stages*."""
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by {n_stages} stages")
    bps = depth // n_stages
    return stage * bps, (stage + 1) * bps


def pp_param_spec(name: str) -> Optional[int]:
    """The block index of a stage's parameter, optimizer entry or checkpoint
    tensor called *name*; ``None`` for the rest, which every stage holds."""
    m = _BLOCK.search(name)
    return int(m.group(1)) if m else None


class OtherStage(nn.Module):
    """The place of a block that another pipeline stage holds: no
    parameters, and it refuses to run."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} runs on pipeline stage {self.stage}, not on this rank")


def _vit(model: nn.Module) -> nn.Module:
    return getattr(model, "backbone", model)


def cut_to_stage(model: nn.Module, mesh: Mesh, optimizer: Optional[torch.optim.Optimizer] = None
                 ) -> nn.Module:
    """Keep only this rank's stage of *model*'s blocks, in place: every other
    block becomes an :class:`OtherStage` and leaves *optimizer* (its
    parameter groups and state). The kept blocks run as the reference's
    stage block (``pp_step.py``'s ``TransformerBlock``): ``attn_impl="xla"``,
    neither fused half-block. Returns *model*."""
    vit = _vit(model)
    depth = len(vit.blocks)
    lo, hi = stage_block_range(depth, mesh.pp, mesh.stage)
    gone: list[torch.Tensor] = []
    for i in range(depth):
        blk = vit.blocks[i]
        if lo <= i < hi:
            blk.attn.attn_impl = "xla"
            blk.fused_attn = blk.fused_mlp = False
        elif not isinstance(blk, OtherStage):
            gone.extend(blk.parameters())
            vit.blocks[i] = OtherStage(i, i // (hi - lo))
    if optimizer is not None and gone:
        ids = {id(p) for p in gone}
        for group in optimizer.param_groups:
            group["params"] = [p for p in group["params"] if id(p) not in ids]
        for p in gone:
            optimizer.state.pop(p, None)
    return model


def stage_blocks(model: nn.Module) -> list[nn.Module]:
    """The blocks *model* holds, in order (a stage's after :func:`cut_to_stage`)."""
    return [b for b in _vit(model).blocks if not isinstance(b, OtherStage)]


def stage_tensors(arrays: Mapping[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This stage's share of full checkpoint-named arrays: the rest and its
    blocks' tensors."""
    index = {k: pp_param_spec(k) for k in arrays}
    depth = 1 + max((i for i in index.values() if i is not None), default=-1)
    lo, hi = stage_block_range(depth, mesh.pp, mesh.stage)
    return {k: a for k, a in arrays.items() if index[k] is None or lo <= index[k] < hi}


def _renamed(name: str, index: int) -> str:
    m = _BLOCK.search(name)
    return f"{name[:m.start(1)]}{index}{name[m.end(1):]}"


def gather_stages(tensors: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The full tensors from this stage's (checkpoint-named, a stage's
    blocks and the rest), on every rank of the pipe group: each stage's
    blocks broadcast from that stage, one flat bucket per dtype on the
    mesh's device. The stages hold blocks of one shape, so a rank names
    another stage's tensors by shifting its own block indices."""
    own = {k: pp_param_spec(k) for k in tensors}
    own = {k: i for k, i in own.items() if i is not None}
    lo = min(own.values())
    bps = len(set(own.values()))
    out = dict(tensors)
    by_dtype: dict[torch.dtype, list[str]] = {}
    for k in own:
        by_dtype.setdefault(tensors[k].dtype, []).append(k)
    for stage in range(mesh.pp):
        for dtype, names in by_dtype.items():
            flat = torch.cat([tensors[k].detach().reshape(-1).to(mesh.device) for k in names])
            flat = broadcast(flat, stage, mesh.pipe_group)
            if stage == mesh.stage:
                continue
            at = 0
            for k in names:
                t = tensors[k]
                out[_renamed(k, own[k] - lo + stage * bps)] = flat[at:at + t.numel()].view(t.shape).to(t.device)
                at += t.numel()
    return out


# -- the schedule ---------------------------------------------------------------


class StageRun:
    """This rank's share of one pass of :func:`pipeline_run_blocks`: the
    microbatches' inputs and outputs of its blocks, kept for the backward.
    ``output`` is the last stage's (B, N, D) tokens (a leaf that requires
    grad under autograd), ``None`` on the other stages."""

    def __init__(self, mesh: Mesh, ins: list, outs: list, output: Optional[torch.Tensor]):
        self.mesh, self.ins, self.outs, self.output = mesh, ins, outs, output

    def backward(self, grad: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """The drain of the backward: the last stage gives the gradient of
        ``output``; each stage takes its microbatches' output gradients in
        reverse order, runs autograd through its blocks (their parameters'
        ``.grad`` accumulate) and sends each input's gradient to the stage
        before it. Returns the gradient of the input on stage 0, ``None``
        elsewhere."""
        mesh, ins, outs = self.mesh, self.ins, self.outs
        first, last = mesh.stage == 0, mesh.stage == mesh.pp - 1
        grads = grad.chunk(len(outs)) if last else None
        dx: list = [None] * len(outs)
        for m in reversed(range(len(outs))):
            y = outs[m]
            g = grads[m].contiguous() if last else recv(y.shape, y.dtype, y.device, mesh.pipe_pairs[1], 1)
            torch.autograd.backward(y, g)
            if first:
                dx[m] = ins[m].grad
            else:
                send(ins[m].grad, mesh.pipe_pairs[0], 0)
        self.ins, self.outs = [], []
        return torch.cat(dx) if first else None


def check_microbatches(batch: int, n_microbatches: Optional[int], mesh: Mesh) -> int:
    """The number of microbatches (*n_microbatches*, default the stages)
    of a global *batch* of rows on *mesh*; raises the reference's errors
    when there are fewer than the stages, when they do not divide the
    batch, or when the data axis does not divide a microbatch."""
    S = mesh.pp
    M = n_microbatches or S
    if M < S:
        raise ValueError(f"need >= {S} microbatches for {S} stages, got {M}")
    if batch % M:
        raise ValueError(f"batch {batch} not divisible into {M} microbatches")
    if (batch // M) % mesh.dp:
        raise ValueError(f"microbatch size {batch // M} not divisible by data axis size {mesh.dp}")
    return M


def pipeline_run_blocks(blocks: Sequence[nn.Module], x: torch.Tensor, mesh: Mesh,
                        n_microbatches: Optional[int] = None, remat: bool = False) -> StageRun:
    """Run this rank's rows ``x`` (B_rank, N, D) through the pipelined block
    stack; *blocks* are this stage's blocks in order. Stage 0 reads *x*;
    the other stages read only its shape, dtype and device. Microbatches
    (default ``S``; more shrink the (S-1)/(M+S-1) bubble) must number at
    least S and divide the global batch ``B = B_rank * dp``, and ``B / M``
    must divide by the data axis. With *remat* each block is recomputed in
    the backward. Under ``torch.no_grad`` there is no backward."""
    S = mesh.pp
    M = check_microbatches(x.shape[0] * mesh.dp, n_microbatches, mesh)
    first, last = mesh.stage == 0, mesh.stage == S - 1
    grad = torch.is_grad_enabled()
    parts = x.detach().chunk(M) if first else None
    shape = (x.shape[0] // M,) + tuple(x.shape[1:])
    ins, outs = [], []
    for m in range(M):
        h = parts[m].contiguous() if first else recv(shape, x.dtype, x.device, mesh.pipe_pairs[0], 0)
        if grad:
            h.requires_grad_()
        y = h
        for blk in blocks:
            y = torch.utils.checkpoint.checkpoint(blk, y, use_reentrant=False) if remat and grad else blk(y)
        if not last:
            send(y.detach(), mesh.pipe_pairs[1], 1)
        if grad:
            ins.append(h)
            outs.append(y)
        elif last:
            outs.append(y)
    output = None
    if last:
        output = torch.cat([y.detach() for y in outs])
        if grad:
            output.requires_grad_()
        else:
            outs = []
    return StageRun(mesh, ins, outs, output)
