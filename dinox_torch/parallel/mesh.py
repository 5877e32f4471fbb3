"""The ``(data, model[, expert])`` mesh over processes: the counterpart of
``dinox_tpu.parallel.mesh``; and the ``(data, pipe)`` mesh of
``parallel.pipeline.make_pp_mesh``.

One process per card, the PyTorch idiom, in place of JAX's one controller
per host. The world of W processes is laid out as ``make_mesh``'s
``reshape(W // (tp * ep), tp, ep)``: ``dp_rank = rank // (tp * ep)``,
``tp_rank = (rank // ep) % tp`` and ``ep_rank = rank % ep`` (with ep 1 the
``(data, model)`` layout ``reshape(W // tp, tp)``). The batch is split over
the data axis only (:func:`batch_rows`): the ranks of a model group and of
an expert group read the same rows. Parameters are replicated, except that
with tp > 1 the Megatron rule of :func:`tp_param_spec` cuts qkv/fc1 by
output columns and proj/fc2 by input rows, and with ep > 1 the MoE expert
stacks are cut on their expert axis (:func:`ep_param_spec`); see
:func:`shard_state`. Gradients, metrics and the losses' batch statistics
are reduced over the data group explicitly (``parallel.collectives``),
where GSPMD inserts them in the JAX package.

Multi-process: call :func:`init_distributed` first; it starts a process
group over a TCP store at the coordinator's address, and a gloo group on
the host for :func:`host_barrier`.
"""

from __future__ import annotations

import datetime
import re
import socket
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from dinox_torch.parallel.collectives import all_gather
from dinox_torch.utils.platform import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

_HOST_GROUP: list = []  # the gloo group of host_barrier, made by init_distributed
TIMEOUT_S = 600.0  # the process group's and the host barrier's


def init_distributed(coordinator: Optional[str], num_processes: Optional[int],
                     process_id: Optional[int], backend: Optional[str] = None,
                     device: torch.device | str | None = None) -> None:
    """Join a process group of *num_processes* over a TCP store at
    *coordinator* (``host:port``, the store of process 0). No-op for one
    process. *backend* ``None`` is NCCL when *device* is a card (the card
    unless ``"cpu"``), gloo on the CPU. Then one real collective on the
    device, as a fail-fast health check of the transport."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"{num_processes} processes need a coordinator host:port and a process id "
                         f"in [0, {num_processes}); got {coordinator!r} and {process_id!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _HOST_GROUP[:] = [dist.new_group(backend="gloo", timeout=timeout)]
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"process group health check: all_reduce of ones gave {probe.item()}, "
                           f"not {num_processes}")
    host_barrier("dinox_torch:init_distributed")


def host_barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """A barrier of every process on the host (gloo), not a device
    collective; a rank that does not arrive within *timeout_s* is named in
    the error. No-op when not distributed or when the group was made
    elsewhere (a plain ``dist.barrier`` then)."""
    if not dist.is_initialized():
        return
    if not _HOST_GROUP:
        dist.barrier()
        return
    try:
        dist.monitored_barrier(_HOST_GROUP[0], timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"host barrier {name!r}: {e}") from e


def any_rank(flag: bool) -> bool:
    """True when *flag* is true on any process (a host all-reduce); the
    local flag when not distributed."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP[0] if _HOST_GROUP else None)
    return bool(t.item())


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place on the ``(data, model, expert)`` mesh: the world
    size and rank, the axes' sizes, the groups of this rank's data axis
    (same tp_rank and ep_rank), model axis (same dp_rank and ep_rank) and
    expert axis (same dp_rank and tp_rank), the number of hosts, and the
    device this rank computes on. Groups are ``None`` on a world of one
    process with no process group, and the expert group is ``None`` with
    ep 1. On a ``(data, pipe)`` mesh (``parallel.pipeline.make_pp_mesh``)
    *pp* is the pipe axis's size, the data group is the stage's (same
    stage), *pipe_group* the ranks of this rank's data rank (every stage)
    and *pipe_pairs* the two-rank groups of this stage with the one before
    and the one after it (``None`` at the ends)."""

    world: int
    rank: int
    dp: int
    tp: int
    data_group: Any
    model_group: Any
    device: torch.device
    hosts: int = 1
    ep: int = 1
    expert_group: Any = None
    pp: int = 1
    pipe_group: Any = None
    pipe_pairs: tuple = (None, None)

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.tp * self.ep * self.pp)

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (0 without a pipe axis)."""
        return self.rank % self.pp

    @property
    def tp_rank(self) -> int:
        return (self.rank // self.ep) % self.tp

    @property
    def ep_rank(self) -> int:
        return self.rank % self.ep

    @property
    def multi(self) -> bool:
        """More than one rank (the reference's ``_is_multidevice``)."""
        return self.world > 1

    def axis(self, name: str) -> tuple[int, int, Any]:
        """(size, this rank's index, group) of the model or expert axis."""
        if name == MODEL_AXIS:
            return self.tp, self.tp_rank, self.model_group
        if name == EXPERT_AXIS:
            return self.ep, self.ep_rank, self.expert_group
        raise ValueError(f"no axis {name!r} to cut parameters over")


def make_mesh(model_parallel: int = 1, expert_parallel: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The ``(data, model[, expert])`` mesh of this process group (a world of
    one without one). Every process calls it, in the same order as its other
    collectives. *device* is the card unless ``"cpu"``; a card without an
    index is ``cuda:{rank % device_count}``. Raises ``ValueError`` when the
    world does not divide by ``model_parallel * expert_parallel``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp, ep = model_parallel, expert_parallel
    if tp < 1 or ep < 1 or world % (tp * ep):
        raise ValueError(f"{world} processes not divisible by model_parallel={tp} x "
                         f"expert_parallel={ep}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dp = world // (tp * ep)
    if not dist.is_initialized():
        return Mesh(world, rank, dp, tp, None, None, dev, ep=ep)

    def at(d: int, t: int, e: int) -> int:
        return (d * tp + t) * ep + e

    here = Mesh(world, rank, dp, tp, None, None, dev, ep=ep)
    groups = {}
    # Every rank makes every group, in one order (at ep 1, PR 15's order).
    for t in range(tp):
        for e in range(ep):
            g = dist.new_group([at(d, t, e) for d in range(dp)])
            if (here.tp_rank, here.ep_rank) == (t, e):
                groups["data"] = g
    for d in range(dp):
        for e in range(ep):
            g = dist.new_group([at(d, t, e) for t in range(tp)])
            if (here.dp_rank, here.ep_rank) == (d, e):
                groups["model"] = g
    if ep > 1:
        for d in range(dp):
            for t in range(tp):
                g = dist.new_group([at(d, t, e) for e in range(ep)])
                if (here.dp_rank, here.tp_rank) == (d, t):
                    groups["expert"] = g
    names: list = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return Mesh(world, rank, dp, tp, groups["data"], groups["model"], dev, hosts=len(set(names)),
                ep=ep, expert_group=groups.get("expert"))


def batch_rows(mesh: Mesh, global_batch: int) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of the global batch that this rank's data group
    owns: the counterpart of ``put_global_batch``/``shard_batch``."""
    if global_batch % mesh.dp:
        raise ValueError(f"batch={global_batch} not divisible by data axis size {mesh.dp}")
    b = global_batch // mesh.dp
    return mesh.dp_rank * b, (mesh.dp_rank + 1) * b


# Megatron's rule on the port's timm-style names (the JAX package's
# tp_param_spec matches flax's qkv/fc1/proj/fc2 kernels under attn/mlp).
# A name may carry a suffix after the parameter's (an optimizer entry's key).
_COLUMN = re.compile(r"(?:^|\.)(attn\.qkv|mlp\.fc1)\.(weight|bias)(?:\.(\w+))?$")
_ROW = re.compile(r"(?:^|\.)(?:attn\.proj|mlp\.fc2)\.weight(?:\.(\w+))?$")
_EXPERT = re.compile(r"(?:^|\.)moe\.(?:w1|w2|b1|b2)(?:\.\w+)?$")
_BLOCK = re.compile(r"^(?:backbone\.|encoder\.)?blocks\.")
_LORA = re.compile(r"(?:^|\.)(attn\.qkv|mlp\.fc1|attn\.proj|mlp\.fc2)\.lora_([AB])\.weight$")


def tp_param_spec(name: str, tensor) -> Optional[tuple[int, int]]:
    """How tensor parallelism cuts the parameter (or optimizer entry) called
    *name*: ``(axis, groups)`` or ``None`` for replicated. Column-parallel
    ``attn.qkv`` and ``mlp.fc1`` cut their output axis (weight axis 0 and
    the bias); row-parallel ``attn.proj`` and ``mlp.fc2`` cut their input
    axis (weight axis 1; the bias is replicated and added once, after the
    reduction). Everything else (embeddings, norms, the scale embedding,
    the DINO head, LoRA factors, MoE layers) is replicated. *groups* 3 cuts
    qkv by heads: the axis is read as ``[q | k | v]`` and each third is cut,
    so a rank's rows are the q, k and v of its heads, the packed layout
    kernel 1 reads.

    The factored second moments of a weight (``train.optim.AdamFactored``:
    ``exp_avg_sq_r`` runs along the input axis, ``exp_avg_sq_c`` along the
    output axis) are cut where their axis is: a column-parallel weight's
    ``c`` as its output axis, a row-parallel weight's ``r`` as its input
    axis. The other statistic is a mean over the cut axis, replicated."""
    ndim = getattr(tensor, "ndim", 0)
    m = _COLUMN.search(name)
    if m:
        layer, kind, key = m.groups()
        groups = 3 if layer == "attn.qkv" else 1
        if key in ("exp_avg_sq_r", "exp_avg_sq_c"):
            return (0, groups) if key == "exp_avg_sq_c" and kind == "weight" and ndim == 1 else None
        if (kind == "weight" and ndim == 2) or (kind == "bias" and ndim == 1):
            return 0, groups
        return None
    m = _ROW.search(name)
    if m:
        key = m.group(1)
        if key in ("exp_avg_sq_r", "exp_avg_sq_c"):
            return (0, 1) if key == "exp_avg_sq_r" and ndim == 1 else None
        return (1, 1) if ndim == 2 else None
    return None


def ep_param_spec(name: str, tensor) -> Optional[tuple[int, int]]:
    """How expert parallelism cuts the parameter (or optimizer entry) called
    *name*: an MoE expert stack (``moe.w1``/``w2``/``b1``/``b2``, axis 0 the
    experts) and its optimizer entries of two or more axes (the moments, the
    factored statistics) on axis 0, ``(0, 1)``; ``None`` for everything else
    (the router stays replicated). The JAX package's ``ep_param_spec``."""
    return (0, 1) if _EXPERT.search(name) and getattr(tensor, "ndim", 0) >= 2 else None


def param_cut(name: str, tensor, mesh: Mesh) -> Optional[tuple[tuple[int, int], str]]:
    """(spec, axis name) of the cut the mesh makes of *name*, or ``None``
    when it is replicated: the expert cut with ep > 1, else the tensor-
    parallel cut with tp > 1 (no tensor takes both)."""
    if mesh.ep > 1 and (spec := ep_param_spec(name, tensor)) is not None:
        return spec, EXPERT_AXIS
    if mesh.tp > 1 and (spec := tp_param_spec(name, tensor)) is not None:
        return spec, MODEL_AXIS
    return None


def model_group_share(name: str, tensor, sequence_parallel: bool) -> bool:
    """True when each rank of a model group (tp > 1) holds a share of the
    gradient of the replicated parameter *name*, so that the step sums it
    over the group. Under sequence parallelism: every replicated parameter
    of the backbone's blocks (norms, row-parallel biases, LoRA factors: each
    rank's comes from its token chunk) but an MoE layer's, which runs whole
    on every rank. Without it: the LoRA factors of the cut layers (a column
    layer's A and B from the rank's output columns, a row layer's A from its
    input columns), but not a row layer's B, computed whole on every rank."""
    if tp_param_spec(name, tensor) is not None or ".moe." in f".{name}":
        return False
    if sequence_parallel:
        return bool(_BLOCK.search(name))
    m = _LORA.search(name)
    return m is not None and not (m.group(1) in ("attn.proj", "mlp.fc2") and m.group(2) == "B")


def cut(t, spec: tuple[int, int], tp: int, tp_rank: int):
    """Rank *tp_rank*'s shard of the full tensor or array *t* under *spec*."""
    axis, groups = spec
    size = t.shape[axis]
    if size % (groups * tp):
        raise ValueError(f"axis {axis} of size {size} does not divide into {groups} x {tp} parts")
    shape = tuple(t.shape)
    v = t.reshape(shape[:axis] + (groups, tp, size // (groups * tp)) + shape[axis + 1:])
    part = v[(slice(None),) * (axis + 1) + (tp_rank,)]
    out = part.reshape(shape[:axis] + (size // tp,) + shape[axis + 1:])
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) else out.contiguous().clone()


def join(parts: list, spec: tuple[int, int]) -> torch.Tensor:
    """The full tensor from the ranks' shards (in rank order) under *spec*."""
    axis, groups = spec
    s = tuple(parts[0].shape)
    views = [p.reshape(s[:axis] + (groups, 1, s[axis] // groups) + s[axis + 1:]) for p in parts]
    return torch.cat(views, axis + 1).reshape(s[:axis] + (s[axis] * len(parts),) + s[axis + 1:])


def _models(state) -> tuple:
    return state.student, state.teacher


def shard_model(model: torch.nn.Module, mesh: Mesh, optimizer=None) -> torch.nn.Module:
    """Put *model* (a full model, the same on every rank) on the mesh, in
    place: it learns the mesh (``models.vit.set_mesh``), and each parameter
    the mesh cuts (:func:`param_cut`) becomes this rank's shard, with its
    entries in *optimizer*'s state (by the name ``{param}.{key}``). An
    optimizer that keeps statistics over a parameter's axes (``cut_axis``,
    ``train.optim.AdamFactored``) learns which axis is cut and over which
    group. On a pipe axis (pp > 1) the model keeps only its stage's blocks
    and their optimizer entries (``parallel.pipeline.cut_to_stage``).
    Returns *model*."""
    from dinox_torch.models.vit import set_mesh
    from dinox_torch.parallel.pipeline import cut_to_stage

    set_mesh(model, mesh)
    if mesh.pp > 1:
        cut_to_stage(model, mesh, optimizer)
    if mesh.tp == 1 and mesh.ep == 1:
        return model
    note_cut = getattr(optimizer, "cut_axis", None)
    for name, p in model.named_parameters():
        c = param_cut(name, p, mesh)
        if c is None:
            continue
        spec, axis = c
        size, index, group = mesh.axis(axis)
        entry = optimizer.state.get(p, {}) if optimizer is not None else {}
        for key, value in entry.items():
            at = param_cut(f"{name}.{key}", value, mesh) if torch.is_tensor(value) else None
            if at is not None:
                entry[key] = cut(value, at[0], size, index)
        p.data = cut(p.data, spec, size, index)
        if note_cut is not None:
            note_cut(p, spec[0], group)
    return model


def shard_state(state, mesh: Mesh):
    """Put *state* (a full ``TrainState``, the same on every rank) on the
    mesh, in place (:func:`shard_model` of the student with its optimizer,
    and of the teacher). Returns *state*."""
    shard_model(state.student, mesh, state.optimizer)
    shard_model(state.teacher, mesh)
    return state


def gather_tensors(tensors: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """Checkpoint-named tensors (``train.checkpoint.state_tensors``) of this
    rank, put back together over the model and expert groups: every rank
    calls it and gets the full tensors. On a pipe axis the other stages'
    blocks are gathered over the pipe group (``parallel.pipeline.gather_stages``).
    With tp 1, ep 1 and pp 1 the tensors are returned as they are."""
    if mesh.pp > 1:
        from dinox_torch.parallel.pipeline import gather_stages

        return gather_stages(tensors, mesh)
    if mesh.tp == 1 and mesh.ep == 1:
        return dict(tensors)
    out = {}
    for name, t in tensors.items():
        c = param_cut(name, t, mesh)
        if c is None:
            out[name] = t
            continue
        full = all_gather(t[None], mesh.axis(c[1])[2], 0)
        out[name] = join(list(full.unbind(0)), c[0])
    return out


def gather_state(state, mesh: Mesh) -> dict[str, torch.Tensor]:
    """The full state's tensors by checkpoint name, on every rank: the
    one-card ``state_tensors`` of *state*."""
    from dinox_torch.train.checkpoint import state_tensors

    return gather_tensors(state_tensors(state), mesh)


def shard_tensors(arrays: Mapping[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This rank's shards of full checkpoint-named arrays (numpy or tensors):
    on a pipe axis, the rest and this stage's blocks."""
    if mesh.pp > 1:
        from dinox_torch.parallel.pipeline import stage_tensors

        return stage_tensors(arrays, mesh)
    if mesh.tp == 1 and mesh.ep == 1:
        return dict(arrays)
    out = {}
    for name, a in arrays.items():
        c = param_cut(name, a, mesh)
        out[name] = a if c is None else cut(a, c[0], *mesh.axis(c[1])[:2])
    return out
