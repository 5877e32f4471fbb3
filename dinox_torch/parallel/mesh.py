"""The ``(data, model)`` mesh over processes: the counterpart of
``dinox_tpu.parallel.mesh``.

One process per card, the PyTorch idiom, in place of JAX's one controller
per host. The world of W processes is laid out as ``make_mesh``'s
``reshape(W // tp, tp)``: ``dp_rank = rank // tp`` and ``tp_rank = rank %
tp``, so the ranks of one model group are consecutive. The batch is split
over the data axis (:func:`batch_rows`); parameters are replicated, except
that with tp > 1 the Megatron rule of :func:`tp_param_spec` cuts qkv/fc1 by
output columns and proj/fc2 by input rows (:func:`shard_state`). Gradients,
metrics and the losses' batch statistics are reduced over the data group
explicitly (``parallel.collectives``), where GSPMD inserts them in the JAX
package.

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
EXPERT_AXIS = "expert"  # MoE expert parallelism: module 13b

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
    """This process's place on the ``(data, model)`` mesh: the world size
    and rank, the two axes' sizes, the groups of this rank's data axis
    (same tp_rank) and model axis (same dp_rank), the number of hosts, and
    the device this rank computes on. Groups are ``None`` on a world of one
    process with no process group."""

    world: int
    rank: int
    dp: int
    tp: int
    data_group: Any
    model_group: Any
    device: torch.device
    hosts: int = 1

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def multi(self) -> bool:
        """More than one rank (the reference's ``_is_multidevice``)."""
        return self.world > 1


def make_mesh(model_parallel: int = 1, expert_parallel: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The ``(data, model)`` mesh of this process group (a world of one
    without one). Every process calls it, in the same order as its other
    collectives. *device* is the card unless ``"cpu"``; a card without an
    index is ``cuda:{rank % device_count}``."""
    if expert_parallel > 1:
        raise NotImplementedError(f"expert_parallel={expert_parallel} is not ported to dinox_torch "
                                  "yet: module 13b")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    tp, dp = model_parallel, world // model_parallel
    if not dist.is_initialized():
        return Mesh(world, rank, dp, tp, None, None, dev)
    data_group = model_group = None
    for t in range(tp):  # every rank makes every group, in one order
        g = dist.new_group(list(range(t, world, tp)))
        if rank % tp == t:
            data_group = g
    for d in range(dp):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if rank // tp == d:
            model_group = g
    names: list = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return Mesh(world, rank, dp, tp, data_group, model_group, dev, hosts=len(set(names)))


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
_COLUMN = re.compile(r"(?:^|\.)(attn\.qkv|mlp\.fc1)\.(weight|bias)(?:\.|$)")
_ROW = re.compile(r"(?:^|\.)(?:attn\.proj|mlp\.fc2)\.weight(?:\.|$)")


def tp_param_spec(name: str, tensor) -> Optional[tuple[int, int]]:
    """How tensor parallelism cuts the parameter (or optimizer entry) called
    *name*: ``(axis, groups)`` or ``None`` for replicated. Column-parallel
    ``attn.qkv`` and ``mlp.fc1`` cut their output axis (weight axis 0 and
    the bias); row-parallel ``attn.proj`` and ``mlp.fc2`` cut their input
    axis (weight axis 1; the bias is replicated and added once, after the
    reduction). Everything else (embeddings, norms, the scale embedding,
    the DINO head, LoRA factors) is replicated. *groups* 3 cuts qkv by
    heads: the axis is read as ``[q | k | v]`` and each third is cut, so a
    rank's rows are the q, k and v of its heads, the packed layout kernel 1
    reads."""
    ndim = getattr(tensor, "ndim", 0)
    m = _COLUMN.search(name)
    if m:
        layer, kind = m.groups()
        if (kind == "weight" and ndim == 2) or (kind == "bias" and ndim == 1):
            return 0, 3 if layer == "attn.qkv" else 1
        return None
    if _ROW.search(name) and ndim == 2:
        return 1, 1
    return None


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


def shard_state(state, mesh: Mesh):
    """Put *state* (a full ``TrainState``, the same on every rank) on the
    mesh, in place: each model learns the mesh (``models.vit.set_mesh``),
    and with tp > 1 each parameter of the student and the teacher, and each
    of the student's optimizer entries shaped like its parameter, becomes
    this rank's shard (:func:`tp_param_spec`). Returns *state*."""
    from dinox_torch.models.vit import set_mesh

    for model in _models(state):
        set_mesh(model, mesh)
    if mesh.tp == 1:
        return state
    for model in _models(state):
        for name, p in model.named_parameters():
            spec = tp_param_spec(name, p)
            if spec is None:
                continue
            entry = state.optimizer.state.get(p, {}) if model is state.student else {}
            for key, value in entry.items():
                if torch.is_tensor(value) and value.shape == p.shape:
                    entry[key] = cut(value, spec, mesh.tp, mesh.tp_rank)
            p.data = cut(p.data, spec, mesh.tp, mesh.tp_rank)
    return state


def gather_tensors(tensors: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """Checkpoint-named tensors (``train.checkpoint.state_tensors``) of this
    rank, put back together over the model group: every rank calls it and
    gets the full tensors. With tp 1 the tensors are returned as they are."""
    if mesh.tp == 1:
        return dict(tensors)
    out = {}
    for name, t in tensors.items():
        spec = tp_param_spec(name, t)
        if spec is None:
            out[name] = t
            continue
        full = all_gather(t[None], mesh.model_group, 0)
        out[name] = join(list(full.unbind(0)), spec)
    return out


def gather_state(state, mesh: Mesh) -> dict[str, torch.Tensor]:
    """The full state's tensors by checkpoint name, on every rank of the
    model group: the one-card ``state_tensors`` of *state*."""
    from dinox_torch.train.checkpoint import state_tensors

    return gather_tensors(state_tensors(state), mesh)


def shard_tensors(arrays: Mapping[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This rank's shards of full checkpoint-named arrays (numpy or tensors)."""
    if mesh.tp == 1:
        return dict(arrays)
    out = {}
    for name, a in arrays.items():
        spec = tp_param_spec(name, a)
        out[name] = a if spec is None else cut(a, spec, mesh.tp, mesh.tp_rank)
    return out

