"""Model FLOPs of a ViT-DINO configuration, frozen from the program's
``utils/flops.py``.

Convention: a matmul is 2*m*n*k, the backward is twice the forward, only
the model's own matmuls count, and a recomputation (gradient checkpointing)
is not counted. A DINO training slice is two views, each through a student
forward and backward and a teacher forward: ``2 * (3 + 1)`` forwards.

*model* is the ``model`` mapping of a configuration file: ``img_size``,
``patch``, ``dim``, ``depth``, ``mlp_ratio``, ``out_dim``,
``num_registers`` and, for a Switch-MoE model, ``moe_experts``,
``moe_every`` and ``moe_capacity_factor``.
"""

from __future__ import annotations

from typing import Any, Mapping

# Published dense bf16 tensor-core peak (FLOP/s) and memory rate (B/s) of the
# H100 parts (NVIDIA data sheets, at the part's full power limit).
H100_PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12), "nvl": (835e12, 3.9e12)}


def card_peaks(name: str) -> tuple[float, float]:
    """(bf16 dense FLOP/s, bytes/s) of the H100 part named *name*
    (``torch.cuda.get_device_name``); SXM unless the name says PCIe or NVL."""
    low = name.lower()
    return H100_PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"]


def n_patches(model: Mapping[str, Any]) -> int:
    return (model["img_size"] // model["patch"]) ** 2


def seq_len(model: Mapping[str, Any]) -> int:
    """CLS + patches + registers."""
    return 1 + n_patches(model) + model.get("num_registers", 0)


def _moe_block(model: Mapping[str, Any]) -> float:
    d, n, e = model["dim"], seq_len(model), model["moe_experts"]
    hidden = int(d * model["mlp_ratio"])
    cap = max(1, int(n / e * model.get("moe_capacity_factor", 1.25)))
    return 2.0 * n * d * e + 2.0 * n * e * cap * d * 2 + 2.0 * e * cap * d * hidden * 2


def backbone_flops_per_view(model: Mapping[str, Any]) -> float:
    """Matmul FLOPs of one backbone forward on one view: patch embed, per
    block qkv, the two attention products, proj and the MLP (or the MoE
    block's, in every ``moe_every``-th block)."""
    d, n, depth = model["dim"], seq_len(model), model["depth"]
    hidden = int(d * model["mlp_ratio"])
    patch_embed = 2.0 * n_patches(model) * (3 * model["patch"] ** 2) * d
    attn = 2.0 * n * d * (3 * d) + 2.0 * (2.0 * n * n * d) + 2.0 * n * d * d
    mlp = 2.0 * n * d * hidden * 2
    experts = model.get("moe_experts", 0)
    every = model.get("moe_every", 2)
    n_moe = sum(1 for i in range(depth) if i % every == every - 1) if experts > 0 else 0
    moe = _moe_block(model) if n_moe else 0.0
    return patch_embed + depth * attn + (depth - n_moe) * mlp + n_moe * moe


def head_flops_per_view(model: Mapping[str, Any]) -> float:
    """The DINO head on CLS: dim -> dim -> out_dim."""
    d = model["dim"]
    return 2.0 * (d * d + d * model["out_dim"])


def forward_flops_per_view(model: Mapping[str, Any]) -> float:
    """Backbone and head, one view."""
    return backbone_flops_per_view(model) + head_flops_per_view(model)


def train_flops_per_slice(model: Mapping[str, Any]) -> float:
    """2 views x (student forward + backward (2x forward) + teacher forward)."""
    return 2.0 * (3.0 + 1.0) * forward_flops_per_view(model)


def embed_flops_per_slice(model: Mapping[str, Any]) -> float:
    """One view through the backbone alone: the embedding path runs no head."""
    return backbone_flops_per_view(model)
