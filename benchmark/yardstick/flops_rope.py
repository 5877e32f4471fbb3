"""Model FLOPs of a DINOv3-block configuration (``reference/vit_rope.py``):
``yardstick.flops``'s convention with the block's own matmuls. Per block
and view: ``W_qkv`` (3 dim wide), the two attention products, ``W_o``,
``W12`` (2 x ffn_hidden wide) and ``W3``; the patch embedding once; the head
as ``flops.head_flops_per_view``. RoPE, the gate and LayerScale are not
matmuls and count nothing. A training slice is two views through the
student's forward and backward and the teacher's forward: ``2 * (3 + 1)``
forwards, recomputation not counted."""

from __future__ import annotations

from typing import Any, Mapping

from yardstick.flops import head_flops_per_view, n_patches, seq_len


def block_flops_per_view(model: Mapping[str, Any]) -> float:
    d, n, hidden = model["dim"], seq_len(model), model["ffn_hidden"]
    attn = 2.0 * n * d * (3 * d) + 2.0 * (2.0 * n * n * d) + 2.0 * n * d * d
    return attn + 2.0 * n * d * (2 * hidden) + 2.0 * n * hidden * d


def backbone_flops_per_view(model: Mapping[str, Any]) -> float:
    patch_embed = 2.0 * n_patches(model) * (3 * model["patch"] ** 2) * model["dim"]
    return patch_embed + model["depth"] * block_flops_per_view(model)


def train_flops_per_slice(model: Mapping[str, Any]) -> float:
    return 2.0 * (3.0 + 1.0) * (backbone_flops_per_view(model) + head_flops_per_view(model))
