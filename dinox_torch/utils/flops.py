"""Analytic model FLOPs for MFU: the counterpart of
``dinox_tpu.utils.flops``.

Convention: a matmul is 2*m*n*k, the backward is twice the forward, and only
the model's own matmuls count. A DINO training slice is two views, each
through a student forward and backward and a teacher forward:
``2 * (3 + 1) * forward_flops_per_view``. The card's peak is an argument:
there is no default.
"""

from __future__ import annotations

from dinox_torch.models.config import ModelConfig

# Published dense bf16 tensor-core peak (FLOP/s) and memory rate (B/s) of the
# H100 parts (NVIDIA data sheets, at the part's full power limit).
H100_PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12), "nvl": (835e12, 3.9e12)}


def card_peaks(name: str) -> tuple[float, float]:
    """(bf16 dense FLOP/s, bytes/s) of the H100 part named *name*
    (``torch.cuda.get_device_name``); SXM unless the name says PCIe or NVL."""
    low = name.lower()
    return H100_PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"]


def moe_flops_per_view_per_block(mcfg: ModelConfig) -> float:
    """Matmul FLOPs of one Switch-MoE MLP block on one view's N tokens, as
    ``models.moe`` computes it (dense dispatch, grouped per image): the
    router, the (N, E, C) x (N, D) dispatch, the experts over the (E, C, D)
    buffer and the combine."""
    d, n, e = mcfg.dim, mcfg.seq_len, mcfg.moe_experts
    hidden = int(d * mcfg.mlp_ratio)
    cap = max(1, int(n / e * mcfg.moe_capacity_factor))
    router = 2.0 * n * d * e
    dispatch = 2.0 * n * e * cap * d
    expert_ffn = 2.0 * e * cap * d * hidden * 2  # fc1 + fc2
    combine = 2.0 * n * e * cap * d
    return router + dispatch + expert_ffn + combine


def forward_flops_per_view(mcfg: ModelConfig) -> float:
    """Matmul FLOPs of one backbone + head forward on one view: patch embed,
    per-block qkv, the two attention products, proj and MLP (or the MoE
    block's, in every ``moe_every``-th block), the head on CLS."""
    d, n, depth = mcfg.dim, mcfg.seq_len, mcfg.depth
    hidden = int(d * mcfg.mlp_ratio)
    patch_embed = 2.0 * mcfg.n_patches * (3 * mcfg.patch ** 2) * d
    qkv = 2.0 * n * d * (3 * d)
    attn_bmm = 2.0 * (2.0 * n * n * d)  # QK^T and AV
    proj = 2.0 * n * d * d
    mlp = 2.0 * n * d * hidden * 2  # fc1 + fc2
    head = 2.0 * (d * d + d * mcfg.out_dim)  # CLS token only
    n_moe = sum(1 for i in range(depth) if i % mcfg.moe_every == mcfg.moe_every - 1) \
        if mcfg.moe_experts > 0 else 0
    moe = moe_flops_per_view_per_block(mcfg) if n_moe else 0.0
    return (patch_embed + (depth - n_moe) * (qkv + attn_bmm + proj + mlp)
            + n_moe * (qkv + attn_bmm + proj + moe) + head)


def train_flops_per_slice(mcfg: ModelConfig) -> float:
    """Model FLOPs of one training slice: 2 views x (student forward +
    backward (2x forward) + teacher forward)."""
    return 2.0 * (3.0 + 1.0) * forward_flops_per_view(mcfg)


def mfu(slices_per_s: float, mcfg: ModelConfig, peak_flops: float) -> float:
    """Model-FLOPs utilisation of a measured training rate against
    *peak_flops* (the card's dense bf16 peak, FLOP/s)."""
    return slices_per_s * train_flops_per_slice(mcfg) / peak_flops
