"""Model configuration and presets.

The same fields, defaults and presets as ``dinox_tpu.models.config``, so a
checkpoint's ``config.json`` has one schema in both packages. ``attn_impl``
keeps its values and meanings: ``"pallas"`` selects the hand-written packed
attention kernel for a CUDA tensor (its plain version, with the kernel's
rounding points, for a CPU tensor), ``"xla"`` the JAX package's plain
``sdpa_xla`` on head-major q, k, v everywhere (``models.vit.sdpa_xla``).

After those fields the port adds its own, which the JAX package does not
have. ``block`` picks the block once: ``"vit"`` (the default, the JAX
package's model) or ``"dinov3"``, DINOv3's ViT-7B block
(``models.vit.RopeBlock``: axial 2D RoPE on q and k with no learned
positions, a SwiGLU feed-forward, LayerScale on both branches, no qkv
bias). Three values belong to the DINOv3 block alone and keep their
defaults with ``"vit"``: ``ffn_hidden``, the SwiGLU's hidden width;
``layer_scale``, the LayerScale gains' initial value; and
``rope_rescale``, DINOv3's ``rescale_coords`` (a training forward of the
student multiplies the RoPE coordinates by a factor log-uniform in
[1/rescale, rescale]; 1 turns it off; the pipeline's step,
``train.pp_step``, draws none).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a PatchViT backbone + DINO head."""

    name: str = "vit-small"
    img_size: int = 224
    patch: int = 14
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    out_dim: int = 8192
    num_registers: int = 4
    scale_aware: bool = False
    use_grad_checkpoint: bool = False
    attn_impl: str = "pallas"  # "pallas" (packed kernel on CUDA) | "xla" (sdpa_xla, plain PyTorch)
    fused_mlp: bool = False
    fused_attn: bool = False
    sequence_parallel: bool = False
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    # MLP nonlinearity: tanh-approximate GELU (native default) or exact erf
    # (reference-format imports; see zoo.hub._cfg_from_dict).
    gelu_approx: bool = True
    scale_gamma_init: float = 1.0
    dtype: str = "bfloat16"  # compute dtype; params always float32
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    lora_targets: tuple = ("qkv", "proj", "fc1", "fc2")
    # Port-only fields: the block, and the DINOv3 block's values.
    block: str = "vit"  # "vit" | "dinov3"
    ffn_hidden: int = 0  # the SwiGLU's hidden width (dinov3)
    layer_scale: float = 0.0  # LayerScale's initial gain (dinov3)
    rope_rescale: float = 1.0  # rescale_coords (dinov3); 1: none

    def __post_init__(self) -> None:
        if self.dim % self.heads != 0:
            raise ValueError(f"dim ({self.dim}) must be divisible by heads ({self.heads})")
        if self.patch not in (8, 14, 16):
            warnings.warn(f"Unusual patch size: {self.patch}")
        if self.img_size % self.patch != 0:
            raise ValueError(f"img_size ({self.img_size}) must be divisible by patch ({self.patch})")
        if self.block == "vit":
            if (self.ffn_hidden, self.layer_scale, self.rope_rescale) != (0, 0.0, 1.0):
                raise ValueError("ffn_hidden, layer_scale and rope_rescale belong to block='dinov3'")
        elif self.block == "dinov3":
            if self.ffn_hidden <= 0 or self.ffn_hidden % 8:
                raise ValueError(f"block='dinov3' needs ffn_hidden, a positive multiple of 8, got {self.ffn_hidden}")
            if self.layer_scale <= 0.0:
                raise ValueError(f"block='dinov3' needs a positive layer_scale, got {self.layer_scale}")
            if self.rope_rescale < 1.0:
                raise ValueError(f"rope_rescale must be at least 1, got {self.rope_rescale}")
        else:
            raise ValueError(f"block must be 'vit' or 'dinov3', got {self.block!r}")

    @property
    def hidden(self) -> int:
        """The MLP's hidden width."""
        return self.ffn_hidden if self.block == "dinov3" else int(self.dim * self.mlp_ratio)

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch) ** 2

    @property
    def seq_len(self) -> int:
        """Total token count: CLS + patches + registers."""
        return 1 + self.n_patches + self.num_registers

    @property
    def params_millions(self) -> float:
        patch_embed = 3 * self.patch * self.patch * self.dim
        mlp = 3 * self.dim * self.hidden if self.block == "dinov3" else 8 * self.dim * self.dim * self.mlp_ratio
        transformer = self.depth * (4 * self.dim * self.dim + mlp)
        head = self.dim * self.out_dim * 2
        return (patch_embed + transformer + head) / 1e6

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# The port-only fields, in their order after the JAX package's.
PORT_ONLY_FIELDS = ("block", "ffn_hidden", "layer_scale", "rope_rescale")

MODEL_CONFIGS: dict[str, ModelConfig] = {
    "vit-tiny": ModelConfig(name="vit-tiny", patch=14, dim=192, depth=12, heads=3, out_dim=4096),
    "vit-small": ModelConfig(name="vit-small", patch=14, dim=384, depth=12, heads=6, out_dim=8192),
    "vit-large": ModelConfig(name="vit-large", patch=14, dim=1024, depth=24, heads=16, out_dim=8192),
    "vit-giant": ModelConfig(name="vit-giant", patch=14, dim=1408, depth=40, heads=16, out_dim=8192),
    # DINOv3 ViT-7B/16 (arXiv:2508.10104, facebookresearch/dinov3 vit_7b): 32
    # heads of 128, SwiGLU 8192 wide, LayerScale, RoPE (base 100) with
    # rescale_coords 2, no qkv bias, 4 registers, 256-pixel crops. The port only.
    "vit-7b16": ModelConfig(name="vit-7b16", img_size=256, patch=16, dim=4096, depth=40, heads=32,
                            out_dim=8192, block="dinov3", ffn_hidden=8192, layer_scale=1e-5,
                            rope_rescale=2.0),
}

# The hub default used when a checkpoint carries no config (patch=16,
# depth=6, exact erf GELU: config-less checkpoints are reference-format
# torch exports).
HUB_DEFAULT_CONFIG: dict[str, Any] = {
    "img_size": 224,
    "patch": 16,
    "dim": 384,
    "depth": 6,
    "heads": 6,
    "mlp_ratio": 4.0,
    "num_registers": 4,
    "scale_aware": False,
    "out_dim": 8192,
    "gelu_approx": False,
}
