"""Model configuration and presets.

The same fields, defaults and presets as ``dinox_tpu.models.config``, so a
checkpoint's ``config.json`` has one schema in both packages. ``attn_impl``
keeps its values and meanings: ``"pallas"`` selects the hand-written packed
attention kernel for a CUDA tensor (its plain version, with the kernel's
rounding points, for a CPU tensor), ``"xla"`` the JAX package's plain
``sdpa_xla`` on head-major q, k, v everywhere (``models.vit.sdpa_xla``).
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

    def __post_init__(self) -> None:
        if self.dim % self.heads != 0:
            raise ValueError(f"dim ({self.dim}) must be divisible by heads ({self.heads})")
        if self.patch not in (8, 14, 16):
            warnings.warn(f"Unusual patch size: {self.patch}")
        if self.img_size % self.patch != 0:
            raise ValueError(f"img_size ({self.img_size}) must be divisible by patch ({self.patch})")

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
        transformer = self.depth * (4 * self.dim * self.dim + 8 * self.dim * self.dim * self.mlp_ratio)
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


MODEL_CONFIGS: dict[str, ModelConfig] = {
    "vit-tiny": ModelConfig(name="vit-tiny", patch=14, dim=192, depth=12, heads=3, out_dim=4096),
    "vit-small": ModelConfig(name="vit-small", patch=14, dim=384, depth=12, heads=6, out_dim=8192),
    "vit-large": ModelConfig(name="vit-large", patch=14, dim=1024, depth=24, heads=16, out_dim=8192),
    "vit-giant": ModelConfig(name="vit-giant", patch=14, dim=1408, depth=40, heads=16, out_dim=8192),
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
