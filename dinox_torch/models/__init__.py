"""PatchViT backbone and configuration."""

from dinox_torch.models.config import HUB_DEFAULT_CONFIG, MODEL_CONFIGS, ModelConfig
from dinox_torch.models.vit import PatchViT

__all__ = ["HUB_DEFAULT_CONFIG", "MODEL_CONFIGS", "ModelConfig", "PatchViT"]
