"""PatchViT backbone, DINO student/teacher and configuration."""

from dinox_torch.models.config import HUB_DEFAULT_CONFIG, MODEL_CONFIGS, ModelConfig
from dinox_torch.models.vit import DinoStudentTeacher, PatchViT

__all__ = ["HUB_DEFAULT_CONFIG", "MODEL_CONFIGS", "DinoStudentTeacher", "ModelConfig", "PatchViT"]
