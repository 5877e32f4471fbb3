"""PatchViT backbone, DINO student/teacher, the MoE MLP, the MAE model and
configuration."""

from dinox_torch.models.config import HUB_DEFAULT_CONFIG, MODEL_CONFIGS, ModelConfig
from dinox_torch.models.mae import MaeModel
from dinox_torch.models.moe import MoeMlp
from dinox_torch.models.vit import DinoStudentTeacher, PatchViT

__all__ = ["HUB_DEFAULT_CONFIG", "MODEL_CONFIGS", "DinoStudentTeacher", "MaeModel", "ModelConfig",
           "MoeMlp", "PatchViT"]
