"""Public zoo API: load and export hub checkpoints, encode slices."""

from dinox_torch.zoo.encode import encode, encode_batch
from dinox_torch.zoo.hub import export_hub_checkpoint, load_model

__all__ = ["encode", "encode_batch", "export_hub_checkpoint", "load_model"]
