"""Public zoo API: the port's copy of ``dinox_tpu.zoo``'s names. The
provenance layer (schemas, catalog, manifests, merging, lineage), hub
checkpoints, encoding, LoRA adapters, the model card and release
staging."""

from dinox_torch.zoo.card import generate_model_card
from dinox_torch.zoo.hub import export_hub_checkpoint, load_model
from dinox_torch.zoo.lineage import (
    compute_catalog_hash,
    get_git_commit,
    load_lineage,
    record_lineage,
)
from dinox_torch.zoo.manifest import DataManifest
from dinox_torch.zoo.merge import DatasetMerger, temperature_weights
from dinox_torch.zoo.peft import (
    apply_lora,
    count_parameters,
    load_adapter,
    merge_adapter,
    save_adapter,
)
from dinox_torch.zoo.publish import publish_to_hub
from dinox_torch.zoo.registry import DatasetRegistry
from dinox_torch.zoo.schemas import (
    DatasetEntry,
    DatasetUsage,
    PreprocessingConfig,
    SliceMetadata,
    SpacingStats,
    TrainingLineage,
)

# Last: "encode" names both the submodule and the function. Importing the
# submodule binds the module onto this package; this line binds the
# function over it, and a later import of the (then cached) submodule binds
# nothing. So ``zoo.encode`` is the function whatever was imported first.
from dinox_torch.zoo.encode import encode, encode_batch  # noqa: E402

__all__ = [
    "DataManifest",
    "DatasetEntry",
    "DatasetMerger",
    "DatasetRegistry",
    "DatasetUsage",
    "PreprocessingConfig",
    "SliceMetadata",
    "SpacingStats",
    "TrainingLineage",
    "apply_lora",
    "compute_catalog_hash",
    "count_parameters",
    "encode",
    "encode_batch",
    "export_hub_checkpoint",
    "generate_model_card",
    "get_git_commit",
    "load_adapter",
    "load_lineage",
    "load_model",
    "merge_adapter",
    "publish_to_hub",
    "record_lineage",
    "save_adapter",
    "temperature_weights",
]
