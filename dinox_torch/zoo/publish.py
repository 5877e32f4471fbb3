"""Release staging: a trained backbone -> a directory with both weight
formats, config.json, the model card, the scrubbed training config and the
evaluation results. The port's copy of ``dinox_tpu.zoo.publish``.

``stage_release`` writes the same files as the JAX package: safetensors and
``backbone.pth`` for a dense backbone, hub v2 safetensors only for MoE.
``publish_to_hub(dry_run=True)`` stages and returns the path. The upload
itself is not ported: the port neither reaches the network nor depends on
``huggingface_hub``, so without ``dry_run`` it raises.
"""

from __future__ import annotations

import json
import logging
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

from dinox_torch.zoo.card import _scrub_path, generate_model_card
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint

log = logging.getLogger(__name__)

_SCRUB_KEYS = ("index_csv", "run_dir", "split_manifest", "data_root", "workdir")
_DROP_KEYS = ("hardware",)


def _scrub_config(config: dict[str, Any]) -> dict[str, Any]:
    """Remove local paths and hardware details before publishing."""
    out: dict[str, Any] = {}
    for k, v in config.items():
        if k in _DROP_KEYS:
            continue
        if isinstance(v, dict):
            out[k] = _scrub_config(v)
        elif k in _SCRUB_KEYS and isinstance(v, str):
            out[k] = _scrub_path(v)
        else:
            out[k] = v
    return out


def stage_release(
    model: LoadedModel,
    staging_dir: str | Path,
    *,
    model_name: str,
    training_config: Optional[dict[str, Any]] = None,
    eval_results: Optional[dict[str, Any]] = None,
    lineage: Optional[dict[str, Any]] = None,
) -> Path:
    """Assemble the full release directory (both weight formats + card).

    The staging dir is owned by the publisher and rebuilt from scratch:
    re-staging a different model into the same dir must not ship leftovers
    from the previous run (e.g. a dense backbone.pth surviving an MoE
    re-stage, or a stale adapter/)."""
    out = Path(staging_dir)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    export_hub_checkpoint(model, out, use_safetensors=True)
    if model.cfg.moe_experts == 0:
        export_hub_checkpoint(model, out)  # torch-loadable .pth (dense only)
    else:
        log.info("MoE family: staging hub v2 safetensors only (torch interop is dense-only)")
    card_cfg = {
        "name": model.cfg.name,
        "dim": model.cfg.dim,
        "depth": model.cfg.depth,
        "heads": model.cfg.heads,
        "patch": model.cfg.patch,
        "img_size": model.cfg.img_size,
        "mlp_ratio": model.cfg.hidden / model.cfg.dim,
        "scale_aware": model.cfg.scale_aware,
        # The shipped backbone's own parameter count (the JAX package's leaf
        # count), not ModelConfig.params_millions, whose rough formula
        # over-counts the MLP.
        "params_millions": round(sum(p.numel() for p in model.parameters()) / 1e6, 1),
    }
    if model.cfg.moe_experts > 0:
        card_cfg.update({
            "moe_experts": model.cfg.moe_experts,
            "moe_every": model.cfg.moe_every,
            "weights_format": "jax",
        })
    (out / "README.md").write_text(
        generate_model_card(
            card_cfg,
            training_config=_scrub_config(training_config) if training_config else None,
            eval_results=eval_results,
            lineage=lineage,
            model_name=model_name,
        )
    )
    if training_config is not None:
        (out / "training_config.json").write_text(
            json.dumps(_scrub_config(training_config), indent=2, default=str)
        )
    if eval_results is not None:
        (out / "eval_results.json").write_text(json.dumps(eval_results, indent=2))
    return out


def publish_to_hub(
    model: LoadedModel,
    repo_id: str,
    *,
    model_name: Optional[str] = None,
    training_config: Optional[dict[str, Any]] = None,
    eval_results: Optional[dict[str, Any]] = None,
    lineage: Optional[dict[str, Any]] = None,
    private: bool = False,
    dry_run: bool = False,
    staging_dir: Optional[str | Path] = None,
) -> Path:
    """Stage a release; returns the staging path. Only ``dry_run=True`` is
    supported: the upload to the HuggingFace Hub raises."""
    if not dry_run:
        raise NotImplementedError(
            f"uploading {repo_id!r} to the HuggingFace Hub is not supported by dinox_torch: it has "
            "no network access and does not depend on huggingface_hub. Stage the release with "
            "dry_run=True and upload the directory with other tooling.")
    staging = Path(staging_dir) if staging_dir else Path(tempfile.mkdtemp(prefix="dinox_pub_"))
    stage_release(
        model,
        staging,
        model_name=model_name or repo_id.split("/")[-1],
        training_config=training_config,
        eval_results=eval_results,
        lineage=lineage,
    )
    log.info("dry run: staged release at %s", staging)
    return staging
