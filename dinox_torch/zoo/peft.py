"""LoRA injection and adapter save/load in the HF peft on-disk format: the
port's ``dinox_tpu.zoo.peft``.

The factors live in the port's ``Linear`` (``models.vit``): ``lora_A.weight``
(r, in) and ``lora_B.weight`` (out, r) under each targeted
``qkv``/``proj``/``fc1``/``fc2``, so a LoraModel's adapter keys are peft's
without the ``base_model.model.`` prefix. On disk: ``adapter_model.safetensors``
with ``base_model.model.blocks.N.<attn|mlp>.<name>.lora_{A,B}.weight`` (float32)
and ``adapter_config.json``, the files the JAX package and peft write, so an
adapter saved by either package loads into the other.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dinox_torch.zoo import safetensors_io
from dinox_torch.zoo.hub import DeviceViT, LoadedModel

log = logging.getLogger(__name__)

DEFAULT_TARGET_MODULES = ["qkv", "proj", "fc1", "fc2"]

# Always frozen during LoRA fine-tuning: the physics/tokenization substrate.
# Adapters learn pathology, not physics.
FROZEN_SUBTREES = ("scale_embed", "patch_embed")
FROZEN_LEAVES = ("cls_token", "pos_embed", "registers")

ADAPTER_FILE = "adapter_model.safetensors"
CONFIG_FILE = "adapter_config.json"
_PEFT_KEY = re.compile(r"^base_model\.model\.(.+)\.lora_([AB])\.weight$")


def _is_factor(name: str) -> bool:
    return name.endswith((".lora_A.weight", ".lora_B.weight"))


class LoraModel(DeviceViT):
    """A DeviceViT whose config carries LoRA factors; its forward is
    differentiable. Only the factors require gradients after
    :func:`apply_lora`."""

    def adapter_params(self) -> dict[str, torch.nn.Parameter]:
        """{state_dict name: parameter} of the adapter factors alone."""
        return {k: p for k, p in self.named_parameters() if _is_factor(k)}


def apply_lora(model: DeviceViT, *, rank: int = 8, alpha: float = 16.0,
               target_modules: Optional[list[str]] = None, dropout: float = 0.05,
               generator: Optional[torch.Generator] = None) -> LoraModel:
    """Fresh (no-op: B = 0) LoRA factors on a copy of *model*, on its device.

    Base weights are copied unchanged; A is drawn from *generator* (seed 0
    when None). Every base parameter is frozen (``requires_grad=False``) and
    the factors train, so the physics layers (``FROZEN_SUBTREES``,
    ``FROZEN_LEAVES``) stay frozen by construction. On an MoE backbone the
    default targets are attention's alone (``qkv``, ``proj``), as in the
    JAX package; fc1/fc2 given explicitly adapt the dense blocks only."""
    if target_modules is None and model.cfg.moe_experts > 0:
        targets: tuple = ("qkv", "proj")  # MoE: router and experts stay frozen
        log.info("MoE backbone: LoRA targets default to attention-only %s", list(targets))
    else:
        targets = tuple(target_modules or DEFAULT_TARGET_MODULES)
    unknown = set(targets) - set(DEFAULT_TARGET_MODULES)
    if unknown:
        raise ValueError(f"unknown target modules: {sorted(unknown)}")
    lora_cfg = model.cfg.replace(lora_rank=rank, lora_alpha=alpha, lora_dropout=dropout,
                                 lora_targets=targets)
    wrapped = LoraModel(lora_cfg, model.device)
    missing, unexpected = wrapped.load_state_dict(model.state_dict(), strict=False)
    if unexpected or not all(_is_factor(k) for k in missing):
        raise ValueError(f"base model does not match: missing {missing[:4]}, "
                         f"unexpected {unexpected[:4]}")
    wrapped.reset_lora_parameters(generator)
    for name, p in wrapped.named_parameters():
        p.requires_grad_(_is_factor(name))
    counts = count_parameters(wrapped)
    log.info("LoRA applied: rank=%d alpha=%.1f targets=%s - %d trainable / %d total (%.2f%%)",
             rank, alpha, list(targets), counts["trainable"], counts["total"],
             100.0 * counts["trainable"] / counts["total"])
    return wrapped


def save_adapter(model: LoraModel, output_dir: str | Path) -> Path:
    """Write adapter_model.safetensors + adapter_config.json (the HF peft layout)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = model.cfg
    sd = {f"base_model.model.{k}": p.detach().to("cpu", torch.float32).numpy()
          for k, p in model.adapter_params().items()}
    safetensors_io.save_file(sd, out / ADAPTER_FILE)
    (out / CONFIG_FILE).write_text(json.dumps({
        "peft_type": "LORA",
        "r": cfg.lora_rank,
        "lora_alpha": cfg.lora_alpha,
        "lora_dropout": cfg.lora_dropout,
        "target_modules": sorted(cfg.lora_targets),
        "bias": "none",
        "base_model_name_or_path": None,
        "task_type": None,
        "inference_mode": False,
    }, indent=2))
    log.info("adapter -> %s (%d tensors)", out, len(sd))
    return out


def load_adapter(model: DeviceViT, adapter_dir: str | Path) -> LoraModel:
    """Load an HF-peft adapter directory onto a base backbone."""
    adapter_dir = Path(adapter_dir)
    cfg_json = json.loads((adapter_dir / CONFIG_FILE).read_text())
    if cfg_json.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"unsupported peft_type: {cfg_json.get('peft_type')}")
    sd = safetensors_io.load_file(adapter_dir / ADAPTER_FILE)
    wrapped = apply_lora(
        model, rank=int(cfg_json["r"]), alpha=float(cfg_json["lora_alpha"]),
        target_modules=list(cfg_json.get("target_modules") or DEFAULT_TARGET_MODULES),
        dropout=float(cfg_json.get("lora_dropout", 0.0)))
    params = wrapped.adapter_params()
    with torch.no_grad():
        for key, arr in sd.items():
            m = _PEFT_KEY.match(key)
            name = f"{m.group(1)}.lora_{m.group(2)}.weight" if m else None
            if name not in params:
                raise KeyError(f"unrecognized adapter key: {key}")
            params[name].copy_(torch.from_numpy(np.asarray(arr, np.float32)))
    log.info("loaded %d adapter tensors from %s", len(sd), adapter_dir)
    return wrapped


def merge_adapter(model: LoraModel) -> LoadedModel:
    """Fold the factors into the base weights, W + (alpha / r) B A in float32,
    -> a plain (adapter-free) LoadedModel on the same device."""
    scale = model.cfg.lora_alpha / model.cfg.lora_rank
    sd = {k: v.detach() for k, v in model.state_dict().items() if not _is_factor(k)}
    for m_name, m in model.named_modules():
        if getattr(m, "lora_rank", 0):
            a = m.lora_A.weight.detach().cpu().numpy()
            b = m.lora_B.weight.detach().cpu().numpy()
            w = m.weight.detach().cpu().numpy() + scale * (a.T @ b.T).T
            sd[f"{m_name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
    merged = LoadedModel(model.cfg.replace(lora_rank=0, lora_dropout=0.0), model.device)
    merged.load_state_dict(sd, strict=True)
    return merged


def count_parameters(model: DeviceViT) -> dict[str, int]:
    """{'total': N, 'trainable': M}: trainable counts the LoRA factors only."""
    total = sum(p.numel() for p in model.parameters())
    trainable = (sum(p.numel() for p in model.adapter_params().values())
                 if isinstance(model, LoraModel) else 0)
    return {"total": int(total), "trainable": int(trainable)}
