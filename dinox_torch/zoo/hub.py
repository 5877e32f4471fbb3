"""Model loading and export in the hub format, for the port.

``load_model`` dispatches over a training-checkpoint ``.pth`` file and a
hub-format directory (``config.json`` + ``backbone.safetensors`` or
``backbone.pth``). Weights are timm-style state dicts, the port's own
parameter names, so hub directories written by either package load in the
other. MoE backbones use hub format v2, as the JAX package writes it:
``weights_format: "jax"`` and the MoE placement knobs in config.json, and
``backbone.safetensors`` keyed by flat flax paths (``blocks_3/moe/w1``),
mapped through ``zoo.interop``. A HuggingFace Hub id is refused: the port
neither reaches the network nor depends on ``huggingface_hub``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from dinox_torch.models.config import HUB_DEFAULT_CONFIG, ModelConfig
from dinox_torch.models.vit import PatchViT
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo import safetensors_io
from dinox_torch.zoo.interop import (
    jax_to_torch_backbone,
    migrate_state_dict,
    needs_migration,
    strip_prefix,
    torch_to_jax_backbone,
)

log = logging.getLogger(__name__)


class DeviceViT(PatchViT):
    """A PatchViT on an explicit device (``cuda`` unless asked otherwise),
    built in eval mode, with its config's sizes as properties.

    ``model(x, spacing)`` takes NHWC numpy arrays or tensors, moves them to
    the model's device as float32 and returns all tokens (B, N, dim),
    differentiable."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__(cfg, device=dev, generator=generator)
        self.device = dev
        self.eval()

    @property
    def scale_aware(self) -> bool:
        return self.cfg.scale_aware

    @property
    def img_size(self) -> int:
        return self.cfg.img_size

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def patch(self) -> int:
        return self.cfg.patch

    def forward(self, x, spacing=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if spacing is not None:
            spacing = torch.as_tensor(spacing, dtype=torch.float32, device=self.device)
        return super().forward(x, spacing)


class LoadedModel(DeviceViT):
    """A DeviceViT called for inference: its forward runs under
    ``torch.inference_mode()``."""

    @torch.inference_mode()
    def forward(self, x, spacing=None) -> torch.Tensor:
        return super().forward(x, spacing)


def _cfg_from_dict(config: dict[str, Any]) -> ModelConfig:
    """Accepts both the packages' ModelConfig dicts and the reference's
    config.json / training-config formats."""
    merged = dict(HUB_DEFAULT_CONFIG)
    merged.update({k: v for k, v in config.items() if v is not None})
    if "gelu_approx" not in config:
        log.warning(
            "hub config has no 'gelu_approx' field: assuming exact erf GELU "
            "(torch-parity default for reference-format exports)"
        )
    return ModelConfig(
        name=str(merged.get("name", "custom")),
        img_size=int(merged["img_size"]),
        patch=int(merged["patch"]),
        dim=int(merged["dim"]),
        depth=int(merged["depth"]),
        heads=int(merged["heads"]),
        mlp_ratio=float(merged["mlp_ratio"]),
        out_dim=int(merged.get("out_dim", 8192)),
        num_registers=int(merged.get("num_registers", 4)),
        scale_aware=bool(merged.get("scale_aware", False)),
        gelu_approx=bool(merged.get("gelu_approx", False)),
        moe_experts=int(merged.get("moe_experts", 0)),
        moe_every=int(merged.get("moe_every", 2)),
        moe_capacity_factor=float(merged.get("moe_capacity_factor", 1.25)),
    )


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax parameters -> {'blocks_3/moe/w1': float32 array}, hub v2's keys."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _load_torch_payload(path: Path, *, trusted: bool = False) -> Any:
    """trusted=True (weights_only=False) only for local training checkpoints;
    hub-dir .pth files load weights_only so a foreign pickle runs no code."""
    return torch.load(path, map_location="cpu", weights_only=not trusted)


def _as_f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def load_from_training_checkpoint(
    path: str | Path,
    *,
    config_override: Optional[dict[str, Any]] = None,
    device: torch.device | str | None = None,
) -> LoadedModel:
    """Extract the student backbone from a reference-format training ``.pth``:
    config from the payload (incl. a nested "model"), legacy-key migration,
    ``backbone.``/``head.`` handling. A ``scale_embed`` whose shapes do not
    match the config is dropped and left freshly initialised (a no-op);
    keys the checkpoint lacks keep their fresh values; any other shape
    mismatch raises."""
    device = resolve_device(device)
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Checkpoint not found: {path}")
    payload = _load_torch_payload(path, trusted=True)

    config = dict(HUB_DEFAULT_CONFIG)
    ckpt_cfg = payload.get("config")
    if isinstance(ckpt_cfg, dict):
        if isinstance(ckpt_cfg.get("model"), dict):
            config.update(ckpt_cfg["model"])
        for k in ("img_size", "scale_aware"):
            if k in ckpt_cfg:
                config[k] = ckpt_cfg[k]
    if config_override:
        config.update(config_override)
    cfg = _cfg_from_dict(config)

    sd = payload.get("student", payload.get("model", payload))
    if needs_migration(sd):
        log.info("migrating legacy state-dict keys")
        sd = migrate_state_dict(sd)
    if any(k.startswith("backbone.") for k in sd):
        sd = strip_prefix(sd, "backbone.")
    sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    if not cfg.scale_aware:
        sd = {k: v for k, v in sd.items() if not k.startswith("scale_embed.")}

    model = LoadedModel(cfg, device)
    own = model.state_dict()
    se_own = {k: v for k, v in own.items() if k.startswith("scale_embed.")}
    if any(k.startswith("scale_embed.") for k in sd) and not all(
        k in sd and tuple(np.shape(sd[k])) == tuple(v.shape) for k, v in se_own.items()
    ):
        log.warning("scale_embed shape mismatch vs model config; dropping checkpoint "
                    "scale_embed and keeping the fresh one (zero-init output => no-op)")
        sd = {k: v for k, v in sd.items() if not k.startswith("scale_embed.")}

    merged = dict(own)
    for k, v in sd.items():
        if k not in own:
            log.warning("ignoring checkpoint key %s: not a parameter of this model", k)
            continue
        t = _as_f32(v)
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(t.shape)} "
                             f"vs model {tuple(own[k].shape)}")
        merged[k] = t
    model.load_state_dict(merged, strict=True)
    log.info("loaded training checkpoint %s (dim=%d depth=%d scale_aware=%s)",
             path.name, cfg.dim, cfg.depth, cfg.scale_aware)
    return model


def load_from_hub_dir(model_dir: str | Path, *,
                      device: torch.device | str | None = None) -> LoadedModel:
    """Hub format: config.json + backbone.safetensors (preferred) or
    backbone.pth, timm-style keys, or (``weights_format: "jax"``, hub v2)
    backbone.safetensors with flat flax paths; strict load."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    config_path = model_dir / "config.json"
    if not config_path.exists():
        raise FileNotFoundError(f"config.json not found in {model_dir}")
    config = json.loads(config_path.read_text())
    jax_format = config.get("weights_format", "torch") == "jax"
    cfg = _cfg_from_dict(config)

    st_path = model_dir / "backbone.safetensors"
    pth_path = model_dir / "backbone.pth"
    if st_path.exists():
        sd: Mapping[str, Any] = safetensors_io.load_file(st_path)
    elif pth_path.exists() and not jax_format:
        sd = _load_torch_payload(pth_path)
    elif jax_format:
        raise FileNotFoundError(f"{model_dir}: weights_format='jax' requires backbone.safetensors")
    else:
        raise FileNotFoundError(
            f"No weights in {model_dir}: expected backbone.safetensors or backbone.pth")
    if jax_format:
        if any("." in k for k in sd):  # timm-style keys; flax scope names hold no dots
            raise ValueError(f"hub checkpoint does not match config: weights_format='jax' "
                             f"wants flat flax paths, got {sorted(sd)[:3]}")
        sd = jax_to_torch_backbone(unflatten_tree(sd))
    elif needs_migration(sd):
        sd = migrate_state_dict(sd)

    model = LoadedModel(cfg, device)
    own = model.state_dict()
    got = {k: _as_f32(v) for k, v in sd.items()}
    if set(got) != set(own) or any(tuple(got[k].shape) != tuple(own[k].shape) for k in own):
        missing, extra = sorted(set(own) - set(got)), sorted(set(got) - set(own))
        bad = sorted(k for k in set(own) & set(got) if got[k].shape != own[k].shape)
        raise ValueError(f"hub checkpoint does not match config: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, wrong shape {bad[:5]}")
    model.load_state_dict(got, strict=True)
    return model


def load_model(
    model_id_or_path: str | Path,
    *,
    config_override: Optional[dict[str, Any]] = None,
    device: torch.device | str | None = None,
) -> LoadedModel:
    """.pth file -> training checkpoint; directory with config.json -> hub
    dir. Runs on ``cuda`` unless *device* says otherwise."""
    device = resolve_device(device)
    p = Path(model_id_or_path)
    if p.is_file() and p.suffix == ".pth":
        return load_from_training_checkpoint(p, config_override=config_override, device=device)
    if p.is_dir() and (p / "config.json").exists():
        return load_from_hub_dir(p, device=device)
    raise FileNotFoundError(
        f"{model_id_or_path}: not a training .pth or a hub directory with config.json. "
        "HuggingFace Hub ids are not supported by dinox_torch: download the hub "
        "directory and pass its path."
    )


def export_hub_checkpoint(
    model: PatchViT,
    output_dir: str | Path,
    *,
    config: Optional[dict[str, Any]] = None,
    use_safetensors: bool = False,
) -> Path:
    """Write config.json + backbone weights (timm-style keys, float32) in the
    hub format, readable by both packages and the reference torch loader.
    An MoE backbone is written in hub format v2, as the JAX package writes
    it: flat flax paths in backbone.safetensors and ``weights_format:
    "jax"`` with the MoE knobs in config.json (also in a caller's
    *config*); its ``.pth`` variant raises before any file is written."""
    out = Path(output_dir)
    c = model.cfg
    jax_format = c.moe_experts > 0
    if jax_format and not use_safetensors:
        raise NotImplementedError(
            "torch interop is dense-only: MoE expert stacks have no torch analog in the "
            "reference architecture. Export with use_safetensors=True (hub format v2, "
            "weights_format='jax').")
    out.mkdir(parents=True, exist_ok=True)
    if config is None:
        config = {
            "img_size": c.img_size, "patch": c.patch, "dim": c.dim, "depth": c.depth,
            "heads": c.heads, "mlp_ratio": c.mlp_ratio, "num_registers": c.num_registers,
            "scale_aware": c.scale_aware, "gelu_approx": c.gelu_approx,
        }
    if jax_format:
        config = {**config, "weights_format": "jax", "moe_experts": c.moe_experts,
                  "moe_every": c.moe_every, "moe_capacity_factor": c.moe_capacity_factor}
    (out / "config.json").write_text(json.dumps(config, indent=2))
    sd = {k: v.detach().to("cpu", torch.float32).contiguous().clone()
          for k, v in model.state_dict().items()}
    if jax_format:
        safetensors_io.save_file(flatten_tree(torch_to_jax_backbone(sd)), out / "backbone.safetensors")
    elif use_safetensors:
        safetensors_io.save_file({k: v.numpy() for k, v in sd.items()}, out / "backbone.safetensors")
    else:
        torch.save(sd, out / "backbone.pth")
    log.info("exported hub checkpoint -> %s", out)
    return out
