"""From a training run directory to the backbone of its checkpoint: the
port's ``dinox_tpu.train.run_export``.

A run directory of the port holds ``config.json`` (the TrainConfig) and
``ckpt/<step>/state.safetensors`` + ``meta.json``
(:mod:`dinox_torch.train.checkpoint`). :func:`load_backbone_from_run` reads
only the ``student.backbone.*`` (or ``teacher.backbone.*``; an MAE run's
``student.encoder.*``) tensors of the
state file, each at its own offset, and moves only those to the device:
the teacher, the DINO head and both Adam moments never leave the disk (a
ViT-G state is ~14 GB in float32). The JAX package's run directories hold
Orbax checkpoints, which the port does not read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.train.checkpoint import STATE_FILE, CheckpointManager
from dinox_torch.train.state import TrainConfig, TrainState, create_train_state
from dinox_torch.zoo.hub import LoadedModel
from dinox_torch.zoo.safetensors_io import load_file


def train_config_from_run(run_dir: str | Path) -> TrainConfig:
    cfg_json = json.loads((Path(run_dir) / "config.json").read_text())
    model = dict(cfg_json["model"])
    if isinstance(model.get("lora_targets"), list):
        model["lora_targets"] = tuple(model["lora_targets"])
    known = set(TrainConfig.__dataclass_fields__)
    kw = {k: v for k, v in cfg_json.items() if k in known and k != "model"}
    return TrainConfig(model=ModelConfig.from_dict(model), **kw)


def _checkpoint_dir(run_dir: Path, step: Optional[int]) -> Path:
    """ckpt/<step> (the latest complete one by default) of the port's run
    dir; a clear error for an Orbax (JAX package) checkpoint."""
    ckpt = run_dir / "ckpt"
    steps = sorted(int(d.name) for d in ckpt.iterdir() if d.name.isdigit()) if ckpt.is_dir() else []
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    step = steps[-1] if step is None else step
    d = ckpt / str(step)
    if not (d / STATE_FILE).exists():
        if d.is_dir() and any(d.iterdir()):
            raise ValueError(f"{d} holds no {STATE_FILE}: it looks like an Orbax checkpoint of the "
                             f"JAX package, which dinox_torch does not read; export its backbone "
                             f"as a hub dir with the JAX package and load that instead")
        raise FileNotFoundError(f"no checkpoint for step {step} under {run_dir}")
    return d


def load_state_from_run(run_dir: str | Path, step: Optional[int] = None, host: bool = False,
                        device: torch.device | str | None = None
                        ) -> tuple[TrainState, TrainConfig, dict]:
    """(TrainState, TrainConfig, meta) of a run's checkpoint (the latest by
    default), restored on *device* (``cuda`` by default), or on the CPU
    with ``host=True``."""
    run_dir = Path(run_dir)
    cfg = train_config_from_run(run_dir)
    d = _checkpoint_dir(run_dir, step)
    state = create_train_state(cfg, device="cpu" if host else device)
    mgr = CheckpointManager(run_dir, keep_last=0)
    state, meta = mgr.restore(state, step=int(d.name))
    return state, cfg, meta


def load_backbone_from_run(run_dir: str | Path, step: Optional[int] = None,
                           source: str = "student",
                           device: torch.device | str | None = None) -> LoadedModel:
    """The student (or teacher) backbone of a run's checkpoint as a
    LoadedModel on *device* (``cuda`` by default), reading only its tensors."""
    if source not in ("student", "teacher"):
        raise ValueError(f"source must be 'student' or 'teacher', got {source!r}")
    run_dir = Path(run_dir)
    cfg = train_config_from_run(run_dir)
    # A pipeline-parallel run's checkpoint needs no merge: the port's rank 0
    # writes the one-process layout (parallel.pipeline.gather_stages). The
    # JAX package merges the stacked {"rest", "blocks"} layout here only
    # because its PP runs save that layout.
    mae = cfg.loss_type == "mae"  # the MAE student's backbone is its encoder
    prefix = f"{source}.encoder." if mae else f"{source}.backbone."
    arrays = load_file(_checkpoint_dir(run_dir, step) / STATE_FILE,
                       keys=lambda name: name.startswith(prefix))
    mcfg = cfg.model.replace(img_size=cfg.img_size)
    model = LoadedModel(mcfg.replace(scale_aware=False) if mae else mcfg, device)
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()},
                          strict=True)
    return model

