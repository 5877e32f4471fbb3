"""Scale-pathway diagnostic of a checkpoint: the twin of
``scripts/diagnose_scale_pathway.py``, with the same flags plus
``--device`` and the same JSON keys.

The ScaleEmbedding (Linear/GELU/Linear(zero-init)/LayerNorm, added to every
pre-register token) matches the reference's wiring, so a counterfactual
magnitude that differs from the reference's is trained dynamics. This tool
says which leg carries it, for a run dir (the port's safetensors
checkpoints), a hub dir or a reference ``.pth``:

  [1] scale-token geometry: the post-LN norm (the trailing LayerNorm pins
      it near sqrt(dim) * rms(gamma) once fc2 leaves zero-init), the raw
      pre-LN norm, the LN gamma rms, and the cosine rotation of the scale
      vector under x2 / x0.5 spacing.
  [2] input-mix ratio: |scale_vec| / mean |patch_token + pos_embed|, the
      share of the residual stream's input that spacing contributes.
  [3] the end-to-end counterfactual curve: the mean cosine distance of the
      L2-normalised CLS under spacing multipliers {0.25, 0.5, 2, 4} on a
      fixed synthetic batch (the same pixels), and its local slope at
      m = 1 (+-5%): seven forwards.

Reference anchors: counterfactual 0.055 (x2) / 0.107 (x0.5) (the
reference's docs/EXPERIMENTS.md:767-775).

    python -m dinox_torch.diagnose_scale_pathway --checkpoint data/runs/mvp \\
        --out docs/mvp_scale_diag.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from dinox_torch.data.synthetic import PROFILES_V2, draw_spacing, synth_series_np
from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.ops.augment import eval_transform
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.hub import DeviceViT


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="run dir (the port's safetensors checkpoints), hub dir, or reference .pth")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--n", type=int, default=32, help="diagnostic batch size")
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def make_batch(n: int, canvas: int, img_size: int, seed: int,
               device: torch.device | str = "cpu") -> tuple[torch.Tensor, np.ndarray]:
    """Fixed synthetic pixels (two v2 profiles) through the eval transform on
    *device*, and their true spacings."""
    rng = np.random.default_rng(seed)
    slices, spacings = [], []
    per = max(1, n // 2)
    for profile in PROFILES_V2[:2]:
        hu = synth_series_np(profile, rng, per, canvas)
        sp = draw_spacing(profile, rng)
        for s in hu:
            # 2.5D stack of the same slice (series edge behaviour), stored as
            # uint16 = HU + 32768.
            u16 = np.clip(s + 32768.0, 0, 65535).astype(np.uint16)
            slices.append(np.stack([u16] * 3, axis=-1))
            spacings.append(sp)
    pixels = torch.from_numpy(np.stack(slices[:n])).to(device)
    return eval_transform(pixels, img_size=img_size), np.asarray(spacings[:n], dtype=np.float32)


def _l2n(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _cosdist(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(1.0 - np.sum(_l2n(a) * _l2n(b), axis=-1)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.inference_mode()
def scale_token_stats(model: DeviceViT, spacing: np.ndarray) -> dict:
    """[1] geometry of the ScaleEmbedding output, pre- and post-LN. Pre-LN
    is ``mlp[:3]`` on float32 spacings (float32 products, as the JAX
    script's); post-LN is the module itself."""
    se = model.scale_embed
    sp = torch.as_tensor(spacing, dtype=torch.float32, device=model.device)

    def post_ln(s: torch.Tensor) -> np.ndarray:
        return _np(se(s)[:, 0, :])

    v1, v2, vh = post_ln(sp), post_ln(sp * 2.0), post_ln(sp * 0.5)
    gamma = _np(se.mlp[3].weight)
    norm1 = float(np.mean(np.linalg.norm(v1, axis=-1)))
    live = norm1 > 1e-6  # rotation is undefined at exact zero-init
    return {
        "post_ln_norm_mean": norm1,
        "pre_ln_norm_mean": float(np.mean(np.linalg.norm(_np(se.mlp[:3](sp)), axis=-1))),
        "ln_gamma_rms": float(np.sqrt(np.mean(gamma**2))),
        "ln_pin_norm": float(np.sqrt(model.cfg.dim) * np.sqrt(np.mean(gamma**2))),
        "scale_vec_cosdist_2x": _cosdist(v1, v2) if live else None,
        "scale_vec_cosdist_0.5x": _cosdist(v1, vh) if live else None,
    }


@torch.inference_mode()
def input_mix_ratio(model: DeviceViT, x: torch.Tensor, scale_norm: float) -> dict:
    """[2] |scale_vec| against the mean norm of the image tokens it is added to."""
    tokens = model.patch_tokens(torch.as_tensor(x, dtype=torch.float32, device=model.device))
    tok = _np(tokens + model.pos_embed[:, 1:, :])  # float32, as flax promotes
    tok_norm = float(np.mean(np.linalg.norm(tok, axis=-1)))
    return {
        "patch_token_norm_mean": tok_norm,
        "scale_to_token_ratio": float(scale_norm / max(tok_norm, 1e-12)),
    }


@torch.inference_mode()
def counterfactual_curve(model: DeviceViT, x: torch.Tensor, spacing: np.ndarray) -> dict:
    """[3] CLS cosine distance against the spacing multiplier, the same pixels."""
    def cls(mult: float) -> np.ndarray:
        return _np(model(x, spacing * mult)[:, 0, :])

    base = cls(1.0)
    curve = {f"{m:g}x": _cosdist(base, cls(m)) for m in (0.25, 0.5, 2.0, 4.0)}
    slope = (_cosdist(base, cls(1.05)) + _cosdist(base, cls(1 / 1.05))) / (2 * np.log(1.05))
    return {"cosdist_vs_multiplier": curve,
            "local_slope_per_log_spacing": float(slope)}


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = load_any_model(args.checkpoint, device)
    if not model.scale_aware:
        print("error: checkpoint is not scale-aware", file=sys.stderr)
        return 2

    x, spacing = make_batch(args.n, args.canvas, model.img_size, args.seed, device)
    report = {
        "checkpoint": str(args.checkpoint),
        "n": int(x.shape[0]),
        "dim": model.cfg.dim,
        "sqrt_dim": float(np.sqrt(model.cfg.dim)),
        "scale_token": scale_token_stats(model, spacing),
        "counterfactual": counterfactual_curve(model, x, spacing),
        "reference_anchor": {"2x": 0.055, "0.5x": 0.107,
                             "source": "reference docs/EXPERIMENTS.md:767-775"},
    }
    report["input_mix"] = input_mix_ratio(model, x, report["scale_token"]["post_ln_norm_mean"])

    st, cf = report["scale_token"], report["counterfactual"]
    rot = st["scale_vec_cosdist_2x"]
    print(f"scale token: |post_ln|={st['post_ln_norm_mean']:.2f} "
          f"(LN pin ~{st['ln_pin_norm']:.2f}, raw pre-LN {st['pre_ln_norm_mean']:.4f}) "
          f"rotation x2={'zero-init' if rot is None else f'{rot:.4f}'}", flush=True)
    print(f"input mix: scale/token ratio = "
          f"{report['input_mix']['scale_to_token_ratio']:.3f}", flush=True)
    print(f"counterfactual: {cf['cosdist_vs_multiplier']} "
          f"(ref anchor 2x=0.055, 0.5x=0.107)", flush=True)

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=2))
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
