"""HuggingFace model-card generator: dicts in, markdown out. No I/O.

The port's copy of ``dinox_tpu.zoo.card``: YAML frontmatter with
scale-aware tagging, architecture/training/data/eval/usage sections, the
mandatory research-use-only disclaimer, local-path scrubbing, and the
CC-BY-NC-3.0 weights / GPL-3.0 code licensing text. Its card equals the JAX
package's line for line except the footer (this package's name and the
time) and the Training table's Hardware row when the config names none
(``DEFAULT_HARDWARE``: a staged card always shows it, because
``publish._scrub_config`` drops ``hardware``). The Usage section documents
the zoo's published loader, as the JAX card does.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any

_LOCAL_PREFIXES = ("/home/", "/tmp/", "/workspace/", "/root/", "/mnt/")
_ANCHOR_DIRS = ("data", "runs", "checkpoints", "experiment")
DEFAULT_HARDWARE = "NVIDIA GPU (PyTorch + CUDA)"


def _scrub_path(path: str) -> str:
    """Strip local filesystem prefixes, keeping a meaningful relative tail
    (from data/, runs/, checkpoints/ or experiment/ onward) or the basename."""
    if not any(p in path for p in _LOCAL_PREFIXES):
        return path
    parts = path.split("/")
    for i, part in enumerate(parts):
        if part in _ANCHOR_DIRS:
            return "/".join(parts[i:])
    return parts[-1]


def _frontmatter(model_config: dict, training_config: dict | None) -> list[str]:
    tags = ["medical-imaging", "vision-transformer", "self-supervised", "dino"]
    if model_config.get("scale_aware"):
        tags.append("scale-aware")
    lines = [
        "---",
        "library_name: dinox",
        "license: cc-by-nc-3.0",
        f"tags: [{', '.join(tags)}]",
        "pipeline_tag: feature-extraction",
    ]
    ds_names = []
    for ds in (training_config or {}).get("datasets", []):
        if isinstance(ds, str):
            ds_names.append(ds)
        elif isinstance(ds, dict) and ds.get("name"):
            ds_names.append(ds["name"])
    if ds_names:
        lines.append(f"datasets: [{', '.join(ds_names)}]")
    lines.append("---")
    return lines


def _kv_table(rows: list[tuple[str, Any]]) -> list[str]:
    out = ["| Parameter | Value |", "|-----------|-------|"]
    out += [f"| {k} | {v} |" for k, v in rows]
    return out


def _architecture(mc: dict) -> list[str]:
    rows = [
        ("Backbone", "Vision Transformer (ViT)"),
        ("Config", mc.get("name", "custom")),
        ("Embedding dim", mc.get("dim", "—")),
        ("Depth (layers)", mc.get("depth", "—")),
        ("Attention heads", mc.get("heads", "—")),
        ("Patch size", mc.get("patch", "—")),
        ("Image size", mc.get("img_size", 224)),
        ("MLP ratio", mc.get("mlp_ratio", 4.0)),
        ("Scale-aware", "✅" if mc.get("scale_aware") else "❌"),
        ("Parameters", f"{mc.get('params_millions', '—')}M"),
    ]
    if mc.get("moe_experts"):
        rows += [
            ("MoE (moe_experts / moe_every)",
             f"Switch top-1, {mc['moe_experts']} experts in every "
             f"{mc.get('moe_every', 2)}. block"),
            ("Weights format", mc.get("weights_format", "jax")
             + " (JAX-native; torch interop is dense-only)"),
        ]
    return ["## Architecture", ""] + _kv_table(rows) + [""]


def _training(tc: dict) -> list[str]:
    eff = tc.get("batch_size", "?")
    try:
        eff = tc["batch_size"] * tc.get("accumulation_steps", 1)
    except (KeyError, TypeError):
        pass
    return ["## Training", ""] + _kv_table(
        [
            ("Method", "DINOv3 (self-supervised student-teacher distillation)"),
            (
                "Loss",
                f"DINO + Gram({tc.get('gram_weight', 1.0)}) + KoLeo({tc.get('koleo_weight', 0.1)})",
            ),
            ("Optimizer", "AdamW"),
            ("Learning rate", f"{tc.get('lr', '—')} (cosine decay to {tc.get('min_lr', '1e-6')})"),
            ("Warmup steps", tc.get("warmup_steps", "—")),
            ("Total steps", tc.get("max_steps", "—")),
            (
                "Effective batch",
                f"{eff} (batch={tc.get('batch_size', '?')} × accum={tc.get('accumulation_steps', '?')})",
            ),
            ("EMA momentum", tc.get("ema", "—")),
            ("Center momentum", tc.get("center_momentum", "—")),
            ("Weight decay", tc.get("weight_decay", "—")),
            ("Seed", tc.get("train_seed", "—")),
            ("Git commit", f"`{tc.get('git_commit', '—')}`"),
            ("Hardware", tc.get("hardware", DEFAULT_HARDWARE)),
        ]
    ) + [""]


def _data(tc: dict | None, lineage: dict | None) -> list[str]:
    lines = ["## Training Data", ""]
    if lineage and lineage.get("datasets"):
        lines += [
            "| Dataset | Organ | Slices | Pixel Spacing | Slice Thickness | License |",
            "|---------|-------|--------|---------------|-----------------|---------|",
        ]
        for ds in lineage["datasets"]:
            lines.append(
                f"| {ds.get('name', '—')} | {ds.get('organ', '—')} | {ds.get('slices', '—')} "
                f"| {ds.get('spacing_range', '—')} | {ds.get('thickness_range', '—')} "
                f"| {ds.get('license', '—')} |"
            )
        lines.append("")
    elif tc:
        lines.append(f"Training index: `{_scrub_path(str(tc.get('index_csv', '—')))}`")
        lines.append("")
    if tc and tc.get("data_manifest_hash"):
        lines.append(f"Data manifest hash: `{tc['data_manifest_hash']}`")
        lines.append("")
    return lines


def _evaluation(ev: dict) -> list[str]:
    m = ev.get("metrics", {})
    lines = ["## Evaluation", ""]
    vr = m.get("view_retrieval_per_dataset", {})
    if vr:
        lines += [
            "### View Retrieval (self-supervised)",
            "",
            "| Dataset | Top-1 | Top-5 | Ratio vs Random |",
            "|---------|-------|-------|-----------------|",
        ]
        for name, v in vr.items():
            lines.append(
                f"| {name} | {v.get('top1', 0):.3%} | {v.get('top5', 0):.3%} "
                f"| **{v.get('ratio_vs_random', 0):.0f}×** |"
            )
        lines.append("")
    dd = m.get("dataset_discrimination_probe", {})
    if dd:
        lines += [
            "### Dataset Discrimination",
            "",
            f"- **Accuracy:** {dd.get('accuracy', 0):.3f}",
            f"- **AUC:** {dd.get('auc', 0):.3f}",
            "",
        ]
    sc = m.get("spacing_counterfactual", {})
    if sc:
        lines += [
            "### Scale Awareness (Spacing Counterfactual)",
            "",
            f"- **Real → 2× spacing distance:** "
            f"{sc.get('cosine_distance_real_vs_2x', {}).get('mean', 0):.4f}",
            f"- **Real → ½× spacing distance:** "
            f"{sc.get('cosine_distance_real_vs_half', {}).get('mean', 0):.4f}",
            "",
            "Higher distances = model encodes physical scale (baseline would be ~0).",
            "",
        ]
    sp = m.get("spacing_prediction", {})
    if sp:
        lines += [f"### Spacing Prediction R²: **{sp.get('r2', 0):.3f}**", ""]
    lines.append(
        f"*Evaluation on {ev.get('val_slices', '?')} validation slices, "
        f"step {ev.get('step', 'final')}, seed {ev.get('seed', '?')}.*"
    )
    lines.append("")
    return lines


def _usage(model_name: str, scale_aware: bool) -> list[str]:
    spacing = (
        ", pixel_spacing=(0.7, 0.7), slice_thickness=1.5" if scale_aware else ""
    )
    comment = (
        "\n    # pixel_spacing in mm (x, y); slice_thickness in mm"
        if scale_aware
        else ""
    )
    return f"""## Usage

```python
from dinox_tpu.zoo.hub import load_model
from dinox_tpu.zoo.encode import encode
import numpy as np

# Load pre-trained backbone
model = load_model("{model_name}")

# Encode a CT slice (raw HU values + physical spacing)
hu_array = np.random.randn(512, 512).astype(np.float32)  # replace with real data{comment}
features = encode(model, hu_array{spacing})
# features shape: (1, dim) — use for downstream tasks
```

### Zero-preprocessing API

`encode()` handles windowing, normalization and resizing internally — pass
raw Hounsfield Unit values straight from your PACS system.

Supported input formats:
- `hu_float`: Raw HU as float32 numpy array (default)
- `hu16_png`: 16-bit PNG (offset HU, as produced by our preprocessing)
- `windowed_float`: Pre-windowed [0, 1] float array

### LoRA Fine-Tuning

```python
from dinox_tpu.zoo.peft import apply_lora, save_adapter

model = load_model("{model_name}")
lora = apply_lora(model, rank=8)  # ~0.5MB trainable adapter
# Train on your downstream task...
# save_adapter(lora, "my-adapter/")
```
""".splitlines()


def generate_model_card(
    model_config: dict[str, Any],
    *,
    training_config: dict[str, Any] | None = None,
    eval_results: dict[str, Any] | None = None,
    lineage: dict[str, Any] | None = None,
    model_name: str = "dinox-ct-vit-small",
) -> str:
    """Render a HuggingFace-compatible model card (markdown + YAML frontmatter)."""
    scale_str = "Scale-Aware " if model_config.get("scale_aware") else ""
    lines: list[str] = []
    lines += _frontmatter(model_config, training_config)
    lines += [
        "",
        f"# {model_name}",
        "",
        f"A {scale_str}Vision Foundation Model for volumetric medical imaging, "
        "trained with DINOv3 self-supervised learning on multi-organ CT data.",
        "",
        "Part of the [DINO-X model zoo](https://github.com/timlawrenz/DINO-X) — "
        "open-source, pan-organ, scale-aware foundation models for medical imaging.",
        "",
        "> ⚠️ **Research use only.** This model is not approved for clinical "
        "diagnosis or treatment decisions. It has not been validated by regulatory "
        "bodies (FDA, CE, etc.). Always consult qualified medical professionals.",
        "",
    ]
    lines += _architecture(model_config)
    if training_config:
        lines += _training(training_config)
    if training_config or lineage:
        lines += _data(training_config, lineage)
    if eval_results:
        lines += _evaluation(eval_results)
    lines += _usage(model_name, bool(model_config.get("scale_aware")))
    lines += [
        "",
        "## Citation",
        "",
        "```bibtex",
        "@software{dinox2026,",
        "  author = {Lawrenz, Tim},",
        "  title = {DINO-X: Scale-Aware Vision Foundation Models for Medical Imaging},",
        "  year = {2026},",
        "  url = {https://github.com/timlawrenz/DINO-X}",
        "}",
        "```",
        "",
        "## License",
        "",
        "Model weights are released under **CC-BY-NC-3.0** (non-commercial), consistent",
        "with the most restrictive upstream dataset license (LIDC-IDRI).",
        "",
        "Training code is released under **GPL-3.0**.",
        "",
        "---",
        f"*Model card auto-generated by {__package__} at "
        f"{datetime.now(timezone.utc).strftime('%Y-%m-%dT%H:%M:%SZ')}*",
        "",
    ]
    return "\n".join(lines)
