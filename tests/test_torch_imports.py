"""The port stands alone: no module of dinox_torch (the training step and
loop, the data layer, the checkpoints, the pretraining CLI, the
augmentation, the bench and the FLOP counts included), and not
chip_smoke.py, imports JAX, flax, optax or the JAX package, and nothing on
the serving, training, evaluation or fine-tuning path imports PIL,
safetensors, huggingface_hub, scikit-learn, peft, pydicom, nibabel or
pylidc (the GPU machine has none of them): the CIFAR control and the
DICOM/NIfTI readers and preprocessing CLIs included. Checked on the source with an AST scan."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dinox_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dinox_tpu", "PIL", "safetensors",
             "huggingface_hub", "sklearn", "peft", "pydicom", "nibabel", "pylidc"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"dinox_torch/serve.py", "dinox_torch/zoo/hub.py", "dinox_torch/models/vit.py",
            "dinox_torch/ops/flash_attention.py", "chip_smoke.py",
            "dinox_torch/train/step.py", "dinox_torch/train/state.py",
            "dinox_torch/train/losses.py", "dinox_torch/train/schedule.py",
            "dinox_torch/ops/augment.py", "dinox_torch/bench.py",
            "dinox_torch/utils/flops.py", "dinox_torch/ops/fused_attn_block.py",
            "dinox_torch/ops/fused_mlp.py", "dinox_torch/validate_attention.py",
            "dinox_torch/pretrain.py", "dinox_torch/data/index.py", "dinox_torch/data/sampler.py",
            "dinox_torch/data/png16.py", "dinox_torch/data/pipeline.py",
            "dinox_torch/data/slice_cache.py", "dinox_torch/data/synthetic.py",
            "dinox_torch/data/prefetch.py", "dinox_torch/train/anomaly.py",
            "dinox_torch/train/checkpoint.py", "dinox_torch/train/trainer.py",
            "dinox_torch/utils/logging.py", "dinox_torch/zoo/lineage.py",
            "dinox_torch/evaluation/linear.py", "dinox_torch/evaluation/metrics.py",
            "dinox_torch/evaluation/embedder.py", "dinox_torch/train/run_export.py",
            "dinox_torch/evaluate_panorgan.py", "dinox_torch/view_retrieval_eval.py",
            "dinox_torch/check_checkpoint.py", "dinox_torch/bench_inference.py",
            "dinox_torch/zoo/peft.py", "dinox_torch/train/finetune.py",
            "dinox_torch/finetune_lora.py", "dinox_torch/ops/augment_rgb.py",
            "dinox_torch/data/cifar.py", "dinox_torch/baseline_cifar10_pretrain.py",
            "dinox_torch/baseline_cifar10_linear_probe.py",
            "dinox_torch/baseline_cifar10_view_retrieval_eval.py", "dinox_torch/data/hu.py",
            "dinox_torch/data/dicom.py", "dinox_torch/data/nifti.py", "dinox_torch/data/lidc.py",
            *(f"dinox_torch/preprocessing/{m}.py" for m in (
                "make_synthetic_data", "preprocess_dicom", "preprocess_nifti",
                "extract_dicom_spacing", "combine_indices", "make_split_manifest",
                "build_slice_cache", "validate_samples", "extract_lidc_malignancy"))} <= names
