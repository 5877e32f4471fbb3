"""The port stands alone: no module of dinox_torch (the training step and
loop, the data layer, the checkpoints, the pretraining CLI, the
augmentation, the bench and the FLOP counts included), and not
chip_smoke.py, imports JAX, flax, optax or the JAX package, and nothing on
the serving, training, evaluation or fine-tuning path imports PIL,
safetensors, huggingface_hub, scikit-learn, peft, pydicom, nibabel or
pylidc, nor (the catalog, the Parquet manifests and the release tooling)
pydantic, PyYAML or pyarrow (the GPU machine has none of them): the CIFAR
control, the DICOM/NIfTI readers and preprocessing CLIs, the MoE and MAE
models, the optimizer-memory options, the monitor, the scale and MoE
benches, module 12's provenance layer, release staging and canary, and
module 12b's run and bench tooling included. TensorBoard
(``torch.utils.tensorboard``, absent on some GPU machines) is imported only
inside functions. Checked on the source with an AST scan."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dinox_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dinox_tpu", "PIL", "safetensors",
             "huggingface_hub", "sklearn", "peft", "pydicom", "nibabel", "pylidc", "pydantic", "yaml",
             "pyarrow"}


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
                "build_slice_cache", "validate_samples", "extract_lidc_malignancy")),
            "dinox_torch/models/moe.py", "dinox_torch/models/mae.py", "dinox_torch/train/optim.py",
            "dinox_torch/train/monitor_hook.py", "dinox_torch/data/png8.py",
            "dinox_torch/monitor.py", "dinox_torch/bench_scale.py",
            "dinox_torch/bench_moe_sweep.py",
            *(f"dinox_torch/zoo/{m}.py" for m in (
                "schemas", "_yaml", "registry", "_parquet", "manifest", "merge", "card", "publish")),
            *(f"dinox_torch/preprocessing/{m}.py" for m in (
                "write_dataset_manifest", "temperature_resample", "prepare_data")),
            "dinox_torch/data/manifest_dataset.py", "dinox_torch/publish_release.py",
            "dinox_torch/integration_canary.py", "dinox_torch/utils/hardware.py",
            "dinox_torch/utils/trace_analysis.py",
            *(f"dinox_torch/{m}.py" for m in (
                "compare_runs", "log_runs", "soak_seam_analysis", "diagnose_scale_pathway",
                "round5_data_probe", "round5_patch_probe", "bench_batch_sweep", "tune_throughput",
                "ablation_lora_lidc"))} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_tensorboard_only_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n.lineno for n in tree.body
           if isinstance(n, (ast.Import, ast.ImportFrom)) and "tensorboard" in ast.unparse(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports torch.utils.tensorboard at import time"
