"""The port's release tooling (module 12) against the JAX package's, in
process on the CPU: the model card line for line (only the documented
lines differ), _scrub_config and _scrub_path, stage_release of a dense and
an MoE ViT-T from the same weights (file set, config.json, tensors, the
scrubbed training config, the evaluation results), python -m
dinox_torch.publish_release's snapshot, the two manifest CLIs and
prepare_data --dry-run against the JAX scripts, detect_hardware's CPU rule,
and the by-kind trace aggregation."""

import contextlib
import csv
import hashlib
import importlib
import importlib.util
import io
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import safetensors.numpy
import torch

from dinox_torch import pretrain, publish_release
from dinox_torch import zoo as t_zoo
from dinox_torch.data.index import IndexRow, write_index_rows
from dinox_torch.data.png16 import read_png16
from dinox_torch.models.config import ModelConfig
from dinox_torch.preprocessing import prepare_data, temperature_resample, write_dataset_manifest
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.utils import hardware as t_hardware
from dinox_torch.utils import trace_analysis
from dinox_torch.zoo import card as t_card
from dinox_torch.zoo import publish as t_publish
from dinox_torch.zoo.hub import LoadedModel
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_torch.zoo.manifest import DataManifest as TManifest
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.utils import hardware as j_hardware
from dinox_tpu.zoo import card as j_card
from dinox_tpu.zoo import hub as jax_hub
from dinox_tpu.zoo import publish as j_publish
from dinox_tpu.zoo.manifest import DataManifest as JManifest

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
FOOTER = "*Model card auto-generated by "
TRAINING_CONFIG = {
    "model": {"name": "vit-tiny", "dim": 192}, "batch_size": 32, "accumulation_steps": 2, "lr": 1e-4,
    "min_lr": 1e-6, "warmup_steps": 10, "max_steps": 100, "ema": 0.996, "center_momentum": 0.9,
    "weight_decay": 0.04, "train_seed": 3, "git_commit": "abc123", "gram_weight": 1.0,
    "koleo_weight": 0.1, "index_csv": "/root/work/data/processed/_index/index.csv",
    "run_dir": "/tmp/runs/vit_tiny", "split_manifest": "/home/u/splits/split.json",
    "data_root": "relative/data", "hardware": {"kind": "x"}, "data_manifest_hash": "deadbeef",
    "datasets": ["lidc-idri", {"name": "pancreas-ct"}, {"other": 1}],
    "nested": {"workdir": "/mnt/scratch/experiment/a/b", "hardware": "card"},
}
EVALS = {
    "metrics": {
        "view_retrieval_per_dataset": {"lidc-idri": {"top1": 0.41, "top5": 0.7, "ratio_vs_random": 210.4}},
        "dataset_discrimination_probe": {"accuracy": 0.93, "auc": 0.99},
        "spacing_counterfactual": {"cosine_distance_real_vs_2x": {"mean": 0.0123},
                                   "cosine_distance_real_vs_half": {"mean": 0.0456}},
        "spacing_prediction": {"r2": 0.81},
    },
    "val_slices": 512, "step": 100, "seed": 0,
    "view_retrieval": {"top1": 0.5, "n": 512},
}
LINEAGE = {"datasets": [{"name": "lidc-idri", "organ": "lung", "slices": 10, "spacing_range": "0.5-0.9",
                         "thickness_range": "1-5", "license": "CC-BY-NC-3.0"}, {"name": "x"}]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(rel):
    spec = importlib.util.spec_from_file_location(f"jax_script_{Path(rel).stem}", SCRIPTS / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_cards_match(got: str, want: str, hardware_default: bool = True):
    """Line for line, except the footer (package and time) and, where the
    training config names no hardware, the Hardware row."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    differ = [(a, b) for a, b in zip(g, w) if a != b]
    expected = 1 + hardware_default
    assert len(differ) == expected, differ
    for a, b in differ:
        if a.startswith(FOOTER):
            assert a.startswith(FOOTER + "dinox_torch.zoo at ") and b.startswith(FOOTER + "dinox_tpu.zoo at ")
        else:
            assert (a, b) == (f"| Hardware | {t_card.DEFAULT_HARDWARE} |", "| Hardware | TPU |")
    assert "TPU" not in got


@pytest.mark.parametrize("case", ["full", "bare", "moe", "index-only", "hardware-named"])
def test_model_card_matches_jax(case):
    mc = {"name": "vit-small", "dim": 384, "depth": 12, "heads": 6, "patch": 14, "img_size": 224,
          "mlp_ratio": 4.0, "scale_aware": case != "bare", "params_millions": 21.7}
    kw = dict(training_config=TRAINING_CONFIG, eval_results=EVALS, lineage=LINEAGE, model_name="dinox-x")
    if case == "bare":
        kw = {}
    elif case == "moe":
        mc.update(moe_experts=4, moe_every=2, weights_format="jax")
    elif case == "index-only":
        kw = dict(training_config={k: TRAINING_CONFIG[k] for k in ("index_csv", "lr")})
    elif case == "hardware-named":
        kw = dict(training_config={"hardware": "8 x A100", "batch_size": 4})
    got = t_card.generate_model_card(mc, **kw)
    want = j_card.generate_model_card(mc, **kw)
    tc = kw.get("training_config")
    assert_cards_match(got, want, hardware_default=bool(tc) and "hardware" not in tc)
    assert t_zoo.generate_model_card is t_card.generate_model_card


def test_scrub_config_and_path_match_jax():
    assert t_publish._scrub_config(TRAINING_CONFIG) == j_publish._scrub_config(TRAINING_CONFIG)
    for p in ("/root/work/data/processed/x.csv", "/tmp/runs/a/ckpt", "/home/u/file.json", "relative/p",
              "/mnt/a/b/c", "/workspace/checkpoints/best.pth", "/srv/data/x"):
        assert t_card._scrub_path(p) == j_card._scrub_path(p)


def _models(moe: bool):
    """A JAX LoadedModel of ViT-T width (depth 2) and the port's, same weights."""
    jcfg = jax_config.MODEL_CONFIGS["vit-tiny"].replace(
        depth=2, scale_aware=True, attn_impl="xla", moe_experts=4 if moe else 0)
    params = init_backbone(jcfg, jax.random.key(1))
    jm = jax_hub.LoadedModel(jcfg, params)
    tm = LoadedModel(ModelConfig(**{k: v for k, v in jcfg.to_dict().items() if k != "lora_targets"}), "cpu")
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        jax_to_torch_backbone(jax.tree_util.tree_map(np.asarray, params)).items()})
    return jm, tm


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stage_release_matches_jax(tmp_path, moe):
    jm, tm = _models(moe)
    kw = dict(model_name="dinox-ct-vit-tiny", training_config=TRAINING_CONFIG, eval_results=EVALS,
              lineage=LINEAGE)
    j_dir = j_publish.stage_release(jm, tmp_path / "jax", **kw)
    t_dir = t_publish.stage_release(tm, tmp_path / "port", **kw)
    files = sorted(p.name for p in t_dir.iterdir())
    assert files == sorted(p.name for p in j_dir.iterdir())
    assert ("backbone.pth" in files) is not moe
    for name in ("config.json", "training_config.json", "eval_results.json"):
        assert json.loads((t_dir / name).read_text()) == json.loads((j_dir / name).read_text()), name
    assert (t_dir / "training_config.json").read_text() == (j_dir / "training_config.json").read_text()
    a = safetensors.numpy.load_file(t_dir / "backbone.safetensors")
    b = safetensors.numpy.load_file(j_dir / "backbone.safetensors")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if not moe:
        a, b = torch.load(t_dir / "backbone.pth"), torch.load(j_dir / "backbone.pth")
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    card = (t_dir / "README.md").read_text()
    assert_cards_match(card, (j_dir / "README.md").read_text())
    count = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(jm.params))
    assert f"| Parameters | {round(count / 1e6, 1)}M |" in card
    # Re-staging rebuilds the dir; the staged dir loads back bit for bit.
    (t_dir / "stale.txt").write_text("x")
    t_publish.stage_release(tm, t_dir, model_name="again")
    assert not (t_dir / "stale.txt").exists()
    back = t_zoo.load_model(t_dir, device="cpu")
    assert all(torch.equal(back.state_dict()[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(NotImplementedError, match="huggingface_hub"):
        t_publish.publish_to_hub(tm, "org/model")
    assert t_publish.publish_to_hub(tm, "org/model", dry_run=True, staging_dir=tmp_path / "dry") == tmp_path / "dry"


def test_publish_release_cli_snapshot(tmp_path):
    run = tmp_path / "run"
    assert pretrain.main(["--config", "vit-tiny", "--batch-size", "4", "--img-size", "56", "--canvas", "64",
                          "--warmup-steps", "1", "--max-steps", "2", "--ckpt-every", "2", "--scale-aware",
                          "--synthetic-device-batches", "1", "--log-json", "--no-tensorboard",
                          "--attn-impl", "xla", "--device", "cpu", "--run-dir", str(run)]) == 0
    (tmp_path / "eval.json").write_text(json.dumps({"metrics": EVALS["metrics"], "step": 2}))
    (tmp_path / "vr.json").write_text(json.dumps({"top1": 0.5}))
    adapter = tmp_path / "adapter"
    adapter.mkdir()
    (adapter / "adapter_config.json").write_text("{}")
    (adapter / "adapter_model.safetensors").write_bytes(b"weights")
    staging, snap = tmp_path / "staged", tmp_path / "snap"
    argv = ["--backbone", str(run), "--model-name", "dinox-test", "--eval-json", str(tmp_path / "eval.json"),
            "--retrieval-json", str(tmp_path / "vr.json"), "--adapter", str(adapter), "--staging-dir",
            str(staging), "--snapshot-dir", str(snap), "--device", "cpu"]
    assert publish_release.main(argv) == 0
    lines = (snap / "WEIGHTS.sha256").read_text().splitlines()
    want = sorted(f.relative_to(staging) for f in staging.rglob("*") if f.suffix in (".pth", ".safetensors"))
    assert [Path(ln.split()[2]) for ln in lines[1:]] == want
    for ln in lines[1:]:
        digest, size, rel = ln.split()
        data = (staging / rel).read_bytes()
        assert digest == hashlib.sha256(data).hexdigest() and int(size) == len(data)
    jax_snap = _script("publish_release.py").snapshot_weightless(staging, tmp_path / "jax_snap")
    assert (jax_snap / "WEIGHTS.sha256").read_text() == (snap / "WEIGHTS.sha256").read_text()
    assert sorted(p.relative_to(snap) for p in snap.rglob("*")) == sorted(
        p.relative_to(jax_snap) for p in jax_snap.rglob("*"))
    tc = json.loads((staging / "training_config.json").read_text())
    prov = json.loads((run / "provenance.json").read_text())
    assert tc["git_commit"] == prov["git_commit"] and "hardware" not in tc
    evals = json.loads((staging / "eval_results.json").read_text())
    assert evals["view_retrieval"] == {"top1": 0.5} and evals["step"] == 2
    staged = t_zoo.load_model(staging, device="cpu")
    ref = load_backbone_from_run(run, device="cpu")
    assert all(torch.equal(staged.state_dict()[k], v) for k, v in ref.state_dict().items())
    assert publish_release.main(argv[:4] + ["--staging-dir", str(staging), "--upload"]) == 2
    with pytest.raises(NotImplementedError):
        publish_release.main(argv + ["--upload", "--repo-id", "org/x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        publish_release.main(argv[:-2])


def _rows(tmp_path):
    rng = np.random.default_rng(0)
    rows = [IndexRow(png_path=f"/d/{ds}/s{i // 4}/{i % 4}.png", series_dir=f"{ds}/s{i // 4}", slice_index=i % 4,
                     spacing_x=float(rng.uniform(0.4, 1)), spacing_y=0.7, spacing_z=float(rng.choice([1.0, 2.5])),
                     dataset=ds)
            for ds, n in (("a", 37), ("b", 9), ("c", 2)) for i in range(n)]
    write_index_rows(rows, tmp_path / "index.csv")
    return tmp_path / "index.csv"


def test_manifest_clis_match_the_jax_scripts(tmp_path):
    index = _rows(tmp_path)
    for total in (0, 100):
        outs = []
        for who, main in (("jax", _script("preprocessing/temperature_resample.py").main),
                          ("port", temperature_resample.main)):
            out = tmp_path / f"{who}_{total}.csv"
            assert main(["--index", str(index), "--out", str(out), "--temperature", "2.0",
                         "--total", str(total), "--seed", "3"]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
    for who, main in (("jax", _script("preprocessing/write_dataset_manifest.py").main),
                      ("port", write_dataset_manifest.main)):
        assert main(["--index", str(index), "--dataset", "lidc-idri", "--out", str(tmp_path / f"{who}.parquet"),
                     "--organs", "lung", "chest"]) == 0
    want = [r.model_dump() for r in JManifest.load(tmp_path / "jax.parquet").records]
    assert [r.model_dump() for r in TManifest.load(tmp_path / "port.parquet").records] == want
    assert [r.model_dump() for r in JManifest.load(tmp_path / "port.parquet").records] == want


def _tree(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))


def test_prepare_data_dry_run_matches_jax(tmp_path):
    """The JAX orchestrator's sibling scripts run in process here (loaded by
    path), the port's CLIs through their main."""
    jax_prepare = _script("preprocessing/prepare_data.py")

    def run(script, *args):
        assert _script(f"preprocessing/{script}").main(list(map(str, args))) == 0

    jax_prepare.run = run
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_prepare.main(["--out", str(tmp_path / "jax"), "--dry-run"]) == 0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert prepare_data.main(["--out", str(tmp_path / "port"), "--dry-run"]) == 0
    assert "-m dinox_torch.preprocessing.write_dataset_manifest" in out.getvalue()
    j, t = tmp_path / "jax", tmp_path / "port"
    assert _tree(t) == _tree(j)

    def text(p, root):
        return p.read_text().replace(str(root), "<out>")

    for rel in ("_index/index.csv", "dryrun_a/_index/index.csv", "split_manifest.json", "qa/qa_report.json"):
        assert text(t / rel, t) == text(j / rel, j), rel
    for name in ("dryrun_a", "dryrun_b"):
        got = [r.model_dump() for r in TManifest.load(t / "manifests" / f"{name}.parquet").records]
        want = [r.model_dump() for r in JManifest.load(j / "manifests" / f"{name}.parquet").records]
        assert [{**r, "image_path": r["image_path"].replace(str(t), "")} for r in got] == [
            {**r, "image_path": r["image_path"].replace(str(j), "")} for r in want]
    with open(t / "_index" / "index.csv") as f:
        for row in list(csv.DictReader(f))[:4]:
            rel = Path(row["png_path"]).relative_to(t)
            np.testing.assert_array_equal(read_png16(t / rel), read_png16(j / rel))
    assert prepare_data.main(["--out", str(tmp_path / "none")]) == 2


def test_detect_hardware_cpu_rule_matches_jax():
    got, want = t_hardware.detect_hardware("cpu"), j_hardware.detect_hardware()
    assert want.backend == "cpu"
    for field in ("backend", "device_kind", "num_hosts", "host_cpus", "num_workers", "batch_size_recommendation"):
        assert getattr(got, field) == getattr(want, field), field
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_hardware.detect_hardware()


def _event(name, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": 0, "pid": 0, "tid": 7}


def test_trace_analysis_by_kind(tmp_path):
    events = [
        _event("void attention_fwd_sm90<64, (Rounding)0, true>(CUtensorMap, CUtensorMap)", 100.0),
        _event("void attention_fwd_sm90<64, (Rounding)1, false>(CUtensorMap)", 10.0),
        _event("void attention_bwd_sm90_dq<64, true>(CUtensorMap)", 50.0),
        _event("void attention_bwd_sm90_dkv<64, true>(CUtensorMap)", 40.0),
        _event("void attention_bwd_sm90_dq<64, false>(CUtensorMap)", 5.0),
        _event("void fused_attn_block_qkv<2>(CUtensorMap)", 30.0),
        _event("fused_mlp_fwd_fc2", 20.0), _event("void fused_mlp_bwd_hidden(CUtensorMap)", 25.0),
        _event("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", 200.0),
        _event("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 100.0),
        _event("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>()", 60.0),
        _event("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>()", 15.0),
        _event("void at::native::reduce_kernel<512, 1>()", 12.0),
        _event("Memcpy HtoD (Pageable -> Device)", 8.0, cat="gpu_memcpy"),
        _event("void multi_tensor_apply_kernel<TensorListMetadata<4>>()", 9.0),
        _event("some_custom_kernel", 3.0),
        _event("aten::mm", 999.0, cat="cpu_op"), _event("cudaLaunchKernel", 999.0, cat="cuda_runtime"),
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]
    (tmp_path / "profile").mkdir()
    (tmp_path / "profile" / "trace_step2.json").write_text(json.dumps({"traceEvents": events}))
    summary = trace_analysis.summarize_trace_dir(tmp_path, steps=2)
    cats = summary["categories"]
    assert summary["trace_file"].endswith("trace_step2.json") and summary["steps"] == 2
    assert cats["cuBLAS GEMM"] == {"ms": 0.3, "count": 2, "ms_per_step": 0.15}
    assert cats["kernel 1 (packed attention forward)"]["ms"] == 0.1
    assert cats["kernel 4 (head-major attention forward)"]["count"] == 1
    assert cats["kernels 2/3 (packed attention backward)"] == {"ms": 0.09, "count": 2, "ms_per_step": 0.045}
    assert cats["kernel 5 (head-major attention backward)"]["count"] == 1
    assert cats["kernel 6 (fused attention half-block)"]["count"] == 1
    assert cats["kernel 7 (fused MLP forward)"]["count"] == cats["kernel 8 (fused MLP backward)"]["count"] == 1
    assert cats["elementwise"]["count"] == 2 and cats["copy/cast"]["count"] == 2
    assert cats["reduction"]["count"] == cats["other"]["count"] == 1
    assert list(cats)[0] == "cuBLAS GEMM" and sum(r["count"] for r in cats.values()) == 16
    table = trace_analysis.format_category_table(cats, top=3)
    assert table.splitlines()[1].startswith("cuBLAS GEMM") and len(table.splitlines()) == 4

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (tmp_path / "cpu").mkdir()
    prof.export_chrome_trace(str(tmp_path / "cpu" / "host.pt.trace.json"))
    assert trace_analysis.summarize_trace_dir(tmp_path / "cpu")["categories"] == {}
    assert trace_analysis.device_ops(prof) == []
    with pytest.raises(FileNotFoundError):
        trace_analysis.summarize_trace_dir(tmp_path / "cpu" / "none")


def test_zoo_exports_the_jax_names():
    jax_zoo = importlib.import_module("dinox_tpu.zoo")
    want = set(jax_zoo.__all__) | set(jax_zoo._LAZY)
    assert want <= set(t_zoo.__all__) and all(hasattr(t_zoo, n) for n in want)
    importlib.import_module("dinox_torch.zoo.encode")
    assert isinstance(t_zoo.encode, types.FunctionType) and t_zoo.encode.__name__ == "encode"
