"""The port's pretraining CLI (python -m dinox_torch.pretrain), in process on
the CPU: a run split by --stop-after and resumed matches the straight run
(the twin of tests/test_stop_after.py), resume reconciles the model config
as the JAX CLI does, an index-CSV run goes through the loader and the
prefetcher, every flag of what is not ported yet raises naming its module,
module 13a's flags on one process, and without --device the CLI wants a
card."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dinox_torch import pretrain
from dinox_torch.data import index as t_index
from dinox_torch.data.png16 import write_png16
from dinox_torch.models.config import MODEL_CONFIGS, PORT_ONLY_FIELDS, ModelConfig
from dinox_tpu.models.config import MODEL_CONFIGS as JAX_MODEL_CONFIGS

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--config", "vit-tiny", "--batch-size", "8", "--img-size", "56", "--canvas", "64",
        "--warmup-steps", "2", "--lr", "5e-4", "--seed", "7", "--scale-aware", "--log-json",
        "--no-tensorboard", "--attn-impl", "pallas", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and a thread pool per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("pretrain_cli", ROOT / "scripts" / "pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(run_dir, *extra):
    argv = TINY + ["--synthetic-device-batches", "2", "--max-steps", "6", "--ckpt-every", "3",
                   "--run-dir", str(run_dir), *extra]
    assert pretrain.main(argv) == 0


def _metrics(run_dir):
    return {r["step"]: r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())}


def test_stop_after_resume_matches_uninterrupted(tmp_path):
    straight = tmp_path / "straight"
    _run(straight)
    ref = _metrics(straight)
    assert sorted(ref) == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in ref.values())
    split = tmp_path / "split"
    _run(split, "--stop-after", "3")
    assert sorted(_metrics(split)) == [1, 2, 3], "leg 1 must stop at --stop-after"
    _run(split, "--resume", str(split))
    got = _metrics(split)
    assert sorted(got) == [1, 2, 3, 4, 5, 6]
    for s in range(1, 7):  # the schedule horizon stayed at --max-steps 6 across the seam
        assert got[s]["lr"] == ref[s]["lr"], (s, got[s]["lr"], ref[s]["lr"])
    for s in range(4, 7):
        np.testing.assert_allclose(got[s]["loss"], ref[s]["loss"], rtol=1e-5, err_msg=f"step {s}")
    prov = json.loads((split / "provenance.json").read_text())
    assert prov["data_manifest_hash"] == "synthetic" and "--resume" in prov["argv"]
    assert (split / "config.json").exists() and sorted(p.name for p in (split / "ckpt").iterdir()) == ["3", "6"]


def test_reconcile_resume_model_config_matches_jax():
    stored = {"gelu_approx": False, "scale_aware": True, "attn_impl": "xla", "fused_attn": True,
              "lora_targets": ["qkv", "proj", "fc1", "fc2"], "dim": 240, "not_a_field": 123}
    got = pretrain.reconcile_resume_model_config(
        MODEL_CONFIGS["vit-tiny"].replace(gelu_approx=True, attn_impl="pallas"), stored)
    want = _jax_cli().reconcile_resume_model_config(
        JAX_MODEL_CONFIGS["vit-tiny"].replace(gelu_approx=True, attn_impl="pallas"), stored)
    port = dataclasses.asdict(got)  # the JAX fields, then the port's own at their defaults
    assert {k: port.pop(k) for k in PORT_ONLY_FIELDS} == {k: getattr(ModelConfig(), k) for k in PORT_ONLY_FIELDS}
    assert port == dataclasses.asdict(want)
    assert got.gelu_approx is False and got.attn_impl == "pallas" and got.dim == 240
    assert pretrain._RUNTIME_ONLY_MODEL_FIELDS == _jax_cli()._RUNTIME_ONLY_MODEL_FIELDS


def test_resume_adopts_the_stored_model_config(tmp_path, capsys):
    run = tmp_path / "run"
    _run(run, "--stop-after", "1", "--gelu", "exact")
    _run(run, "--resume", "auto", "--stop-after", "2")
    assert "resume: adopting stored model.gelu_approx=False" in capsys.readouterr().out
    assert sorted(_metrics(run)) == [1, 2]


def test_index_csv_run_through_the_loader(tmp_path, capsys):
    rng = np.random.default_rng(5)
    rows = []
    for s in range(3):
        (tmp_path / f"s{s}").mkdir()
        for z in range(4):
            path = tmp_path / f"s{s}" / f"{z}.png"
            write_png16(path, rng.integers(31000, 35000, (64 if s else 80, 64 if s else 80)).astype(np.uint16))
            rows.append(t_index.IndexRow(png_path=str(path), series_dir=f"s{s}", slice_index=z,
                                         spacing_x=0.7, spacing_y=0.7, spacing_z=2.0))
    t_index.write_index_rows(rows, tmp_path / "index.csv")
    argv = TINY + ["--index-csv", str(tmp_path / "index.csv"), "--max-steps", "2", "--ckpt-every", "0",
                   "--num-workers", "2", "--device-prefetch", "2", "--decoded-cache", "build",
                   "--diverse-batches", "--run-dir", str(tmp_path / "run")]
    assert pretrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "loaded_rows=12" in out and "decoded-slice cache: 12 slices @64" in out
    assert "png decoder: native" in out
    meta = json.loads((tmp_path / "run" / "ckpt" / "2" / "meta.json").read_text())
    # 12 rows, batch 8: one batch an epoch. The position is that of the
    # batches trained, not of those the prefetcher has pulled ahead.
    assert (meta["loader_epoch"], meta["loader_batch"]) == (2, 0)
    assert json.loads((tmp_path / "run" / "provenance.json").read_text())["data_manifest_hash"] != "synthetic"


@pytest.mark.parametrize("argv", [[], ["--signature-strength", "2"]])
def test_data_arguments_refused(tmp_path, argv):
    assert pretrain.main(TINY + ["--run-dir", str(tmp_path / "run"), *argv]) == 2


UNPORTED = [
    (["--model-parallel", "2"], "module 13a"), (["--pipeline-parallel", "2"], "module 13b"),
    (["--expert-parallel", "2"], "exit 2"), (["--sequence-parallel"], "module 13a"),
    (["--dist-coordinator", "localhost:1234"], "module 13a"), (["--dist-processes", "2"], "module 13a"),
    (["--dist-process-id", "0"], "module 13a"), (["--moe-experts", "4"], "module 11"),
    (["--loss-type", "mae"], "module 11"), (["--mu-dtype", "bfloat16"], "module 11"),
    (["--nu-dtype", "bfloat16"], "module 11"), (["--factored-nu"], "module 11"),
    (["--monitor-every", "5"], "module 11"),
    (["--pipeline-parallel", "2", "--model-parallel", "2"], "exit 2"),
    (["--pipeline-parallel", "2", "--expert-parallel", "2", "--moe-experts", "2"], "exit 2"),
    (["--pipeline-parallel", "2", "--monitor-every", "5"], "exit 2"),
]


@pytest.mark.parametrize("flags,module", UNPORTED, ids=[" ".join(f) for f, _ in UNPORTED])
def test_unported_flags_raise(tmp_path, capsys, flags, module):
    """--pipeline-parallel 2 (module 13b's last part) on one process is
    refused by make_pp_mesh, as the JAX make_pp_mesh refuses it on one
    device, before anything is written; with --model-parallel it exits 2
    with the reference's message, and with --expert-parallel or
    --monitor-every (which the (data, pipe) mesh and a rank's one stage do
    not take) it exits 2 too; --expert-parallel 2 without --moe-experts
    divisible by it exits 2 before anything is written (the reference's help
    text asks for it; its mesh fails only later). Module 13a's do
    what they now do, in process and on one process, contacting no
    coordinator: --model-parallel 2 is refused as make_mesh refuses it on
    one device, --dist-processes 2 without a coordinator and a process id is
    refused, and --sequence-parallel, --dist-coordinator and
    --dist-process-id alone change nothing (one process initialises no
    group, and the JAX package's _sp is a no-op off a model axis). Module
    11's are ported: one step runs and the flag reaches the run's config."""
    argv = TINY + ["--synthetic", "--max-steps", "1", "--run-dir", str(tmp_path / "run"), *flags]
    if module == "exit 2":
        assert pretrain.main(argv) == 2
        assert not (tmp_path / "run").exists()
        if flags[0] == "--pipeline-parallel":
            assert f"--pipeline-parallel and {flags[2]} are mutually exclusive" in capsys.readouterr().err
        return
    refused = {"--model-parallel": "not divisible by model_parallel=2",
               "--dist-processes": "--dist-coordinator",
               "--pipeline-parallel": "1 processes not divisible by pp=2"}
    if flags[0] in refused:
        with pytest.raises(ValueError, match=refused[flags[0]]):
            pretrain.main(argv)
        assert not (tmp_path / "run").exists()
        return
    assert pretrain.main(argv + ["--no-tensorboard"]) == 0
    cfg = json.loads((tmp_path / "run" / "config.json").read_text())
    field, value = {"--moe-experts": ("moe_experts", 4), "--loss-type": ("loss_type", "mae"),
                    "--mu-dtype": ("mu_dtype", "bfloat16"), "--nu-dtype": ("nu_dtype", "bfloat16"),
                    "--factored-nu": ("factored_nu", True), "--monitor-every": (None, None),
                    "--sequence-parallel": ("sequence_parallel", True),
                    "--dist-coordinator": ("sequence_parallel", False),
                    "--dist-process-id": ("sequence_parallel", False)}[flags[0]]
    if field in ("moe_experts", "sequence_parallel"):
        assert cfg["model"][field] == value
    elif field is not None:
        assert cfg[field] == value
    else:  # the monitor is made at start-up; its first snapshot is at step 5
        assert (tmp_path / "run" / "monitor").is_dir()
    if module == "module 13a":  # one process: no group, and one step trained
        assert not torch.distributed.is_initialized()
        assert sorted(_metrics(tmp_path / "run")) == [1]


def test_cli_wants_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain.main(argv + ["--synthetic", "--max-steps", "1", "--run-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
