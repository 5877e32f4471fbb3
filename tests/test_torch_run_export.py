"""From a run directory of the port to its backbone (train.run_export) and
the checkpoint inspector (python -m dinox_torch.check_checkpoint), on the
CPU: a state saved by the checkpoint manager reads back as the student's and
the teacher's backbone bit for bit, only the backbone's tensors are read
from the state file, a run written by pretrain.main loads and is
inspected, and an Orbax (JAX package) run dir raises a clear error."""

import json

import numpy as np
import pytest
import torch

from dinox_torch import check_checkpoint, evaluate_panorgan, finetune_lora, pretrain, view_retrieval_eval
from dinox_torch.models.config import MODEL_CONFIGS
from dinox_torch.train import run_export
from dinox_torch.train.checkpoint import CheckpointManager
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.trainer import config_dict
from dinox_torch.zoo import safetensors_io

CFG = TrainConfig(model=MODEL_CONFIGS["vit-tiny"].replace(depth=2, scale_aware=True, out_dim=64),
                  img_size=28, batch_size=2)


@pytest.fixture
def saved_run(tmp_path):
    state = create_train_state(CFG, seed=3, device="cpu")
    with torch.no_grad():  # the teacher differs from the student
        for p in state.teacher.parameters():
            p.add_(0.01)
    (tmp_path / "config.json").write_text(json.dumps(config_dict(CFG), default=str))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(7, state)
    mgr.close()
    return tmp_path, state


@pytest.mark.parametrize("source", ["student", "teacher"])
def test_backbone_from_run_equals_the_saved_modules(saved_run, source):
    run, state = saved_run
    model = run_export.load_backbone_from_run(run, source=source, device="cpu")
    want = getattr(state, source).backbone.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert model.cfg == CFG.model.replace(img_size=28) and model.device.type == "cpu"
    assert run_export.train_config_from_run(run) == CFG


def test_only_backbone_tensors_are_read(saved_run, monkeypatch):
    run, _ = saved_run
    read = []
    real = safetensors_io._read

    def spy(f, base, size, name, info):
        read.append(name)
        return real(f, base, size, name, info)

    monkeypatch.setattr(safetensors_io, "_read", spy)
    run_export.load_backbone_from_run(run, device="cpu")
    assert read and all(name.startswith("student.backbone.") for name in read)
    n_read = len(read)
    everything = safetensors_io.load_file(run / "ckpt" / "7" / "state.safetensors")
    assert n_read == sum(k.startswith("student.backbone.") for k in everything) < len(everything) // 2


def test_state_from_run(saved_run):
    run, state = saved_run
    got, cfg, meta = run_export.load_state_from_run(run, device="cpu")
    assert cfg == CFG and meta["step"] == 7 and got.step == state.step
    for a, b in zip(got.teacher.parameters(), state.teacher.parameters()):
        assert torch.equal(a, b)


def test_orbax_run_dir_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(config_dict(CFG), default=str))
    (tmp_path / "ckpt" / "5" / "default").mkdir(parents=True)
    (tmp_path / "ckpt" / "5" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        run_export.load_backbone_from_run(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError):
        run_export.load_backbone_from_run(tmp_path / "nothing", device="cpu")


def test_pretrain_run_loads_and_is_inspected(tmp_path, capsys):
    run = tmp_path / "run"
    assert pretrain.main(["--config", "vit-tiny", "--batch-size", "2", "--img-size", "28",
                          "--canvas", "32", "--warmup-steps", "1", "--scale-aware", "--log-json",
                          "--no-tensorboard", "--device", "cpu", "--synthetic-device-batches", "1",
                          "--max-steps", "1", "--run-dir", str(run)]) == 0
    model = run_export.load_backbone_from_run(run, device="cpu")
    state, _, _ = run_export.load_state_from_run(run, host=True)
    for source, got in (("student", model),
                        ("teacher", run_export.load_backbone_from_run(run, source="teacher", device="cpu"))):
        want = getattr(state, source).backbone.state_dict()
        assert got.state_dict().keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got.state_dict()[k], v), (source, k)
    capsys.readouterr()
    assert check_checkpoint.main(["--run-dir", str(run), "--tail", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    n = sum(p.numel() for p in state.student.parameters())
    assert out[0] == "config: vit-tiny dim=192 depth=12 scale_aware=True batch=2x1 lr=0.0001"
    assert out[1] == "checkpoints: [1] (latest=1)"
    assert out[2] == (f"latest: step=1 params={n / 1e6:.1f}M "
                      f"center_norm={float(state.center.abs().mean()):.4f} loader_pos=(0,0)")
    assert out[3] == "metrics: 1 steps logged; last 1:" and out[4].startswith("  ") and "step=1" in out[4]
    assert check_checkpoint.main(["--run-dir", str(tmp_path / "absent"), "--device", "cpu"]) == 2
    np.testing.assert_array_equal(model(np.zeros((1, 28, 28, 3), np.float32), np.ones((1, 3))).shape,
                                  (1, 1 + 4 + 4, 192))


@pytest.mark.parametrize("cli,argv", [
    (evaluate_panorgan, ["--checkpoint", "x", "--index-csv", "x.csv"]),
    (view_retrieval_eval, ["--checkpoint", "x", "--index-csv", "x.csv"]),
    (check_checkpoint, ["--run-dir", "x"]),
    (finetune_lora, ["--backbone", "x", "--train-csv", "t.csv", "--val-csv", "v.csv", "--out", "o"]),
])
def test_clis_want_a_card_without_device(monkeypatch, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
