"""The port's training monitor (``dinox_torch.train.monitor_hook``, the
``--monitor-every`` hook, and ``python -m dinox_torch.monitor``) against the
JAX package's ``TrainingMonitor``, which draws its previews with PIL.

Tolerances: ``health.jsonl``'s ``embed_std`` and ``gram_mean`` within 1e-4
relative of JAX's hook on the same weights and probe; the preview PNG
(read with PIL, here in the test only) equal in size and mode, its heat
half pixel-equal and its input half within one grey level of PIL's
resize. The port's resamplers are also held to PIL directly.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dinox_torch import monitor, pretrain
from dinox_torch.data.png8 import resize_bicubic, resize_nearest, write_png8
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.mae import MaeModel
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.train.monitor_hook import TrainingMonitor
from dinox_torch.zoo.interop import jax_to_torch_student
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import init_model
from dinox_tpu.train.monitor_hook import TrainingMonitor as JaxMonitor

MODEL = dict(name="mon-tiny", img_size=56, patch=14, dim=32, depth=2, heads=2, out_dim=16,
             num_registers=2, dtype="float32", scale_aware=True)


@pytest.mark.parametrize("shape,size", [((512, 512), (192, 192)), ((64, 64), (192, 192)),
                                        ((50, 37), (91, 23))])
def test_resamplers_match_pil(shape, size):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(resize_bicubic(a, size), np.asarray(Image.fromarray(a).resize(size)))
    np.testing.assert_array_equal(resize_nearest(a, size),
                                  np.asarray(Image.fromarray(a).resize(size, Image.NEAREST)))


def test_png8_reads_back_in_pil(tmp_path):
    a = np.random.default_rng(0).integers(0, 256, (17, 33)).astype(np.uint8)
    write_png8(tmp_path / "a.png", a)
    img = Image.open(tmp_path / "a.png")
    assert img.mode == "L"
    np.testing.assert_array_equal(np.asarray(img), a)
    with pytest.raises(ValueError):
        write_png8(tmp_path / "b.png", a.astype(np.uint16))


@pytest.fixture(scope="module")
def probe():
    rng = np.random.default_rng(0)
    return (rng.integers(25000, 41000, (4, 64, 64, 3), dtype=np.uint16),
            rng.uniform(0.4, 3.0, (4, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_student():
    cfg = jax_config.ModelConfig(**MODEL, attn_impl="xla")
    params = init_model(cfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def test_snapshot_matches_the_jax_hook(tmp_path, probe, jax_student):
    px, sp = probe
    jmon = JaxMonitor(tmp_path / "jax", jax_config.ModelConfig(**MODEL, attn_impl="xla"), px, sp,
                      every=5, tensorboard=False)
    tmon = TrainingMonitor(tmp_path / "port", ModelConfig(**MODEL), px, sp, every=5,
                           tensorboard=False)
    student = DinoStudentTeacher(ModelConfig(**MODEL))
    student.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_student(jax_student).items()})
    assert tmon.maybe_snapshot(3, student) is None
    for step in (5, 10):
        want, got = jmon.maybe_snapshot(step, jax_student), tmon.maybe_snapshot(step, student)
        assert got["step"] == step and got["collapse_warning"] == want["collapse_warning"]
        for k in ("embed_std", "gram_mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    lines = [json.loads(s) for s in (tmp_path / "port" / "monitor" / "health.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [5, 10]
    assert set(lines[0]) == {"step", "embed_std", "gram_mean", "collapse_warning", "timestamp"}
    for step in (5, 10):
        name = f"monitor/step_{step:07d}.png"
        a, b = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert a.mode == b.mode == "L" and a.size == b.size == (388, 192)
        a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
        assert np.abs(a[:, :192] - b[:, :192]).max() <= 1  # the input half
        np.testing.assert_array_equal(a[:, 192:196], 255)
        np.testing.assert_array_equal(a[:, 196:], b[:, 196:])  # the heat half


def test_mae_student_is_monitored_through_its_encoder(tmp_path, probe):
    px, sp = probe
    mon = TrainingMonitor(tmp_path, ModelConfig(**MODEL), px, sp, every=1, tensorboard=False)
    stats = mon.maybe_snapshot(1, MaeModel(ModelConfig(**MODEL)))
    assert stats is not None and np.isfinite([stats["embed_std"], stats["gram_mean"]]).all()


def test_monitor_every_and_the_monitor_cli_on_a_port_run(tmp_path):
    run = tmp_path / "run"
    argv = ["--config", "vit-tiny", "--batch-size", "4", "--img-size", "56", "--canvas", "64",
            "--warmup-steps", "1", "--device", "cpu", "--synthetic-device-batches", "2",
            "--max-steps", "4", "--ckpt-every", "2", "--monitor-every", "2", "--no-tensorboard",
            "--run-dir", str(run)]
    assert pretrain.main(argv) == 0
    health = (run / "monitor" / "health.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in health] == [2, 4]
    assert sorted(p.name for p in (run / "monitor").glob("*.png")) == [
        "step_0000002.png", "step_0000004.png"]
    assert monitor.main(["--run-dir", str(run), "--device", "cpu", "--n", "4", "--canvas", "64"]) == 0
    stats = json.loads((run / "stats.json").read_text())
    assert stats["step"] == 4
    assert set(stats) == {"step", "embed_std", "embed_norm_mean", "gram_mean", "collapse_warning",
                          "timestamp"}
    heat = Image.open(run / "heatmap.png")
    assert heat.mode == "L" and heat.size == (224, 224)


def test_monitor_cli_wants_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monitor.main(["--run-dir", str(tmp_path)])
