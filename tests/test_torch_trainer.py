"""The port's training loop (dinox_torch.train.trainer) and anomaly detector
against the JAX package's: the detector's verdicts at window=10, the loop's
sinks, checkpoints, NaN handling, flush window and SIGINT, and a 4-step run
of both loops from one state (augmentation stubbed as in
test_torch_train_step.py): per-step loss within 1e-5 relative and lr within
1e-7."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from dinox_torch.data.pipeline import Batch
from dinox_torch.pretrain import SyntheticBatches
from dinox_torch.train.anomaly import AnomalyDetector
from dinox_torch.train.state import create_train_state, state_from_jax
from dinox_torch.train.step import build_train_step
from dinox_torch.train.trainer import train
from dinox_tpu.train import step as jax_step
from dinox_tpu.train import trainer as jax_trainer
from dinox_tpu.train.anomaly import AnomalyDetector as JaxAnomalyDetector
from tests.test_torch_train_step import _as_tree, _configs, _jax_start, _jax_views, _torch_views

# (loss, embed_std) sequences: the cases of tests/test_trainer_loop.py at the
# JAX detector's own window of 10.
DETECTOR_CASES = {
    "spike_and_collapse": ([(1.0, 0.5)] * 10 + [(5.0, 0.5), (1.0, 0.001), (float("inf"), 0.5)], {}),
    "spike_floor": ([(0.01, 0.5)] * 10 + [(0.03, 0.5), (1.0, 0.5)], dict(spike_floor=0.5)),
    "relative_only": ([(0.01, 0.5)] * 10 + [(0.03, 0.5)], {}),
    "nan_and_warmup": ([(2.0, 0.5), (float("nan"), 0.5), (9.0, 0.5)] + [(1.0, 0.5)] * 12
                       + [(3.0, 0.5)], dict(spike_factor=2.5)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and a thread pool per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_anomaly_detector_matches_jax_at_window_10(case):
    seq, kw = DETECTOR_CASES[case]
    port, ref = AnomalyDetector(window=10, **kw), JaxAnomalyDetector(window=10, **kw)
    verdicts = [port.check(*x) for x in seq]
    assert verdicts == [ref.check(*x) for x in seq]
    assert {v[0] for v in verdicts} >= {"ok", "warn"}


def test_anomaly_window_sizes_the_history():
    det = AnomalyDetector(window=3)
    for _ in range(3):
        assert det.check(1.0, 0.5) == ("ok", "")
    assert det.check(5.0, 0.5)[0] == "warn"
    det = AnomalyDetector(window=20)
    for _ in range(19):
        det.check(1.0, 0.5)
    assert det.check(5.0, 0.5) == ("ok", "")  # 19 losses: the window is not full yet
    for _ in range(5):
        det.check(1.0, 0.5)
    assert len(det._history) == 20


# -- the loop with a scripted step ----------------------------------------------


def _tiny_state():
    _, tcfg = _configs()
    return tcfg.replace(batch_size=4), create_train_state(tcfg, device="cpu")


def _batches():
    rng = np.random.default_rng(0)
    while True:
        yield Batch(pixels=rng.integers(30000, 36000, (1, 4, 32, 32, 3), dtype=np.uint16),
                    spacing=np.ones((1, 4, 3), np.float32), indices=np.arange(4))


def _fake_step(losses):
    it = iter(losses)

    def step_fn(state, pixels, spacing):
        assert pixels.shape == (1, 4, 32, 32, 3)
        state.step += 1
        return state, {"loss": torch.tensor(next(it)), "embed_std": torch.tensor(0.5)}

    return step_fn


def _lines(run):
    return [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]


def _ckpt_steps(run):
    return sorted(int(d.name) for d in (run / "ckpt").iterdir() if d.name.isdigit())


def test_train_loop_logs_and_checkpoints(tmp_path):
    cfg, state = _tiny_state()
    state = train(cfg, state, _fake_step([1.0] * 10), _batches(), run_dir=tmp_path / "run",
                  max_steps=4, device="cpu", ckpt_every=2, log_jsonl=True, tensorboard=False)
    assert state.step == 4
    lines = _lines(tmp_path / "run")
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
    assert "samples_per_s" in lines[1] and "data_wait_frac" in lines[-1]
    assert json.loads((tmp_path / "run" / "config.json").read_text())["model"]["dim"] == 32
    assert _ckpt_steps(tmp_path / "run") == [2, 4]
    stats = json.loads((tmp_path / "run" / "checkpoints.json").read_text())
    assert stats["saves"] == 2 and stats["bytes"] > 0


def test_train_loop_nan_triggers_emergency(tmp_path):
    cfg, state = _tiny_state()
    with pytest.raises(FloatingPointError, match="anomaly"):
        train(cfg, state, _fake_step([1.0, float("nan")]), _batches(), run_dir=tmp_path / "run",
              max_steps=10, device="cpu", ckpt_every=0, tensorboard=False)
    assert (tmp_path / "run" / "EMERGENCY.txt").exists()
    assert _ckpt_steps(tmp_path / "run") == [2]


def test_train_loop_anomaly_no_duplicate_flush(tmp_path):
    cfg, state = _tiny_state()
    with pytest.raises(FloatingPointError, match="anomaly"):
        train(cfg, state, _fake_step([1.0, float("nan"), 0.9]), _batches(), run_dir=tmp_path / "run",
              max_steps=3, device="cpu", ckpt_every=0, tensorboard=False, log_jsonl=True)
    steps = [ln["step"] for ln in _lines(tmp_path / "run")]
    assert len(steps) == len(set(steps)), f"duplicate metric rows: {steps}"
    emergency = (tmp_path / "run" / "EMERGENCY.txt").read_text()
    assert "step=3" in emergency and "detected at step 2" in emergency


def test_metric_flush_window_bounds_anomaly_latency(tmp_path):
    cfg, state = _tiny_state()
    with pytest.raises(FloatingPointError, match="anomaly at step 2"):
        train(cfg, state, _fake_step([1.0, float("nan"), 0.9]), _batches(), run_dir=tmp_path / "run",
              max_steps=3, device="cpu", ckpt_every=0, tensorboard=False, log_jsonl=True,
              flush_max_steps=1)
    assert "step=2" in (tmp_path / "run" / "EMERGENCY.txt").read_text()


def test_sigint_finishes_the_step_and_checkpoints(tmp_path):
    cfg, state = _tiny_state()
    prev = signal.getsignal(signal.SIGINT)

    def interrupt(step, metrics, state):
        if step == 2:
            os.kill(os.getpid(), signal.SIGINT)

    state = train(cfg, state, _fake_step([1.0] * 10), _batches(), run_dir=tmp_path / "run",
                  max_steps=8, device="cpu", ckpt_every=5, tensorboard=False, log_jsonl=True,
                  on_step=interrupt, loader_position=lambda: (1, 7))
    assert state.step == 2 and _ckpt_steps(tmp_path / "run") == [2]
    meta = json.loads((tmp_path / "run" / "ckpt" / "2" / "meta.json").read_text())
    assert (meta["loader_epoch"], meta["loader_batch"]) == (1, 7)
    assert [ln["step"] for ln in _lines(tmp_path / "run")] == [1, 2]
    assert signal.getsignal(signal.SIGINT) is prev


def test_profile_window_writes_a_trace(tmp_path):
    cfg, state = _tiny_state()
    train(cfg, state, _fake_step([1.0] * 10), _batches(), run_dir=tmp_path / "run", max_steps=4,
          device="cpu", ckpt_every=0, tensorboard=False, profile_steps=1, profile_start=1)
    assert [p.name for p in (tmp_path / "run" / "profile").iterdir()] == ["trace_step1.json"]


# -- both loops from one state ---------------------------------------------------


def test_loop_matches_jax_over_four_steps(tmp_path):
    jcfg, tcfg = _configs()
    jstate = _jax_start(jcfg)
    tstate = state_from_jax(tcfg, _as_tree(jstate), device="cpu")
    jfn = jax_step.build_train_step(jcfg, donate=False, augment_fn=_jax_views)
    tfn = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
    kw = dict(max_steps=4, ckpt_every=0, log_jsonl=True, tensorboard=False, flush_max_steps=2)
    jax_trainer.train(jcfg, jstate, jfn, SyntheticBatches(8, 1, 48, seed=2), run_dir=tmp_path / "jax", **kw)
    tstate = train(tcfg, tstate, tfn, SyntheticBatches(8, 1, 48, seed=2), run_dir=tmp_path / "port",
                   device="cpu", **kw)
    want, got = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert [ln["step"] for ln in got] == [ln["step"] for ln in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=0, atol=1e-7, err_msg=f"step {g['step']}")
    assert tstate.step == 4
