"""The port's checkpoints (dinox_torch.train.checkpoint): exact round trips
of a real TrainState, resume continuity, rotation, the emergency marker,
the save watchdog, and the snapshot an async save takes before it returns
(the step updates the state in place)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.train import checkpoint as ckpt_mod
from dinox_torch.train.checkpoint import (CheckpointManager, find_latest_run, load_state_tensors,
                                          state_tensors)
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step

TINY = TrainConfig(model=ModelConfig(name="test-tiny", img_size=32, patch=16, dim=32, depth=2,
                                     heads=2, out_dim=64, num_registers=2, scale_aware=True),
                   img_size=32, batch_size=4, lr=1e-3, warmup_steps=2, max_steps=50,
                   koleo_weight=0.1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and a thread pool per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(i):
    rng = np.random.default_rng(i)
    return (rng.integers(30000, 36000, (1, 4, 48, 48, 3)).astype(np.uint16),
            rng.uniform(0.5, 2.0, (1, 4, 3)).astype(np.float32))


def _trained(steps=2, seed=0):
    state = create_train_state(TINY, seed=seed, device="cpu")
    step_fn = build_train_step(TINY, device="cpu")
    for i in range(steps):
        state, _ = step_fn(state, *_batch(i))
    return state, step_fn


def _assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k].cpu(), tb[k].cpu()), k


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_is_bit_equal(tmp_path, async_save):
    state, _ = _trained()
    names = state_tensors(state)
    assert {"step", "center"} <= set(names)
    assert any(k.endswith(".exp_avg") for k in names) and any(k.endswith(".exp_avg_sq") for k in names)
    mgr = CheckpointManager(tmp_path / "run", async_save=async_save)
    assert mgr.save(2, state, config={"a": 1}, loader_position=(3, 4))
    mgr.wait()
    fresh = create_train_state(TINY, seed=9, device="cpu")
    restored, meta = mgr.restore(fresh)
    assert restored is fresh and restored.step == 2
    assert meta == {"step": 2, "config": {"a": 1}, "loader_epoch": 3, "loader_batch": 4}
    _assert_states_equal(restored, state)
    for p in restored.student.parameters():  # AdamW's step count where AdamW keeps it
        assert restored.optimizer.state[p]["step"].device.type == "cpu"
    assert mgr.stats["saves"] == 1 and mgr.stats["bytes"] > 0
    mgr.close()


def test_resume_continues_the_straight_run(tmp_path):
    straight, step_fn = _trained(steps=4)
    state, _ = _trained(steps=2)
    mgr = CheckpointManager(tmp_path / "run")
    mgr.save(2, state)
    mgr.close()
    resumed, _ = CheckpointManager(tmp_path / "run").restore(create_train_state(TINY, seed=5, device="cpu"))
    for i in range(2, 4):
        resumed, _ = step_fn(resumed, *_batch(i))
    _assert_states_equal(resumed, straight)


def test_async_save_is_not_changed_by_an_update_after_it_returns(tmp_path, monkeypatch):
    """The writer is held back until the state has been updated in place,
    as the next training step does; the checkpoint still holds the state of
    the moment save() returned."""
    state, step_fn = _trained(steps=1)
    want = {k: v.clone() for k, v in state_tensors(state).items()}
    release = threading.Event()
    real_save_file = ckpt_mod.save_file

    def held_back(arrays, path):
        assert release.wait(timeout=60)
        real_save_file(arrays, path)

    monkeypatch.setattr(ckpt_mod, "save_file", held_back)
    mgr = CheckpointManager(tmp_path / "run", async_save=True)
    mgr.save(1, state)
    state, _ = step_fn(state, *_batch(7))  # in place: optimizer.step(), EMA, centre
    with torch.no_grad():
        for p in state.student.parameters():
            p.add_(1.0)
    release.set()
    mgr.wait()
    arrays = ckpt_mod.load_file(tmp_path / "run" / "ckpt" / "1" / ckpt_mod.STATE_FILE)
    assert sorted(arrays) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[k], v.numpy(), err_msg=k)
    name, live = next(iter(state.student.state_dict().items()))
    assert not np.array_equal(arrays[f"student.{name}"], live.numpy())


def test_rotation_latest_step_and_empty_restore(tmp_path):
    state, _ = _trained(steps=0)
    mgr = CheckpointManager(tmp_path / "run", keep_last=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    assert mgr.latest_step() is None
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(d.name for d in (tmp_path / "run" / "ckpt").iterdir()) == ["3", "4"]
    _, meta = mgr.restore(create_train_state(TINY, device="cpu"), step=3)
    assert meta["step"] == 3
    mgr.close()


def test_find_latest_run_and_emergency_marker(tmp_path):
    assert find_latest_run(tmp_path / "missing") is None
    assert find_latest_run(tmp_path) is None
    state, _ = _trained(steps=0)
    for name in ("a", "b"):
        CheckpointManager(tmp_path / name).emergency_save(7, state, f"nan in {name}")
        time.sleep(0.02)
    (tmp_path / "no_ckpt").mkdir()
    assert find_latest_run(tmp_path) == tmp_path / "b"
    assert (tmp_path / "b" / "EMERGENCY.txt").read_text() == "step=7\nreason=nan in b\n"
    assert CheckpointManager(tmp_path / "b").latest_step() == 7
    meta = json.loads((tmp_path / "b" / "ckpt" / "7" / "meta.json").read_text())
    assert meta["step"] == 7


def test_save_watchdog_abandons_wedged_save(tmp_path, monkeypatch):
    """A save whose write never returns is abandoned after save_timeout_s:
    save() returns False, the manager is wedged, later operations are fast
    no-ops and close() does not block (the twin of
    tests/test_checkpoint.py's watchdog test)."""
    state, _ = _trained(steps=0)
    mgr = CheckpointManager(tmp_path / "run", async_save=False, save_timeout_s=0.5)
    hang = threading.Event()
    monkeypatch.setattr(mgr, "_write", lambda *a, **k: hang.wait())
    t0 = time.monotonic()
    assert mgr.save(1, state) is False
    assert mgr.wedged
    assert time.monotonic() - t0 < 5.0
    t0 = time.monotonic()
    assert mgr.save(2, state) is False
    mgr.wait()
    mgr.close()
    assert time.monotonic() - t0 < 1.0
    hang.set()


def test_a_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    state, _ = _trained(steps=0)
    mgr = CheckpointManager(tmp_path / "run")

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_file", broken)
    assert mgr.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    assert list((tmp_path / "run" / "ckpt").iterdir()) == []


def test_restore_refuses_state_of_unknown_parameters(tmp_path):
    state, _ = _trained(steps=1)
    arrays = {k: v.numpy() for k, v in state_tensors(state).items()}
    arrays["optimizer.not_a_param.exp_avg"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown parameters"):
        load_state_tensors(create_train_state(TINY, device="cpu"), arrays)
