"""The phase readers (``harness.spans``) on synthetic traces, and on the host
ops of a tiny step profiled on the CPU."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from harness import spans, trace


def host(name, a, b, ext=None, cat="cpu_op", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": tid,
            "args": {} if ext is None else {"External id": ext}}


def span(name, a, b):
    return host(name, a, b, cat="user_annotation")


def dev(a, b, ext, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": a, "dur": b - a, "args": {"External id": ext}}


def later(e):
    """The same event in a second step, 1000 us on, with an id of its own."""
    return dict(e, ts=e["ts"] + 1000, args={k: v + 100 for k, v in e["args"].items()})


def run_of(tr, on_card=True, traced=()):
    return SimpleNamespace(trace=tr, on_card=on_card, traced=list(traced))


# One step, 0-1000 us: augment 0-100, student 100-300, loss 300-600 with the
# teacher at 350-500, backward 600-900 (its op on autograd's thread), update
# 900-1000.
STEP = [span("dinox.train.step", 0, 1000), span("dinox.train.augment", 0, 100),
        span("dinox.train.student", 100, 300), span("dinox.train.loss", 300, 600),
        span("dinox.train.teacher", 350, 500), span("dinox.train.backward", 600, 900),
        span("dinox.train.update", 900, 1000), span("bench.step", 0, 1000)]
OPS = [host("aten::copy_", 10, 20, 1), host("aten::mm", 110, 120, 2), host("aten::softmax", 310, 320, 3),
       host("aten::mm", 360, 370, 4), host("aten::mul", 510, 520, 5), host("MmBackward0", 610, 620, 6, tid=2),
       host("aten::_foreach_add_", 910, 920, 7)]
DEV = [dev(20, 60, 1, "gpu_memcpy"), dev(130, 250, 2), dev(330, 340, 3), dev(380, 480, 4), dev(530, 560, 5),
       dev(650, 890, 6), dev(930, 990, 7), dev(995, 998, 99), dict(dev(998, 1000, 0), args={})]


def step_trace():
    return trace.Trace((0.0, 1000.0), DEV, STEP + OPS)


def test_device_time_goes_to_the_innermost_span_of_the_launching_op():
    p = spans.attribute(step_trace(), spans.TRAIN)
    got = {k: v for k, v in p.device_us.items()}
    assert got == {"dinox.train.augment": 40, "dinox.train.student": 120, "dinox.train.loss": 40,
                   "dinox.train.teacher": 100, "dinox.train.backward": 240, "dinox.train.update": 60}
    # The teacher's kernel is under the loss too, at any depth; an unknown or missing id is apart.
    assert p.under_us["dinox.train.loss"] == 140 and p.under_us[spans.STEP] == 600
    assert p.unmatched_us == 5 and p.total_us == 605
    assert p.launches[spans.STEP] == 6  # kernels only: the copy is no launch


def test_ops_on_another_thread_are_matched_by_time():
    p = spans.attribute(step_trace(), spans.TRAIN)
    assert p.device_us["dinox.train.backward"] == 240  # MmBackward0 on tid 2, inside the backward's interval


def test_idle_gaps_go_to_the_span_at_their_midpoint():
    p = spans.attribute(step_trace(), spans.TRAIN)
    # Gaps: 0-20 (augment), 60-130 (mid 95: augment), 250-330 (mid 290: student),
    # 340-380 (mid 360: teacher), 480-530 (mid 505: loss), 560-650 (mid 605: backward),
    # 890-930 (mid 910: update), 990-995 (update).
    assert dict(p.idle_us) == {"dinox.train.augment": 90, "dinox.train.student": 80, "dinox.train.teacher": 40,
                               "dinox.train.loss": 50, "dinox.train.backward": 90, "dinox.train.update": 45}


def test_readers_per_step_and_per_slice():
    two = trace.Trace((0.0, 2000.0), DEV + [later(e) for e in DEV], STEP + OPS + [later(e) for e in STEP + OPS])
    run = run_of(two)
    assert spans.train_device_ms(run, "augment") == pytest.approx(0.040)  # two steps, 40 us each
    assert spans.train_device_ms(run, "student", "teacher") == pytest.approx(0.220)
    assert spans.train_launches_per_step(run) == 6
    assert spans.train_idle_ms(run, "update") == pytest.approx(0.045)
    embed = [span("dinox.embed.transform", 0, 100), span("dinox.embed.forward", 100, 400),
             host("aten::mm", 10, 20, 1), host("aten::mm", 110, 120, 2), host("aten::add", 130, 140, 3)]
    tr = trace.Trace((0.0, 500.0), [dev(20, 80, 1), dev(150, 250, 2), dev(300, 380, 3)], embed)
    run = run_of(tr, traced=[(64, 1, 0), (36, 1, 0)])  # 100 slices
    assert spans.embed_device_us(run, "transform") == pytest.approx(0.6)
    assert spans.embed_device_us(run, "forward") == pytest.approx(1.8)
    assert spans.embed_idle_us(run, "forward") == pytest.approx((70 + 50) / 100)  # 80-150 and 250-300
    assert spans.embed_launches_per_batch(run) == 2


def test_nothing_to_read_without_spans_or_off_the_card():
    bare = trace.Trace((0.0, 1000.0), DEV, [e for e in STEP + OPS if not e["name"].startswith("dinox.")])
    assert spans.train_device_ms(run_of(bare), "augment") is None
    assert spans.embed_launches_per_batch(run_of(step_trace())) is None  # no embed span
    off = run_of(step_trace(), on_card=False)
    assert spans.train_launches_per_step(off) is None and spans.train_idle_ms(off, "update") is None


def test_a_tiny_cpu_step_puts_every_op_in_a_leaf(tmp_path):
    """Each host op of a profiled step, taken as a device event with its
    External id, lands in a leaf phase: none under the step alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dinox_torch.models.config import ModelConfig
    from dinox_torch.train.state import TrainConfig, create_train_state
    from dinox_torch.train.step import build_train_step

    model = ModelConfig(name="t", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=64, num_registers=2,
                        dtype="float32", scale_aware=True, attn_impl="pallas")
    cfg = TrainConfig(model=model, img_size=32, batch_size=4, accumulation_steps=2, warmup_steps=2, max_steps=50)
    state = create_train_state(cfg, device="cpu")
    fn = build_train_step(cfg, device="cpu")
    rng = np.random.default_rng(0)
    px = rng.integers(30000, 36000, (2, 4, 48, 48, 3)).astype(np.uint16)
    sp = rng.uniform(0.5, 2.0, (2, 4, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn(state, px, sp)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = [dict(e, cat="kernel") for e in events if e.get("cat") == "cpu_op"]
    tr = trace.parse(events + ops)
    p = spans.attribute(tr, spans.TRAIN)
    assert p.unmatched_us == 0 and len(tr.device) > 100
    leaves = {spans.TRAIN + n for n in ("augment", "student", "teacher", "loss", "backward", "update")}
    assert set(p.device_us) <= leaves
    assert p.under_us[spans.STEP] == pytest.approx(p.total_us)
    assert p.spans[spans.STEP] == 1 and p.launches[spans.STEP] == len(tr.device)
