"""The port's phase spans (``dinox_torch.utils.tracing``): where the training
step and the embedding path emit them under ``torch.profiler``, that every
op of a step lies under exactly one leaf phase, that a span is one shared
null context when no profiler runs, and that tracing leaves the numbers
alone. CPU, tiny configurations."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dinox_torch.models.config import ModelConfig
from dinox_torch.ops.augment import eval_transform
from dinox_torch.train.state import TrainConfig, create_train_state
from dinox_torch.train.step import build_train_step
from dinox_torch.utils import tracing
from dinox_torch.zoo.hub import LoadedModel

MODEL = dict(name="test-tiny", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=64,
             num_registers=2, dtype="float32", scale_aware=True, attn_impl="pallas")
TRAIN = dict(img_size=32, batch_size=4, lr=1e-3, warmup_steps=2, max_steps=50, koleo_weight=0.1,
             train_seed=0)
LEAVES = ("augment", "student", "teacher", "loss", "backward", "reduce", "update")


def _cfg(accum=1, loss_type="dino", **model):
    return TrainConfig(model=ModelConfig(**dict(MODEL, **model)), accumulation_steps=accum, loss_type=loss_type,
                       **TRAIN)


def _batch(accum, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(30000, 36000, (accum, 4, 48, 48, 3)).astype(np.uint16),
            rng.uniform(0.5, 2.0, (accum, 4, 3)).astype(np.float32))


def _traced(fn, tmp_path):
    """The complete host events (name, start, end, category) of *fn()* under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")]


def _spans(events, prefix):
    return [(n[len(prefix):], a, b) for n, a, b, c in events if c == "user_annotation" and n.startswith(prefix)]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("accum, loss_type, ckpt", [(1, "dino", False), (2, "dino", True), (2, "mae", False)])
def test_step_spans_cover_every_op_once(accum, loss_type, ckpt, tmp_path):
    """One step emits ``dinox.train.step`` once; ``augment``, ``student``,
    ``loss`` and ``backward`` once per micro-step, ``teacher`` inside each
    ``loss`` (DINO), ``update`` at each accumulation and after the loop;
    every op starts under exactly one leaf (``loss`` without its teacher,
    ``update`` without a mesh's ``reduce``)."""
    cfg = _cfg(accum, loss_type, use_grad_checkpoint=ckpt)
    state = create_train_state(cfg, device="cpu")
    fn = build_train_step(cfg, device="cpu")
    px, sp = _batch(accum)
    events = _traced(lambda: fn(state, px, sp), tmp_path)
    spans = _spans(events, "dinox.train.")
    count = {k: sum(1 for n, _, _ in spans if n == k) for k in ("step",) + LEAVES}
    teachers = accum if loss_type == "dino" else 0
    assert count == dict(step=1, augment=accum, student=accum, teacher=teachers, loss=accum, backward=accum,
                         reduce=0, update=accum)
    step = next(s for s in spans if s[0] == "step")
    assert all(_within(s, step) for s in spans)
    losses = [s for s in spans if s[0] == "loss"]
    for t in (s for s in spans if s[0] == "teacher"):
        assert sum(_within(t, lo) for lo in losses) == 1
    ops = [e for e in events if e[3] == "cpu_op" and step[1] <= e[1] <= step[2]]
    assert len(ops) > 100
    for name, t, _, _ in ops:
        holding = sorted(n for n, a, b in spans if n != "step" and a <= t <= b)
        nested = holding in (["loss", "teacher"], ["reduce", "update"])
        assert nested or (len(holding) == 1 and holding[0] in LEAVES), (name, holding)


def test_embedding_path_spans(tmp_path):
    net = LoadedModel(ModelConfig(**MODEL), device="cpu")
    px = torch.from_numpy(_batch(1)[0][0])

    def embed():
        net(eval_transform(px, img_size=32), torch.full((4, 3), 0.7))

    events = _traced(embed, tmp_path)
    spans = _spans(events, "dinox.embed.")
    assert [n for n, _, _ in spans] == ["transform", "forward"]
    for s in spans:
        assert any(c == "cpu_op" and s[1] <= a <= s[2] for _, a, _, c in events), s[0]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert tracing.span("dinox.a") is tracing.span("dinox.b")
    assert isinstance(tracing.span("dinox.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("dinox.a"), torch.profiler.record_function)
    assert isinstance(tracing.span("dinox.a"), contextlib.nullcontext)


def test_tracing_leaves_the_state_and_metrics_alone():
    """Two steps with the profiler on and off: the same state and metrics, to the bit."""
    cfg = _cfg(2)
    px, sp = _batch(2, seed=3)
    out = []
    for traced in (False, True):
        state = create_train_state(cfg, device="cpu")
        fn = build_train_step(cfg, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            metrics = [fn(state, px, sp)[1] for _ in range(2)]
        out.append((state, metrics))
    (a, ma), (b, mb) = out
    assert a.step == b.step == 2
    for x, y in ((a.student, b.student), (a.teacher, b.teacher)):
        for (n, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    torch.testing.assert_close(a.center, b.center, rtol=0, atol=0)
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:
            torch.testing.assert_close(x[k], y[k], rtol=0, atol=0, msg=k)
