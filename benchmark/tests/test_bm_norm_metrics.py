"""The LayerNorm kernels' per-layer readers (``metrics/train_norm_device_ms.py``,
``metrics/embed_norm_device_us.py``) on synthetic traces: device time of the
kernels named ``dinox_layer_norm*`` per step and per slice, None off the
card, without spans, or where no such kernel ran (a program without them),
and the launch count the traced work makes."""

from types import SimpleNamespace

import pytest

from harness import spec, trace
from yardstick import kinds

NAMES = ["void (anonymous namespace)::dinox_layer_norm_fwd_rows<3, __nv_bfloat16, __nv_bfloat16>"
         "(__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, float*, float*, int, int, "
         "int, float)",
         "void (anonymous namespace)::dinox_layer_norm_bwd_rows<3, __nv_bfloat16, __nv_bfloat16>(...)",
         "(anonymous namespace)::dinox_layer_norm_bwd_params_sum(float const*, float*, float*, int, int)"]
MODEL = dict(depth=12, scale_aware=True)


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a, "args": {}}


def op(a, ext):
    return {"ph": "X", "cat": "cpu_op", "name": "op", "ts": a, "dur": 1, "args": {"External id": ext}}


def kernel(name, a, b, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a, "args": {"External id": ext}}


def run_of(tr, traced, on_card=True):
    return SimpleNamespace(trace=tr, traced=traced, model=MODEL, on_card=on_card)


def train_trace(with_norms=True):
    """Two steps of 1000 us; in each, a GEMM of 100 us and the three
    LayerNorm launches of 10, 20 and 5 us."""
    host, dev = [], []
    for s in range(2):
        t = 1000 * s
        host += [span("dinox.train.step", t, t + 1000), span("dinox.train.student", t, t + 500),
                 span("dinox.train.backward", t + 500, t + 1000)]
        host += [op(t + 10 * i + 1, 10 * s + i) for i in range(4)]
        dev.append(kernel("sm90_xmma_gemm_bf16", t + 100, t + 200, 10 * s))
        if with_norms:
            dev += [kernel(NAMES[0], t + 200, t + 210, 10 * s + 1),
                    kernel(NAMES[1], t + 600, t + 620, 10 * s + 2),
                    kernel(NAMES[2], t + 620, t + 625, 10 * s + 3)]
    return trace.Trace((0.0, 2000.0), dev, host)


def test_the_kernels_are_of_no_library_kind():
    assert {kinds.kernel_kind(n) for n in NAMES} == {"other"}


def test_train_norm_device_ms_per_step(capsys):
    read = spec.metric_reader("train_norm_device_ms").read
    assert read(run_of(train_trace(), [(256, 2, 1)] * 2)) == pytest.approx(0.035)  # 35 us a step
    # ViT-S without recomputation: 26 norms through the student and the teacher,
    # two backward launches each: 104 a micro-step, two micro-steps.
    assert "the traced work makes 208" in capsys.readouterr().err
    # With recomputation a third pass re-runs the blocks' 24: 128 a micro-step.
    read(run_of(train_trace(), [(128, 3, 1)] * 4))
    assert "the traced work makes 512" in capsys.readouterr().err


def test_embed_norm_device_us_per_slice(capsys):
    read = spec.metric_reader("embed_norm_device_us").read
    host = [span("dinox.embed.forward", 0, 400), op(1, 1), op(2, 2)]
    dev = [kernel(NAMES[0], 10, 40, 1), kernel(NAMES[0], 50, 80, 2),
           kernel("elementwise_kernel", 90, 190, 2)]
    tr = trace.Trace((0.0, 500.0), dev, host)
    assert read(run_of(tr, [(64, 1, 0), (36, 1, 0)])) == pytest.approx(60 / 100)
    assert "the traced batches make 52" in capsys.readouterr().err


def test_nothing_to_read_without_the_kernels_the_spans_or_the_card():
    train = spec.metric_reader("train_norm_device_ms").read
    embed = spec.metric_reader("embed_norm_device_us").read
    assert train(run_of(train_trace(with_norms=False), [(256, 2, 1)])) is None  # the parent
    assert train(run_of(train_trace(), [(256, 2, 1)], on_card=False)) is None
    assert embed(run_of(train_trace(), [(64, 1, 0)])) is None  # no embed span
    bare = trace.Trace((0.0, 2000.0), train_trace().device, [])
    assert train(run_of(bare, [(256, 2, 1)])) is None
