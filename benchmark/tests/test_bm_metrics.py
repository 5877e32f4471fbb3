"""Each metric's arithmetic on synthetic timelines."""

from types import SimpleNamespace

import pytest

from harness import compare, readers, timing, trace
from yardstick import flops, roofline

MODEL = dict(img_size=224, patch=14, dim=384, depth=12, heads=6, mlp_ratio=4.0, out_dim=8192, num_registers=4)
PEAKS = flops.card_peaks("NVIDIA H100 80GB HBM3")


def test_rate_is_all_the_work_over_all_the_time():
    # Three steps of 256 slices ending 0.9 s after the window opened: not
    # the best step's rate, not the median of chunks.
    assert timing.rate(3 * 256, 0.9) == pytest.approx(853.333, rel=1e-6)
    with pytest.raises(ValueError):
        timing.rate(1, 0.0)


def test_p95_counts_every_request_with_a_stall():
    lat = [10.0] * 95 + [11.0] * 4 + [5000.0]  # one stalled request of 100
    assert timing.percentile(lat, 95) == 10.0
    assert timing.percentile(lat + [5000.0] * 5, 95) == 5000.0  # six stalls of 105 reach the p95
    assert timing.percentile([3.0], 95) == 3.0


def events(*spans, name="k", cat="kernel", grid=None):
    return [{"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "args": {"grid": grid} if grid else {}}
            for a, b in spans]


def test_idle_share_from_overlapping_intervals():
    # Window 0-100 us; device busy 10-30 and 20-40 (overlapping) and 60-70: 40 us busy.
    tr = trace.Trace((0.0, 100.0), events((10, 30), (20, 40), (60, 70)))
    assert trace.busy(tr) == [(10, 40), (60, 70)]
    assert trace.busy_s(tr) == pytest.approx(40e-6)
    assert trace.idle_pct(tr) == pytest.approx(60.0)
    assert trace.gaps(tr) == [(0.0, 10), (40, 60), (70, 100.0)]


def test_events_past_the_window_are_clipped():
    tr = trace.parse([{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100, "dur": 100}]
                     + events((50, 120), (190, 260), (300, 310)))
    assert len(tr.device) == 2 and trace.busy_s(tr) == pytest.approx(30e-6)


def test_idle_gaps_are_named_by_the_host_span_at_their_middle():
    host = [{"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 0, "dur": 100},
            {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 25}]
    tr = trace.Trace((0.0, 100.0), events((10, 40), (60, 70)), host)
    assert trace.idle_gaps(tr) == [["bench.step", pytest.approx(40e-6)], ["aten::item", pytest.approx(20e-6)]]


def test_device_ops_sum_by_name():
    tr = trace.Trace((0.0, 100.0), events((0, 10), (20, 25), name="a") + events((30, 60), name="b"))
    assert trace.device_ops(tr) == [["b", pytest.approx(30e-6)], ["a", pytest.approx(15e-6)]]


def run_with(device, rate=None, on_card=True, traced=()):
    return SimpleNamespace(model=MODEL, rate=rate, trace=trace.Trace((0.0, 1e4), device), peaks=PEAKS,
                           on_card=on_card, traced=list(traced))


FWD = "void dinox_fwd::attention_fwd_sm90<64, (dinox_fwd::Rounding)0, true>(x)"


def test_forward_roofline_counts_the_cells_calls_at_the_cells_shapes():
    # One micro-step of 256 views through two passes and a series' tail of
    # 64 views through one: 12 blocks each, so 36 calls. The launches' grids
    # and count do not enter the bound, only their time (36 x 10 us).
    dev = events(*[(20 * i, 20 * i + 10) for i in range(36)], name=FWD, grid=[1, 1, 1])
    calls = readers.attention_calls(run_with(dev, traced=[(256, 2, 1), (64, 1, 0)]))
    assert calls == [(256, 261, 384, 6)] * 24 + [(64, 261, 384, 6)] * 12
    bound = 24 * roofline.bound_ms(*roofline.attention_fwd_work(256, 261, 384, 6), PEAKS)[0] + \
        12 * roofline.bound_ms(*roofline.attention_fwd_work(64, 261, 384, 6), PEAKS)[0]
    got = readers.attention_fwd_pct(run_with(dev, traced=[(256, 2, 1), (64, 1, 0)]))
    assert got == pytest.approx(100.0 * bound / 0.36)
    # The same work in half as many launches (views folded into one call) reads the same.
    half = events(*[(20 * i, 20 * i + 20) for i in range(18)], name=FWD)
    assert readers.attention_fwd_pct(run_with(half, traced=[(256, 2, 1), (64, 1, 0)])) == pytest.approx(got)


def test_backward_roofline_counts_backward_passes_and_time_of_both():
    dq = "void dinox_bwd::attention_bwd_sm90_dq<64, true>(x)"
    dkv = "void dinox_bwd::attention_bwd_sm90_dkv<64, true>(x)"
    spans = [(100 * i, 100 * i + 40) for i in range(12)]
    dev = events(*spans, name=dq) + events(*[(a + 40, b + 60) for a, b in spans], name=dkv)
    bound = 12 * roofline.bound_ms(*roofline.attention_bwd_work(256, 261, 384, 6), PEAKS)[0]
    got = readers.attention_bwd_pct(run_with(dev, traced=[(256, 3, 1)]))
    assert got == pytest.approx(100.0 * bound / (12 * 0.1))


def test_readers_read_nothing_where_there_is_nothing():
    assert readers.attention_fwd_pct(run_with([], traced=[(256, 2, 1)])) is None  # the kernel is off the path
    assert readers.idle_pct(run_with([], on_card=False)) is None
    assert readers.mfu_pct(run_with([], rate=800.0, on_card=False), flops.train_flops_per_slice) is None


def test_mfu_is_rate_times_flops_over_peak():
    got = readers.mfu_pct(run_with([], rate=840.0), flops.train_flops_per_slice)
    assert got == pytest.approx(100 * 840.0 * 99.694166016e9 / 989e12)


def test_worst_leaf_and_its_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    gap, leaf = compare.worst_leaf({"a": 1.1, "b": 2.0, "c": 3e-6}, ref)
    assert leaf == "a" and gap == pytest.approx(0.1)  # c's gap is measured against the median leaf
    assert compare.loss_gap([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)


def test_nought_gradient_elements_leave_the_change():
    import torch
    grad = {"w": torch.tensor([1.0, 1.0, 0.0]), "v": torch.tensor([2.0, 2.0])}
    change = {"w": torch.tensor([3.0, 4.0, 100.0]), "v": torch.tensor([0.0, 1.0])}
    assert compare.moving_norms(change, grad) == {"w": pytest.approx(5.0), "v": pytest.approx(1.0)}
