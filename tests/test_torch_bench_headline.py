"""The headline JSON of ``python -m dinox_torch.bench``: the JAX bench's
(bench.py:184-203), i.e. ``value`` and ``mfu`` from the better of the two
tanh arms, ``gelu`` "tanh" and ``vs_baseline`` = value / 159. The training
steps, the card and nvidia-smi are stubbed, so this runs on the CPU."""

import json

import pytest
import torch

from dinox_torch import bench
from dinox_torch.utils.flops import mfu

PEAK = 989e12
KEYS = {"metric", "value", "unit", "vs_baseline", "gelu", "mfu", "exact_gelu_slices_per_sec",
        "exact_gelu_mfu", "fused_attn_slices_per_sec", "peak_flops", "card"}


def _headline(monkeypatch, capsys, rates: dict[str, float]) -> dict:
    calls = []

    def fake_step(batch_size, gelu_approx=True, fused_attn=False, **_):
        name = "tanh+fused_attn" if fused_attn else "tanh" if gelu_approx else "exact"
        calls.append(name)
        return {"slices_per_s": rates[name], "step_ms": 1e3 * batch_size / rates[name]}

    monkeypatch.setattr(bench, "bench_train_step", fake_step)
    monkeypatch.setattr(bench, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(bench, "card_peaks", lambda name: (PEAK, 3.35e12))
    monkeypatch.setattr(bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    assert bench.main([]) == 0
    assert sorted(calls) == ["exact", "tanh", "tanh+fused_attn"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("rates, best", [
    ({"exact": 650.0, "tanh": 700.0, "tanh+fused_attn": 540.0}, "tanh"),
    ({"exact": 650.0, "tanh": 600.0, "tanh+fused_attn": 720.0}, "tanh+fused_attn"),
])
def test_headline_takes_the_better_tanh_arm(monkeypatch, capsys, rates, best):
    out = _headline(monkeypatch, capsys, rates)
    assert set(out) == KEYS
    assert out["metric"] == "vit_s_pretrain_slices_per_sec" and out["unit"] == "slices/s"
    assert out["gelu"] == "tanh"
    assert out["value"] == rates[best]
    assert out["vs_baseline"] == pytest.approx(rates[best] / 159.0)
    assert out["mfu"] == pytest.approx(mfu(rates[best], bench.bench_config(96).model, PEAK))
    assert out["exact_gelu_slices_per_sec"] == rates["exact"]
    assert out["fused_attn_slices_per_sec"] == rates["tanh+fused_attn"]
    assert out["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_exact_arm_never_becomes_the_headline(monkeypatch, capsys):
    """As in the JAX bench, a faster exact-GELU arm stays beside the headline."""
    rates = {"exact": 900.0, "tanh": 700.0, "tanh+fused_attn": 540.0}
    out = _headline(monkeypatch, capsys, rates)
    assert out["value"] == 700.0 and out["exact_gelu_slices_per_sec"] == 900.0


def test_a_failing_arm_raises(monkeypatch):
    """No arm is wrapped in a try: a kernel fault is not hidden behind
    another arm's number."""
    def broken(batch_size, gelu_approx=True, fused_attn=False, **_):
        if fused_attn:
            raise RuntimeError("launch failed")
        return {"slices_per_s": 600.0, "step_ms": 160.0}

    monkeypatch.setattr(bench, "bench_train_step", broken)
    monkeypatch.setattr(bench, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(bench, "card_peaks", lambda name: (PEAK, 3.35e12))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    with pytest.raises(RuntimeError, match="launch failed"):
        bench.main([])
