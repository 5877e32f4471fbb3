"""The roofline bounds (dinox_torch.utils.roofline) from the shapes: the
bytes and operations of the attention kernels at the ViT-S training shape,
and the bound's choice between them."""

import pytest

from dinox_torch.utils.flops import card_peaks
from dinox_torch.utils.roofline import (
    VALIDATE_SHAPE,
    attention_fwd_work,
    bound_ms,
    fused_attn_parts_work,
    fused_attn_work,
    tpu_kernel_bounds,
)


def test_attention_work_at_the_training_shape():
    rows = {r["kernel"]: r for r in tpu_kernel_bounds(card_peaks("NVIDIA H100 80GB HBM3"))}
    assert sorted(rows) == list(range(1, 9))
    # 192 views x 261 tokens: qkv 115.5 MB, out/dO 38.5 MB, dqkv 115.5 MB (bf16)
    assert rows[1]["mbytes"] == pytest.approx(153.9, abs=0.05)
    assert rows[2]["mbytes"] == pytest.approx(269.4, abs=0.05)
    assert rows[2]["gflop"] == pytest.approx(50.22, abs=0.005)
    assert rows[2]["bound_by"] == "bytes" and rows[2]["bound_ms"] == pytest.approx(0.0804, abs=1e-4)
    assert rows[4]["bound_ms"] == rows[1]["bound_ms"] and rows[5]["bound_ms"] == rows[2]["bound_ms"]
    assert rows[7]["bound_by"] == rows[8]["bound_by"] == "operations"


def test_bound_takes_the_larger_time():
    peaks = (1e12, 1e9)  # 1 TFLOP/s, 1 GB/s
    assert bound_ms(1e6, 1e9, peaks) == (1.0, "bytes")
    assert bound_ms(1e5, 2e9, peaks) == (2.0, "operations")


def test_head_major_forward_at_the_validate_shape():
    """(8, 8, 1024, 64): q, k, v and out 33.6 MB against 17.2 GFLOP, so the
    tensor cores bound it, at 17.4 us on the SXM peak."""
    moved, flops = attention_fwd_work(*VALIDATE_SHAPE)
    assert moved / 1e6 == pytest.approx(33.55, abs=0.01)
    assert flops / 1e9 == pytest.approx(17.18, abs=0.01)
    ms, by = bound_ms(moved, flops, card_peaks("NVIDIA H100 80GB HBM3"))
    assert by == "operations" and ms == pytest.approx(0.01737, abs=1e-5)


def test_kernel_6_parts_bound_more_than_the_fused_call():
    """The three launches of the port's kernel 6 at the training shape: qkv
    154.8 MB (44.3 GFLOP), attention 153.9 MB, proj 115.8 MB, each bound by
    bytes; qkv and attn written and read back, so their bounds sum to 0.127
    ms against the fused call's 0.0801."""
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    step = (192, 261, 384, 6)
    parts = fused_attn_parts_work(*step)
    assert list(parts) == ["qkv", "attention", "proj"]
    assert parts["qkv"][0] / 1e6 == pytest.approx(154.8, abs=0.05)
    assert parts["qkv"][1] / 1e9 == pytest.approx(44.34, abs=0.01)
    assert parts["attention"] == attention_fwd_work(*step)
    assert parts["proj"][0] / 1e6 == pytest.approx(115.8, abs=0.05)
    bounds = {k: bound_ms(*v, peaks) for k, v in parts.items()}
    assert all(by == "bytes" for _, by in bounds.values())
    assert bounds["qkv"][0] == pytest.approx(0.0462, abs=1e-4)
    assert bounds["proj"][0] == pytest.approx(0.0346, abs=1e-4)
    total = sum(ms for ms, _ in bounds.values())
    fused = bound_ms(*fused_attn_work(*step), peaks)
    assert total == pytest.approx(0.127, abs=5e-4) and fused[0] == pytest.approx(0.0801, abs=1e-4)
    assert total > fused[0]
    # the flops of the parts are the fused call's
    assert sum(f for _, f in parts.values()) == pytest.approx(fused_attn_work(*step)[1])
