"""The roofline bounds (dinox_torch.utils.roofline) from the shapes: the
bytes and operations of the attention kernels at the ViT-S training shape,
and the bound's choice between them."""

import pytest

from dinox_torch.utils.flops import card_peaks
from dinox_torch.utils.roofline import (
    VALIDATE_SHAPE,
    attention_fwd_work,
    bound_ms,
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
