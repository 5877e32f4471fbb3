"""The roofline bounds (dinox_torch.utils.roofline) from the shapes: the
bytes and operations of the attention kernels at the ViT-S training shape,
and the bound's choice between them."""

import pytest

from dinox_torch.utils.flops import card_peaks
from dinox_torch.utils.roofline import (
    CIFAR_SHAPE,
    MLP_WEIGHT_CHUNKS,
    VALIDATE_SHAPE,
    attention_bwd_work,
    attention_fwd_work,
    bound_ms,
    fused_attn_parts_work,
    fused_attn_work,
    fused_mlp_bwd_parts_work,
    fused_mlp_bwd_work,
    fused_mlp_fwd_parts_work,
    fused_mlp_fwd_work,
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


MLP_SHAPE = (192 * 261, 384, 1536)  # the ViT-S training rows, 384 -> 1536 -> 384


def test_kernel_7_parts_bound_more_than_the_fused_call():
    """fc1 (x in, a out) 193.6 MB and 59.1 GFLOP, bound by operations at
    0.0598 ms; fc2 (a and x in, y out) 232.1 MB, bound by bytes at 0.0693
    ms; a written and read back, so 0.1291 ms by launch against the fused
    call's 0.1195."""
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    parts = fused_mlp_fwd_parts_work(*MLP_SHAPE)
    assert list(parts) == ["fc1", "fc2"]
    assert parts["fc1"][0] / 1e6 == pytest.approx(193.6, abs=0.05)
    assert parts["fc2"][0] / 1e6 == pytest.approx(232.1, abs=0.05)
    assert parts["fc1"][1] == parts["fc2"][1] and parts["fc1"][1] / 1e9 == pytest.approx(59.11, abs=0.01)
    bounds = {k: bound_ms(*v, peaks) for k, v in parts.items()}
    assert bounds["fc1"][1] == "operations" and bounds["fc1"][0] == pytest.approx(0.0598, abs=1e-4)
    assert bounds["fc2"][1] == "bytes" and bounds["fc2"][0] == pytest.approx(0.0693, abs=1e-4)
    fused = bound_ms(*fused_mlp_fwd_work(*MLP_SHAPE), peaks)
    assert sum(ms for ms, _ in bounds.values()) == pytest.approx(0.1291, abs=1e-4)
    assert fused[0] == pytest.approx(0.1195, abs=1e-4)
    assert sum(f for _, f in parts.values()) == pytest.approx(fused_mlp_fwd_work(*MLP_SHAPE)[1])


@pytest.mark.parametrize("part, mbytes, gflop, ms, by", [
    ("norm", 77.0, 0.0, 0.0230, "bytes"),           # x in, lnb out
    ("hidden", 392.0, 118.23, 0.1195, "operations"),  # lnb, dy in; ab, dhb, db1 partials out
    ("dln", 232.1, 59.11, 0.0693, "bytes"),         # dhb in, f32 dln out
    ("dx", 196.0, 0.0, 0.0585, "bytes"),            # x, dy, dln in; dx, partials out
    ("weights", 417.9, 118.23, 0.1247, "bytes"),    # dy, ab, dhb, lnb in; 7 chunk partials out
    ("reduce", 46.2, 0.0, 0.0138, "bytes"),         # the partials in, the gradients out
])
def test_kernel_8_launches_at_the_training_shape(part, mbytes, gflop, ms, by):
    parts = fused_mlp_bwd_parts_work(*MLP_SHAPE, MLP_WEIGHT_CHUNKS)
    moved, flops = parts[part]
    assert moved / 1e6 == pytest.approx(mbytes, abs=0.05)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.01)
    assert bound_ms(moved, flops, card_peaks("NVIDIA H100 80GB HBM3")) == (pytest.approx(ms, abs=1e-4), by)


def test_kernel_8_parts_sum_to_the_fused_products_and_more_bytes():
    """The six launches' products are the fused backward's five (295.6
    GFLOP); lnb, ab, dhb, dln and the partials go through device memory, so
    their bounds sum to 0.4089 ms against the fused 0.2989; each chunk adds
    two f32 copies of dW1 and dW2 (4.72 MB) to the weights and reduce."""
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    parts = fused_mlp_bwd_parts_work(*MLP_SHAPE, MLP_WEIGHT_CHUNKS)
    assert list(parts) == ["norm", "hidden", "dln", "dx", "weights", "reduce"]
    fused_bytes, fused_flops = fused_mlp_bwd_work(*MLP_SHAPE)
    assert sum(f for _, f in parts.values()) == pytest.approx(fused_flops)
    total = sum(bound_ms(*v, peaks)[0] for v in parts.values())
    assert total == pytest.approx(0.4089, abs=2e-4)
    assert bound_ms(fused_bytes, fused_flops, peaks)[0] == pytest.approx(0.2989, abs=1e-4)
    more = fused_mlp_bwd_parts_work(*MLP_SHAPE, MLP_WEIGHT_CHUNKS + 1)
    grads = 4 * 2 * 384 * 1536
    assert more["weights"][0] - parts["weights"][0] == grads
    assert more["reduce"][0] - parts["reduce"][0] == grads


def test_packed_pair_at_the_cifar_shape():
    """(512, 69, 192, 6): the forward moves qkv in and out out, 54.3 MB
    against 1.87 GFLOP, and the backward qkv, dO and dqkv, 95.0 MB against
    4.68 GFLOP: both bound by bytes on the H100."""
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    for work, mbytes, gflop in ((attention_fwd_work, 54.26, 1.872), (attention_bwd_work, 94.96, 4.680)):
        moved, flops = work(*CIFAR_SHAPE)
        assert moved / 1e6 == pytest.approx(mbytes, abs=0.01)
        assert flops / 1e9 == pytest.approx(gflop, abs=0.001)
        assert bound_ms(moved, flops, peaks)[1] == "bytes"
