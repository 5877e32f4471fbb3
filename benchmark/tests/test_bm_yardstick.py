"""The frozen yardstick pinned to hand-worked numbers."""

import pytest

from yardstick import flops, kinds, roofline

VIT_S = dict(img_size=224, patch=14, dim=384, depth=12, heads=6, mlp_ratio=4.0, out_dim=8192, num_registers=4)
VIT_L = dict(VIT_S, dim=1024, depth=24, heads=16)
H100 = flops.card_peaks("NVIDIA H100 80GB HBM3")


def test_tokens():
    assert flops.n_patches(VIT_S) == 256 and flops.seq_len(VIT_S) == 261


def test_training_slice_flops():
    # ViT-S: per view, patch embed 2*256*588*384, per block qkv + attention + proj
    # + MLP, the head on CLS; a slice is 2 views x 4 forwards.
    assert flops.train_flops_per_slice(VIT_S) == pytest.approx(99.694e9, rel=1e-4)
    assert flops.train_flops_per_slice(VIT_L) == pytest.approx(1.31730e12, rel=1e-4)


def test_embedding_slice_flops_leave_out_the_head():
    assert flops.forward_flops_per_view(VIT_S) - flops.embed_flops_per_slice(VIT_S) == \
        2.0 * (384 * 384 + 384 * 8192)
    assert flops.embed_flops_per_slice(VIT_L) == pytest.approx(164.64e9, rel=1e-4)


def test_published_peaks():
    assert H100 == (989e12, 3.35e12)
    assert flops.card_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)


@pytest.mark.parametrize("shape, fwd, bwd", [((256, 261, 384, 6), 0.0613, 0.1072),
                                              ((128, 261, 1024, 16), 0.0817, 0.1430)])
def test_attention_bounds(shape, fwd, bwd):
    ms, by = roofline.bound_ms(*roofline.attention_fwd_work(*shape), H100)
    assert by == "bytes" and ms == pytest.approx(fwd, abs=1e-4)
    ms, by = roofline.bound_ms(*roofline.attention_bwd_work(*shape), H100)
    assert by == "bytes" and ms == pytest.approx(bwd, abs=1e-4)


@pytest.mark.parametrize("name, kind", [
    ("void dinox_fwd::attention_fwd_sm90<64, (dinox_fwd::Rounding)0, true>(CUtensorMap_st)",
     "kernel 1 (packed attention forward)"),
    ("void dinox_fwd::attention_fwd_sm90<64, (dinox_fwd::Rounding)1, false>(CUtensorMap_st)",
     "kernel 4 (head-major attention forward)"),
    ("void dinox_bwd::attention_bwd_sm90_dq<64, true>(CUtensorMap_st)", "kernels 2/3 (packed attention backward)"),
    ("void dinox_bwd::attention_bwd_sm90_dkv<64, false>(CUtensorMap_st)", "kernel 5 (head-major attention backward)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "cuBLAS GEMM"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", "elementwise"),
    ("Memset (Device)", "copy/cast"),
    ("something_else", "other"),
])
def test_kernel_kinds(name, kind):
    assert kinds.kernel_kind(name) == kind
