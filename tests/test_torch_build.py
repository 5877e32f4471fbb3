"""The library key of dinox_torch.ops._build: a library is
named by a hash of its source, every shared header in csrc/ and the nvcc
flags, so editing a header that a source includes rebuilds it. Checked on the
CPU against a scratch csrc directory; nothing is compiled."""

import pytest
import torch

from dinox_torch.ops import _build


def _key(monkeypatch, csrc, name="k.cu"):
    monkeypatch.setattr(_build, "CSRC", csrc)
    return _build._target(csrc / name)


def test_key_follows_source_headers_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text("// v1\n")
    first = _key(monkeypatch, tmp_path)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-") and first.suffix == ".so"
    assert _key(monkeypatch, tmp_path) == first  # stable
    (tmp_path / "core.cuh").write_text("// v2\n")
    second = _key(monkeypatch, tmp_path)
    assert second != first  # an edited header rebuilds
    (tmp_path / "other.cuh").write_text("// new\n")
    third = _key(monkeypatch, tmp_path)
    assert third != second  # so does a new one
    (tmp_path / "k.cu").write_text('#include "core.cuh"\n// edited\n')
    fourth = _key(monkeypatch, tmp_path)
    assert fourth != third
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _key(monkeypatch, tmp_path) != fourth


def test_every_source_of_the_package_has_a_key():
    names = {src.stem for src in _build.sources()}
    assert {"packed_attention", "packed_attention_bwd", "fused_attn_block", "fused_mlp",
            "fused_mlp_bwd", "mha_attention", "mha_attention_bwd"} <= names
    assert (_build.CSRC / "gemm_sm90.cuh").exists()
    assert (_build.CSRC / "attention_bwd_sm90.cuh").exists()
    assert not (_build.CSRC / "attention_bwd_tile.cuh").exists()
    assert '#include "gemm_sm90.cuh"' in (_build.CSRC / "fused_attn_block.cu").read_text()
    assert not any("attention_tile.cuh" in p.read_text() for p in _build.CSRC.iterdir())
    for pair in ("packed_attention_bwd", "mha_attention_bwd"):
        assert '#include "attention_bwd_sm90.cuh"' in (_build.CSRC / f"{pair}.cu").read_text()
    assert len({_build._target(src) for src in _build.sources()}) == len(names)


def test_check_operands_raises_on_what_a_kernel_cannot_take():
    good = torch.zeros(4, 8, dtype=torch.bfloat16)
    cpu = torch.device("cpu")
    _build.check_operands({"x": (good, (4, 8), torch.bfloat16)}, cpu, 16, "test")
    cases = [({"x": (good.float(), (4, 8), torch.bfloat16)}, TypeError),
             ({"x": (good, (8, 4), torch.bfloat16)}, ValueError),
             ({"x": (good.t(), (8, 4), torch.bfloat16)}, ValueError),  # not contiguous
             ({"x": (good.view(-1)[1:], (31,), torch.bfloat16)}, ValueError)]  # misaligned
    for operands, err in cases:
        with pytest.raises(err):
            _build.check_operands(operands, cpu, 16, "test")
    with pytest.raises(ValueError):
        _build.check_operands({"x": (good, (4, 8), torch.bfloat16)}, torch.device("meta"), 16, "t")
