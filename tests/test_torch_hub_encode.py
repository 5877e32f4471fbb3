"""The port's zoo against the JAX package's: key interop both ways, hub
directories written by one package loaded by the other, training-checkpoint
loading, HU preprocessing (the numpy resize against PIL's), batched encode,
the safetensors reader/writer, and the device rule of load_model."""

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.zoo import interop as t_interop
from dinox_torch.zoo import safetensors_io
from dinox_torch.zoo.encode import _preprocess
from dinox_torch.zoo.encode import encode as t_encode
from dinox_torch.zoo.encode import encode_batch as t_encode_batch
from dinox_torch.zoo.hub import (
    LoadedModel,
    export_hub_checkpoint,
    load_from_hub_dir,
    load_from_training_checkpoint,
    load_model,
)
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.zoo import hub as jax_hub
from dinox_tpu.zoo import interop as j_interop
from dinox_tpu.zoo.encode import _preprocess as jax_preprocess
from dinox_tpu.zoo.encode import encode_batch as jax_encode_batch

KW = dict(name="tiny-hub", img_size=32, patch=16, dim=64, depth=2, heads=2, out_dim=128,
          num_registers=4, scale_aware=True, attn_impl="xla", dtype="float32",
          gelu_approx=False)
JCFG = jax_config.ModelConfig(**KW)
TCFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def jax_params():
    params = init_backbone(JCFG, jax.random.key(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _assert_same_sd(a, b):
    assert set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else np.asarray(a[k])
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_interop_matches_jax_bit_for_bit(jax_params):
    t_sd = t_interop.jax_to_torch_backbone(jax_params)
    _assert_same_sd(t_sd, j_interop.jax_to_torch_backbone(jax_params))
    assert all(v.flags["C_CONTIGUOUS"] for v in t_sd.values())
    _leaves_equal(t_interop.torch_to_jax_backbone(t_sd), j_interop.torch_to_jax_backbone(t_sd))
    legacy = {k.replace(".attn.qkv.weight", ".attn.in_proj_weight").replace(".mlp.fc1.", ".mlp.0."): v
              for k, v in t_sd.items()}
    assert t_interop.needs_migration(legacy) and j_interop.needs_migration(legacy)
    assert t_interop.migrate_state_dict(legacy).keys() == j_interop.migrate_state_dict(legacy).keys()
    assert (t_interop.strip_prefix({"backbone.a": 1, "b": 2}, "backbone.")
            == j_interop.strip_prefix({"backbone.a": 1, "b": 2}, "backbone."))


@pytest.mark.parametrize("use_safetensors", [False, True])
def test_jax_hub_dir_loads_strictly_in_port(tmp_path, jax_params, use_safetensors):
    jax_hub.export_hub_checkpoint(jax_hub.LoadedModel(JCFG, jax_params), tmp_path,
                                  use_safetensors=use_safetensors)
    model = load_from_hub_dir(tmp_path, device="cpu")
    assert model.cfg.dim == 64 and model.scale_aware and model.cfg.dtype == "bfloat16"
    _assert_same_sd({k: v.numpy() for k, v in model.state_dict().items()},
                    j_interop.jax_to_torch_backbone(jax_params))


@pytest.mark.parametrize("use_safetensors", [False, True])
def test_port_hub_dir_loads_in_jax(tmp_path, jax_params, use_safetensors):
    model = LoadedModel(TCFG, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           t_interop.jax_to_torch_backbone(jax_params).items()})
    export_hub_checkpoint(model, tmp_path, use_safetensors=use_safetensors)
    loaded = jax_hub.load_from_hub_dir(tmp_path)
    assert loaded.cfg.gelu_approx is False and loaded.scale_aware
    _leaves_equal(loaded.params, jax_params)


def test_hub_dir_strict_and_moe_refused(tmp_path, jax_params):
    model = LoadedModel(TCFG, "cpu")
    export_hub_checkpoint(model, tmp_path, use_safetensors=True)
    sd = safetensors_io.load_file(tmp_path / "backbone.safetensors")
    del sd["norm.bias"]
    safetensors_io.save_file(sd, tmp_path / "backbone.safetensors")
    with pytest.raises(ValueError, match="does not match config"):
        load_from_hub_dir(tmp_path, device="cpu")
    (tmp_path / "config.json").write_text('{"weights_format": "jax", "moe_experts": 2}')
    with pytest.raises(NotImplementedError):
        load_from_hub_dir(tmp_path, device="cpu")


def _training_payload(sd, legacy=False):
    out = {}
    for k, v in sd.items():
        if legacy:
            k = (k.replace(".attn.qkv.weight", ".attn.in_proj_weight")
                 .replace(".attn.qkv.bias", ".attn.in_proj_bias")
                 .replace(".attn.proj.weight", ".attn.out_proj.weight")
                 .replace(".attn.proj.bias", ".attn.out_proj.bias")
                 .replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.", ".mlp.2."))
        out[f"backbone.{k}"] = torch.from_numpy(np.array(v))
    out["head.0.weight"] = torch.zeros(64, 64)
    return {"step": 10, "student": out, "config": {
        "model": {"patch": 16, "dim": 64, "depth": 2, "heads": 2, "num_registers": 4,
                  "gelu_approx": False},
        "img_size": 32, "scale_aware": True}}


@pytest.mark.parametrize("legacy", [False, True])
def test_training_checkpoint_loads(tmp_path, jax_params, legacy):
    sd = t_interop.jax_to_torch_backbone(jax_params)
    torch.save(_training_payload(sd, legacy), tmp_path / "ckpt.pth")
    model = load_model(tmp_path / "ckpt.pth", device="cpu")
    want = jax_hub.load_from_training_checkpoint(tmp_path / "ckpt.pth")
    _assert_same_sd({k: v.numpy() for k, v in model.state_dict().items()},
                    j_interop.jax_to_torch_backbone(want.params))


def test_training_checkpoint_scale_embed_drop_and_fill(tmp_path, jax_params):
    sd = t_interop.jax_to_torch_backbone(jax_params)
    sd["scale_embed.mlp.0.weight"] = np.zeros((24, 3), np.float32)  # wrong hidden width
    torch.save(_training_payload(sd), tmp_path / "ckpt.pth")
    model = load_from_training_checkpoint(tmp_path / "ckpt.pth", device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    a = model(x, [[0.5, 0.5, 1.0]])
    b = model(x, [[9.9, 9.9, 9.9]])
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # fresh scale_embed is a no-op
    np.testing.assert_array_equal(model.state_dict()["norm.weight"].numpy(), sd["norm.weight"])

    no_scale = {k: v for k, v in t_interop.jax_to_torch_backbone(jax_params).items()
                if not k.startswith("scale_embed.")}
    torch.save(_training_payload(no_scale), tmp_path / "blind.pth")
    model = load_from_training_checkpoint(tmp_path / "blind.pth", device="cpu")
    torch.testing.assert_close(model(x, [[0.5, 0.5, 1.0]]), model(x, [[9.9, 9.9, 9.9]]),
                               rtol=0, atol=0)

    bad = dict(t_interop.jax_to_torch_backbone(jax_params))
    bad["norm.weight"] = np.zeros(32, np.float32)
    torch.save(_training_payload(bad), tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_from_training_checkpoint(tmp_path / "bad.pth", device="cpu")


def _image(fmt, layout, size, rng):
    if fmt == "hu16_png":
        base = rng.integers(32768 - 10000, 32768 + 20000, size=(size, size)).astype(np.uint16)
    elif fmt == "windowed_float":
        base = rng.uniform(0, 1, size=(size, size)).astype(np.float32)
    else:
        base = rng.uniform(-1000, 1500, size=(size, size)).astype(np.float32)
    if layout == "hw":
        return base
    stack = np.stack([base, base[::-1], base.T])
    return stack if layout == "chw" else np.ascontiguousarray(stack.transpose(1, 2, 0))


@pytest.mark.parametrize("size", [512, 100])
@pytest.mark.parametrize("layout", ["hw", "hwc", "chw"])
@pytest.mark.parametrize("fmt", ["hu_float", "hu16_png", "windowed_float"])
def test_preprocess_matches_jax_pil_path(fmt, layout, size):
    img = _image(fmt, layout, size, np.random.default_rng(size))
    got = _preprocess(img, 224, fmt, 40.0, 400.0)
    want = jax_preprocess(img, 224, fmt, 40.0, 400.0)
    assert got.dtype == np.float32 and got.shape == want.shape == (224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encode_batch_matches_jax(tmp_path, jax_params):
    jax_hub.export_hub_checkpoint(jax_hub.LoadedModel(JCFG, jax_params), tmp_path)
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(-1000, 1500, (40, 40)).astype(np.float32) for _ in range(5)]
    sps = [(0.7, 0.7, 1.5), (1.0, 1.0, 3.0), (0.5, 0.5, 1.0), (2.0, 2.0, 5.0), (1.0, 1.0, 1.0)]
    want = np.asarray(jax_encode_batch(jax_hub.load_model(tmp_path), imgs, sps, batch_size=2))
    model = load_model(tmp_path, device="cpu")
    got = t_encode_batch(model, imgs, sps, batch_size=2).numpy()
    assert got.shape == want.shape == (5, 64)
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos
    one = t_encode(model, imgs[1], (1.0, 1.0), 3.0).numpy()
    np.testing.assert_allclose(one[0], got[1], atol=1e-6, rtol=0)
    assert t_encode(model, imgs[1], return_all_tokens=True).shape == (1, 1 + 4 + 4, 64)


def test_safetensors_io_interoperates_with_safetensors(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a": rng.normal(size=(3, 5)).astype(np.float32),
               "b.c": rng.integers(0, 9, size=(7,)).astype(np.int64),
               "half": rng.normal(size=(2, 2)).astype(np.float16),
               "byte": np.arange(5, dtype=np.uint8)}
    p = tmp_path / "x.safetensors"
    p.write_bytes(safetensors.numpy.save(tensors))
    _assert_same_sd(safetensors_io.load_file(p), tensors)
    safetensors_io.save_file(tensors, p)
    _assert_same_sd(safetensors.numpy.load_file(str(p)), tensors)
    bf16 = torch.randn(4, 3).to(torch.bfloat16)
    safetensors.torch.save_file({"w": bf16}, str(p))
    np.testing.assert_array_equal(safetensors_io.load_file(p)["w"], bf16.float().numpy())


def test_load_model_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the rule under test is what happens without a CUDA device")
    export_hub_checkpoint(LoadedModel(TCFG, "cpu"), tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoadedModel(TCFG)
    with pytest.raises(FileNotFoundError, match="HuggingFace Hub"):
        load_model("someone/some-model", device="cpu")
