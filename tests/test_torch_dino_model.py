"""The port's DinoStudentTeacher (backbone + DINO head) against the JAX
package's on the same weights: flax params made by init_model, perturbed so
that no bias is zero and the scale pathway is live, carried across with the
port's jax_to_torch_student. On the CPU the JAX model takes XLA attention;
the port takes its autograd Function (plain forward and backward) for
attn_impl="pallas" and plain attention for "xla"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models import config as torch_config
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.zoo.interop import jax_to_torch_student, torch_to_jax_student
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import DinoStudentTeacher as JaxDinoStudentTeacher
from dinox_tpu.models.vit import init_model
from dinox_tpu.zoo import interop as jax_interop

BASE = dict(name="tiny", img_size=56, patch=14, dim=64, depth=2, heads=2, out_dim=32,
            scale_aware=True, num_registers=4)


def _both(dtype, gelu_approx=True, attn_impl="pallas", seed=0):
    jcfg = jax_config.ModelConfig(**BASE, dtype=dtype, gelu_approx=gelu_approx, attn_impl="xla")
    params = init_model(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    tcfg = torch_config.ModelConfig(**BASE, dtype=dtype, gelu_approx=gelu_approx,
                                    attn_impl=attn_impl)
    model = DinoStudentTeacher(tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_student(params).items()},
                          strict=True)
    return jcfg, params, model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 56, 56, 3)).astype(np.float32),
            rng.uniform(0.5, 3.0, size=(3, 3)).astype(np.float32))


def _jax_forward(jcfg, params, x, sp):
    with jax.default_matmul_precision("highest"):
        return JaxDinoStudentTeacher(jcfg).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(sp),
            method=JaxDinoStudentTeacher.forward_features)


@pytest.mark.parametrize("dtype,gelu_approx,attn_impl", [
    ("float32", True, "pallas"), ("float32", False, "xla"),
    ("bfloat16", True, "pallas"), ("bfloat16", False, "pallas")])
def test_forward_features_match_jax(dtype, gelu_approx, attn_impl):
    jcfg, params, model = _both(dtype, gelu_approx, attn_impl)
    x, sp = _inputs()
    want_out, want_feats = (np.asarray(a) for a in _jax_forward(jcfg, params, x, sp))
    with torch.no_grad():
        out, feats = model.forward_features(torch.from_numpy(x), torch.from_numpy(sp))
    assert out.dtype == feats.dtype == torch.float32
    assert out.shape == (3, 32) and feats.shape == (3, jcfg.seq_len, 64)
    tol = 2e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=tol, rtol=0)
    np.testing.assert_allclose(out.numpy(), want_out, atol=tol, rtol=0)
    if dtype == "bfloat16":
        a, b = feats.numpy()[:, 0], want_feats[:, 0]
        cos = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= 0.999, cos


def test_parameter_gradients_match_jax():
    """Gradients of a fixed random projection of both outputs, per tensor:
    max|dg| <= 1e-4 * max|g| (f32; the port through its autograd Function)."""
    jcfg, params, model = _both("float32")
    x, sp = _inputs(seed=2)
    rng = np.random.default_rng(3)
    r_out = rng.normal(size=(3, 32)).astype(np.float32)
    r_feats = rng.normal(size=(3, jcfg.seq_len, 64)).astype(np.float32)

    def jax_objective(p):
        out, feats = _jax_forward(jcfg, p, x, sp)
        return jnp.sum(out * r_out) + jnp.sum(feats * r_feats)

    want = jax_to_torch_student(jax.tree_util.tree_map(np.asarray, jax.grad(jax_objective)(params)))
    out, feats = model.forward_features(torch.from_numpy(x), torch.from_numpy(sp))
    (torch.sum(out * torch.from_numpy(r_out)) + torch.sum(feats * torch.from_numpy(r_feats))).backward()
    for name, p in model.named_parameters():
        w = want[name]
        assert np.abs(w).max() > 0, name
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_student_interop_round_trip_is_bit_exact():
    _, params, model = _both("float32")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert {k.split(".")[0] for k in sd} == {"backbone", "head"}
    assert {k for k in sd if k.startswith("head.")} == {
        "head.0.weight", "head.0.bias", "head.2.weight", "head.2.bias"}
    back = torch_to_jax_student(sd)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in leaves:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    # the port's mapping is the JAX package's, key for key and value for value
    jsd = jax_interop.jax_to_torch_student(params)
    assert jsd.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])


def test_grad_checkpoint_only_in_training():
    cfg = torch_config.ModelConfig(**BASE, use_grad_checkpoint=True, dtype="float32")
    model = DinoStudentTeacher(cfg)
    x, sp = (torch.from_numpy(a) for a in _inputs())
    attn = model.backbone.blocks[0].attn
    calls = []
    forward = attn.forward
    attn.forward = lambda *a: calls.append(1) or forward(*a)
    model.train()
    model(x, sp).sum().backward()
    assert len(calls) == 2  # forward, and the recompute in the backward
    calls.clear()
    model.eval()
    model(x, sp).sum().backward()
    assert len(calls) == 1
