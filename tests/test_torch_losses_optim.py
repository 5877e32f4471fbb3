"""The port's losses, LR schedule, optimizer and TrainConfig against the JAX
package's (dinox_tpu.train), on the same numpy inputs, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.models.vit import DinoStudentTeacher
from dinox_torch.train import losses
from dinox_torch.train.schedule import get_lr, get_lr_tensor
from dinox_torch.train.state import TrainConfig, apply_gradients, make_optimizer
from dinox_torch.zoo.interop import jax_to_torch_student
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import init_model
from dinox_tpu.train import losses as jax_losses
from dinox_tpu.train import schedule as jax_schedule
from dinox_tpu.train import state as jax_state

TOL = dict(rtol=1e-5, atol=1e-6)  # f32, the same math in another summation order


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _torch_value_and_grad(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    val = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(val, ts, allow_unused=True)
    return out, [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(arrays, grads)]


def test_dino_loss_matches_jax():
    s, t = _rand(0, 16, 64, scale=3.0), _rand(1, 16, 64, scale=3.0)
    center = _rand(2, 1, 64, scale=0.5)
    kw = dict(student_temp=0.1, teacher_temp=0.04, center_momentum=0.9)
    jout = jax_losses.dino_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(center), **kw)
    jgrad = jax.grad(lambda a: jax_losses.dino_loss(a, jnp.asarray(t), jnp.asarray(center),
                                                    **kw).loss)(jnp.asarray(s))
    out, (gs, gt) = _torch_value_and_grad(
        lambda a, b: losses.dino_loss(a, b, torch.from_numpy(center), **kw), s, t)
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gs, np.asarray(jgrad), **TOL)
    assert not gt.any()  # the teacher gets no gradient


def test_gram_anchoring_loss_matches_jax():
    a, b = _rand(3, 4, 13, 32), _rand(4, 4, 13, 32)
    want, jgrad = jax.value_and_grad(jax_losses.gram_anchoring_loss)(jnp.asarray(a), jnp.asarray(b))
    got, (ga, gb) = _torch_value_and_grad(losses.gram_anchoring_loss, a, b)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(ga, np.asarray(jgrad), **TOL)
    assert not gb.any()
    # CLS (index 0) is dropped: changing it changes nothing
    a2 = a.copy()
    a2[:, 0] += 5.0
    assert losses.gram_anchoring_loss(torch.from_numpy(a2), torch.from_numpy(b)).item() == got.item()


def test_koleo_loss_matches_jax():
    x = _rand(5, 16, 64)
    want, jgrad = jax.value_and_grad(jax_losses.koleo_loss)(jnp.asarray(x))
    got, (g,) = _torch_value_and_grad(losses.koleo_loss, x)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(g, np.asarray(jgrad), **TOL)


def test_simclr_loss_matches_jax():
    z1, z2 = _rand(6, 8, 32), _rand(7, 8, 32)
    want, (j1, j2) = jax.value_and_grad(
        lambda a, b: jax_losses.simclr_loss(a, b, 0.1), argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
    got, (g1, g2) = _torch_value_and_grad(lambda a, b: losses.simclr_loss(a, b, 0.1), z1, z2)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(g1, np.asarray(j1), **TOL)
    np.testing.assert_allclose(g2, np.asarray(j2), **TOL)


@pytest.mark.parametrize("total", [None, 40])
def test_schedule_matches_jax(total):
    args = (total, 10, 1e-3, 1e-6)
    steps = np.arange(61)
    for s in steps:
        assert get_lr(int(s), *args) == jax_schedule.get_lr(int(s), *args)
    got = get_lr_tensor(torch.from_numpy(steps), *args).numpy()
    want = np.asarray(jax_schedule.get_lr_jnp(jnp.asarray(steps), *args))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_train_config_schema_matches_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls) if f.name != "model"]

    assert fields(TrainConfig) == fields(jax_state.TrainConfig)
    assert TrainConfig().model.to_dict() == jax_state.TrainConfig().model.to_dict()
    assert dataclasses.asdict(TrainConfig().aug) == dataclasses.asdict(jax_state.TrainConfig().aug)


@pytest.mark.parametrize("scale_lr_mult", [1.0, 0.5])
def test_three_adamw_updates_match_optax(scale_lr_mult):
    kw = dict(name="tiny", img_size=28, patch=14, dim=32, depth=1, heads=2, out_dim=16,
              scale_aware=True, num_registers=2)
    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**kw), img_size=28, lr=1e-3,
                                 warmup_steps=2, max_steps=10, scale_lr_mult=scale_lr_mult)
    tcfg = TrainConfig(model=ModelConfig(**kw), img_size=28, lr=1e-3, warmup_steps=2,
                       max_steps=10, scale_lr_mult=scale_lr_mult)
    params = init_model(jcfg.model, jax.random.key(0))
    model = DinoStudentTeacher(tcfg.model)
    model.load_state_dict({k: torch.tensor(v) for k, v in jax_to_torch_student(params).items()})
    tx = jax_state.make_optimizer(jcfg)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = make_optimizer(tcfg, model)
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(0)
    for step in range(3):
        jgrads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.1), params)
        updates, opt_state = update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tgrads = jax_to_torch_student(jax.tree_util.tree_map(np.asarray, jgrads))
        apply_gradients(tcfg, opt, list(model.parameters()),
                        [torch.tensor(tgrads[n]) for n in names], step)
        want = jax_to_torch_student(jax.tree_util.tree_map(np.asarray, params))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("name", ["vit-small", "vit-giant"])
def test_flops_match_jax(name):
    from dinox_torch.models.config import MODEL_CONFIGS
    from dinox_torch.utils import flops
    from dinox_tpu.utils import flops as jax_flops

    t, j = MODEL_CONFIGS[name].replace(scale_aware=True), jax_config.MODEL_CONFIGS[name]
    assert flops.forward_flops_per_view(t) == jax_flops.forward_flops_per_view(j)
    assert flops.train_flops_per_slice(t) == jax_flops.train_flops_per_slice(j)
    assert flops.mfu(100.0, t, 989e12) == jax_flops.mfu(100.0, j, 989e12)
