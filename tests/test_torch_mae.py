"""The port's MAE objective (``dinox_torch.models.mae`` and the step's MAE
branch) against the JAX package's: the twin of ``tests/test_mae.py``.

Tolerances: ``sincos_2d`` and ``patchify`` exact; ``random_masking`` fed
JAX's noise (``jax.random.uniform(key, (B, L))``) exact; ``MaeModel``
forward within 1e-4 (float32, weights through the interop); three MAE steps
against JAX's ``build_train_step`` (the views and JAX's mask noise patched
in) with the loss within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.models import mae as t_mae
from dinox_torch.models.config import ModelConfig
from dinox_torch.train import step as t_step
from dinox_torch.train.state import TrainConfig, create_train_state, state_from_jax
from dinox_torch.zoo.interop import jax_to_torch_mae, torch_to_jax_mae
from dinox_tpu.models import config as jax_config
from dinox_tpu.models import mae as j_mae
from dinox_tpu.train import state as jax_state
from dinox_tpu.train import step as jax_step

MODEL = dict(name="mae-tiny", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=64,
             num_registers=2, dtype="float32", scale_aware=True)
S = 32


def _pair(**kw):
    return (jax_config.ModelConfig(**dict(MODEL, attn_impl="xla", **kw)),
            ModelConfig(**dict(MODEL, attn_impl="pallas", **kw)))


def test_sincos_and_patchify_are_exact():
    for dim, grid, cls in ((512, 16, True), (64, 4, False), (32, 2, True)):
        np.testing.assert_array_equal(t_mae.sincos_2d(dim, grid, cls), j_mae.sincos_2d(dim, grid, cls))
    img = np.random.default_rng(0).normal(size=(2, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_mae.patchify(torch.from_numpy(img), 16).numpy(),
                                  np.asarray(j_mae.patchify(jnp.asarray(img), 16)))


@pytest.mark.parametrize("ratio", [0.75, 0.5])
def test_random_masking_with_jax_noise_is_exact(ratio):
    x = np.random.default_rng(1).normal(size=(3, 16, 8)).astype(np.float32)
    key = jax.random.key(2)
    want = j_mae.random_masking(jnp.asarray(x), ratio, key)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (3, 16))))
    got = t_mae.random_masking(torch.from_numpy(x), ratio, noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # A generator draws its own noise: the same invariants as the JAX test.
    x_vis, mask, ids = t_mae.random_masking(torch.from_numpy(x), ratio, torch.Generator().manual_seed(0))
    assert x_vis.shape == (3, int(16 * (1 - ratio)), 8) and mask.sum(dim=1).eq(16 * ratio).all()


def test_mae_loss_only_masked_patches():
    imgs = torch.zeros((1, 4, 4, 3))
    pred = torch.ones((1, 4, 12))
    mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    assert float(t_mae.mae_loss(pred, imgs, mask, 2)) == 1.0
    pred[0, 2:] = 0.0
    assert float(t_mae.mae_loss(pred, imgs, mask, 2)) == 1.0


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _pair()
    params = j_mae.init_mae(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def test_mae_state_dict_is_the_interop_tree(jax_params):
    _, tcfg = _pair()
    model = t_mae.MaeModel(tcfg)
    sd = jax_to_torch_mae(jax_params)
    assert set(model.state_dict()) == set(sd)  # no scale_embed in the encoder, no pos buffer
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    back = torch_to_jax_mae(model.state_dict())
    la = jax.tree_util.tree_leaves_with_path(jax_params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(lb[path]))
    # The decoder: 16 heads of 32 at width 512, exact GELU whatever the config says.
    blk = model.decoder.blocks[0]
    assert blk.attn.heads == 16 and blk.mlp.approximate == "none" and model.cfg.gelu_approx
    assert len(model.decoder.blocks) == 8


@pytest.mark.parametrize("attn", ["pallas", "xla"])
def test_mae_forward_matches_jax(jax_params, attn):
    jcfg, tcfg = _pair()
    tcfg = tcfg.replace(attn_impl=attn)
    model = t_mae.MaeModel(tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_mae(jax_params).items()})
    imgs = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(4)
    pred_j, mask_j = j_mae.MaeModel(jcfg).apply({"params": jax_params}, jnp.asarray(imgs), key)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (2, 4))))
    with torch.no_grad():
        pred, mask = model(torch.from_numpy(imgs), noise)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_j), rtol=0, atol=1e-4)
    want = float(j_mae.mae_loss(pred_j, jnp.asarray(imgs), mask_j, 16))
    got = float(t_mae.mae_loss(pred, torch.from_numpy(imgs), mask, 16))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_views(px, key, aug_cfg):
    x = px.astype(jnp.float32)
    return jnp.stack([(x[:, :S, :S] - 33000.0) / 1500.0,
                      (x[:, -S:, -S:][:, :, ::-1] - 32500.0) / 2000.0])


def _torch_views(px, generator, aug_cfg):
    x = px.to(torch.float32)
    return torch.stack([(x[:, :S, :S] - 33000.0) / 1500.0,
                        (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0])


def test_three_mae_steps_match_jax(jax_params, monkeypatch):
    train = dict(img_size=32, batch_size=4, lr=1e-3, warmup_steps=1, max_steps=50, loss_type="mae",
                 train_seed=0)
    jcfg = jax_state.TrainConfig(model=_pair()[0], **train)
    tcfg = TrainConfig(model=_pair()[1], **train)
    opt_state = jax_state.make_optimizer(jcfg).init(jax_params)
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    jstate = jax_state.TrainState(step=jnp.asarray(0, jnp.int32),
                                  student=jax.tree_util.tree_map(jnp.asarray, jax_params),
                                  teacher=jax.tree_util.tree_map(jnp.asarray, jax_params),
                                  opt_state=opt_state, center=jnp.zeros((1, 64), jnp.float32))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tstate = state_from_jax(tcfg, dict(step=np.asarray(0), student=jax_params, teacher=jax_params,
                                       center=np.zeros((1, 64), np.float32), mu=np_tree(adam.mu),
                                       nu=np_tree(adam.nu), count=np.asarray(0)), device="cpu")
    teacher0 = {k: v.clone() for k, v in tstate.teacher.state_dict().items()}

    # The JAX step's mask noise: uniform(fold_in(fold_in(fold_in(key(seed), step), a), 0x3AE)).
    real = t_step.seeded_generator

    def jax_noise(seed, step, a, stream, **kw):
        if stream != 2:
            return real(seed, step, a, stream, **kw)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), step), a), 0x3AE)
        return torch.from_numpy(np.asarray(jax.random.uniform(key, (8, 4))))

    monkeypatch.setattr(t_step, "seeded_generator", jax_noise)
    jfn = jax_step.build_train_step(jcfg, donate=False, augment_fn=_jax_views)
    tfn = t_step.build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
    for i in range(3):
        r = np.random.default_rng(i)
        px = r.integers(30000, 36000, (1, 4, 48, 48, 3)).astype(np.uint16)
        sp = r.uniform(0.5, 2.0, (1, 4, 3)).astype(np.float32)
        jstate, jm = jfn(jstate, jnp.asarray(px), jnp.asarray(sp))
        tstate, tm = tfn(tstate, px, sp)
        for k in ("loss", "loss_mae"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(tm["embed_std"]), float(jm["embed_std"]), rtol=1e-4)
        assert float(tm["loss_dino"]) == 0.0
    # MAE keeps the teacher (no EMA), as the JAX step does.
    for k, v in tstate.teacher.state_dict().items():
        torch.testing.assert_close(v, teacher0[k], rtol=0, atol=0)


def test_mae_state_and_step_on_the_cpu():
    """create_train_state builds the MaeModel student; with the kernels'
    plain versions the step's loss falls over a few steps on one batch."""
    _, tcfg = _pair()
    cfg = TrainConfig(model=tcfg, img_size=32, batch_size=4, loss_type="mae", lr=1e-3,
                      warmup_steps=0, max_steps=50)
    state = create_train_state(cfg, device="cpu")
    assert isinstance(state.student, t_mae.MaeModel)
    px = np.random.default_rng(0).integers(30000, 36000, (1, 4, 48, 48, 3)).astype(np.uint16)
    sp = np.ones((1, 4, 3), np.float32)
    fn = t_step.build_train_step(cfg, device="cpu", augment_fn=_torch_views)
    losses = [float(fn(state, px, sp)[1]["loss"]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
