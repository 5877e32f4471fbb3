"""The port's optimizer-memory options (``dinox_torch.train.optim``) against
the JAX package's ``make_optimizer`` (optax ``adamw(mu_dtype)``,
``_scale_by_adam_lowp``, ``_scale_by_adam_factored``).

One tiny scale-aware DINO student (float32 parameters, a ``scale_embed``
LR group at multiplier 2), three updates from one state with the same
gradients (drawn in JAX's layout, carried across by the interop), held
against the jitted optax update. Tolerances, relative to each tensor's
largest value: parameters, float32 moments and the factored ``r``/``c``
within 1e-6; bfloat16 moments equal after the cast. The default float32
kind stays ``torch.optim.AdamW``, whose bias corrections are taken in double
precision where the JAX package's ``1 - 0.999 ** t`` in float32 loses ~1e-5
to cancellation: its parameters are held to 2e-5. ``state_from_jax`` and
the checkpoint round trip are bit-exact for each kind, dtypes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.train.checkpoint import CheckpointManager
from dinox_torch.train.optim import AdamFactored, AdamLowp
from dinox_torch.train.state import (
    TrainConfig,
    apply_gradients,
    create_train_state,
    state_from_jax,
)
from dinox_torch.zoo.interop import jax_layout, jax_to_torch_student
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import init_model
from dinox_tpu.train import state as jax_state

MODEL = dict(name="test-tiny", img_size=28, patch=14, dim=32, depth=2, heads=2, out_dim=16,
             num_registers=2, dtype="float32", scale_aware=True)
TRAIN = dict(img_size=28, lr=1e-2, warmup_steps=2, max_steps=20, weight_decay=0.04,
             scale_lr_mult=2.0)
KINDS = {
    "f32": {},
    "mu_bf16": dict(mu_dtype="bfloat16"),
    "nu_bf16": dict(nu_dtype="bfloat16"),
    "both_bf16": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
    "factored": dict(factored_nu=True),
    "factored_mu_bf16": dict(factored_nu=True, mu_dtype="bfloat16"),
}


def _configs(kind):
    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**MODEL, attn_impl="xla"),
                                 **TRAIN, **KINDS[kind])
    tcfg = TrainConfig(model=ModelConfig(**MODEL), **TRAIN, **KINDS[kind])
    return jcfg, tcfg


def _adam(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _grads(params, step):
    """Gradients of every leaf, with a per-leaf scale and a rank-1 row/column
    structure plus noise, so that the factored statistics are not uniform."""
    rng = np.random.default_rng(100 + step)

    def one(a):
        a = np.asarray(a)
        g = rng.normal(size=a.shape) * rng.uniform(0.1, 3.0)
        if a.ndim >= 2:
            g *= rng.uniform(0.2, 2.0, a.shape[-1]) * rng.uniform(0.2, 2.0, a.shape[:-1])[..., None]
        return g.astype(np.float32)

    return jax.tree_util.tree_map(one, params)


def _run_jax(jcfg, params, steps=3):
    """Updates as the JAX train step makes them: jitted (XLA fuses the
    moment arithmetic in float32, where eager optax rounds ``b1 * mu`` to
    bfloat16 first)."""
    tx = jax_state.make_optimizer(jcfg)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for step in range(steps):
        updates, opt_state = update(_grads(params, step), opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


def _run_torch(tcfg, params, steps=3):
    state = create_train_state(tcfg, device="cpu")
    state.student.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   jax_to_torch_student(_np(params)).items()})
    names = [n for n, _ in state.student.named_parameters()]
    plist = list(state.student.parameters())
    for step in range(steps):
        g = jax_to_torch_student(_grads(params, step))
        apply_gradients(tcfg, state.optimizer, plist, [torch.from_numpy(g[n]) for n in names], step)
    return state


def _assert_close(got, want, rel, name):
    """max |got - want| <= rel * max |want| over the tensor."""
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def _factors_by_name(tree):
    """{port name: (r, c)} of a JAX factored nu tree (via the port's import)."""
    from dinox_torch.train.state import _factored_nu

    _, tcfg = _configs("factored")
    full, factors = _factored_nu(tcfg, tree, torch.device("cpu"))
    return ({k: v.numpy() for k, v in full.items()},
            {k: (r.numpy(), c.numpy()) for k, (r, c) in factors.items()})


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _configs("f32")
    return init_model(jcfg.model.replace(img_size=28), jax.random.key(0))


@pytest.mark.parametrize("kind", list(KINDS))
def test_three_updates_match_optax(params, kind):
    jcfg, tcfg = _configs(kind)
    jparams, opt_state = _run_jax(jcfg, params)
    state = _run_torch(tcfg, params)
    want = jax_to_torch_student(_np(jparams))
    for name, p in state.student.named_parameters():
        _assert_close(p.detach().numpy(), want[name], 2e-5 if kind == "f32" else 1e-6, name)
    opt = state.optimizer
    if kind == "f32":
        assert type(opt) is torch.optim.AdamW
        return
    assert isinstance(opt, AdamFactored if "factored" in kind else AdamLowp)
    adam = _adam(opt_state)
    mu = jax_to_torch_student(_np(adam.mu))
    if "factored" in kind:
        full, factors = _factors_by_name(adam.nu)
    else:
        full, factors = jax_to_torch_student(_np(adam.nu)), {}
    mu_bf16 = tcfg.mu_dtype == "bfloat16"
    for name, p in state.student.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == 3
        got_mu = st["exp_avg"]
        assert got_mu.dtype == (torch.bfloat16 if mu_bf16 else torch.float32)
        if mu_bf16:  # equal after the cast
            np.testing.assert_array_equal(got_mu.float().numpy(), mu[name], err_msg=name)
        else:
            _assert_close(got_mu.numpy(), mu[name], 1e-6, name)
        if name in factors:
            for key, want_f in zip(("exp_avg_sq_r", "exp_avg_sq_c"), factors[name]):
                assert st[key].shape == want_f.shape, (name, key)
                _assert_close(st[key].numpy(), want_f, 1e-6, name)
        else:
            got_nu = st["exp_avg_sq"]
            if tcfg.nu_dtype == "bfloat16" and not tcfg.factored_nu:
                assert got_nu.dtype == torch.bfloat16
                np.testing.assert_array_equal(got_nu.float().numpy(), full[name], err_msg=name)
            else:
                _assert_close(got_nu.numpy(), full[name], 1e-6, name)


def test_factored_statistics_follow_the_jax_layout(params):
    """r and c are JAX's, over the trailing two axes of JAX's layout: a dense
    weight (out, in) factors as JAX's (in, out), so r has the length of the
    input axis; the patch embedding (D, 3, p, p) as JAX's (p, p, 3, D);
    pos_embed (1, N, D), cls_token (1, 1, D) and registers are factored too
    (exactly, where an axis has length 1)."""
    _, tcfg = _configs("factored")
    state = _run_torch(tcfg, params, steps=1)
    named = dict(state.student.named_parameters())
    shapes = {k: (tuple(v["exp_avg_sq_r"].shape), tuple(v["exp_avg_sq_c"].shape))
              for k, p in named.items() for v in [state.optimizer.state[p]] if "exp_avg_sq_r" in v}
    d, hidden, p = 32, 128, 14
    assert shapes["backbone.blocks.0.mlp.fc1.weight"] == ((d,), (hidden,))
    assert shapes["backbone.blocks.0.mlp.fc2.weight"] == ((hidden,), (d,))
    assert shapes["backbone.patch_embed.weight"] == ((p, p, 3), (p, p, d))
    assert shapes["backbone.pos_embed"] == ((1, 5), (1, d))
    assert shapes["backbone.cls_token"] == ((1, 1), (1, d))
    assert shapes["backbone.registers"] == ((1, 2), (1, d))
    assert jax_layout("backbone.patch_embed.weight", 4) == (2, 3, 1, 0)
    assert jax_layout("backbone.blocks.0.attn.qkv.weight", 2) == (1, 0)
    assert jax_layout("backbone.blocks.1.moe.w1", 3) == (0, 1, 2)
    assert all("exp_avg_sq" in state.optimizer.state[p] for p in named.values() if p.ndim == 1)
    # The first update's r of a dense weight: JAX's row means of g^2 in (in, out).
    g = np.asarray(_grads(params, 0)["backbone"]["blocks_0"]["mlp"]["fc1"]["kernel"])
    r = state.optimizer.state[named["backbone.blocks.0.mlp.fc1.weight"]]["exp_avg_sq_r"]
    np.testing.assert_allclose(r.numpy(), (1 - 0.999) * (g * g).mean(axis=-1), rtol=1e-6)
    # Factoring the port's own (D, 3, p, p) trailing axes would be another
    # approximation, not a rounding difference: the JAX-layout statistics differ.
    gp = np.asarray(_grads(params, 0)["backbone"]["patch_embed"]["kernel"])  # (p, p, 3, D)
    port_layout = np.transpose(gp, (3, 2, 0, 1)) ** 2
    assert port_layout.mean(axis=-1).shape != (p, p, 3)


def _jax_tree(jcfg, params):
    """A JAX state three updates in, as the numpy tree state_from_jax takes."""
    jparams, opt_state = _run_jax(jcfg, params)
    adam = _adam(opt_state)
    keep = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731 - moments keep their dtype
    return dict(step=np.asarray(3), student=_np(jparams), teacher=_np(params),
                center=np.zeros((1, 16), np.float32), mu=keep(adam.mu), nu=keep(adam.nu),
                count=np.asarray(adam.count))


def _state_dict_of(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    for name, p in state.student.named_parameters():
        for key, v in state.optimizer.state[p].items():
            out[f"opt.{name}.{key}"] = torch.as_tensor(v)
    return out


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "f32"])
def test_state_from_jax_and_checkpoint_round_trip_are_exact(params, kind, tmp_path):
    jcfg, tcfg = _configs(kind)
    tree = _jax_tree(jcfg, params)
    state = state_from_jax(tcfg, tree, device="cpu")
    mu = jax_to_torch_student(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree["mu"]))
    for name, p in state.student.named_parameters():
        st = state.optimizer.state[p]
        assert st["exp_avg"].dtype == (torch.bfloat16 if tcfg.mu_dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), mu[name], err_msg=name)
    if tcfg.factored_nu:
        _, factors = _factors_by_name(tree["nu"])
        for name, p in state.student.named_parameters():
            if name in factors:
                st = state.optimizer.state[p]
                np.testing.assert_array_equal(st["exp_avg_sq_r"].numpy(), factors[name][0])
                np.testing.assert_array_equal(st["exp_avg_sq_c"].numpy(), factors[name][1])

    mgr = CheckpointManager(tmp_path / "run", async_save=False)
    mgr.save(3, state)
    mgr.close()
    restored, meta = CheckpointManager(tmp_path / "run").restore(create_train_state(tcfg, device="cpu"))
    assert meta["step"] == 3 and restored.step == 3
    a, b = _state_dict_of(state), _state_dict_of(restored)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    # And the next update from either is the same, bit for bit.
    grads = jax_to_torch_student(_grads(params, 5))
    for st in (state, restored):
        names = [n for n, _ in st.student.named_parameters()]
        apply_gradients(tcfg, st.optimizer, list(st.student.parameters()),
                        [torch.from_numpy(grads[n]) for n in names], 3)
    a, b = _state_dict_of(state), _state_dict_of(restored)
    assert all(torch.equal(a[k], b[k]) for k in a)
