"""The port's training step (dinox_torch.train) against the JAX package's on
one state and the same views.

Both packages start from one JAX state (its student perturbed so that every
pathway, the scale embedding included, carries gradient), carried across
with ``state_from_jax``. Augmentation is replaced in both by the same
deterministic function of the canvases, through each package's
``augment_fn`` hook. The port takes ``attn_impl="pallas"`` (its autograd
Function with the plain forward and backward on the CPU); JAX takes XLA
attention on the CPU. Float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinox_torch.models.config import ModelConfig
from dinox_torch.parallel import Mesh
from dinox_torch.train.pp_step import build_pp_train_step
from dinox_torch.train.state import TrainConfig, create_train_state, state_from_jax
from dinox_torch.train.step import METRICS, build_train_step, micro_loss_and_grads
from dinox_torch.zoo.interop import jax_to_torch_student
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import DinoStudentTeacher as JaxDinoStudentTeacher
from dinox_tpu.train import state as jax_state
from dinox_tpu.train import step as jax_step

MODEL = dict(name="test-tiny", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=64,
             num_registers=2, dtype="float32", scale_aware=True)
TRAIN = dict(img_size=32, batch_size=8, lr=1e-3, warmup_steps=2, max_steps=50,
             koleo_weight=0.1, train_seed=0)
S = 32


def _configs(**kw):
    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**MODEL, attn_impl="xla"),
                                 **dict(TRAIN, **kw))
    tcfg = TrainConfig(model=ModelConfig(**MODEL, attn_impl="pallas"), **dict(TRAIN, **kw))
    return jcfg, tcfg


def _jax_views(px, key, aug_cfg):
    x = px.astype(jnp.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:][:, :, ::-1] - 32500.0) / 2000.0
    return jnp.stack([v1, v2])


def _torch_views(px, generator, aug_cfg):
    x = px.to(torch.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0
    return torch.stack([v1, v2])


def _batch(accum, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(30000, 36000, (accum, 8, 48, 48, 3)).astype(np.uint16)
    sp = rng.uniform(0.5, 2.0, (accum, 8, 3)).astype(np.float32)
    return px, sp


def _jax_start(jcfg, warm=False):
    """A JAX state: fresh, or (*warm*) ten steps in, with random Adam moments."""
    state = jax_state.create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(7)

    def noise(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), tree)

    student = jax.tree_util.tree_map(jnp.asarray, noise(state.student, 0.05))
    teacher = jax.tree_util.tree_map(jnp.copy, student)
    opt_state = jax_state.make_optimizer(jcfg).init(student)
    step = state.step
    if warm:
        step = jnp.asarray(10, jnp.int32)
        zeros = jax.tree_util.tree_map(np.zeros_like, student)

        def warm_adam(s):
            if not isinstance(s, optax.ScaleByAdamState):
                return s
            nu = jax.tree_util.tree_map(lambda a: (a + 1e-3) ** 2, noise(zeros, 1e-2))
            return optax.ScaleByAdamState(count=step, mu=noise(zeros, 1e-3), nu=nu)

        opt_state = jax.tree_util.tree_map(
            warm_adam, opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        opt_state = jax.tree_util.tree_map(
            lambda a: step if getattr(a, "dtype", None) == jnp.int32 and a.shape == () else a,
            opt_state)
    return jax_state.TrainState(step=step, student=student, teacher=teacher,
                                opt_state=opt_state, center=state.center)


def _as_tree(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(step=np.asarray(state.step), student=np_tree(state.student),
                teacher=np_tree(state.teacher), center=np.asarray(state.center),
                mu=np_tree(adam.mu), nu=np_tree(adam.nu), count=np.asarray(adam.count))


def _noise_only(name, shape):
    """True where the gradient is zero in exact arithmetic: the k third of a
    qkv bias (softmax is unchanged by adding one vector to every key). There
    both packages differentiate rounding noise, and Adam's first steps turn
    any nonzero noise into +-lr, so those elements are held to 2*lr only."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        mask[shape[0] // 3: 2 * shape[0] // 3] = True
    return mask


def _assert_params_close(torch_module, jax_tree, lr):
    want = jax_to_torch_student(jax.tree_util.tree_map(np.asarray, jax_tree))
    got = {k: v.detach().numpy() for k, v in torch_module.state_dict().items()}
    assert got.keys() == want.keys()
    close = []
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max())
        close.append(diff[~_noise_only(k, diff.shape)] <= 1e-5)
    # Elsewhere a gradient near Adam's eps by chance is amplified the same way.
    assert np.mean(np.concatenate(close)) >= 0.999


@pytest.mark.parametrize("accum,warm", [(1, False), (2, True)])
def test_two_steps_match_jax(accum, warm):
    jcfg, tcfg = _configs(accumulation_steps=accum, batch_size=8 // accum)
    jstate = _jax_start(jcfg, warm)
    tstate = state_from_jax(tcfg, _as_tree(jstate), device="cpu")
    jfn = jax_step.build_train_step(jcfg, donate=False, augment_fn=_jax_views)
    tfn = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
    for i in range(2):
        px, sp = _batch(accum, seed=i)
        px, sp = px[:, : 8 // accum], sp[:, : 8 // accum]
        jstate, jm = jfn(jstate, jnp.asarray(px), jnp.asarray(sp))
        tstate, tm = tfn(tstate, px, sp)
        assert set(tm) == set(METRICS) <= set(jm)
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tstate.center.numpy(), np.asarray(jstate.center), rtol=0, atol=1e-6)
        assert tstate.step == int(jstate.step) == i + 1 + 10 * warm
        _assert_params_close(tstate.student, jstate.student, tcfg.lr)
        _assert_params_close(tstate.teacher, jstate.teacher, tcfg.lr)


def test_first_micro_step_gradients_match_jax():
    _micro_step_gradients_match(*_configs())


def test_fused_micro_step_gradients_match_jax():
    """The fused half-block configuration (fused_attn + fused_mlp, exact GELU,
    attn_impl="pallas" on both sides: the JAX step runs its Pallas kernels in
    interpret mode)."""
    fused = dict(MODEL, attn_impl="pallas", gelu_approx=False, fused_attn=True, fused_mlp=True)
    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**fused), **TRAIN)
    tcfg = TrainConfig(model=ModelConfig(**fused), **TRAIN)
    _micro_step_gradients_match(jcfg, tcfg)


def _micro_step_gradients_match(jcfg, tcfg):
    jstate = _jax_start(jcfg)
    tstate = state_from_jax(tcfg, _as_tree(jstate), device="cpu")
    px, sp = _batch(1, seed=3)
    jviews = _jax_views(jnp.asarray(px[0]), None, None)
    model = JaxDinoStudentTeacher(jcfg.model.replace(img_size=jcfg.img_size))
    (jloss, _), jgrads = jax.value_and_grad(jax_step._micro_loss, has_aux=True)(
        jstate.student, jstate.teacher, jstate.center, jviews.reshape((-1, S, S, 3)),
        jnp.asarray(sp[0]), jax.random.key(0), jcfg, model)
    tviews = _torch_views(torch.from_numpy(px[0]), None, None)
    grads, _, metrics = micro_loss_and_grads(tstate, tstate.center, tviews.reshape(-1, S, S, 3),
                                             torch.from_numpy(sp[0]), tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    want = jax_to_torch_student(jax.tree_util.tree_map(np.asarray, jgrads))
    names = [n for n, _ in tstate.student.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[name]
        assert np.abs(w).max() > 0, f"{name}: the test wants a live gradient"
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_grad_checkpoint_gives_the_same_gradients():
    _, tcfg = _configs()
    ckpt = tcfg.replace(model=tcfg.model.replace(use_grad_checkpoint=True))
    px, sp = _batch(1, seed=4)
    views = _torch_views(torch.from_numpy(px[0]), None, None).reshape(-1, S, S, 3)
    out = []
    for cfg in (tcfg, ckpt):
        state = create_train_state(cfg, seed=1, device="cpu")
        grads, _, _ = micro_loss_and_grads(state, state.center, views, torch.from_numpy(sp[0]), cfg)
        out.append(grads)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_simclr_keeps_the_teacher():
    _, tcfg = _configs(loss_type="simclr")
    state = create_train_state(tcfg, device="cpu")
    before = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    px, sp = _batch(1, seed=5)
    state, m = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)(state, px, sp)
    assert np.isfinite(float(m["loss_simclr"])) and float(m["loss_dino"]) == 0.0
    for k, v in state.teacher.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_default_augmentation_step_is_deterministic():
    _, tcfg = _configs()
    px, sp = _batch(1, seed=6)
    losses = []
    for _ in range(2):
        state = create_train_state(tcfg, device="cpu")
        fn = build_train_step(tcfg, device="cpu")
        losses.append([float(fn(state, px, sp)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()


def test_step_wants_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(tcfg)


@pytest.mark.parametrize("kw", [dict(loss_type="mae"), dict(factored_nu=True),
                                dict(mu_dtype="bfloat16"), dict(nu_dtype="bfloat16"),
                                dict(pipeline_parallel=2)])
def test_unported_options_raise(kw):
    """Pipeline parallelism (module 13b-3) is ported: its step refuses, with
    the reference's ValueError, accumulation, MAE and LoRA (its parity with
    JAX is in test_torch_pipeline.py), and the step without a pipe axis
    refuses a (data, pipe) mesh. MAE and the optimizer-memory options
    (module 11) are ported: a step runs and stays finite (their parity with
    JAX is in test_torch_mae.py and test_torch_optim.py)."""
    _, tcfg = _configs(**kw)
    if kw.get("pipeline_parallel"):
        mesh = Mesh(2, 0, 1, 1, None, None, torch.device("cpu"), pp=2)
        for bad, msg in ((dict(accumulation_steps=2), "folds accumulation into microbatches"),
                         (dict(loss_type="mae"), "supports dino/simclr, not mae"),
                         (dict(model=tcfg.model.replace(lora_rank=4)), "LoRA fine-tunes are single-stage")):
            with pytest.raises(ValueError, match=msg):
                build_pp_train_step(tcfg.replace(**bad), device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="build_pp_train_step"):
            build_train_step(tcfg, device="cpu", mesh=mesh)
        return
    state = create_train_state(tcfg, device="cpu")
    px, sp = _batch(1, seed=8)
    state, m = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)(state, px, sp)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
