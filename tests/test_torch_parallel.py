"""Module 13a: the port's (data, model) mesh on CPU gloo process groups.

Worker processes (they import only torch and dinox_torch) join a gloo group
over a TCP store on localhost and run several cases each; the parent holds
them against the port's one-process step on the global batch and against
the JAX package's ``build_train_step`` on the conftest's 8 CPU devices
(``mesh=None``, and ``make_mesh(model_parallel=2)`` for the tensor-parallel
cases). Each group is spawned once:

* two ranks: one step pair at dp 2, tp 2 and tp 2 + sequence parallel
  (N = 7, odd); the KoLeo, NT-Xent, DINO, Gram, MAE and MoE-aux values and
  gradients at dp 2 against the global ones; the collectives' gloo
  composition against gloo's native ops; the pretraining CLI at tp 2 + SP
  (its checkpoint against a one-process one, resumed at dp 2 and in one
  process) and its exit 2 on a batch the data axis does not divide;
* four ranks: dp 2 x tp 2 with sequence parallelism.

Then the CLI twin of ``tests/test_multihost.py``'s two-process test: two
``python -m dinox_torch.pretrain --device cpu --dist-...`` processes over an
index CSV at global bs 8 against the one-process run. Float32 throughout,
metrics at rtol = atol = 1e-5; parameters under the rule of
``tests/test_torch_train_step.py`` (the qkv bias's k third, whose gradient
is rounding noise, held to 2 lr).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch import pretrain
from dinox_torch.data import index as t_index
from dinox_torch.data.png16 import write_png16
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.moe import MoeMlp
from dinox_torch.models.mae import mae_loss
from dinox_torch.ops.flash_attention import flash_attention_packed_sharded
from dinox_torch.parallel import Mesh, batch_rows, make_mesh, make_pp_mesh, tp_param_spec
from dinox_torch.parallel.mesh import cut, join
from dinox_torch.train import losses as t_losses
from dinox_torch.train.state import TrainConfig, state_from_jax
from dinox_torch.train.step import METRICS, build_train_step
from dinox_torch.zoo.safetensors_io import load_file
from dinox_tpu.models import config as jax_config
from dinox_tpu.ops.flash_attention import flash_attention_packed_sharded as jax_sharded
from dinox_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dinox_tpu.parallel.mesh import state_shardings
from dinox_tpu.train import state as jax_state
from dinox_tpu.train import step as jax_step

ROOT = Path(__file__).resolve().parent.parent
S = 32
# img 32 at patch 16 with 2 registers: N = 1 + 4 + 2 = 7, odd.
MODEL = dict(name="par-tiny", img_size=32, patch=16, dim=32, depth=2, heads=4, out_dim=64,
             num_registers=2, dtype="float32", scale_aware=True)
TRAIN = dict(img_size=32, batch_size=8, lr=1e-3, warmup_steps=2, max_steps=50,
             koleo_weight=0.1, train_seed=0)
# (tp, sequence_parallel, spacing_jitter) of the two-rank group's steps. The
# jitter's draws are the port's own (not JAX's), so that case is held to the
# port's one-process step only.
LAYOUTS = [(1, False, 0.0), (2, False, 0.0), (2, True, 0.0), (1, False, 0.1)]
CLI = ["--config", "vit-small", "--batch-size", "8", "--img-size", "28", "--canvas", "32",
       "--warmup-steps", "2", "--lr", "5e-4", "--seed", "7", "--scale-aware", "--log-json",
       "--no-tensorboard", "--attn-impl", "pallas", "--device", "cpu", "--synthetic",
       "--max-steps", "3", "--ckpt-every", "2"]

# -- the worker ---------------------------------------------------------------

WORKER = r'''
import json, pickle, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
coord, world, rank, out = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])
torch.set_num_threads(1)
from dinox_torch import pretrain
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.mae import mae_loss
from dinox_torch.models.moe import MoeMlp
from dinox_torch.parallel import batch_rows, gather_state, init_distributed, make_mesh
from dinox_torch.parallel import collectives as C
from dinox_torch.parallel.mesh import any_rank
from dinox_torch.train import losses as L
from dinox_torch.train.state import TrainConfig, state_from_jax
from dinox_torch.train.step import build_train_step

init_distributed(coord, world, rank, device="cpu")
inp = pickle.loads((out / "inputs.pkl").read_bytes())
S = inp["S"]
res = {}


def views(px, gen, aug, rows=None):
    x = px.to(torch.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0
    return torch.stack([v1, v2])


def steps(tp, sp, jitter=0.0):
    mesh = make_mesh(model_parallel=tp, device="cpu")
    cfg = TrainConfig(model=ModelConfig(**inp["model"], attn_impl="pallas", sequence_parallel=sp),
                      **inp["train"], spacing_jitter=jitter)
    state = state_from_jax(cfg, inp["tree"], mesh=mesh)
    seen = []
    state.student.backbone.blocks[0].norm1.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].shape[1]))
    fn = build_train_step(cfg, augment_fn=views, mesh=mesh)
    lo, hi = batch_rows(mesh, cfg.batch_size)
    metrics = []
    for px, spc in inp["batches"]:
        state, m = fn(state, px[:, lo:hi], spc[:, lo:hi])
        metrics.append({k: float(v) for k, v in m.items()})
    full = gather_state(state, mesh)
    return {"metrics": metrics, "tokens": seen[0], "center": state.center.numpy(),
            "state": {k: v.detach().numpy() for k, v in full.items()
                      if k.startswith(("student.", "teacher."))}}


if world == 2:
    for tp, sp, jitter in inp["layouts"]:
        res[f"step_tp{tp}_sp{int(sp)}_j{jitter}"] = steps(tp, sp, jitter)

    # The losses at dp 2: values and the data-group mean of the gradients.
    mesh = make_mesh(device="cpu")
    g = mesh.data_group
    lo, hi = batch_rows(mesh, inp["B"])
    idx = np.r_[lo:hi, inp["B"] + lo:inp["B"] + hi]
    lossres = {}

    def record(name, value, params, extra=None):
        grads = torch.autograd.grad(value, params)
        lossres[name] = {"value": float(value.detach()),
                         "grads": [C.all_reduce(gr, g, "mean").numpy() for gr in grads],
                         **(extra or {})}

    w = torch.nn.Parameter(torch.from_numpy(inp["w"]))
    f = torch.from_numpy(inp["x"][idx]) @ w
    t = torch.from_numpy(inp["t"][idx])
    d = L.dino_loss(f, t, torch.from_numpy(inp["center"]), group=g)
    record("dino", d.loss, [w], {"center": d.new_center.numpy(), "te": float(d.teacher_entropy),
                                "se": float(d.student_entropy)})
    record("koleo", L.koleo_loss(torch.from_numpy(inp["x"][idx]) @ w, group=g), [w])
    f = torch.from_numpy(inp["x"][idx]) @ w
    b = hi - lo
    record("simclr", L.simclr_loss(f[:b], f[b:], 0.1, group=g), [w])
    fs = torch.from_numpy(inp["tokens"][idx]) @ w
    record("gram", L.gram_anchoring_loss(fs, torch.from_numpy(inp["tokens_t"][idx]), group=g), [w])
    wp = torch.nn.Parameter(torch.from_numpy(inp["wp"]))
    pred = torch.from_numpy(inp["latent"][idx]) @ wp
    record("mae", mae_loss(pred, torch.from_numpy(inp["imgs"][idx]), torch.from_numpy(inp["mask"][idx]),
                           inp["patch"], group=g), [wp])
    moe = MoeMlp(inp["moe_dim"], 4)
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in inp["moe"].items()})
    moe.data_group = g
    _, aux = moe(torch.from_numpy(inp["moe_x"][lo:hi]))
    record("moe_aux", aux, [moe.router.weight])
    res["losses"] = lossres

    # The gloo composition against gloo's native ops.
    x = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) * (rank + 1) - 5
    ok = {}
    for dim in (0, 1):
        for t in (x, x.bfloat16()):
            native = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(native, t, group=g)
            ok[f"all_gather_{dim}_{t.dtype}"] = torch.equal(C.all_gather(t, g, dim), torch.cat(native, dim))
        want = torch.empty_like(x.chunk(2, dim)[0]).movedim(dim, 0).contiguous()
        dist.reduce_scatter_tensor(want, x.movedim(dim, 0).contiguous(), group=g)
        ok[f"reduce_scatter_{dim}"] = torch.equal(C.reduce_scatter(x, g, dim), want.movedim(0, dim))
    xr = x.clone().requires_grad_()
    y = C.gather_rows(xr, g, 1)
    (y * torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)).sum().backward()
    up = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    ok["gather_rows_backward"] = torch.equal(xr.grad, (2 * up).chunk(2, 1)[rank])
    xs = x.clone().requires_grad_()
    z = C.split_to_group(xs, g, 1)
    z.sum().backward()
    ok["split_backward"] = torch.equal(xs.grad, torch.ones_like(x))
    ok["bf16_all_reduce"] = torch.equal(C.all_reduce(torch.ones(3, dtype=torch.bfloat16), g),
                                        torch.full((3,), 2.0, dtype=torch.bfloat16))
    ok["any_rank_stops_all"] = any_rank(rank == 1) and not any_rank(False)  # the loop's agreed stop
    res["collectives"] = ok

    # The CLI on the group: tp 2 + SP to step 2 (of a 3-step schedule), then
    # its checkpoint resumed at dp 2 for step 3; a batch dp does not divide.
    a, b_ = out / "cli_tp2", out / "cli_dp2"
    base = inp["cli"] + ["--dist-coordinator", coord, "--dist-processes", "2",
                         "--dist-process-id", str(rank)]
    bad = [{"8": "7"}.get(x, x) if i == base.index("--batch-size") + 1 else x for i, x in enumerate(base)]
    res["cli_rc"] = [pretrain.main(base + ["--run-dir", str(a), "--model-parallel", "2",
                                           "--sequence-parallel", "--stop-after", "2"])]
    with torch.backends.mkldnn.flags(enabled=False):  # as the one-process resume it is held to
        res["cli_rc"].append(pretrain.main(base + ["--run-dir", str(b_), "--resume", str(a)]))
    res["cli_rc"].append(pretrain.main(bad + ["--run-dir", str(out / "cli_bad")]))
else:
    res["step_dp2_tp2_sp"] = steps(2, True)

if rank == 0:
    (out / "result.pkl").write_bytes(pickle.dumps(res))
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out: Path) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(ROOT), coord, str(world), str(r), str(out)],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _wait(procs: list, out: Path) -> dict:
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed rc={p.returncode}\n{o[-2000:]}\n{e[-4000:]}"
    return pickle.loads((out / "result.pkl").read_bytes())


# -- the references -------------------------------------------------------------


def _jax_views(px, key, aug_cfg):
    x = px.astype(jnp.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:][:, :, ::-1] - 32500.0) / 2000.0
    return jnp.stack([v1, v2])


def _torch_views(px, generator, aug_cfg, rows=None):
    x = px.to(torch.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0
    return torch.stack([v1, v2])


def _jax_start(jcfg):
    """A JAX state whose student is perturbed, so that every pathway (the
    scale embedding included) carries gradient."""
    state = jax_state.create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(7)
    student = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        state.student)
    return jax_state.TrainState(step=state.step, student=student,
                                teacher=jax.tree_util.tree_map(jnp.copy, student),
                                opt_state=jax_state.make_optimizer(jcfg).init(student),
                                center=state.center)


def _as_tree(state):
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(step=np.asarray(state.step), student=np_tree(state.student),
                teacher=np_tree(state.teacher), center=np.asarray(state.center),
                mu=np_tree(adam.mu), nu=np_tree(adam.nu), count=np.asarray(adam.count))


def _batches():
    out = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        out.append((rng.integers(30000, 36000, (1, 8, 48, 48, 3)).astype(np.uint16),
                    rng.uniform(0.5, 2.0, (1, 8, 3)).astype(np.float32)))
    return out


def _loss_inputs():
    rng = np.random.default_rng(3)
    b, k, n, d, patch, lat = 8, 16, 5, 12, 4, 6
    return dict(
        B=b, w=(rng.normal(size=(k, k)) / 4).astype(np.float32),
        x=rng.normal(size=(2 * b, k)).astype(np.float32),
        t=rng.normal(size=(2 * b, k)).astype(np.float32),
        center=(0.1 * rng.normal(size=(1, k))).astype(np.float32),
        tokens=rng.normal(size=(2 * b, n, k)).astype(np.float32),
        tokens_t=rng.normal(size=(2 * b, n, k)).astype(np.float32),
        wp=(rng.normal(size=(lat, patch * patch * 3)) / 3).astype(np.float32),
        latent=rng.normal(size=(2 * b, 4, lat)).astype(np.float32),
        imgs=rng.normal(size=(2 * b, 8, 8, 3)).astype(np.float32),
        mask=np.stack([rng.permutation([1.0, 1.0, 1.0, 0.0]) for _ in range(2 * b)]).astype(np.float32),
        patch=patch, moe_dim=d, moe_x=rng.normal(size=(b, n, d)).astype(np.float32))


def _global_losses(inp):
    """The one-process values and gradients of the worker's loss cases."""
    out = {}

    def record(name, value, params, extra=None):
        out[name] = {"value": float(value.detach()),
                     "grads": [g.numpy() for g in torch.autograd.grad(value, params)], **(extra or {})}

    w = torch.nn.Parameter(torch.from_numpy(inp["w"]))
    f = torch.from_numpy(inp["x"]) @ w
    d = t_losses.dino_loss(f, torch.from_numpy(inp["t"]), torch.from_numpy(inp["center"]))
    record("dino", d.loss, [w], {"center": d.new_center.numpy(), "te": float(d.teacher_entropy),
                                "se": float(d.student_entropy)})
    record("koleo", t_losses.koleo_loss(torch.from_numpy(inp["x"]) @ w), [w])
    f = torch.from_numpy(inp["x"]) @ w
    record("simclr", t_losses.simclr_loss(f[:inp["B"]], f[inp["B"]:], 0.1), [w])
    record("gram", t_losses.gram_anchoring_loss(torch.from_numpy(inp["tokens"]) @ w,
                                                torch.from_numpy(inp["tokens_t"])), [w])
    wp = torch.nn.Parameter(torch.from_numpy(inp["wp"]))
    pred = torch.from_numpy(inp["latent"]) @ wp
    record("mae", mae_loss(pred, torch.from_numpy(inp["imgs"]), torch.from_numpy(inp["mask"]),
                           inp["patch"]), [wp])
    moe = MoeMlp(inp["moe_dim"], 4)
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in inp["moe"].items()})
    _, aux = moe(torch.from_numpy(inp["moe_x"]))
    record("moe_aux", aux, [moe.router.weight])
    return out


def _noise_only(name, shape):
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        mask[shape[0] // 3: 2 * shape[0] // 3] = True
    return mask


def _assert_params_close(got, want, lr):
    assert got.keys() == want.keys()
    close = []
    for k in want:
        assert got[k].shape == want[k].shape, k
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max())
        close.append(diff[~_noise_only(k, diff.shape)] <= 1e-5)
    assert np.mean(np.concatenate(close)) >= 0.999


def _state_dicts(state):
    out = {f"student.{k}": v.detach().numpy() for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v.detach().numpy() for k, v in state.teacher.state_dict().items()})
    return out


def _jax_state_dicts(jstate):
    from dinox_torch.zoo.interop import jax_to_torch_student

    out = {}
    for part in ("student", "teacher"):
        tree = jax.tree_util.tree_map(np.asarray, getattr(jstate, part))
        out.update({f"{part}.{k}": v for k, v in jax_to_torch_student(tree).items()})
    return out


def _run_jax(jcfg, jstart, mesh=None):
    state = jstart
    if mesh is not None:
        state = jax.device_put(state, state_shardings(mesh, state))
    fn = jax_step.build_train_step(jcfg, mesh=mesh, donate=False, augment_fn=_jax_views)
    metrics = []
    for px, sp in _batches():
        state, m = fn(state, jnp.asarray(px), jnp.asarray(sp))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _jax_state_dicts(state), np.asarray(state.center)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn the two- and four-rank groups once, compute the references in
    this process while they run, then collect their results."""
    out2, out4 = tmp_path_factory.mktemp("g2"), tmp_path_factory.mktemp("g4")
    jcfg = jax_state.TrainConfig(model=jax_config.ModelConfig(**MODEL, attn_impl="xla"), **TRAIN)
    jstart = _jax_start(jcfg)
    tree = _as_tree(jstart)
    moe = MoeMlp(12, 4)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    losses_in = dict(_loss_inputs(), moe={k: v.numpy() for k, v in moe.state_dict().items()})
    inputs = dict(S=S, model=MODEL, train=TRAIN, tree=tree, batches=_batches(), layouts=LAYOUTS,
                  cli=CLI, **losses_in)
    for out in (out2, out4):
        (out / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    procs2, procs4 = _spawn(2, out2), _spawn(4, out4)
    try:
        refs = {"losses": _global_losses(losses_in)}
        for sp, jitter in ((False, 0.0), (True, 0.0), (False, 0.1)):  # the port, one process
            tcfg = TrainConfig(model=ModelConfig(**MODEL, attn_impl="pallas", sequence_parallel=sp),
                               **TRAIN, spacing_jitter=jitter)
            state = state_from_jax(tcfg, tree, device="cpu")
            fn = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
            metrics = []
            for px, spc in _batches():
                state, m = fn(state, px, spc)
                metrics.append({k: float(v) for k, v in m.items()})
            refs[f"port_sp{int(sp)}_j{jitter}"] = (metrics, _state_dicts(state), state.center.numpy())
        refs["jax"] = _run_jax(jcfg, jstart)
        mesh = jax_make_mesh(model_parallel=2)
        for sp in (False, True):
            cfg = jcfg.replace(model=jcfg.model.replace(sequence_parallel=sp))
            refs[f"jax_tp2_sp{int(sp)}"] = _run_jax(cfg, jstart, mesh)
        res2, res4 = _wait(procs2, out2), _wait(procs4, out4)
    finally:
        for p in procs2 + procs4:
            if p.poll() is None:
                p.kill()
    return {"refs": refs, "g2": res2, "g4": res4, "out2": out2}


def _check_step(res, refs, sp, jax_key, jitter=0.0):
    lr = TRAIN["lr"]
    against = [("port", refs[f"port_sp{int(sp)}_j{jitter}"])]
    if jax_key is not None:
        against.append(("jax", refs[jax_key]))
    for name, (metrics, params, center) in against:
        for i, (got, want) in enumerate(zip(res["metrics"], metrics)):
            assert set(got) == set(METRICS)
            for k in METRICS:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} step {i + 1} {k}")
        np.testing.assert_allclose(res["center"], center, rtol=0, atol=1e-6)
        _assert_params_close(res["state"], params, lr)


@pytest.mark.parametrize("tp,sp,jitter", LAYOUTS, ids=["dp2", "tp2", "tp2-sp", "dp2-jitter"])
def test_two_rank_steps_match_one_process_and_jax(groups, tp, sp, jitter):
    """Two steps at dp 2, tp 2 and tp 2 + sequence parallelism: every metric,
    the centre and the gathered parameters against the port's one-process
    step and JAX's build_train_step (mesh=None for dp 2, the (4, 2) mesh
    for the tp cases); with the spacing jitter, drawn at the global shape,
    against the port's one-process step."""
    res = groups["g2"][f"step_tp{tp}_sp{int(sp)}_j{jitter}"]
    jax_key = None if jitter else "jax" if tp == 1 else f"jax_tp2_sp{int(sp)}"
    _check_step(res, groups["refs"], sp, jax_key, jitter)
    # Sequence parallelism runs the first norm on a rank's chunk of the 7
    # tokens padded to 8; without it the norm sees all 7.
    assert res["tokens"] == (4 if sp else 7)


def test_dp2_by_tp2_sequence_parallel_step(groups):
    """Four ranks, data 2 x model 2 with sequence parallelism."""
    res = groups["g4"]["step_dp2_tp2_sp"]
    _check_step(res, groups["refs"], True, "jax_tp2_sp1")
    assert res["tokens"] == 4


@pytest.mark.parametrize("name", ["dino", "koleo", "simclr", "gram", "mae", "moe_aux"])
def test_losses_are_global_batch_quantities_at_dp2(groups, name):
    """Each loss's value on a rank, and the data-group mean of the ranks'
    gradients (what the step takes), equal the one-process loss and gradient
    on the global batch. KoLeo's and NT-Xent's gathers sum the rows'
    gradients in their backward; DINO's centre and entropies are global."""
    got, want = groups["g2"]["losses"][name], groups["refs"]["losses"][name]
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5, atol=1e-6)
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    if name == "dino":
        np.testing.assert_allclose(got["center"], want["center"], rtol=1e-6, atol=1e-7)
        for k in ("te", "se"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_gloo_composition_matches_native_gloo(groups):
    """all_gather and reduce_scatter composed from all_reduce (the build gloo
    takes, on CUDA tensors too) equal gloo's native ops on the CPU, the
    differentiable gathers have the backward they state, and a stop asked
    on one rank is every rank's (the loop's SIGINT agreement)."""
    ok = groups["g2"]["collectives"]
    assert ok and all(ok.values()), ok


def _ckpt(run_dir, step):
    return load_file(run_dir / "ckpt" / str(step) / "state.safetensors")


def _losses(run_dir):
    rows = map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
    return {r["step"]: r["loss"] for r in rows}


def test_tp2_checkpoint_is_a_one_process_checkpoint(groups, tmp_path):
    """The CLI at ViT-S width, bfloat16, tp 2 + SP on two ranks: its
    checkpoint has a one-process run's keys, shapes and dtypes; the one
    process and dp 2 resume it to the same step-3 loss (one state, one
    batch; oneDNN off on both sides, see PRETRAIN); its losses keep to the
    one-process run's within the bfloat16 gate of the card's micro-steps
    (1e-2: the row-parallel sums round differently); the CLI exits 2 on a
    global batch the data axis does not divide."""
    out = groups["out2"]
    assert groups["g2"]["cli_rc"] == [0, 0, 2]
    straight, one = tmp_path / "straight", tmp_path / "one"
    assert pretrain.main(CLI + ["--run-dir", str(straight), "--stop-after", "2"]) == 0
    with torch.backends.mkldnn.flags(enabled=False):
        assert pretrain.main(CLI + ["--run-dir", str(one), "--resume", str(out / "cli_tp2")]) == 0
    a, b = _ckpt(out / "cli_tp2", 2), _ckpt(straight, 2)
    assert {k: (v.shape, v.dtype) for k, v in a.items()} == {k: (v.shape, v.dtype) for k, v in b.items()}
    assert json.loads((out / "cli_tp2" / "config.json").read_text())["model"]["sequence_parallel"]
    ref, tp2, dp2, resumed = (_losses(d) for d in (straight, out / "cli_tp2", out / "cli_dp2", one))
    assert sorted(tp2) == [1, 2] and sorted(dp2) == sorted(resumed) == [3]
    np.testing.assert_allclose(resumed[3], dp2[3], rtol=1e-5)
    for s, got in tp2.items():
        np.testing.assert_allclose(got, ref[s], rtol=1e-2, err_msg=f"step {s}")


def test_sharded_attention_dispatch_matches_jax_shard_map():
    """flash_attention_packed_sharded's plain path, run on every (data,
    model) rank's block of one qkv and put back together, against the JAX
    package's under shard_map (interpret mode) on the (4, 2) mesh."""
    rng = np.random.default_rng(11)
    b, n, heads, hd = 4, 7, 4, 8
    qkv = rng.normal(size=(b, n, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(jax_sharded(jnp.asarray(qkv), heads, jax_make_mesh(model_parallel=2)))
    dp, tp = 4, 2
    spec = tp_param_spec("attn.qkv.bias", np.zeros(3 * heads * hd))
    out_rows = []
    for d in range(dp):
        outs = []
        for t in range(tp):
            mesh = Mesh(dp * tp, d * tp + t, dp, tp, None, None, torch.device("cpu"))
            lo, hi = batch_rows(mesh, b)
            block = np.stack([cut(row, spec, tp, t) for row in qkv[lo:hi].reshape(-1, qkv.shape[-1])])
            block = torch.from_numpy(block.reshape(hi - lo, n, -1))
            outs.append(flash_attention_packed_sharded(block, heads, mesh))
        out_rows.append(torch.cat(outs, dim=-1))  # heads' columns in rank order
    np.testing.assert_allclose(torch.cat(out_rows).numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible by model axis"):
        flash_attention_packed_sharded(torch.from_numpy(qkv), 3, Mesh(2, 0, 1, 2, None, None, "cpu"))


def test_tp_param_spec_cuts_and_joins():
    """Megatron's rule on the port's names, and cut/join as inverses (qkv by
    heads: a rank's rows are its heads' q, k and v)."""
    cases = {"backbone.blocks.0.attn.qkv.weight": (0, 3), "backbone.blocks.0.attn.qkv.bias": (0, 3),
             "backbone.blocks.3.mlp.fc1.weight": (0, 1), "backbone.blocks.3.mlp.fc1.bias": (0, 1),
             "backbone.blocks.1.attn.proj.weight": (1, 1), "backbone.blocks.1.mlp.fc2.weight": (1, 1),
             "optimizer.backbone.blocks.0.attn.qkv.weight.exp_avg": (0, 3),
             "backbone.blocks.1.attn.proj.bias": None, "backbone.blocks.1.mlp.fc2.bias": None,
             "backbone.blocks.0.norm1.weight": None, "head.0.weight": None,
             "backbone.scale_embed.mlp.0.weight": None, "backbone.blocks.0.attn.qkv.lora_A.weight": None}
    for name, want in cases.items():
        t = torch.zeros(12, 12) if name.endswith(("weight", "exp_avg")) else torch.zeros(12)
        assert tp_param_spec(name, t) == want, name
    assert tp_param_spec("optimizer.backbone.blocks.0.attn.qkv.weight.step", torch.zeros(())) is None
    w = torch.arange(24 * 5, dtype=torch.float32).reshape(24, 5)
    parts = [cut(w, (0, 3), 2, r) for r in range(2)]
    assert torch.equal(parts[0][:4], w[:4]) and torch.equal(parts[0][4:8], w[8:12])
    assert torch.equal(join(parts, (0, 3)), w)
    assert torch.equal(join([cut(w, (1, 1), 5, r) for r in range(5)], (1, 1)), w)


@pytest.mark.parametrize("what", ["expert", "pipeline"])
def test_module_13b_raises(what):
    """Expert and pipeline parallelism are refused, as the JAX make_mesh and
    make_pp_mesh refuse them, on a world that does not divide by
    model_parallel x expert_parallel or by pp (one process here)."""
    if what == "expert":
        with pytest.raises(ValueError, match="1 processes not divisible by model_parallel=1 x "
                                             "expert_parallel=2"):
            make_mesh(expert_parallel=2, device="cpu")
        return
    with pytest.raises(ValueError, match="1 processes not divisible by pp=2"):
        make_pp_mesh(2, device="cpu")


def test_one_process_mesh_refuses_model_parallel():
    """make_mesh on one process, as the JAX make_mesh on one device."""
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.dp, mesh.tp, mesh.data_group) == (1, 1, 1, None)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, device="cpu")


def test_hardware_follows_the_mesh():
    """detect_hardware's device and host counts are the mesh's."""
    from dinox_torch.utils.hardware import detect_hardware

    hw = detect_hardware(mesh=Mesh(8, 3, 4, 2, None, None, torch.device("cpu"), hosts=2))
    assert (hw.backend, hw.num_devices, hw.num_hosts) == ("cpu", 8, 2)
    assert detect_hardware("cpu").num_hosts == 1


# -- the CLI twin of tests/test_multihost.py ---------------------------------------


def _make_tree(root: Path) -> Path:
    rows = []
    for ds in ("dsa", "dsb"):
        for s in range(2):
            for z in range(5):
                p = root / ds / f"series{s}" / f"{z:03d}.png"
                p.parent.mkdir(parents=True, exist_ok=True)
                arr = np.random.default_rng((ord(ds[-1]), s, z)).integers(30000, 36000, (64, 64))
                write_png16(p, arr.astype(np.uint16))
                rows.append(t_index.IndexRow(png_path=str(p), series_dir=f"{ds}/series{s}", slice_index=z,
                                             encoding="hu16", spacing_x=0.7, spacing_y=0.7,
                                             spacing_z=1.5, dataset=ds))
    index_csv = root / "index.csv"
    t_index.write_index_rows(rows, index_csv)
    return index_csv


# ``python -m dinox_torch.pretrain`` with oneDNN off: the CPU's oneDNN
# bfloat16 GEMM gives a row a result that depends on how many rows the call
# has (a (16, 21, 768) x (768, 192) product differs by 2^-3 in some rows from
# the same rows in a call of half the batch), so a rank's half-batch and the
# one-process batch would not run the same arithmetic per row. PyTorch's own
# kernels compute each row alike whatever the batch.
PRETRAIN = ("import runpy, torch; torch.backends.mkldnn.enabled = False; "
            "runpy.run_module('dinox_torch.pretrain', run_name='__main__', alter_sys=True)")


def _cli(index_csv, run_dir, dist=None):
    cmd = [sys.executable, "-c", PRETRAIN, "--config", "vit-tiny", "--index-csv",
           str(index_csv), "--run-dir", str(run_dir), "--batch-size", "8", "--img-size", "56",
           "--canvas", "64", "--max-steps", "3", "--warmup-steps", "2", "--lr", "5e-4", "--seed", "3",
           "--scale-aware", "--log-json", "--no-tensorboard", "--ckpt-every", "0", "--num-workers", "1",
           "--decoded-cache", "off", "--device", "cpu"]
    if dist is not None:
        coord, nproc, pid = dist
        cmd += ["--dist-coordinator", coord, "--dist-processes", str(nproc), "--dist-process-id", str(pid)]
    return cmd


def test_pretrain_cli_two_process_matches_single(tmp_path):
    """python -m dinox_torch.pretrain as two gloo processes on the CPU, with
    the GLOBAL --batch-size 8 (each rank's loader reads its block of 4 rows
    of every batch), reproduces the one-process run; rank 0 alone writes
    the run dir. Step 1 (global batch content, the loader's blocks, the
    augmentation drawn at the global shape, before any update) within
    1e-5. Later steps as the JAX twin holds them (2e-2): in bfloat16 the
    ranks' partial weight gradients round apart from the whole batch's, and
    Adam turns a near-zero gradient's rounding into +-lr."""
    index_csv = _make_tree(tmp_path / "tree")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    multi = tmp_path / "multi"
    procs = [subprocess.Popen(_cli(index_csv, multi, (coord, 2, pid)), env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    try:
        single = subprocess.run(_cli(index_csv, tmp_path / "single"), env=env, cwd=ROOT,
                                capture_output=True, text=True, timeout=600)
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert single.returncode == 0, single.stderr[-3000:]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{o[-2000:]}\n{e[-3000:]}"
    assert "mesh: 2 processes" in outs[0][0] and outs[1][0] == ""
    ls, lm = _losses(tmp_path / "single"), _losses(multi)
    assert sorted(ls) == sorted(lm) == [1, 2, 3]
    np.testing.assert_allclose(lm[1], ls[1], rtol=1e-5)
    for s in ls:
        np.testing.assert_allclose(lm[s], ls[s], rtol=2e-2, err_msg=f"step {s}")


def test_jax_cli_feeds_a_model_group_different_rows(tmp_path):
    """The fault of the pre-port tree recorded in ROADMAP.md §3: the JAX CLI
    shards its loader by process (scripts/pretrain.py:499-527), so with
    --model-parallel 2 on two processes (a (1, 2) mesh: one data shard that
    both processes hold whole) each process reads a different half-batch for
    what the step takes as one replicated batch. The port shards by data
    rank: both ranks of the model group read the one-process batch."""
    from dinox_tpu.data.index import load_index_rows as jax_rows
    from dinox_tpu.data.pipeline import TrainLoader as JaxLoader

    from dinox_torch.data.pipeline import TrainLoader

    index_csv = _make_tree(tmp_path / "tree")
    jrows, trows = jax_rows(index_csv), t_index.load_index_rows(index_csv)
    jax_cli = [next(iter(JaxLoader(jrows, 8 // 2, seed=3, canvas=64, num_workers=1, host_id=pid,
                                   num_hosts=2))).indices for pid in (0, 1)]
    assert not np.array_equal(jax_cli[0], jax_cli[1])  # one data shard, two different feeds
    mesh = Mesh(2, 1, 1, 2, None, None, torch.device("cpu"))  # tp rank 1 of the one model group
    port = next(iter(TrainLoader(trows, 8 // mesh.dp, seed=3, canvas=64, num_workers=1,
                                 host_id=mesh.dp_rank, num_hosts=mesh.dp))).indices
    one = next(iter(TrainLoader(trows, 8, seed=3, canvas=64, num_workers=1))).indices
    assert np.array_equal(port, one)
    np.testing.assert_array_equal(np.sort(np.concatenate(jax_cli)), np.sort(one))
