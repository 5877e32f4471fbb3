"""Module 13b, parts 1 and 2: the port's ``(data, model, expert)`` mesh on
one CPU gloo group of four worker processes.

The workers (they import only torch and dinox_torch) join one gloo group
over a TCP store on localhost, spawned once, and run every case on meshes
made from it; the parent holds their results against the port's
one-process step on the global batch and against the JAX package's
``build_train_step`` on the conftest's 8 CPU devices with its own meshes.
The models are float32 and tiny: the reference's ``MOE_MODEL``
(``tests/test_moe.py``; N = 1 + 4 + 2 = 7 tokens, odd, so sequence
parallelism pads). The step cases, two steps each:

* expert parallelism at (data 1, model 1, expert 4) with 4 experts, held
  against JAX's (2, 1, 4) step (``test_moe.py``'s
  ``test_expert_parallel_step_matches_single_device``), and at (2, 1, 2);
* tensor x expert parallelism at (1, 2, 2) with 2 experts, held against
  JAX's (2, 2, 2) step (``test_tensor_and_expert_parallel_compose``);
* MoE under tp 2 at (2, 2, 1), without and with sequence parallelism (the
  latter with factored Adam moments), held against JAX's (4, 2) step.

Metrics at rtol = atol = 1e-5 against the one-process port and against
JAX's step where JAX runs without a mesh, at the reference's own rel 1e-4
where it runs on one; the gathered parameters (and, for the factored case,
every optimizer entry) against the one-process port. Then LoRA under tp 2
(the forward against JAX's tp forward at the reference's atol 2e-4, the
factors' gradients against one process, with dropout), the pretraining CLI
at (1, 2, 2) with MoE, sequence parallelism and factored moments (its
rank-0 checkpoint resumed in one process and read by ``run_export``), and
the CLI's exit 2 when the experts do not divide by the expert axis.
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
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.moe import MoeMlp
from dinox_torch.models.vit import PatchViT
from dinox_torch.parallel import Mesh, ep_param_spec, model_group_share, tp_param_spec
from dinox_torch.parallel.mesh import cut, join
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.train.state import TrainConfig, state_from_jax
from dinox_torch.train.step import METRICS, build_train_step
from dinox_torch.zoo.interop import jax_to_torch_student, torch_to_jax_backbone
from dinox_torch.zoo.safetensors_io import load_file
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import PatchViT as JaxPatchViT
from dinox_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dinox_tpu.parallel.mesh import state_shardings
from dinox_tpu.train import state as jax_state
from dinox_tpu.train import step as jax_step

ROOT = Path(__file__).resolve().parent.parent
S = 32
MOE_MODEL = dict(name="moe-tiny", img_size=32, patch=16, dim=32, depth=2, heads=2, out_dim=64,
                 num_registers=2, dtype="float32", moe_every=2, moe_capacity_factor=2.0)
TRAIN = dict(img_size=32, batch_size=8, lr=1e-3, warmup_steps=2, max_steps=20, train_seed=0)
# name: ((data, model, expert), experts, sequence_parallel, factored_nu,
# the JAX mesh's (model_parallel, expert_parallel) or None for the port alone)
CASES = {
    "ep4": ((1, 1, 4), 4, False, False, (1, 4)),
    "dp2-ep2": ((2, 1, 2), 4, False, False, None),
    "tp2-ep2": ((1, 2, 2), 2, False, False, (2, 2)),
    "moe-tp2": ((2, 2, 1), 4, False, False, (2, 1)),
    "moe-tp2-sp-factored": ((2, 2, 1), 4, True, True, (2, 1)),
}
# A LoRA backbone (the LoRA parity test's, N = 1 + 4 + 4 = 9, odd) with dropout.
LORA_MODEL = dict(name="lora-tiny", img_size=28, patch=14, dim=32, depth=2, heads=2, out_dim=16,
                  scale_aware=True, num_registers=4, dtype="float32", lora_rank=4, lora_alpha=8.0,
                  lora_dropout=0.1)
CLI = ["--config", "vit-small", "--batch-size", "8", "--img-size", "28", "--canvas", "32",
       "--warmup-steps", "2", "--lr", "5e-4", "--seed", "7", "--log-json", "--no-tensorboard",
       "--attn-impl", "pallas", "--device", "cpu", "--synthetic", "--max-steps", "3",
       "--ckpt-every", "2", "--moe-experts", "2", "--moe-every", "4", "--factored-nu"]
CLI_MESH = ["--model-parallel", "2", "--expert-parallel", "2", "--sequence-parallel"]

# -- the worker ---------------------------------------------------------------

WORKER = r'''
import pickle, sys
from pathlib import Path
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
coord, world, rank, out = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])
torch.set_num_threads(1)
from dinox_torch import pretrain
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.vit import PatchViT
from dinox_torch.parallel import (batch_rows, gather_state, init_distributed, make_mesh,
                                  model_group_share, shard_model)
from dinox_torch.parallel import collectives as C
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


def ranks(group):
    return None if group is None else dist.get_process_group_ranks(group)


def layout(mesh):
    mine = (mesh.dp_rank, mesh.tp_rank, mesh.ep_rank, ranks(mesh.data_group), ranks(mesh.model_group),
            ranks(mesh.expert_group))
    every = [None] * world
    dist.all_gather_object(every, mine)
    return every


def steps(shape, experts, sp, factored):
    mesh = make_mesh(model_parallel=shape[1], expert_parallel=shape[2], device="cpu")
    cfg = TrainConfig(model=ModelConfig(**inp["model"], attn_impl="pallas", moe_experts=experts,
                                        sequence_parallel=sp), **inp["train"], factored_nu=factored)
    state = state_from_jax(cfg, inp["trees"][(experts, factored)], mesh=mesh)
    local = {k: tuple(v.shape) for k, v in state.student.state_dict().items()}
    fn = build_train_step(cfg, augment_fn=views, mesh=mesh)
    lo, hi = batch_rows(mesh, cfg.batch_size)
    metrics = []
    for px, spc in inp["batches"]:
        state, m = fn(state, px[:, lo:hi], spc[:, lo:hi])
        metrics.append({k: float(v) for k, v in m.items()})
    full = gather_state(state, mesh)
    return {"metrics": metrics, "center": state.center.numpy(), "local": local, "layout": layout(mesh),
            "mesh": (mesh.dp, mesh.tp, mesh.ep),
            "state": {k: v.detach().numpy() for k, v in full.items()
                      if k.startswith(("student.", "teacher.", "optimizer."))}}


def lora(sp):
    """A LoRA backbone at tp 2; each model group runs the whole batch."""
    mesh = make_mesh(model_parallel=2, device="cpu")
    model = PatchViT(ModelConfig(**inp["lora_model"], attn_impl="pallas", sequence_parallel=sp))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["lora_params"].items()})
    shard_model(model, mesh)
    x, spc = torch.from_numpy(inp["lora_x"]), torch.from_numpy(inp["lora_sp"])
    with torch.no_grad():
        forward = model.eval()(x, spc).numpy()
    model.train().set_lora_generator(torch.Generator().manual_seed(3))
    loss = (model(x, spc) * torch.from_numpy(inp["lora_w"])).sum()
    named = [(n, p) for n, p in model.named_parameters() if ".lora_" in n]
    grads = list(torch.autograd.grad(loss, [p for _, p in named]))
    shares = [i for i, (n, p) in enumerate(named) if model_group_share(n, p, sp)]
    for i, g in zip(shares, C.all_reduce_bucket([grads[i] for i in shares], mesh.model_group)):
        grads[i] = g
    return {"forward": forward, "loss": float(loss.detach()), "grads": {n: g.numpy() for (n, _), g in zip(named, grads)},
            "shares": sorted(named[i][0] for i in shares)}


for name, (shape, experts, sp, factored, _) in inp["cases"].items():
    res[name] = steps(shape, experts, sp, factored)
res["lora"] = {sp: lora(sp) for sp in (False, True)}

# The CLI at (1, 2, 2) with MoE, sequence parallelism and factored moments,
# to step 2 of a 3-step schedule.
argv = inp["cli"] + inp["cli_mesh"] + ["--run-dir", str(out / "cli"), "--stop-after", "2",
                                       "--dist-coordinator", coord, "--dist-processes", str(world),
                                       "--dist-process-id", str(rank)]
res["cli_rc"] = pretrain.main(argv)

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


def _jax_cfg(experts, sp=False, factored=False):
    model = jax_config.ModelConfig(**MOE_MODEL, attn_impl="xla", moe_experts=experts, sequence_parallel=sp)
    return jax_state.TrainConfig(model=model, **TRAIN, factored_nu=factored)


def _jax_start(jcfg):
    """A JAX state whose student is perturbed, so that every pathway carries
    gradient and the router's top-2 margins are not ties."""
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


def _run_jax(jcfg, jstart, mesh):
    state = jax.device_put(jstart, state_shardings(mesh, jstart))
    fn = jax_step.build_train_step(jcfg, mesh=mesh, donate=False, augment_fn=_jax_views)
    metrics = []
    for px, sp in _batches():
        state, m = fn(state, jnp.asarray(px), jnp.asarray(sp))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _run_port(experts, factored, tree):
    cfg = TrainConfig(model=ModelConfig(**MOE_MODEL, attn_impl="pallas", moe_experts=experts),
                      **TRAIN, factored_nu=factored)
    state = state_from_jax(cfg, tree, device="cpu")
    fn = build_train_step(cfg, device="cpu", augment_fn=_torch_views)
    metrics = []
    for px, spc in _batches():
        state, m = fn(state, px, spc)
        metrics.append({k: float(v) for k, v in m.items()})
    from dinox_torch.train.checkpoint import state_tensors

    full = {k: v.detach().numpy() for k, v in state_tensors(state).items()
            if k.startswith(("student.", "teacher.", "optimizer."))}
    return metrics, full, state.center.numpy()


def _lora_inputs():
    """The port's fresh LoRA backbone, perturbed (a non-zero lora_B), as
    both packages' parameters."""
    rng = np.random.default_rng(2)
    model = PatchViT(ModelConfig(**LORA_MODEL), generator=torch.Generator().manual_seed(0))
    params = {k: v.numpy() + 0.05 * rng.normal(size=v.shape).astype(np.float32)
              for k, v in model.state_dict().items()}
    x = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    sp = rng.uniform(0.5, 3.0, size=(4, 3)).astype(np.float32)
    w = rng.normal(size=(4, 9, 32)).astype(np.float32)
    return (jax_config.ModelConfig(**LORA_MODEL), torch_to_jax_backbone(params),
            dict(lora_model=LORA_MODEL, lora_params=params, lora_x=x, lora_sp=sp, lora_w=w))


def _lora_reference(inp):
    """The one-process port: the forward and the LoRA factors' gradients."""
    out = {}
    for sp in (False, True):
        model = PatchViT(ModelConfig(**LORA_MODEL, attn_impl="pallas", sequence_parallel=sp))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["lora_params"].items()})
        x, spc = torch.from_numpy(inp["lora_x"]), torch.from_numpy(inp["lora_sp"])
        with torch.no_grad():
            forward = model.eval()(x, spc).numpy()
        model.train().set_lora_generator(torch.Generator().manual_seed(3))
        loss = (model(x, spc) * torch.from_numpy(inp["lora_w"])).sum()
        named = [(n, p) for n, p in model.named_parameters() if ".lora_" in n]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        out[sp] = {"forward": forward, "loss": float(loss.detach()),
                   "grads": {n: g.numpy() for (n, _), g in zip(named, grads)}}
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the four-rank group once, compute the references in this
    process while it runs, then collect its results."""
    out = tmp_path_factory.mktemp("g4")
    starts = {(e, False): _jax_start(_jax_cfg(e)) for e in (4, 2)}
    s4 = starts[(4, False)]
    starts[(4, True)] = s4.replace(opt_state=jax_state.make_optimizer(_jax_cfg(4, factored=True)).init(s4.student))
    jcfg_lora, lora_params, lora_in = _lora_inputs()
    inputs = dict(S=S, model=MOE_MODEL, train=TRAIN, batches=_batches(), cases=CASES, cli=CLI,
                  cli_mesh=CLI_MESH, trees={k: _as_tree(v) for k, v in starts.items()}, **lora_in)
    (out / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    procs = _spawn(4, out)
    try:
        refs = {"port": {k: _run_port(*k, inputs["trees"][k]) for k in starts}, "jax": {}}
        for name, (_, experts, sp, factored, jmesh) in CASES.items():
            if jmesh is not None:
                mesh = jax_make_mesh(model_parallel=jmesh[0], expert_parallel=jmesh[1])
                refs["jax"][name] = _run_jax(_jax_cfg(experts, sp, factored), starts[(experts, factored)], mesh)
        refs["lora"] = _lora_reference(lora_in)
        mesh = jax_make_mesh(model_parallel=2)
        sharded = jax.device_put(lora_params, state_shardings(mesh, lora_params))
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
        model_tp = JaxPatchViT(jcfg_lora, mesh=mesh)
        refs["lora_jax"] = np.asarray(jax.jit(lambda p, a, b: model_tp.apply({"params": p}, a, b))(
            sharded, jax.device_put(lora_in["lora_x"], sh), jax.device_put(lora_in["lora_sp"], sh)))
        res = _wait(procs, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {"refs": refs, "res": res, "out": out}


def _noise_only(name, shape):
    """The qkv bias's k third, whose gradient is rounding noise (the rule of
    tests/test_torch_train_step.py)."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        mask[shape[0] // 3: 2 * shape[0] // 3] = True
    return mask


def _assert_state_close(got, want, lr):
    assert got.keys() == want.keys()
    close = []
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.startswith("optimizer."):  # moments and factored statistics: relative to the tensor
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max())
        close.append(diff[~_noise_only(k, diff.shape)] <= 1e-5)
    assert np.mean(np.concatenate(close)) >= 0.999


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_one_process_and_jax(group, name):
    """Two steps on each (data, model, expert) layout: every metric against
    the port's one-process step (1e-5) and JAX's step on its mesh (rel
    1e-4), the centre and the gathered parameters (with every optimizer
    entry: the moments, the factored statistics) against the one-process
    port, and each rank's shards the mesh's cut."""
    shape, experts, sp, factored, jmesh = CASES[name]
    res = group["res"][name]
    metrics, state, center = group["refs"]["port"][(experts, factored)]
    assert res["mesh"] == shape
    for i, (got, want) in enumerate(zip(res["metrics"], metrics)):
        assert set(got) == set(METRICS) | {"loss_moe_aux"}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"port step {i + 1} {k}")
    if jmesh is not None:
        for i, (got, want) in enumerate(zip(res["metrics"], group["refs"]["jax"][name])):
            for k in ("loss", "loss_dino", "loss_gram", "loss_moe_aux", "grad_norm", "embed_std",
                      "teacher_entropy", "student_entropy", "lr"):
                assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), f"jax step {i + 1} {k}"
    np.testing.assert_allclose(res["center"], center, rtol=0, atol=1e-6)
    _assert_state_close(res["state"], state, TRAIN["lr"])
    _, tp, ep = shape
    w1, qkv = res["local"]["backbone.blocks.1.moe.w1"], res["local"]["backbone.blocks.0.attn.qkv.weight"]
    assert w1[0] == experts // ep and qkv[0] == 3 * MOE_MODEL["dim"] // tp
    assert res["local"]["backbone.blocks.1.moe.router.weight"] == (experts, MOE_MODEL["dim"])


def test_rank_layout_is_the_reference_grid(group):
    """Ranks laid out as the JAX make_mesh's reshape(W // (tp * ep), tp,
    ep): each rank's (data, model, expert) coordinates and the members of
    its three groups, on every layout of the group."""
    for name, (shape, *_rest) in CASES.items():
        dp, tp, ep = shape
        grid = np.arange(4).reshape(dp, tp, ep)
        for rank, (d, t, e, data, model, expert) in enumerate(group["res"][name]["layout"]):
            assert grid[d, t, e] == rank, name
            assert data == grid[:, t, e].tolist() and model == grid[d, :, e].tolist(), name
            assert expert == (grid[d, t, :].tolist() if ep > 1 else None), name


@pytest.mark.parametrize("sp", [False, True], ids=["tp2", "tp2-sp"])
def test_lora_under_tensor_parallelism(group, sp):
    """A LoRA backbone at tp 2 (base kernels cut by Megatron's rule, factors
    replicated): the forward against JAX's tp forward at the reference's
    atol 2e-4 and against one process; in training mode, with dropout masks
    drawn at the full shape, the loss and every factor's gradient (a share
    of which is summed over the model group) against one process."""
    got, want = group["res"]["lora"][sp], group["refs"]["lora"][sp]
    np.testing.assert_allclose(got["forward"], group["refs"]["lora_jax"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["forward"], want["forward"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["grads"].keys() == want["grads"].keys() and len(want["grads"]) == 16
    for k, w in want["grads"].items():  # float32 sums reassociated: relative to the tensor's scale
        np.testing.assert_allclose(got["grads"][k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=k)
    row_b = {f"blocks.{i}.{m}.lora_B.weight" for i in range(2) for m in ("attn.proj", "mlp.fc2")}
    assert set(got["shares"]) == (set(want["grads"]) if sp else set(want["grads"]) - row_b)


def _losses(run_dir):
    rows = map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
    return {r["step"]: r["loss"] for r in rows}


def test_cli_expert_checkpoint_is_a_one_process_checkpoint(group, tmp_path):
    """python -m dinox_torch.pretrain at (1, 2, 2) with 2 experts in every
    fourth block, sequence parallelism and factored moments, bfloat16 at
    ViT-S width: rank 0's
    checkpoint has a one-process run's keys, shapes and dtypes (expert
    stacks, tp shards and the cut factored statistics joined), one process
    resumes it to step 3, and run_export reads its backbone. The losses keep
    to the one-process run's: step 1 (one bfloat16 forward apart) within
    1e-3, later steps within 2e-2, the bfloat16 gate of the two-process CLI
    twin in tests/test_torch_parallel.py (Adam turns the ranks' differently
    rounded near-zero gradients into +-lr; oneDNN's bfloat16 GEMM also
    rounds a row by the call's row count; measured up to 1.3e-2). The
    joined factored statistics are within 0.2 of the one-process run's in
    relative L2 (bfloat16 gradients put them ~0.05 apart; shards joined in
    the wrong order, or a statistic not averaged over the model group, are
    ~1.0 apart)."""
    cli = group["out"] / "cli"
    assert group["res"]["cli_rc"] == 0
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert pretrain.main(CLI + ["--run-dir", str(straight)]) == 0
    assert pretrain.main(CLI + ["--run-dir", str(resumed), "--resume", str(cli)]) == 0
    a = load_file(cli / "ckpt" / "2" / "state.safetensors")
    b = load_file(straight / "ckpt" / "2" / "state.safetensors")
    assert {k: (v.shape, v.dtype) for k, v in a.items()} == {k: (v.shape, v.dtype) for k, v in b.items()}
    assert "optimizer.backbone.blocks.3.moe.w1.exp_avg_sq_c" in a
    for k in ("optimizer.backbone.blocks.0.attn.qkv.weight.exp_avg_sq_c",
              "optimizer.backbone.blocks.0.mlp.fc2.weight.exp_avg_sq_r",
              "optimizer.backbone.blocks.0.mlp.fc2.weight.exp_avg_sq_c",
              "optimizer.backbone.blocks.3.moe.w1.exp_avg_sq_r"):
        assert np.linalg.norm(a[k] - b[k]) <= 0.2 * np.linalg.norm(b[k]), k
    cfg = json.loads((cli / "config.json").read_text())
    assert cfg["factored_nu"] and cfg["model"]["moe_experts"] == 2 and cfg["model"]["sequence_parallel"]
    ref, got, res = _losses(straight), _losses(cli), _losses(resumed)
    assert sorted(got) == [1, 2] and sorted(res) == [3]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-3, err_msg="step 1")
    for s, loss in {**got, **res}.items():
        np.testing.assert_allclose(loss, ref[s], rtol=2e-2, err_msg=f"step {s}")
    model = load_backbone_from_run(cli, device="cpu")
    want = {k[len("student.backbone."):]: v for k, v in a.items() if k.startswith("student.backbone.")}
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])


@pytest.mark.parametrize("experts", [0, 3])
def test_cli_exits_2_when_experts_do_not_divide(tmp_path, experts):
    """--expert-parallel 2 needs --moe-experts divisible by it (the
    reference's help text; its mesh fails only later): exit 2, nothing
    written, no process group."""
    argv = CLI + ["--run-dir", str(tmp_path / "run"), "--expert-parallel", "2", "--moe-experts", str(experts)]
    assert pretrain.main(argv) == 2
    assert not (tmp_path / "run").exists() and not torch.distributed.is_initialized()


def test_rank_coordinates_and_specs():
    """The rank coordinates of Mesh at (2, 2, 2) against the JAX make_mesh's
    device grid on the 8 CPU devices; ep_param_spec and the factored
    statistics' tp cuts on the port's names; cut and join of an expert
    stack; an MoE layer refuses experts the expert axis does not divide."""
    grid = np.vectorize(lambda d: d.id)(jax_make_mesh(model_parallel=2, expert_parallel=2).devices)
    for rank in range(8):
        m = Mesh(8, rank, 2, 2, None, None, torch.device("cpu"), ep=2)
        assert grid[m.dp_rank, m.tp_rank, m.ep_rank] == rank
        assert m.axis("model")[:2] == (2, m.tp_rank) and m.axis("expert")[:2] == (2, m.ep_rank)
        flat = Mesh(8, rank, 4, 2, None, None, torch.device("cpu"))  # ep 1: the (data, model) layout
        assert (flat.dp_rank, flat.tp_rank, flat.ep_rank) == (rank // 2, rank % 2, 0)
    e = torch.zeros(4, 8, 16)
    for name in ("backbone.blocks.1.moe.w1", "backbone.blocks.1.moe.b2",
                 "optimizer.backbone.blocks.1.moe.w2.exp_avg", "optimizer.encoder.blocks.1.moe.w1.exp_avg_sq_r"):
        assert ep_param_spec(name, e) == (0, 1), name
    assert ep_param_spec("backbone.blocks.1.moe.router.weight", torch.zeros(4, 8)) is None
    assert ep_param_spec("optimizer.backbone.blocks.1.moe.w1.step", torch.zeros(())) is None
    stats = {"backbone.blocks.0.attn.qkv.weight.exp_avg_sq_c": (0, 3),
             "backbone.blocks.0.attn.qkv.weight.exp_avg_sq_r": None,
             "backbone.blocks.0.mlp.fc1.weight.exp_avg_sq_c": (0, 1),
             "backbone.blocks.0.mlp.fc2.weight.exp_avg_sq_r": (0, 1),
             "backbone.blocks.0.attn.proj.weight.exp_avg_sq_c": None,
             "backbone.blocks.0.attn.qkv.bias.exp_avg_sq": (0, 3)}
    for name, want in stats.items():
        assert tp_param_spec(f"optimizer.{name}", torch.zeros(12)) == want, name
    assert model_group_share("backbone.blocks.0.attn.qkv.lora_B.weight", torch.zeros(12, 4), False)
    assert not model_group_share("backbone.blocks.0.attn.proj.lora_B.weight", torch.zeros(12, 4), False)
    assert model_group_share("backbone.blocks.0.attn.proj.lora_B.weight", torch.zeros(12, 4), True)
    assert not model_group_share("backbone.blocks.1.moe.router.weight", torch.zeros(4, 12), True)
    w = torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2)
    parts = [cut(w, (0, 1), 2, r) for r in range(2)]
    assert torch.equal(parts[1], w[2:]) and torch.equal(join(parts, (0, 1)), w)
    with pytest.raises(ValueError, match="moe_experts=4 not divisible by expert axis size 3"):
        MoeMlp(8, 4).set_mesh(Mesh(3, 0, 1, 1, None, None, "cpu", ep=3))


def test_student_names_reach_the_cut_rules():
    """Every MoE expert stack of the interop's student tree is cut by
    ep_param_spec and nothing else is; every tensor-parallel name keeps its
    cut (the rules read the port's names, as the JAX rules read flax's)."""
    jcfg = _jax_cfg(4)
    tree = jax.tree_util.tree_map(np.asarray, jax_state.create_train_state(jcfg, jax.random.key(0)).student)
    names = jax_to_torch_student(tree)
    cut_ep = {k for k, v in names.items() if ep_param_spec(k, v) is not None}
    assert cut_ep == {f"backbone.blocks.1.moe.{w}" for w in ("w1", "w2", "b1", "b2")}
    cut_tp = {k for k, v in names.items() if tp_param_spec(k, v) is not None}
    assert cut_tp == {f"backbone.blocks.{i}.attn.{n}" for i in range(2)
                      for n in ("qkv.weight", "qkv.bias", "proj.weight")} | {
        "backbone.blocks.0.mlp.fc1.weight", "backbone.blocks.0.mlp.fc1.bias", "backbone.blocks.0.mlp.fc2.weight"}
