"""Module 13b-3: the port's ``(data, pipe)`` mesh and GPipe step on CPU gloo
process groups, held against ``tests/test_pipeline.py``'s cases.

Worker processes (they import only torch and dinox_torch) join a gloo group
over a TCP store on localhost; one group of two ranks and one of four are
spawned once per module, and each rank writes what it holds. The parent
computes the references meanwhile: the JAX package's ``pipeline_run_blocks``
and sequential ``run_blocks``, its ``build_pp_train_step`` and
``make_pp_loss`` on a (2, 2) mesh of the conftest's CPU devices, and the
port's one-process step. The model is the reference test's ``MODEL`` (dim
32, depth 4, float32, N = 1 + 4 + 2 = 7 tokens).

* two ranks (pp 2): the block stack at M 2; two steps from a JAX PP state,
  with and without remat, and two from the seed with factored moments and
  with SimCLR;
  the composed hop against gloo's native send/recv; ``python -m
  dinox_torch.pretrain --pipeline-parallel 2 --pp-microbatches 4`` to step
  2 of 3, then resumed at pp 2 for step 3;
* four ranks: the block stack at pp 4 (M 4 and 8) and at dp 2 x pp 2 (M 2);
  two dp 2 x pp 2 steps, without and with the spacing jitter; the
  gradients of ``make_pp_loss``.
"""

import functools
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

from dinox_torch import check_checkpoint, pretrain
from dinox_torch.models.config import ModelConfig
from dinox_torch.parallel import Mesh
from dinox_torch.parallel import pipeline as t_pipe
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.train.state import TrainConfig, create_train_state, state_from_jax
from dinox_torch.train.step import METRICS, build_train_step
from dinox_torch.zoo.interop import jax_to_torch_backbone, jax_to_torch_student
from dinox_torch.zoo.safetensors_io import load_file
from dinox_tpu.models import config as jax_config
from dinox_tpu.models.vit import PatchViT as JaxPatchViT
from dinox_tpu.models.vit import TransformerBlock as JaxBlock
from dinox_tpu.models.vit import init_backbone, init_model
from dinox_tpu.parallel import pipeline as j_pipe
from dinox_tpu.train import pp_step as j_pp_step
from dinox_tpu.train import state as jax_state

ROOT = Path(__file__).resolve().parent.parent
S = 32
MODEL = dict(name="pp-tiny", img_size=32, patch=16, dim=32, depth=4, heads=2, out_dim=64,
             num_registers=2, scale_aware=True, dtype="float32")
TRAIN = dict(img_size=32, batch_size=8, lr=1e-3, warmup_steps=2, max_steps=50, koleo_weight=0.1,
             train_seed=0)
M_STEP = 4  # the steps' microbatches: 2 x 8 views, 4 of 4 rows (2 a data rank at dp 2)
# (pp, M, dp) of the block stack; the rows are the reference test's 16.
STACKS = [(2, 2, 1), (4, 4, 1), (4, 8, 1), (2, 2, 2)]
# The CLI at vit-tiny (12 blocks, 6 a stage), bfloat16; --attn-impl pallas
# reaches the stage blocks as xla, so the one-process runs take xla.
CLI = ["--config", "vit-tiny", "--batch-size", "8", "--img-size", "56", "--canvas", "64",
       "--warmup-steps", "2", "--lr", "5e-4", "--seed", "7", "--scale-aware", "--log-json",
       "--no-tensorboard", "--device", "cpu", "--synthetic", "--max-steps", "3", "--ckpt-every", "2"]
PP_CLI = CLI + ["--attn-impl", "pallas", "--pipeline-parallel", "2", "--pp-microbatches", "4"]
ONE_CLI = CLI + ["--attn-impl", "xla"]

# -- the worker ---------------------------------------------------------------

WORKER = r'''
import contextlib, io, pickle, runpy, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
coord, world, rank, out = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])
torch.set_num_threads(1)
from dinox_torch.models.config import ModelConfig
from dinox_torch.models.vit import PatchViT
from dinox_torch.parallel import batch_rows, gather_state, init_distributed
from dinox_torch.parallel import collectives as C
from dinox_torch.parallel.pipeline import (cut_to_stage, gather_stages, make_pp_mesh,
                                           pipeline_run_blocks, stage_blocks)
from dinox_torch.train.pp_step import (build_pp_train_step, create_pp_train_state, make_pp_loss,
                                       reduce_pp_grads)
from dinox_torch.train.state import TrainConfig, state_from_jax

init_distributed(coord, world, rank, device="cpu")
inp = pickle.loads((out / "inputs.pkl").read_bytes())
S = inp["S"]
res = {}


def views(px, gen, aug, rows=None):
    x = px.to(torch.float32)
    v1 = (x[:, :S, :S] - 33000.0) / 1500.0
    v2 = (x[:, -S:, -S:].flip(2) - 32500.0) / 2000.0
    return torch.stack([v1, v2])


def config(pp, **kw):
    model = ModelConfig(**inp["model"], attn_impl="xla", **kw.pop("model", {}))
    return TrainConfig(model=model, **inp["train"], pipeline_parallel=pp, pp_microbatches=inp["m_step"], **kw)


def stack(pp, m):
    mesh = make_pp_mesh(pp, device="cpu")
    vit = PatchViT(ModelConfig(**inp["model"], attn_impl="xla"))
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in inp["backbone"].items()})
    cut_to_stage(vit, mesh)
    lo, hi = batch_rows(mesh, len(inp["tokens"]))
    with torch.no_grad():
        run = pipeline_run_blocks(stage_blocks(vit), torch.from_numpy(inp["tokens"][lo:hi]), mesh, m)
    return {"dp_rank": mesh.dp_rank, "stage": mesh.stage, "rows": (lo, hi),
            "out": None if run.output is None else run.output.numpy(),
            "groups": [dist.get_process_group_ranks(g) for g in (mesh.data_group, mesh.pipe_group)]}


def steps(cfg, mesh, state):
    fn = build_pp_train_step(cfg, augment_fn=views, mesh=mesh)
    lo, hi = batch_rows(mesh, cfg.batch_size)
    metrics = []
    for px, spc in inp["batches"]:
        state, m = fn(state, px[:, lo:hi], spc[:, lo:hi])
        metrics.append({k: float(v) for k, v in m.items()})
    full = gather_state(state, mesh)
    opt = {n: sorted(state.optimizer.state[p]) for n, p in state.student.named_parameters()}
    return {"metrics": metrics, "center": state.center.numpy(),
            "state": {k: v.detach().numpy() for k, v in full.items()
                      if k.startswith(("student.", "teacher.", "optimizer."))},
            "held": {part: sorted(getattr(state, part).state_dict()) for part in ("student", "teacher")},
            "moments": opt}


def cli(argv):
    """python -m dinox_torch.pretrain in this process (the group is reused),
    oneDNN off as the one-process runs it is held to; (rc, stdout)."""
    sys.argv = ["dinox_torch.pretrain", *argv, "--dist-coordinator", coord, "--dist-processes",
                str(world), "--dist-process-id", str(rank)]
    rc = 0
    with torch.backends.mkldnn.flags(enabled=False), contextlib.redirect_stdout(io.StringIO()) as text:
        try:
            runpy.run_module("dinox_torch.pretrain", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            rc = e.code
    return rc, text.getvalue()


if world == 2:
    res["stack_2_2_1"] = stack(2, 2)
    mesh = make_pp_mesh(2, device="cpu")
    res["step"] = steps(config(2), mesh, state_from_jax(config(2), inp["tree"], mesh=mesh))
    cfg = config(2, model=dict(use_grad_checkpoint=True))
    res["remat"] = steps(cfg, mesh, state_from_jax(cfg, inp["tree"], mesh=mesh))
    cfg = config(2, factored_nu=True)
    res["factored"] = steps(cfg, mesh, create_pp_train_state(cfg, mesh=mesh))
    cfg = config(2, loss_type="simclr")
    res["simclr"] = steps(cfg, mesh, create_pp_train_state(cfg, mesh=mesh))

    # The composed hop against gloo's native send/recv, bit for bit.
    pair = mesh.pipe_pairs[1] if rank == 0 else mesh.pipe_pairs[0]
    x = torch.tensor([1.5, -0.0, 0.0, float("nan"), float("inf"), -3e-38, 7.25e12]).repeat(5, 1)
    same = {}
    for t in (x, x.bfloat16(), (x * 3).reshape(5, 7, 1)):
        if rank == 0:
            C.send(t, pair, 1)
            dist.send(t.contiguous(), 1)
        else:
            got = C.recv(t.shape, t.dtype, t.device, pair, 0)
            want = torch.empty_like(t)
            dist.recv(want, 0)
            bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
            same[str(t.dtype) + str(tuple(t.shape))] = torch.equal(got.view(bits), want.view(bits))
    res["hop"] = same

    a, b = out / "cli_pp", out / "cli_pp_resumed"
    res["cli"] = [cli(inp["cli"] + ["--run-dir", str(a), "--stop-after", "2"]),
                  cli(inp["cli"] + ["--run-dir", str(b), "--resume", str(a)])]
else:
    for pp, m, dp in inp["stacks"]:
        if pp * dp == 4:
            res[f"stack_{pp}_{m}_{dp}"] = stack(pp, m)
    mesh = make_pp_mesh(2, device="cpu")
    res["step"] = steps(config(2), mesh, state_from_jax(config(2), inp["tree"], mesh=mesh))
    cfg = config(2, spacing_jitter=0.1)
    res["jitter"] = steps(cfg, mesh, state_from_jax(cfg, inp["tree"], mesh=mesh))

    cfg = config(2)
    state = state_from_jax(cfg, inp["tree"], mesh=mesh)
    lo, hi = batch_rows(mesh, 8)
    batch = torch.from_numpy(inp["grad_batch"][np.r_[lo:hi, 8 + lo:8 + hi]]) if mesh.stage == 0 else None
    grads, _, _ = make_pp_loss(cfg, mesh)(state.student, state.teacher, torch.zeros((1, 64)), batch,
                                          torch.from_numpy(inp["grad_sp"][lo:hi]), (lo, hi, 8))
    grads = reduce_pp_grads(state.student, grads, mesh)
    named = {f"student.{n}": g for (n, _), g in zip(state.student.named_parameters(), grads)}
    res["grads"] = {k: v.numpy() for k, v in gather_stages(named, mesh).items()}

(out / f"result_rank{rank}.pkl").write_bytes(pickle.dumps(res))
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


def _wait(procs: list, out: Path) -> list:
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed rc={p.returncode}\n{o[-2000:]}\n{e[-4000:]}"
    return [pickle.loads((out / f"result_rank{r}.pkl").read_bytes()) for r in range(len(procs))]


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


def _jax_cfg(**kw):
    return jax_state.TrainConfig(model=jax_config.ModelConfig(**MODEL, attn_impl="xla"), **TRAIN,
                                 pipeline_parallel=2, pp_microbatches=M_STEP, **kw)


def _torch_cfg(**kw):
    return TrainConfig(model=ModelConfig(**MODEL, attn_impl="xla"), **TRAIN, pipeline_parallel=2,
                       pp_microbatches=M_STEP, **kw)


def _jax_pp_start(jcfg, mesh):
    """A JAX PP state whose student is perturbed, so that every pathway (the
    scale embedding included) carries gradient: the student and teacher as
    ``{"rest", "blocks"}`` trees, the optimizer initialised on them, as
    ``create_pp_train_state`` makes them."""
    base = jax_state.create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(7)
    student = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), base.student)
    pp = j_pipe.split_model_params(student, 2)
    state = jax_state.TrainState(step=base.step, student=pp, teacher=jax.tree_util.tree_map(jnp.copy, pp),
                                 opt_state=jax_state.make_optimizer(jcfg).init(pp), center=base.center)
    return jax.device_put(state, j_pipe.pp_state_shardings(mesh, state))


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


def _state_dicts(state):
    from dinox_torch.train.checkpoint import state_tensors

    return {k: v.detach().numpy() for k, v in state_tensors(state).items()
            if k.startswith(("student.", "teacher.", "optimizer."))}


def _run_port(cfg, state):
    fn = build_train_step(cfg, device="cpu", augment_fn=_torch_views)
    metrics = []
    for px, spc in _batches():
        state, m = fn(state, px, spc)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _state_dicts(state), state.center.numpy()


@functools.lru_cache(maxsize=1)
def _jax_backbone():
    """The reference test's backbone parameters (numpy), made once."""
    mcfg = jax_config.ModelConfig(**MODEL, attn_impl="xla")
    return jax.tree_util.tree_map(np.asarray, init_backbone(mcfg, jax.random.key(1)))


def _losses(run_dir):
    rows = map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
    return {r["step"]: r["loss"] for r in rows}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn the two- and four-rank groups once, compute the references in
    this process while they run, then collect each rank's results."""
    out2, out4 = tmp_path_factory.mktemp("pp2"), tmp_path_factory.mktemp("pp4")
    mcfg = jax_config.ModelConfig(**MODEL, attn_impl="xla")
    backbone = _jax_backbone()
    x = jnp.asarray(np.random.default_rng(0).normal(size=(16, 32, 32, 3)), jnp.float32)
    tokens = JaxPatchViT(mcfg).apply({"params": backbone}, x, jnp.ones((16, 3), jnp.float32),
                                     method=JaxPatchViT.embed)
    jcfg = _jax_cfg()
    mesh22 = j_pipe.make_pp_mesh(jax.devices()[:4], 2)
    jstart = _jax_pp_start(jcfg, mesh22)
    tree = _as_tree(jstart)
    rng = np.random.default_rng(1)
    grad_batch = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    grad_sp = rng.uniform(0.5, 2.0, (16, 3)).astype(np.float32)[:8]
    inputs = dict(S=S, model=MODEL, train=TRAIN, m_step=M_STEP, tree=tree, batches=_batches(),
                  backbone=jax_to_torch_backbone(jax.tree_util.tree_map(np.asarray, backbone)),
                  tokens=np.asarray(tokens), stacks=STACKS, grad_batch=grad_batch, grad_sp=grad_sp,
                  cli=PP_CLI)
    for out in (out2, out4):
        (out / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    procs2, procs4 = _spawn(2, out2), _spawn(4, out4)
    try:
        refs = {}
        blk = JaxBlock(mcfg.dim, mcfg.heads, mcfg.mlp_ratio, attn_impl="xla", dtype=jnp.float32, lora=(),
                       fused_mlp=False, fused_attn=False, gelu_approx=mcfg.gelu_approx, mesh=None)
        refs["sequential"] = np.asarray(JaxPatchViT(mcfg).apply({"params": backbone}, tokens, True,
                                                                method=JaxPatchViT.run_blocks))
        for pp, m, dp in STACKS:
            mesh = j_pipe.make_pp_mesh(jax.devices()[:pp * dp] if dp > 1 else jax.devices(), pp)
            _, stacked = j_pipe.split_backbone_params(backbone, pp)
            run = jax.jit(lambda st, t, mesh=mesh, m=m: j_pipe.pipeline_run_blocks(
                lambda p, y: blk.apply({"params": p}, y, True), st, t, mesh, m))
            refs[(pp, m, dp)] = np.asarray(run(stacked, tokens))
        # JAX's PP step on the (2, 2) mesh, two steps.
        fn = j_pp_step.build_pp_train_step(jcfg, mesh22, donate=False, augment_fn=_jax_views)
        state, metrics = jstart, []
        for px, spc in _batches():
            state, m = fn(state, jnp.asarray(px), jnp.asarray(spc))
            metrics.append({k: float(v) for k, v in m.items()})
        refs["jax_step"] = (metrics, np.asarray(state.center))
        # JAX's make_pp_loss gradients, merged to the one-device layout.
        loss_fn = j_pp_step.make_pp_loss(jcfg, mesh22)
        pp_grads = jax.jit(jax.grad(loss_fn, has_aux=True))(
            jstart.student, jstart.teacher, jnp.zeros((1, MODEL["out_dim"]), jnp.float32),
            jnp.asarray(grad_batch), jnp.asarray(grad_sp), jax.random.key(7))[0]
        merged = j_pipe.merge_model_params(jax.tree_util.tree_map(np.asarray, pp_grads))
        refs["jax_grads"] = {f"student.{k}": v for k, v in jax_to_torch_student(merged).items()}
        # The port in one process: the same state, and the factored moments from the seed.
        refs["port"] = _run_port(_torch_cfg(), state_from_jax(_torch_cfg(), tree, device="cpu"))
        for name, kw in (("factored", dict(factored_nu=True)), ("simclr", dict(loss_type="simclr"))):
            cfg = _torch_cfg(**kw)
            refs[f"port_{name}"] = _run_port(cfg, create_train_state(cfg, device="cpu"))
        cfg = _torch_cfg(spacing_jitter=0.1)
        refs["port_jitter"] = _run_port(cfg, state_from_jax(cfg, tree, device="cpu"))
        # The CLI in one process, the straight run the pp 2 CLI run is held to.
        refs["straight"] = tmp_path_factory.mktemp("straight")
        with torch.backends.mkldnn.flags(enabled=False):
            assert pretrain.main(ONE_CLI + ["--run-dir", str(refs["straight"])]) == 0
        res2, res4 = _wait(procs2, out2), _wait(procs4, out4)
    finally:
        for p in procs2 + procs4:
            if p.poll() is None:
                p.kill()
    return {"refs": refs, "g2": res2, "g4": res4, "out2": out2}


# -- the parameter layout -------------------------------------------------------


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)) == \
        jax.tree_util.tree_structure(got)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_split_merge_roundtrip_matches_jax():
    """split/merge_backbone_params on a numpy tree: the JAX package's split
    to the bit (leaves (stages, blocks_per_stage, ...)), and the merge its
    inverse."""
    params = _jax_backbone()
    rest, stacked = t_pipe.split_backbone_params(params, 2)
    j_rest, j_stacked = j_pipe.split_backbone_params(params, 2)
    assert "blocks_0" not in rest and "patch_embed" in rest
    assert jax.tree_util.tree_leaves(stacked)[0].shape[:2] == (2, 2)
    _assert_trees_equal(rest, j_rest)
    _assert_trees_equal(stacked, j_stacked)
    _assert_trees_equal(t_pipe.merge_backbone_params(rest, stacked), params)


def test_split_model_params_roundtrip_matches_jax():
    params = jax.tree_util.tree_map(np.asarray, init_model(jax_config.ModelConfig(**MODEL), jax.random.key(2)))
    pp = t_pipe.split_model_params(params, 2)
    assert set(pp) == {"rest", "blocks"} and "head" in pp["rest"]
    _assert_trees_equal(pp, j_pipe.split_model_params(params, 2))
    _assert_trees_equal(t_pipe.merge_model_params(pp), params)
    _assert_trees_equal(t_pipe.merge_model_params(pp), j_pipe.merge_model_params(pp))


def test_split_rejects_indivisible_depth():
    """The reference's refusal, in its words, from the split and the stage cut."""
    params = _jax_backbone()
    for split in (t_pipe.split_backbone_params, j_pipe.split_backbone_params):
        with pytest.raises(ValueError, match="depth=4 not divisible by 3 stages"):
            split(params, 3)
    with pytest.raises(ValueError, match="depth=4 not divisible by 3 stages"):
        t_pipe.stage_block_range(4, 3, 0)
    assert [t_pipe.stage_block_range(12, 4, s) for s in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 12)]


# -- the schedule ---------------------------------------------------------------


@pytest.mark.parametrize("pp,m,dp", STACKS, ids=[f"pp{pp}-m{m}-dp{dp}" for pp, m, dp in STACKS])
def test_pipelined_blocks_match_jax_and_sequential(groups, pp, m, dp):
    """The GPipe schedule over gloo ranks on (data, pipe) meshes, each data
    rank's rows from its last stage put back in order, against JAX's
    pipeline_run_blocks and the sequential run_blocks (atol 1e-5); ranks
    laid out as rank = dp_rank * pp + stage."""
    res = groups["g2" if pp * dp == 2 else "g4"]
    parts = [r[f"stack_{pp}_{m}_{dp}"] for r in res]
    for rank, part in enumerate(parts):
        assert (part["dp_rank"], part["stage"]) == divmod(rank, pp)
        assert part["groups"] == [[d * pp + part["stage"] for d in range(dp)],
                                  [part["dp_rank"] * pp + s for s in range(pp)]]
        assert (part["out"] is None) == (part["stage"] != pp - 1)
    got = np.concatenate([p["out"] for p in parts if p["out"] is not None])
    np.testing.assert_allclose(got, groups["refs"][(pp, m, dp)], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, groups["refs"]["sequential"], rtol=0, atol=1e-5)


def test_pipeline_rejects_bad_microbatches():
    """The reference's three refusals, raised before any hop: fewer
    microbatches than stages, a global batch they do not divide, and a
    microbatch the data axis does not divide; the step raises them when it
    is built."""
    x = torch.zeros((16, 5, 32))
    cases = [((1, 4), 2, "need >= 4 microbatches for 4 stages, got 2"),
             ((1, 2), 3, "batch 16 not divisible into 3 microbatches"),
             ((4, 2), 8, "microbatch size 2 not divisible by data axis size 4")]
    for (dp, pp), m, msg in cases:
        mesh = Mesh(dp * pp, 0, dp, 1, None, None, torch.device("cpu"), pp=pp)
        with pytest.raises(ValueError, match=msg):
            t_pipe.pipeline_run_blocks([], x[:16 // dp], mesh, m)
    # The step checks its microbatches when it is built, before a run writes anything.
    from dinox_torch.train.pp_step import build_pp_train_step

    mesh = Mesh(2, 0, 1, 1, None, None, torch.device("cpu"), pp=2)
    with pytest.raises(ValueError, match="batch 16 not divisible into 3 microbatches"):
        build_pp_train_step(_torch_cfg().replace(pp_microbatches=3), device="cpu", mesh=mesh)
    jmesh = j_pipe.make_pp_mesh(jax.devices(), 4)
    with pytest.raises(ValueError, match="need >= 4 microbatches for 4 stages, got 2"):
        j_pipe.pipeline_run_blocks(lambda p, y: y, {"w": jnp.zeros((4, 1))}, jnp.zeros((8, 5, 32)), jmesh, 2)


def test_make_pp_mesh_refuses_a_world_pp_does_not_divide():
    with pytest.raises(ValueError, match="1 processes not divisible by pp=2"):
        t_pipe.make_pp_mesh(2, device="cpu")
    mesh = t_pipe.make_pp_mesh(1, device="cpu")
    assert (mesh.world, mesh.dp, mesh.pp, mesh.stage, mesh.pipe_group) == (1, 1, 1, 0, None)


# -- the step ---------------------------------------------------------------------


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
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k.startswith("optimizer."):  # moments and factored statistics: relative to the tensor
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max())
        close.append(diff[~_noise_only(k, diff.shape)] <= 1e-5)
    assert np.mean(np.concatenate(close)) >= 0.999


JAX_KEYS = ("loss", "loss_dino", "loss_gram", "loss_koleo", "embed_std", "grad_norm", "teacher_entropy")


@pytest.mark.parametrize("world", [2, 4], ids=["pp2", "dp2-pp2"])
def test_pp_steps_match_jax_and_one_process(groups, world):
    """Two steps from one JAX PP state (carried across by state_from_jax's
    merge) at pp 2 and at dp 2 x pp 2: the reference test's metrics at its
    rel 1e-5 / abs 2e-4 against JAX's build_pp_train_step on the (2, 2)
    mesh, every metric at 1e-5 against the port's one-process step, the
    centre at atol 1e-5 against both, and the gathered state (the
    parameters, the moments) against one process."""
    res = groups[f"g{world}"][0]["step"]
    metrics, state, center = groups["refs"]["port"]
    jax_metrics, jax_center = groups["refs"]["jax_step"]
    for i, (got, want, jwant) in enumerate(zip(res["metrics"], metrics, jax_metrics)):
        assert set(got) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"step {i + 1} {k}")
        for k in JAX_KEYS:
            assert got[k] == pytest.approx(jwant[k], rel=1e-5, abs=2e-4), f"jax step {i + 1} {k}"
    np.testing.assert_allclose(res["center"], center, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["center"], jax_center, rtol=0, atol=1e-5)
    _assert_state_close(res["state"], state, TRAIN["lr"])


def test_pp_spacing_jitter_matches_one_process(groups):
    """The lognormal spacing jitter at dp 2 x pp 2: stage 0 draws it at the
    global shape from build_train_step's generator and takes its data
    rank's rows, so two steps give one process's metrics and state."""
    res = groups["g4"][0]["jitter"]
    metrics, state, center = groups["refs"]["port_jitter"]
    assert res["metrics"][0]["loss"] != groups["g4"][0]["step"]["metrics"][0]["loss"]
    for i, (got, want) in enumerate(zip(res["metrics"], metrics)):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"step {i + 1} {k}")
    np.testing.assert_allclose(res["center"], center, rtol=0, atol=1e-6)
    _assert_state_close(res["state"], state, TRAIN["lr"])


def test_pp_gradients_match_jax(groups):
    """The port's make_pp_loss gradients at dp 2 x pp 2, the rest summed over
    the pipe group and all averaged over the data group, gathered to the
    one-process names, against JAX's make_pp_loss gradients on the (2, 2)
    mesh merged to the one-device layout: each leaf's relative L2 < 1e-4."""
    got, want = groups["g4"][0]["grads"], groups["refs"]["jax_grads"]
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12)
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("world", [2, 4], ids=["pp2", "dp2-pp2"])
def test_ranks_hold_their_stage(groups, world):
    """Each rank's student and teacher hold the rest whole and only their
    stage's blocks, and its optimizer only their moments."""
    depth, pp = MODEL["depth"], 2
    one = groups["refs"]["port"][1]
    for rank, res in enumerate(groups[f"g{world}"]):
        stage = rank % pp
        mine = {stage * depth // pp + j for j in range(depth // pp)}
        for part in ("student", "teacher"):
            want = sorted(k[len(part) + 1:] for k in one if k.startswith(f"{part}.")
                          and (t_pipe.pp_param_spec(k) is None or t_pipe.pp_param_spec(k) in mine))
            assert res["step"]["held"][part] == want, (rank, part)
        moments = res["step"]["moments"]
        assert {t_pipe.pp_param_spec(n) for n in moments} - {None} == mine
        assert all(v == ["exp_avg", "exp_avg_sq", "step"] for v in moments.values())
        assert "backbone.patch_embed.weight" in moments and "head.2.weight" in moments


def test_remat_step_equals_plain_step(groups):
    """use_grad_checkpoint recomputes each stage block in the backward: the
    same metrics, centre and state as the step without it."""
    plain, remat = groups["g2"][0]["step"], groups["g2"][0]["remat"]
    assert remat["metrics"] == plain["metrics"]
    np.testing.assert_array_equal(remat["center"], plain["center"])
    for k, v in plain["state"].items():
        np.testing.assert_array_equal(remat["state"][k], v, err_msg=k)


def test_pp_factored_moments_match_one_process(groups):
    """--factored-nu at pp 2: the port keeps each parameter's one-process
    moments (a 1-D parameter's whole, a weight's r and c of its own layout),
    so two steps from the seed give one process's metrics and, gathered,
    its every optimizer entry."""
    res = groups["g2"][0]["factored"]
    metrics, state, center = groups["refs"]["port_factored"]
    for i, (got, want) in enumerate(zip(res["metrics"], metrics)):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"step {i + 1} {k}")
    np.testing.assert_allclose(res["center"], center, rtol=0, atol=1e-6)
    _assert_state_close(res["state"], state, TRAIN["lr"])
    assert state["optimizer.backbone.blocks.3.norm1.bias.exp_avg_sq"].shape == (MODEL["dim"],)
    assert "optimizer.backbone.blocks.3.attn.qkv.weight.exp_avg_sq_r" in res["state"]


def test_pp_simclr_steps_match_one_process(groups):
    """SimCLR at pp 2 (the student alone, no teacher forward through the
    stages, no EMA): two steps from the seed against one process."""
    res = groups["g2"][0]["simclr"]
    metrics, state, center = groups["refs"]["port_simclr"]
    for i, (got, want) in enumerate(zip(res["metrics"], metrics)):
        assert got["loss_simclr"] > 0 and got["loss_dino"] == 0
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"step {i + 1} {k}")
    np.testing.assert_array_equal(res["center"], center)
    _assert_state_close(res["state"], state, TRAIN["lr"])


def test_jax_pp_factored_nu_is_a_recorded_fault():
    """The fault of the pre-port tree recorded in ROADMAP.md §3: JAX's
    create_pp_train_state builds tx.init on the stacked (S, bps, ...) block
    leaves, so with factored_nu a stage's 1-D parameters get r/c factors
    across its blocks (norm1.bias: r (2, 2), c (2, 32)) where the one-device
    state keeps the moment whole (32,). The port refuses to carry such a nu
    across, naming why."""
    jcfg = _jax_cfg(factored_nu=True)
    mesh = j_pipe.make_pp_mesh(jax.devices()[:4], 2)
    tree = _as_tree(j_pp_step.create_pp_train_state(jcfg, jax.random.key(0), mesh))
    one = _as_tree(jax_state.create_train_state(jcfg, jax.random.key(0)))
    leaf = tree["nu"]["blocks"]["norm1"]["bias"]
    assert {k: np.shape(v) for k, v in leaf.items()} == {"r": (2, 2), "c": (2, MODEL["dim"])}
    assert np.shape(one["nu"]["backbone"]["blocks_0"]["norm1"]["bias"]) == (MODEL["dim"],)
    with pytest.raises(ValueError, match="factored across the stacked"):
        state_from_jax(_torch_cfg(factored_nu=True), tree, device="cpu")


def test_gloo_hop_is_native_send_recv(groups):
    """The composed hop (a broadcast over the stage pair's gloo group: the
    bytes summed, the receiver's zeros) delivers what gloo's native
    send/recv delivers, bit for bit: -0.0, NaN (bfloat16's 0xffff, which
    gloo's bfloat16 sum would turn into 0x7fc0), inf and subnormals,
    float32 and bfloat16."""
    hop = groups["g2"][1]["hop"]
    assert len(hop) == 3 and all(hop.values()), hop


# -- the CLI, checkpoints and export -------------------------------------------------


def test_pretrain_cli_pipeline_parallel(groups, tmp_path):
    """python -m dinox_torch.pretrain --pipeline-parallel 2 --pp-microbatches
    4 on two gloo processes (vit-tiny, bfloat16, 6 blocks a stage) to step 2
    of 3: rank 0 alone logs each step once; step 1 within 1e-5 of one
    process with xla attention (oneDNN off on both sides: its bf16 GEMM rounds
    a row by the call's row count), step 2 within the bfloat16 rule of the
    JAX twin (2e-2). One process resumes its step-2 checkpoint, and so does
    pp 2 (cut back to the stage): the same step-3 loss (1e-5)."""
    out = groups["out2"]
    (rc0, text0), (rc0r, _) = groups["g2"][0]["cli"]
    (rc1, text1), (rc1r, text1r) = groups["g2"][1]["cli"]
    assert (rc0, rc1, rc0r, rc1r) == (0, 0, 0, 0)
    assert "data 1 x pipe 2 (6 blocks a stage), 4 microbatches" in text0 and text1 == text1r == ""
    straight, one = groups["refs"]["straight"], tmp_path / "one"
    with torch.backends.mkldnn.flags(enabled=False):
        assert pretrain.main(ONE_CLI + ["--run-dir", str(one), "--resume", str(out / "cli_pp")]) == 0
    pp, ref, resumed, pp_resumed = (_losses(d) for d in (out / "cli_pp", straight, one, out / "cli_pp_resumed"))
    assert sorted(pp) == [1, 2] and sorted(resumed) == sorted(pp_resumed) == [3]
    assert all(np.isfinite(v) for v in pp.values())
    np.testing.assert_allclose(pp[1], ref[1], rtol=1e-5)
    np.testing.assert_allclose(pp[2], ref[2], rtol=2e-2)
    np.testing.assert_allclose(pp_resumed[3], resumed[3], rtol=1e-5)
    np.testing.assert_allclose(resumed[3], ref[3], rtol=2e-2)


def test_pp_checkpoint_is_a_one_process_checkpoint(groups, capsys):
    """Rank 0's checkpoint of the pp 2 run holds a one-process run's keys,
    shapes and dtypes (every stage's blocks gathered over the pipe group),
    check_checkpoint reads it, and load_backbone_from_run loads its student
    backbone as it stands in the file."""
    run = groups["out2"] / "cli_pp"
    a, b = (load_file(d / "ckpt" / "2" / "state.safetensors") for d in (run, groups["refs"]["straight"]))
    assert {k: (v.shape, v.dtype) for k, v in a.items()} == {k: (v.shape, v.dtype) for k, v in b.items()}
    assert json.loads((run / "config.json").read_text())["pipeline_parallel"] == 2
    assert check_checkpoint.main(["--run-dir", str(run), "--device", "cpu"]) == 0
    assert "step" in capsys.readouterr().out
    model = load_backbone_from_run(run, device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), a[f"student.backbone.{k}"], err_msg=k)
