"""A CPU dry run of each mix at a tiny size through the program's plain
versions; the same runs with the timed path broken underneath, which must
come out not correct; and the float8 control and the half-batch fault in
the program's place, which the run's own decision must find not correct
where it finds the program correct."""

import json
import subprocess
import sys

import pytest

from conftest import REPO, TINY_LIMITS, TINY_SEED, last_json, run_copy

CELLS = ("tiny.pretrain.b128x2", "tiny.embed.series")


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(tiny_root, cell):
    out = run_copy(tiny_root, "--workload", cell, "--seed", str(TINY_SEED), "--seconds", "0.5")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out.stdout)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    want = {"setup_s"} | ({"train_slices_per_s"} if "pretrain" in cell else
                          {"embed_slices_per_s", "embed_request_p95_ms"})
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(TINY_LIMITS[cell])
    tail = out.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[0] for line in tail] == list(res["checks"])  # the checks end standard error


@pytest.mark.parametrize("cell", CELLS)
def test_traced_dry_run_gives_no_device_numbers(tiny_root, cell):
    out = run_copy(tiny_root, "--workload", cell, "--seed", str(TINY_SEED), "--seconds", "0.3", "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out.stdout)
    assert res["metrics"] == {}  # a CPU run reads no device metric
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0 and res["correct"] is True


FAULTS = {
    # A step that returns its state unchanged.
    "state_unchanged": ("tiny.pretrain.b128x2", """
import torch, dinox_torch.train.step as S
def build(cfg, device=None, **kw):
    return lambda state, px, sp: (state, {"loss": torch.zeros(())})
S.build_train_step = build
"""),
    # Half of each micro-batch left out, the mean taken over the rest.
    "half_batch": ("tiny.pretrain.b128x2", """
import dinox_torch.train.step as S
real = S.build_train_step
def build(cfg, device=None, **kw):
    step = real(cfg.replace(batch_size=cfg.batch_size // 2), device, **kw)
    return lambda state, px, sp: step(state, px[:, :px.shape[1] // 2], sp[:, :sp.shape[1] // 2])
S.build_train_step = build
"""),
    # The EMA left out: the teacher keeps its weights.
    "no_ema": ("tiny.pretrain.b128x2", """
import torch, dinox_torch.train.step as S
real = S.build_train_step
def build(cfg, device=None, **kw):
    step = real(cfg, device, **kw)
    def run(state, px, sp):
        keep = [p.detach().clone() for p in state.teacher.parameters()]
        state, metrics = step(state, px, sp)
        with torch.no_grad():
            for p, k in zip(state.teacher.parameters(), keep):
                p.copy_(k)
        return state, metrics
    return run
S.build_train_step = build
"""),
    # A wrong Gram term: the student's Gram matrices against its own, not the teacher's.
    "gram_wrong": ("tiny.pretrain.b128x2", """
import dinox_torch.train.step as S
real = S.gram_anchoring_loss
S.gram_anchoring_loss = lambda s, t, group=None: real(s, s, group)
"""),
    # An answer altered where it is produced: each batch's first CLS.
    "answer_altered": ("tiny.embed.series", """
import torch, dinox_torch.zoo.hub as H
real = H.LoadedModel.forward
def forward(self, x, spacing=None):
    out = real(self, x, spacing).clone()
    out[:1, 0] = -out[:1, 0]
    return out
H.LoadedModel.forward = forward
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(tiny_root, fault):
    cell, patch = FAULTS[fault]
    code = patch + "\nimport sys\nsys.path.insert(0, 'benchmark')\nimport run\nsys.exit(run.main(sys.argv[1:]))\n"
    out = subprocess.run([sys.executable, "-c", code, "--workload", cell, "--seed", str(TINY_SEED),
                          "--seconds", "0.5", "--device", "cpu"], cwd=tiny_root, capture_output=True, text=True,
                         timeout=240, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert last_json(out.stdout)["correct"] is False


KINDS = {"tiny.pretrain.b128x2": "program,control,half_batch", "tiny.embed.series": "program,control"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_where_the_program_is(tiny_root, cell):
    out = run_copy(tiny_root, "--workload", cell, "--readings", KINDS[cell], "--seeds", f"{TINY_SEED},2",
                   "--seconds", "0.3")
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert len(rows) == 2 * len(KINDS[cell].split(","))
    for row in rows:
        assert set(row["checks"]) == set(TINY_LIMITS[cell])
        assert row["correct"] is (row["kind"] == "program"), row
