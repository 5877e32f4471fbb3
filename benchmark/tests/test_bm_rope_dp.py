"""CPU dry runs of the two newer mix kinds at tiny sizes through the
program's plain versions: ``pretrain_rope`` (a DINOv3-block model: RoPE,
SwiGLU, LayerScale) and ``pretrain_dp`` (two gloo ranks on the CPU, rank 1
started by the driver); each must come out correct, and the float8
control in the program's place not correct. The two-rank cell with the
gradients' all-reduce left out must fail ``grad_dir_gap``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from conftest import BENCH, REPO, last_json, run_copy

TINY_ROPE = dict(dim=64, depth=2, heads=2, img_size=32, out_dim=256, ffn_hidden=128)
TINY_DP = dict(dim=64, depth=2, heads=2, img_size=28, out_dim=256)
SIZES = dict(batch_size=4, accumulation_steps=2, canvas=64, check_steps=2, trace_steps=1)
# Limits of the tiny cells, from their readings on the CPU (seeds 1-3), not
# the real cells'. tiny.rope: program loss_koleo_gap 0.0016-0.0042,
# loss_gram_gap 0.0007-0.0057, update_gap 0.0079-0.019, teacher_gap
# 0.0001-0.0003; float8 control loss_koleo_gap 0.0096-0.026, update_gap
# 0.034-0.048. tiny.dp: program loss_koleo_gap 0.0009-0.0042,
# loss_gram_gap 0.0012-0.0030, update_gap 0.006-0.018, grad_dir_gap
# 0.023-0.052 (seeds 1-4); control loss_gram_gap 0.025-0.087; the
# all-reduce left out grad_dir_gap 0.43-0.64.
DP_LIMITS = {"loss_koleo_gap": 0.01, "loss_gram_gap": 0.01, "update_gap": 0.05, "teacher_gap": 0.01,
             "grad_dir_gap": 0.15}
LIMITS = {
    "tiny.rope": {"loss_koleo_gap": 0.008, "loss_gram_gap": 0.01, "update_gap": 0.03, "teacher_gap": 0.01},
    "tiny.dp": DP_LIMITS,
    "tiny.dp-unreduced": DP_LIMITS,
}
CELLS = {"tiny.rope": ("dinov3-vit7b16-stage", "pretrain.b32x4-ckpt-rope", TINY_ROPE, {}),
         "tiny.dp": ("vit-s14-scale", "pretrain.dp4.b128x2", TINY_DP, {"ranks": 2}),
         "tiny.dp-unreduced": ("vit-s14-scale", "pretrain.dp4.b128x2", TINY_DP,
                               {"ranks": 2, "fault": "unreduced"})}
GOOD = ("tiny.rope", "tiny.dp")


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A copy of the benchmark with the two tiny cells."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (config, mix, model, extra) in CELLS.items():
        conf = json.loads((root / f"benchmark/configs/{config}.json").read_text())
        conf["model"].update(model)
        (root / f"benchmark/configs/{cell}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": cell, "source": "test", "file": f"benchmark/configs/{cell}.json",
                                 "reduced": [], "why": "test"})
        data = {**json.loads((root / f"benchmark/mixes/{mix}.json").read_text()), **SIZES, **extra}
        (root / f"benchmark/mixes/{cell}.json").write_text(json.dumps(data))
        bench["workloads"].append({"name": cell, "config": cell, "traffic": cell, "chips": 1, "why": "test"})
        (root / f"benchmark/limits/{cell}.json").write_text(json.dumps(LIMITS[cell]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and "vits14.pretrain.b128x2" in m["workloads"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("cell", GOOD)
def test_dry_run(root, cell):
    out = run_copy(root, "--workload", cell, "--seed", "1", "--seconds", "0.5", "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out.stdout)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1, res
    assert res["metrics"] == {}  # a CPU run reads no device metric
    assert set(res["checks"]) == set(LIMITS[cell])


@pytest.mark.parametrize("cell", GOOD)
def test_control_is_not_correct_where_the_program_is(root, cell):
    out = run_copy(root, "--workload", cell, "--readings", "program,control", "--seeds", "1,2", "--seconds", "0.3")
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert len(rows) == 4
    for row in rows:
        assert row["correct"] is (row["kind"] == "program"), row


def test_unreduced_gradients_fail_grad_dir_gap(root):
    out = run_copy(root, "--workload", "tiny.dp-unreduced", "--seed", "1", "--seconds", "0.3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out.stdout)
    gap = res["checks"]["grad_dir_gap"]
    assert res["correct"] is False and gap["value"] > gap["limit"], res
