"""Nothing a run loads is JAX or the JAX package, and the reference loads
neither them nor the program (top-level module names compared whole)."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, REPO, TINY_SEED, last_json, run_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "dinox_tpu"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_only_torch_numpy_and_itself():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch", "reference"}, path


def test_reference_loads_no_jax_and_no_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.dino, reference.embed, reference.lowp, reference.vit, reference.augment; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True, text=True, check=True,
                         cwd="/").stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"dinox_torch", "harness"}), loaded


def test_harness_sources_never_import_jax():
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" not in path.parts:
            assert not top_level_imports(path) & FORBIDDEN, path


def test_a_run_of_each_mix_loads_no_jax(tiny_root):
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; rc = run.main(sys.argv[1:]); "
            "print({m.split('.')[0] for m in sys.modules} & " + repr(FORBIDDEN) + ", rc)")
    for cell in ("tiny.pretrain.b128x2", "tiny.embed.series"):
        out = subprocess.run([sys.executable, "-c", code, "--workload", cell, "--seed", str(TINY_SEED),
                              "--seconds", "0.5", "--device", "cpu"], cwd=tiny_root, capture_output=True,
                             text=True, timeout=240, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "set() 0"


def test_a_loaded_jax_fails_the_run(tiny_root):
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "sys.path.insert(0, 'benchmark'); import run; sys.exit(run.main(sys.argv[1:]))")
    out = subprocess.run([sys.executable, "-c", code, "--workload", "tiny.embed.series", "--seed", str(TINY_SEED),
                          "--seconds", "0.2", "--device", "cpu"], cwd=tiny_root, capture_output=True, text=True,
                         timeout=240, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1 and "jax" in out.stderr
    assert not out.stdout.strip() or '"correct"' not in out.stdout.strip().splitlines()[-1]


def test_no_card_no_result(tiny_root):
    out = run_copy(tiny_root, "--workload", "tiny.embed.series", "--seconds", "0.2")
    assert out.returncode == 0  # the CPU run is the test's own
    assert last_json(out.stdout)["device"]["platform"] == "cpu"
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny.embed.series"], cwd=tiny_root,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and '"correct"' not in out.stdout
