"""The port's sweeps (``bench_batch_sweep``, ``tune_throughput``) and the
LoRA ablation runbook against the JAX scripts, loaded by path with
importlib. The port's steps run for real at ViT-T on the CPU; the JAX
steps are stubbed (their rows' keys do not depend on the step), so only
the host code of the JAX scripts runs. The ablation's arms are held to the
``run_arm`` lines and ``COMMON`` of ``scripts/ablation_lora_lidc.sh``,
parsed here."""

import importlib.util
import json
import re
import shlex
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch import ablation_lora_lidc, bench_batch_sweep, tune_throughput
from dinox_torch.data.index import IndexRow, write_index_rows
from dinox_torch.data.png16 import write_png16

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_cli", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_step_stubbed(monkeypatch):
    """The JAX train state and step replaced by a no-op with a finite loss."""
    import dinox_tpu.train.state as j_state
    import dinox_tpu.train.step as j_step

    monkeypatch.setattr(j_state, "create_train_state", lambda cfg, key: {})
    monkeypatch.setattr(j_step, "build_train_step",
                        lambda cfg, donate=False: lambda s, p, sp: (s, {"loss": jnp.float32(1.0)}))


def test_bench_one_row_has_the_jax_scripts_keys(jax_step_stubbed, tmp_path):
    want = _load("bench_batch_sweep").bench_one("vit-tiny", 2, 1, 1, None, 1)
    # One warm-up, one timed and one profiled step: --profile adds the JAX script's
    # categories_ms_per_step (empty on a CPU capture: no device lane), from
    # a Chrome trace under the profile dir.
    got = bench_batch_sweep.bench_one("vit-tiny", 2, 1, 1, tmp_path, 1, device="cpu")
    assert set(got) == set(want) | {"categories_ms_per_step"}
    assert got["batch_size"] == 2 and got["remat"] is False and got["ms_per_step"] > 0
    assert got["mfu"] is None  # no card, no peak
    assert got["categories_ms_per_step"] == {} and (tmp_path / "trace.json").exists()


def test_bench_batch_sweep_exits_1_when_every_batch_size_fails(monkeypatch, tmp_path, capsys):
    def oom(config, bs, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError(f"CUDA out of memory at bs {bs}")

    monkeypatch.setattr(bench_batch_sweep, "bench_one", oom)
    out = tmp_path / "sweep.json"
    assert bench_batch_sweep.main(["--batch-sizes", "2", "4", "--device", "cpu", "--out", str(out)]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"status": "all failed"}
    payload = json.loads(out.read_text())
    assert payload["best"] is None
    assert [r["status"] for r in payload["results"]] == [
        "OutOfMemoryError: CUDA out of memory at bs 2", "OutOfMemoryError: CUDA out of memory at bs 4"]


def test_measure_record_and_summary_have_the_jax_scripts_keys(jax_step_stubbed, tmp_path):
    jtune = _load("tune_throughput")
    argv = ["--synthetic", "--config", "vit-tiny", "--batch-sizes", "2", "--steps", "1", "--warmup",
            "1", "--canvas", "64"]
    assert tune_throughput.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "port")]) == 0
    assert jtune.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    (got,), (want,) = (json.loads((tmp_path / d / "results.json").read_text()) for d in ("port", "jax"))
    assert want["status"] == got["status"] == "ok"
    assert got.keys() == want.keys()
    assert got["bound"] in ("io_bound", "h2d_bound", "compute_bound") and got["step_total_s"] > 0
    assert got["peak_bytes_in_use"] is None  # no card
    port, jax = (json.loads((tmp_path / d / "summary.json").read_text()) for d in ("port", "jax"))
    assert port.keys() == jax.keys() and port["best_config"].keys() == jax["best_config"].keys()
    assert port["max_stable_batch"] == 2 and port["oom_batches"] == []
    heads = [(tmp_path / d / "results.csv").read_text().splitlines()[0] for d in ("port", "jax")]
    assert heads[0] == heads[1]


def test_an_out_of_memory_step_is_an_oom_cell(monkeypatch, tmp_path):
    built = []

    def build(cfg, device=None):
        def step(state, pixels, spacing):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        built.append(cfg.batch_size)
        return step

    monkeypatch.setattr(tune_throughput, "build_train_step", build)
    out = tmp_path / "tune"
    assert tune_throughput.main(["--synthetic", "--config", "vit-tiny", "--batch-sizes", "2", "4",
                                 "--steps", "1", "--warmup", "1", "--canvas", "64", "--device", "cpu",
                                 "--out-dir", str(out)]) == 0
    results = json.loads((out / "results.json").read_text())
    assert built == [2, 4] and [r["status"] for r in results] == ["oom", "oom"]
    assert results[0]["error"].startswith("CUDA out of memory")
    summary = json.loads((out / "summary.json").read_text())
    assert summary["oom_batches"] == [2, 4] and summary["best_config"] is None
    assert summary["max_stable_batch"] == 0


def test_loader_only_matches_the_jax_script(monkeypatch, tmp_path):
    import dinox_tpu.data.pipeline as j_pipeline

    rng = np.random.default_rng(0)
    rows = []
    for s in range(3):
        (tmp_path / f"s{s}").mkdir()
        for z in range(4):
            path = tmp_path / f"s{s}" / f"{z}.png"
            write_png16(path, rng.integers(31000, 34500, (48, 48)).astype(np.uint16), filters=z % 5)
            rows.append(IndexRow(png_path=str(path), series_dir=f"s{s}", slice_index=z, dataset="d"))
    write_index_rows(rows, tmp_path / "index.csv")
    images = {"port": 0, "jax": 0}

    def counting(base, key):
        class Counting(base):
            def __iter__(self):
                for b in super().__iter__():
                    images[key] += len(b.pixels)
                    yield b
        return Counting

    monkeypatch.setattr(tune_throughput, "TrainLoader", counting(tune_throughput.TrainLoader, "port"))
    monkeypatch.setattr(j_pipeline, "TrainLoader", counting(j_pipeline.TrainLoader, "jax"))
    argv = ["--index-csv", str(tmp_path / "index.csv"), "--loader-only", "--batch-sizes", "4",
            "--num-workers", "2", "--prefetch", "2", "--steps", "2", "--warmup", "1", "--canvas", "64",
            "--inflate", "2"]
    assert tune_throughput.main(argv + ["--out-dir", str(tmp_path / "port")]) == 0
    assert _load("tune_throughput").main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    port, jax = (json.loads((tmp_path / d / "results.json").read_text()) for d in ("port", "jax"))
    assert [r.keys() for r in port] == [r.keys() for r in jax]
    assert port[0]["status"] == "ok" and port[0]["mode"] == "loader_only" and port[0]["batch_ms"] > 0
    assert images["port"] == images["jax"] >= 3 * 4  # warm-up and timed batches, at least
    assert tune_throughput.main(["--loader-only", "--out-dir", str(tmp_path / "x")]) == 2


def _runbook():
    """COMMON and the run_arm lines of the shell runbook, its variables
    left as names."""
    text = (SCRIPTS / "ablation_lora_lidc.sh").read_text()
    common = shlex.split(re.search(r"COMMON=\((.*?)\n\)", text, re.S).group(1), comments=True)
    all_arms = re.search(r"\n  all\)\n(.*?)\n    ;;", text, re.S).group(1)
    arms = [shlex.split(line.strip())[1:] for line in all_arms.splitlines()]
    single = {m.group(1): shlex.split(m.group(2))[1:]
              for m in re.finditer(r"^  (\w+)\)\s+(run_arm .*?) ;;$", text, re.M)}
    return common, arms, single


def test_ablation_arms_equal_the_runbook(monkeypatch, tmp_path, capsys):
    common, arms, single = _runbook()
    calls = []

    def fake_main(argv):
        calls.append(list(argv))
        out = Path(argv[argv.index("--out") + 1])
        out.mkdir(parents=True, exist_ok=True)
        (out / "history.json").write_text(json.dumps(
            [{"epoch": 0, "auroc": 0.5}, {"epoch": 1, "auroc": 0.8125}, {"epoch": 2}]))
        return 0

    monkeypatch.setattr(ablation_lora_lidc.finetune_lora, "main", fake_main)
    base = str(tmp_path / "adapters")
    monkeypatch.setenv("ADAPTER_BASE", base)
    monkeypatch.setenv("SEED", "7")
    values = {"$BACKBONE": "run", "$TRAIN_CSV": "train.csv", "$VAL_CSV": "val.csv", "$SEED": "7"}
    want_common = [values.get(a, a) for a in common]
    assert ablation_lora_lidc.main(["run", "train.csv", "val.csv"]) == 0
    want = [want_common + ["--out", f"{base}/{name}"] + extra for name, *extra in arms]
    assert calls == want and len(calls) == 4
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["==== arm: baseline ====", f"{base}/baseline: best val AUROC = 0.8125"]
    assert len(out) == 8

    for arm, (name, *extra) in single.items():
        calls.clear()
        assert ablation_lora_lidc.main(["run", "train.csv", "val.csv", arm]) == 0
        assert calls == [want_common + ["--out", f"{base}/{name}"] + extra]
    assert set(single) == {"baseline", "rank", "unfreeze", "crop128"}

    monkeypatch.delenv("ADAPTER_BASE")
    monkeypatch.delenv("SEED")
    calls.clear()
    monkeypatch.chdir(tmp_path)
    assert ablation_lora_lidc.main(["run", "train.csv", "val.csv", "baseline"]) == 0
    assert calls[0][calls[0].index("--seed") + 1] == "42"
    assert calls[0][calls[0].index("--out") + 1] == "adapters/ablation-lidc/baseline"
    assert ablation_lora_lidc.main(["run", "train.csv", "val.csv", "bogus"]) == 2
    assert ablation_lora_lidc.main(["run", "train.csv"]) == 2


def test_best_auroc_reads_a_history(tmp_path):
    (tmp_path / "history.json").write_text(json.dumps(
        [{"epoch": 0, "loss": 0.7, "auroc": 0.61}, {"epoch": 1, "loss": 0.6, "auroc": 0.74},
         {"epoch": 2, "loss": 0.5, "auroc": 0.7}]))
    assert ablation_lora_lidc.best_auroc(tmp_path) == 0.74
