"""A new configuration, mix, metric or cell is new files and entries: the
harness finds each by name, and no existing file changes."""

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

from conftest import BENCH
from harness import spec


def digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_of_the_benchmark_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.mix["kind"] in ("pretrain", "embed_series")
        assert cell.limits is not None, f"{w['name']} has no limits file"
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


def test_new_files_are_found_by_name(tiny_root: Path):
    bench_dir = tiny_root / "benchmark"
    before = digests(bench_dir)
    # A new configuration, a new mix and a new per-layer metric, each a file of its own.
    config = json.loads((bench_dir / "configs/vit-s14-scale.json").read_text())
    config["name"] = "vit-s14-wide-crop"
    config["recipe"]["crop_scale"] = [0.1, 1.0]
    (bench_dir / "configs/vit-s14-wide-crop.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "mixes/embed.series.json").read_text())
    mix["lengths"] = [64] * 16
    (bench_dir / "mixes/embed.short.json").write_text(json.dumps(mix))
    (bench_dir / "metrics/requests_per_s.embed.py").write_text("def read(run):\n    return 2.0 * run.rate\n")
    (bench_dir / "limits/new.embed.short.json").write_text(json.dumps({"emb_gap": 0.01}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vit-s14-wide-crop", "source": "test", "reduced": [], "why": "test",
                             "file": "benchmark/configs/vit-s14-wide-crop.json"})
    bench["workloads"].append({"name": "new.embed.short", "config": "vit-s14-wide-crop", "traffic": "embed.short",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("embed_"):
            m["workloads"].append("new.embed.short")
    bench["per_layer"].append({"name": "requests_per_s.embed", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "embedding path", "moves": "embed_slices_per_s",
                               "workloads": ["new.embed.short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("new.embed.short", root=tiny_root, bench_dir=bench_dir)
    assert cell.config["recipe"]["crop_scale"] == [0.1, 1.0]
    assert cell.mix["lengths"] == [64] * 16
    assert cell.limits == {"emb_gap": 0.01}
    assert [m["name"] for m in cell.per_layer] == ["requests_per_s.embed"]
    assert {m["name"] for m in cell.end_to_end} == {"embed_slices_per_s", "embed_request_p95_ms", "setup_s"}
    reader = spec.metric_reader("requests_per_s.embed", bench_dir)
    assert reader.read(SimpleNamespace(rate=3.0)) == 6.0
    after = digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


def test_the_copy_is_the_benchmark():
    assert (BENCH / "run.py").exists() and (BENCH.parent / "BENCHMARK.json").exists()
