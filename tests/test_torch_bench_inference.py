"""python -m dinox_torch.bench_inference in process on the CPU at a tiny
size: the throughput mode and the --slo mode each end with the JAX
script's JSON line (the same keys), and without --device the CLI wants a
card."""

import json

import pytest
import torch

from dinox_torch import bench_inference

TINY = ["--config", "vit-tiny", "--img-size", "28", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("fused", [[], ["--fused-attn"]])
def test_throughput_mode(capsys, fused):
    assert bench_inference.main(TINY + ["--batch-sizes", "1", "3", "--steps", "2", *fused]) == 0
    res = _last_json(capsys.readouterr().out)
    assert set(res) == {"metric", "value", "unit", "batch_size", "all"}
    assert res["metric"] == "vit_tiny_encode_img_per_sec" and res["unit"] == "img/s"
    assert [r["batch_size"] for r in res["all"]] == [1, 3]
    assert all(set(r) == {"batch_size", "img_per_sec", "latency_ms"} for r in res["all"])
    assert res["value"] == max(r["img_per_sec"] for r in res["all"]) > 0


def test_slo_mode(capsys):
    assert bench_inference.main(TINY + ["--slo", "--concurrency", "1", "3",
                                        "--requests-per-client", "2"]) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    assert set(res) == {"metric", "value", "unit", "concurrency", "all"}
    assert res["metric"] == "vit_tiny_serve_p95_ms" and res["unit"] == "ms" and res["concurrency"] == 3
    assert [r["concurrency"] for r in res["all"]] == [1, 3]
    keys = {"concurrency", "p50_ms", "p95_ms", "p99_ms", "req_per_s", "coalesce_ratio"}
    assert all(set(r) == keys and r["coalesce_ratio"] >= 1.0 for r in res["all"])
    assert "service forwards=" in out and "requests=8 " in out


def test_wants_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_inference.main(["--config", "vit-tiny", "--img-size", "28"])
