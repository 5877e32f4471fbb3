"""The tiny cells on the card, through the program's kernels (run with
``python -m pytest benchmark/tests -m cuda`` on a machine with a card)."""

import pytest

from conftest import TINY_SEED, last_json, run_copy


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("tiny.pretrain.b128x2", "tiny.embed.series"))
def test_tiny_cell_on_the_card(tiny_root, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_copy(tiny_root, "--workload", cell, "--seed", str(TINY_SEED), "--seconds", "1", "--trace", "1",
                   device="cuda", timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out.stdout)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["metrics"], "a traced run on the card reads its per-layer metrics"
