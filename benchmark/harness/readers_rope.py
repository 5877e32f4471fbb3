"""What the per-layer metrics of the DINOv3 block's kernels share: the
RoPE and SwiGLU launches that the traced training work makes, and their
device time and roofline share. Each returns None where the run has
nothing to read: not on a card, or no launch of the kernel in the trace (a
program without it).

The traced work (``run.traced``: (views, forward passes, backward passes)
a batch) makes one forward call of each kernel a block and forward pass
(the student's, its recomputation, the teacher's) and one backward call a
block and backward pass. Standard error gets the launches in the trace
beside those counts."""

from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from harness import spans, trace
from yardstick import flops, roofline

Work = Callable[[int], tuple[float, float]]


def calls(run: Any) -> tuple[list[int], list[int]]:
    """The views of each forward and each backward call of the traced work."""
    depth = run.model["depth"]
    fwd = [views for views, f, _ in run.traced for _ in range(depth * f)]
    bwd = [views for views, _, b in run.traced for _ in range(depth * b)]
    return fwd, bwd


def _launches(run: Any, prefix: str) -> tuple[list[dict], list[dict]]:
    found = trace.launches(run.trace, lambda n: prefix in n)
    return [e for e in found if f"{prefix}_fwd" in e["name"]], [e for e in found if f"{prefix}_bwd" in e["name"]]


def device_ms(run: Any, prefix: str) -> Optional[float]:
    """Device ms per optimizer step of the kernels whose names hold *prefix*
    over the steps the ``dinox.train.step`` spans count."""
    p = spans.phases(run, spans.TRAIN)
    if p is None or not p.spans[spans.STEP]:
        return None
    fwd, bwd = _launches(run, prefix)
    if not fwd and not bwd:
        return None
    want_fwd, want_bwd = calls(run)
    print(f"cross-check: {len(fwd)} forward and {len(bwd)} backward {prefix} launches in the trace; the "
          f"traced work makes {len(want_fwd)} and {len(want_bwd)}", file=sys.stderr)
    return sum(float(e["dur"]) for e in fwd + bwd) / p.spans[spans.STEP] / 1e3


def roofline_pct(run: Any, prefix: str, fwd_work: Work, bwd_work: Work) -> Optional[float]:
    """The roofline bounds of the calls the traced work makes over the
    device time of the kernels' launches, in %."""
    if not run.on_card:
        return None
    fwd, bwd = _launches(run, prefix)
    if not fwd and not bwd:
        return None
    want_fwd, want_bwd = calls(run)
    bound = (sum(roofline.bound_ms(*fwd_work(v), run.peaks)[0] for v in want_fwd)
             + sum(roofline.bound_ms(*bwd_work(v), run.peaks)[0] for v in want_bwd))
    spent = sum(float(e["dur"]) for e in fwd + bwd) / 1e3
    return 100.0 * bound / spent


def shape(run: Any) -> dict[str, int]:
    m = run.model
    return {"tokens": flops.seq_len(m), "patches": flops.n_patches(m), "dim": m["dim"], "heads": m["heads"],
            "hidden": m["ffn_hidden"]}
