"""train_norm_device_ms: device ms per optimizer step of the LayerNorm
kernels (device kernels whose names hold ``dinox_layer_norm``: the forward,
the backward's dx and its parameters' launch) in the traced sub-window, over
the steps the ``dinox.train.step`` spans count (``harness.spans``). None
where no such kernel ran: a program without them.

Standard error gets the launches in the trace beside those the traced work
makes (``run.traced``: (views, forward passes, backward passes) a batch): a
pass of the backbone runs 2 x depth + 1 norms, one more with the scale
token; passes beyond the student's and the teacher's recompute the blocks'
2 x depth; the student's backward launches two kernels a norm."""

import sys

from harness import spans, trace

PREFIX = "dinox_layer_norm"


def traced_launches(model: dict, traced: list) -> int:
    depth = model["depth"]
    per_pass = 2 * depth + 1 + int(bool(model.get("scale_aware")))
    total = 0
    for _, fwd, bwd in traced:
        recompute = fwd - 2 if bwd else 0
        total += (fwd - recompute) * per_pass + recompute * 2 * depth + 2 * bwd * per_pass
    return total


def read(run):
    p = spans.phases(run, spans.TRAIN)
    if p is None or not p.spans[spans.STEP]:
        return None
    found = trace.launches(run.trace, lambda n: PREFIX in n)
    if not found:
        return None
    print(f"cross-check: {len(found)} LayerNorm kernel launches in the trace; the traced work makes "
          f"{traced_launches(run.model, run.traced)}", file=sys.stderr)
    return sum(float(e["dur"]) for e in found) / p.spans[spans.STEP] / 1e3
