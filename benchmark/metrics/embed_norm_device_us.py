"""embed_norm_device_us: device us per slice embedded of the LayerNorm
kernels (device kernels whose names hold ``dinox_layer_norm``) in the traced
sub-window (``harness.spans``). None where no such kernel ran: a program
without them. Standard error gets the launches in the trace beside those
the traced batches make: 2 x depth + 1 norms a forward, one more with the
scale token."""

import sys

from harness import spans, trace

PREFIX = "dinox_layer_norm"


def read(run):
    p = spans.phases(run, spans.EMBED)
    if p is None or not p.spans[spans.FORWARD]:
        return None
    found = trace.launches(run.trace, lambda n: PREFIX in n)
    if not found:
        return None
    per_pass = 2 * run.model["depth"] + 1 + int(bool(run.model.get("scale_aware")))
    print(f"cross-check: {len(found)} LayerNorm kernel launches in the trace; the traced batches "
          f"make {per_pass * sum(fwd for _, fwd, _ in run.traced)}", file=sys.stderr)
    return sum(float(e["dur"]) for e in found) / sum(views for views, _, _ in run.traced)
