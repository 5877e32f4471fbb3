"""Readings the per-layer metric files share. Each returns None where the
run has nothing to read: not on a card, or no launch of the kernel in the
trace."""

from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from harness import trace
from yardstick import flops, kinds, roofline

PACKED_FWD = "kernel 1 (packed attention forward)"
PACKED_BWD = "kernels 2/3 (packed attention backward)"


def mfu_pct(run: Any, flops_per_slice: Callable[[dict], float]) -> Optional[float]:
    """The window's rate times the model FLOPs of a slice over the card's
    dense bf16 peak, in %."""
    if not run.on_card or not run.rate:
        return None
    return 100.0 * run.rate * flops_per_slice(run.model) / run.peaks[0]


def idle_pct(run: Any) -> Optional[float]:
    return trace.idle_pct(run.trace) if run.on_card else None


def attention_calls(run: Any, backward: bool = False) -> list[tuple[int, int, int, int]]:
    """(views, tokens, width, heads) of every attention call that the
    traced work makes, from the cell's own shapes: ``run.traced`` lists
    each traced batch as (views, forward passes, backward passes), and a
    pass makes one call per block."""
    m = run.model
    shape = (flops.seq_len(m), m["dim"], m["heads"])
    return [(views, *shape) for views, fwd, bwd in run.traced for _ in range(m["depth"] * (bwd if backward else fwd))]


def roofline_pct(run: Any, kind: str, work, backward: bool = False, part: Optional[str] = None
                 ) -> Optional[float]:
    """The sum of the roofline bounds of the attention calls that the
    traced work makes (:func:`attention_calls`) over the device time of
    every launch of *kind*, in %; None where no launch of *kind* ran. The
    count of launches (those whose name holds *part*, where one call makes
    several) is a cross-check, printed to standard error where it differs."""
    if not run.on_card:
        return None
    found = trace.launches(run.trace, lambda n: kinds.kernel_kind(n) == kind)
    if not found:
        return None
    calls = attention_calls(run, backward)
    launched = sum(1 for e in found if part is None or part in e["name"])
    if launched != len(calls):
        print(f"cross-check: {launched} launches of {kind} in the trace; the traced work makes "
              f"{len(calls)} calls", file=sys.stderr)
    bound = sum(roofline.bound_ms(*work(*s), run.peaks)[0] for s in calls)
    spent = sum(float(e["dur"]) for e in found) / 1e3
    return 100.0 * bound / spent


def attention_fwd_pct(run: Any) -> Optional[float]:
    return roofline_pct(run, PACKED_FWD, roofline.attention_fwd_work)


def attention_bwd_pct(run: Any) -> Optional[float]:
    """Each call's dq and dkv launches: the bound once, the time of both."""
    return roofline_pct(run, PACKED_BWD, roofline.attention_bwd_work, backward=True, part="_dq<")
