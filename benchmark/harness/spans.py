"""The program's phase spans in a traced window, and the device work and
idle time under each.

``dinox_torch`` marks its phases with ``torch.profiler.record_function``
ranges named ``dinox.<family>.<phase>``: the family ``dinox.train.`` (the
step and its leaves: augment, student, teacher nested in loss, backward,
reduce nested in update) and ``dinox.embed.`` (transform, forward). They are host
events (``user_annotation``) of the same Chrome trace as the kernels.

:func:`attribute` puts each device event of a :class:`harness.trace.Trace`
down to a span of one family in two steps: the host event with the same
``External id`` (the op that launched it), then the innermost span of the
family whose interval holds that op's start. The match is by time, not by
thread: autograd runs the backward's ops on a thread of its own while the
step's thread waits inside ``dinox.train.backward``. Each idle gap
(:func:`harness.trace.gaps`) goes to the innermost span of the family that
holds its midpoint. Device events that match no host event are counted
apart. As cross-checks, standard error gets their share of the window's
device time and, for each outermost span with inner ones (the step), the
share of the device time under it that lies in an inner one.

The readers return None off the card and where the trace has no span of the
family (a program without the spans).
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Any, Optional

from harness import trace

TRAIN = "dinox.train."
EMBED = "dinox.embed."
STEP = TRAIN + "step"
FORWARD = EMBED + "forward"


@dataclass
class Phases:
    """What a window's device did under the spans of one family, in us:
    ``device_us`` and ``idle_us`` by the innermost span's name (None:
    under none), ``launches`` the kernel events under each span name at
    any depth, ``spans`` how many spans of each name the window holds."""

    spans: Counter = field(default_factory=Counter)
    device_us: dict = field(default_factory=lambda: defaultdict(float))
    under_us: dict = field(default_factory=lambda: defaultdict(float))
    launches: Counter = field(default_factory=Counter)
    idle_us: dict = field(default_factory=lambda: defaultdict(float))
    unmatched_us: float = 0.0
    total_us: float = 0.0


class _Tree:
    """A family's spans, properly nested, sorted by start, each with its parent."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent: list[int] = []
        open_: list[int] = []
        for i, (_, b, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] < b:  # ends before this one: not around it
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, t: float) -> int:
        """The index of the innermost span holding *t*, or -1. A span that
        starts later than another and holds *t* lies inside it, so from the
        last span to start by *t* the walk goes up through parents only."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i

    def names(self, i: int) -> list[str]:
        """The names of span *i* and of every span around it."""
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out


def _external_id(e: dict[str, Any]) -> Optional[int]:
    return (e.get("args") or {}).get("External id")


def attribute(tr: trace.Trace, family: str) -> Phases:
    """The :class:`Phases` of *family* (``TRAIN`` or ``EMBED``) in *tr*."""
    tree = _Tree([(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
                  for e in tr.host if e.get("cat") == "user_annotation" and str(e["name"]).startswith(family)])
    out = Phases(spans=Counter(name for _, _, name in tree.spans))
    launched_at = {ext: float(e["ts"]) for e in tr.host if (ext := _external_id(e)) is not None}
    for e in tr.device:
        dur = float(e["dur"])
        out.total_us += dur
        t = launched_at.get(_external_id(e))
        if t is None:
            out.unmatched_us += dur
            continue
        i = tree.innermost(t)
        out.device_us[tree.spans[i][2] if i >= 0 else None] += dur
        for name in set(tree.names(i)):
            out.under_us[name] += dur
            if e.get("cat") == "kernel":
                out.launches[name] += 1
    for a, b in trace.gaps(tr):
        i = tree.innermost((a + b) / 2.0)
        out.idle_us[tree.spans[i][2] if i >= 0 else None] += b - a
    if out.spans:
        _cross_check(out, tree, family)
    return out


def _cross_check(p: Phases, tree: _Tree, family: str) -> None:
    outer = {tree.spans[i][2] for i, up in enumerate(tree.parent) if up < 0}
    with_inner = outer & {tree.spans[up][2] for up in tree.parent if up >= 0}
    for name in sorted(with_inner):
        inner = 100.0 * (1.0 - p.device_us.get(name, 0.0) / p.under_us[name]) if p.under_us[name] else float("nan")
        print(f"spans: {inner:.3f}% of the device time under {name} lies in an inner span", file=sys.stderr)
    unmatched = 100.0 * p.unmatched_us / p.total_us if p.total_us else float("nan")
    print(f"spans {family}*: {unmatched:.3f}% of the window's device time matches no host event", file=sys.stderr)


def phases(run: Any, family: str) -> Optional[Phases]:
    """The run's :class:`Phases` of *family*, worked out once per run; None
    off the card or where the trace has no span of the family."""
    if not run.on_card:
        return None
    cache = vars(run).setdefault("_phases", {})
    if family not in cache:
        cache[family] = attribute(run.trace, family)
    return cache[family] if cache[family].spans else None


def train_device_ms(run: Any, *leaves: str) -> Optional[float]:
    """Device ms per optimizer step whose innermost span is one of *leaves*."""
    p = phases(run, TRAIN)
    if p is None or not p.spans[STEP]:
        return None
    return sum(p.device_us.get(TRAIN + leaf, 0.0) for leaf in leaves) / p.spans[STEP] / 1e3


def train_idle_ms(run: Any, leaf: str) -> Optional[float]:
    """Device idle ms per optimizer step at gaps whose midpoint is innermost in *leaf*."""
    p = phases(run, TRAIN)
    if p is None or not p.spans[STEP]:
        return None
    return p.idle_us.get(TRAIN + leaf, 0.0) / p.spans[STEP] / 1e3


def train_launches_per_step(run: Any) -> Optional[float]:
    p = phases(run, TRAIN)
    if p is None or not p.spans[STEP]:
        return None
    return p.launches[STEP] / p.spans[STEP]


def _slices(run: Any) -> int:
    return sum(views for views, _, _ in run.traced)


def embed_device_us(run: Any, phase: str) -> Optional[float]:
    """Device us per slice embedded under ``dinox.embed.<phase>``."""
    p = phases(run, EMBED)
    if p is None or not p.spans[EMBED + phase]:
        return None
    return p.device_us.get(EMBED + phase, 0.0) / _slices(run)


def embed_idle_us(run: Any, phase: str) -> Optional[float]:
    """Device idle us per slice at gaps whose midpoint is in ``dinox.embed.<phase>``."""
    p = phases(run, EMBED)
    if p is None or not p.spans[EMBED + phase]:
        return None
    return p.idle_us.get(EMBED + phase, 0.0) / _slices(run)


def embed_launches_per_batch(run: Any) -> Optional[float]:
    p = phases(run, EMBED)
    if p is None or not p.spans[FORWARD]:
        return None
    return p.launches[FORWARD] / p.spans[FORWARD]
