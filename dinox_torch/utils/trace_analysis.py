"""Aggregate ``torch.profiler`` Chrome traces by kind of device work: the
port's twin of ``dinox_tpu.utils.trace_analysis`` (which groups a
``jax.profiler`` trace by HLO category).

``prof.export_chrome_trace`` (the trainer's ``profile/trace_step<N>.json``)
and ``tensorboard_trace_handler`` (``*.pt.trace.json``) write
``traceEvents``; device-lane events are complete ("X") events whose ``cat``
is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, with ``dur`` in
microseconds. Each is put in one kind: a ported kernel by the number of the
TPU kernel it replaces (kernel 6's attention launch runs kernel 1's core
and counts as kernel 1), cuBLAS GEMM, copy/cast, reduction, elementwise or
other. A trace with no device lane (a CPU capture) gives an empty table,
as the JAX aggregation does.
"""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Optional

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
# (kind, test on the kernel's name), first match wins.
KINDS = [
    ("kernel 6 (fused attention half-block)", lambda n: "fused_attn_block" in n),
    ("kernel 7 (fused MLP forward)", lambda n: "fused_mlp_fwd" in n),
    ("kernel 8 (fused MLP backward)", lambda n: "fused_mlp_bwd" in n),
    ("kernel 4 (head-major attention forward)",
     lambda n: "attention_fwd_sm90" in n and re.search(r"Rounding\)1|Rounding::Normalised", n) is not None),
    ("kernel 1 (packed attention forward)", lambda n: "attention_fwd_sm90" in n),
    ("kernel 5 (head-major attention backward)",
     lambda n: "attention_bwd_sm90" in n and re.search(r"<\d+, false>", n) is not None),
    ("kernels 2/3 (packed attention backward)", lambda n: "attention_bwd_sm90" in n),
    ("cuBLAS GEMM", lambda n: any(w in n for w in ("nvjet", "gemm", "cutlass", "sm90_xmma"))),
    ("copy/cast", lambda n: "copy_kernel" in n or n.startswith("Memcpy") or n.startswith("Memset")),
    ("reduction", lambda n: "reduce_kernel" in n or "reduction" in n.lower()),
    ("elementwise", lambda n: "elementwise" in n or "multi_tensor_apply" in n),
]


def kernel_kind(name: str) -> str:
    return next((kind for kind, test in KINDS if test(name)), "other")


def find_trace_files(trace_dir: str | Path) -> list[Path]:
    """All Chrome trace files under a profiler output dir, newest first."""
    root = Path(trace_dir)
    files = {*root.rglob("*trace*.json"), *root.rglob("*trace*.json.gz")}
    return sorted(files, key=lambda p: p.stat().st_mtime, reverse=True)


def load_trace_events(path: str | Path) -> list[dict]:
    p = Path(path)
    raw = gzip.open(p, "rt") if p.suffix == ".gz" else open(p, "rt")
    with raw as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def aggregate_by_kind(events: list[dict], steps: Optional[int] = None) -> dict[str, dict]:
    """Sum device-lane duration per kind of work.

    Returns {kind: {"ms": total_ms, "count": n, "ms_per_step": ...}},
    largest first; ms_per_step only when ``steps`` is given."""
    total_us: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in _DEVICE_CATS:
            continue
        kind = kernel_kind(str(ev.get("name", "")))
        total_us[kind] += float(ev.get("dur", 0.0))
        count[kind] += 1
    out: dict[str, dict] = {}
    for kind, us in sorted(total_us.items(), key=lambda kv: -kv[1]):
        row = {"ms": us / 1e3, "count": count[kind]}
        if steps:
            row["ms_per_step"] = us / 1e3 / steps
        out[kind] = row
    return out


def summarize_trace_dir(trace_dir: str | Path, steps: Optional[int] = None) -> dict:
    """Aggregate the newest trace file under ``trace_dir``."""
    files = find_trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no trace json under {trace_dir}")
    cats = aggregate_by_kind(load_trace_events(files[0]), steps=steps)
    return {"trace_file": str(files[0]), "steps": steps, "categories": cats}


def format_category_table(cats: dict[str, dict], top: int = 12) -> str:
    lines = [f"{'kind':<44} {'ms/step':>9} {'count':>7}"]
    for name, row in list(cats.items())[:top]:
        ms = row.get("ms_per_step", row["ms"])
        lines.append(f"{name:<44} {ms:>9.2f} {row['count']:>7}")
    return "\n".join(lines)


def device_ops(prof) -> list[tuple[float, int, str]]:
    """(device ms, count, name) of every op with device time in a finished
    ``torch.profiler.profile``, largest first."""
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
