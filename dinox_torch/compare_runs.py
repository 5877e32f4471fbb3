"""Compare two training runs' loss curves (``metrics.jsonl``) step by step:
the twin of ``scripts/compare_runs.py``, with the same flags and JSON keys.

Built for optimizer-numerics A/Bs (bf16 against f32 Adam moments, a
resumed run against a straight one): aligns the two runs on step and
reports absolute and relative drift over the overlap and over the final
window. Prints one JSON document. Host work only: it reads files.

    python -m dinox_torch.compare_runs runA/metrics.jsonl runB/metrics.jsonl \\
        [--key loss] [--tail 100] [--out cmp.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def load(path: Path, key: str) -> dict[int, float]:
    """{step: value of *key*} over the rows of a ``metrics.jsonl`` that hold
    both; a later row of a step replaces an earlier one. Exits when none do."""
    out: dict[int, float] = {}
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if key in row and "step" in row:
                out[int(row["step"])] = float(row[key])
    if not out:
        raise SystemExit(f"no '{key}' rows in {path}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("a", type=Path)
    p.add_argument("b", type=Path)
    p.add_argument("--key", default="loss")
    p.add_argument("--tail", type=int, default=100,
                   help="final-window size (steps) for the tail comparison")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    ca, cb = load(args.a, args.key), load(args.b, args.key)
    steps = sorted(set(ca) & set(cb))
    if not steps:
        raise SystemExit("no overlapping steps")
    va = np.asarray([ca[s] for s in steps])
    vb = np.asarray([cb[s] for s in steps])
    diff = np.abs(va - vb)
    scale = np.maximum(np.abs(va), 1e-9)
    tail = min(args.tail, len(steps))
    report = {
        "a": str(args.a), "b": str(args.b), "key": args.key,
        "overlap_steps": len(steps),
        "first_step": steps[0], "last_step": steps[-1],
        "max_abs_diff": float(diff.max()),
        "max_rel_diff": float((diff / scale).max()),
        "mean_abs_diff": float(diff.mean()),
        "tail_window": tail,
        "tail_mean_a": float(va[-tail:].mean()),
        "tail_mean_b": float(vb[-tail:].mean()),
        "tail_mean_abs_diff": float(diff[-tail:].mean()),
        "tail_rel_gap": float(abs(va[-tail:].mean() - vb[-tail:].mean())
                              / max(abs(va[-tail:].mean()), 1e-9)),
    }
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
