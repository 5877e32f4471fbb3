"""Temperature-resample a combined index CSV across its datasets: the twin
of ``scripts/preprocessing/temperature_resample.py``.

Per-dataset quotas follow n_d^(1/T) temperature weights over the raw sizes
(the quota math of ``dinox_torch.zoo.merge``), small datasets are
oversampled (with replacement) and large ones subsampled, and the
resampled rows are shuffled into one training index, with the JAX script's
``random.Random(seed)`` draws.

    python -m dinox_torch.preprocessing.temperature_resample \\
        --index combined.csv --out combined_t2.csv --temperature 2.0
"""

from __future__ import annotations

import argparse
import random
from collections import defaultdict

from dinox_torch.data.index import load_index_rows, write_index_rows
from dinox_torch.zoo.merge import _allocate_quotas, temperature_weights


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", required=True, help="combined index.csv with a dataset column")
    p.add_argument("--out", required=True)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--total", type=int, default=0,
                   help="total resampled rows (default: same as input)")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    rows = load_index_rows(args.index)
    by_ds: dict[str, list] = defaultdict(list)
    for r in rows:
        by_ds[r.dataset or "unknown"].append(r)
    names = sorted(by_ds)
    sizes = [len(by_ds[n]) for n in names]
    total = args.total or len(rows)
    weights = temperature_weights(sizes, args.temperature)
    quotas = _allocate_quotas(total, weights)

    rng = random.Random(args.seed)
    out_rows = []
    print(f"raw slices: {len(rows)}  T={args.temperature}  target total: {total}")
    for name, size, quota in zip(names, sizes, quotas):
        src = by_ds[name]
        if quota <= size:
            sampled = rng.sample(src, quota)
        else:  # oversample small datasets with replacement
            sampled = list(src) + rng.choices(src, k=quota - size)
        print(f"  {name}: {size} -> {len(sampled)} ({len(sampled) / size:.2f}x)")
        out_rows.extend(sampled)
    rng.shuffle(out_rows)
    write_index_rows(out_rows, args.out)
    print(f"wrote {len(out_rows)} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
