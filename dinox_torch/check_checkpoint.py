"""Inspect a run directory of the port: checkpoint steps, config, metric
tail. The twin of ``scripts/check_checkpoint.py`` (its flags plus
``--device``): the latest state is restored on the card unless
``--device cpu``.

    python -m dinox_torch.check_checkpoint --run-dir data/runs/mvp [--tail 5]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from dinox_torch.train.run_export import load_state_from_run
from dinox_torch.utils.platform import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--tail", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device to restore the state on (default cuda; or 'cpu')")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    run = args.run_dir
    if not run.is_dir():
        print(f"error: {run} is not a directory", file=sys.stderr)
        return 2

    cfg_path = run / "config.json"
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        model = cfg.get("model", {})
        print(f"config: {model.get('name')} dim={model.get('dim')} "
              f"depth={model.get('depth')} scale_aware={model.get('scale_aware')} "
              f"batch={cfg.get('batch_size')}x{cfg.get('accumulation_steps')} "
              f"lr={cfg.get('lr')}")

    ckpt_dir = run / "ckpt"
    if ckpt_dir.is_dir():
        steps = sorted(int(d.name) for d in ckpt_dir.iterdir() if d.name.isdigit())
        print(f"checkpoints: {steps} (latest={steps[-1] if steps else None})")
        if steps:
            state, _, meta = load_state_from_run(run, device=device)
            n_params = sum(p.numel() for p in state.student.parameters())
            print(f"latest: step={meta['step']} params={n_params / 1e6:.1f}M "
                  f"center_norm={float(state.center.abs().mean()):.4f} "
                  f"loader_pos=({meta.get('loader_epoch')},{meta.get('loader_batch')})")
    else:
        print("checkpoints: none")

    metrics = run / "metrics.jsonl"
    if metrics.exists():
        lines = metrics.read_text().splitlines()
        print(f"metrics: {len(lines)} steps logged; last {args.tail}:")
        for line in lines[-args.tail:]:
            rec = json.loads(line)
            print("  " + " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                  for k, v in sorted(rec.items())))
    if (run / "EMERGENCY.txt").exists():
        print(f"!! EMERGENCY marker present:\n{(run / 'EMERGENCY.txt').read_text()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
