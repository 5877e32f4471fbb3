"""The benchmark of dinox_torch, the PyTorch and CUDA port, on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json``: set-up (the program's state, the
weights and inputs from the seed, the warm-up), a measured window of
``--seconds``, with ``--trace 1`` a profiled sub-window after it, then the
comparison of what the window's path produced with the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the same numbers end standard error.

Readings for setting limits (no result line; one JSON line per seed and
kind, with the numbers, ``checks`` and ``correct`` as a run decides them,
the window's path or the reference of *kind* in its place):

    python3 benchmark/run.py --workload <cell> --readings program,control --seeds 1,2,3 [--seconds s]

``--device cpu`` skips the look for a card and runs the program's plain
versions on the CPU, for the tests at tiny sizes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "dinox_tpu")


def process_start() -> float:
    """The process's start on the wall clock (Linux's ``/proc/self/stat``),
    or the first line of this file where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time() - (time.perf_counter() - T_START)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--readings", default=None, help="comma-separated kinds: program, control, half_batch")
    ap.add_argument("--seeds", default=None, help="comma-separated seeds for --readings")
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_for(args, chips: int):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {chips} CUDA device(s); {have} available")
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def device_info(dev, chips: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def per_layer(cell, dev, drv, tr) -> dict:
    """The cell's per-layer metrics that its readers find something for."""
    from harness import spec
    from yardstick import flops

    name = "" if dev.type != "cuda" else __import__("torch").cuda.get_device_name(dev)
    run = SimpleNamespace(model=drv.model, mix=cell.mix, rate=drv.rate, trace=tr, traced=drv.traced_batches,
                          peaks=flops.card_peaks(name), on_card=dev.type == "cuda")
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, checks): each compared number with its limit; correct
    when no answer failed and every compared number is finite and within
    its limit. The numbers not compared go to standard error."""
    for k in sorted(set(numbers) - set(limits)):
        print(f"{k} {numbers[k]!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": numbers.get(k, math.nan), "limit": limit} for k, limit in limits.items()}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def readings(args, cell, dev, driver_cls) -> int:
    kinds = args.readings.split(",")
    for seed in [int(s) for s in (args.seeds or str(args.seed)).split(",")]:
        t = time.perf_counter()
        drv = driver_cls(cell, dev, seed)
        drv.setup()
        res = drv.window(args.seconds)
        drv.release()
        for kind in kinds:
            numbers = drv.check(kind)
            row = {"workload": cell.name, "seed": seed, "kind": kind, **numbers}
            if cell.limits is not None:
                failed = res["failed"] if kind == "program" else 0
                row["correct"], row["checks"] = verdict(numbers, cell.limits, failed)
            print(json.dumps({**row, "seconds": time.perf_counter() - t}), flush=True)
        del drv
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness import spec, trace
    from harness.drivers import driver_class

    cell = spec.find_cell(args.workload)
    dev = device_for(args, cell.chips)
    driver_cls = driver_class(cell.mix["kind"])
    if args.readings:
        return readings(args, cell, dev, driver_cls)
    if cell.limits is None:
        raise SystemExit(f"no limits/{cell.name}.json: the cell's comparison has no limits")

    print(f"process start to set-up {time.time() - process_start():.3f} s", file=sys.stderr)
    drv = driver_cls(cell, dev, args.seed)
    drv.setup()
    setup_s = time.time() - process_start()
    res = drv.window(args.seconds)
    device = device_info(dev, cell.chips)
    result = {"correct": False, "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        tr = drv.traced()
        result["metrics"] = per_layer(cell, dev, drv, tr)
        device.update(busy_s=trace.busy_s(tr), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(tr), "idle_gaps": trace.idle_gaps(tr)}
    else:
        values = {**res["metrics"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device
    drv.release()
    result["correct"], result["checks"] = verdict(drv.check("program"), cell.limits, res["failed"])
    checks = result["checks"]
    found = forbidden_modules()
    if found:
        print(f"loaded modules that the benchmark must not load: {', '.join(found)}", file=sys.stderr)
        return 1
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
