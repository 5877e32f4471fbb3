"""Hardware bring-up gate for the head-major attention kernel (TPU kernel 4,
``csrc/mha_attention.cu``): the twin of the JAX package's
``scripts/validate_attention.py``. Runs ``flash_attention`` on a long
sequence and checks its numerics and throughput. Exit 1 on any failure.

    python -m dinox_torch.validate_attention [--batch 8 --heads 8 --seq 1024 --dim 64]
                                             [--device cuda|cpu]

q, k and v (``--dim`` is the head dim) are drawn from seed 0 with numpy. On
the card (the default) they are bf16 and go through kernel 4; with
``--device cpu`` they are f32 and go through its plain version. The check
holds sum(out) against the plain ``mha_attention_reference``
(``rel_diff < 1e-2``). Prints the backend, the first call's time (which
includes the kernel's build), ``sum / ref / rel_diff``, the steady time of
one call (host clock over 10 calls, each ending in the sum) with its
TFLOP/s, and PASS or FAIL.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dinox_torch.ops.flash_attention import flash_attention, mha_attention_reference
from dinox_torch.utils.platform import resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    devices = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else ["cpu"])
    print(f"backend={dev.type} devices={devices}", flush=True)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rng = np.random.default_rng(0)
    shape = (args.batch, args.heads, args.seq, args.dim)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).to(dtype)
               for _ in range(3))

    def fn() -> torch.Tensor:
        return flash_attention(q, k, v).float().sum()

    t0 = time.perf_counter()
    got = float(fn())
    print(f"first call (build): {time.perf_counter() - t0:.1f}s", flush=True)
    want = float(mha_attention_reference(q, k, v).float().sum())
    rel = abs(got - want) / max(abs(want), 1e-9)
    ok = bool(np.isfinite(got)) and rel < 1e-2
    print(f"sum={got:.3f} ref={want:.3f} rel_diff={rel:.2e}", flush=True)

    t0 = time.perf_counter()
    n = 10
    for _ in range(n):
        out = fn()
    float(out)
    dt = (time.perf_counter() - t0) / n
    flops = 4 * args.batch * args.heads * args.seq ** 2 * args.dim
    print(f"steady: {dt * 1e3:.2f} ms -> {flops / dt / 1e12:.1f} TFLOP/s", flush=True)
    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
