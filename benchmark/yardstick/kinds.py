"""Device kernels sorted by kind, frozen from the program's
``utils/trace_analysis.KINDS``: a hand-written kernel by the number of the
TPU kernel it replaces, cuBLAS GEMM, copy/cast, reduction, elementwise or
other. The first test that matches a kernel's name wins."""

from __future__ import annotations

import re

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
