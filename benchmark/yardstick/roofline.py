"""Roofline bounds, frozen from the program's ``utils/roofline.py``: the
least time a card could take for a function's work, the larger of its bytes
over the memory rate and its operations over the peak rate. Each input is
counted read once and each output written once."""

from __future__ import annotations

BF16 = 2


def bound_ms(moved_bytes: float, flops: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") for *peaks* = (FLOP/s, B/s)."""
    t_ops, t_bytes = flops / peaks[0] * 1e3, moved_bytes / peaks[1] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_fwd_work(b: int, n: int, dim: int, heads: int) -> tuple[float, float]:
    """(bytes, FLOPs) of packed attention forward: qkv in, out out, bf16."""
    hd = dim // heads
    return BF16 * b * n * (3 * dim + dim), 4.0 * b * heads * n * n * hd


def attention_bwd_work(b: int, n: int, dim: int, heads: int) -> tuple[float, float]:
    """Its backward: qkv and dO in, dqkv out; S, dV, dP, dQ, dK products."""
    hd = dim // heads
    return BF16 * b * n * (3 * dim + dim + 3 * dim), 10.0 * b * heads * n * n * hd
