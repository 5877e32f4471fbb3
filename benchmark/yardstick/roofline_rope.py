"""Roofline work of the DINOv3 block's memory-bound kernels
(``yardstick.roofline``'s convention: each input read once, each output
written once), bf16 activations and float32 tables.

- RoPE forward and backward alike: the q and k columns of the patch rows
  read and written, and the (patches, hd/2) cos and sin tables read. The
  backward kernel works out of place and so also copies v and the
  unrotated rows; the bound leaves that copy out, as a rotation in place
  would not make it.
- SwiGLU forward: ``[u | g]`` read, ``z`` written; backward: ``[u | g]`` and
  ``dz`` read, ``[du | dg]`` written.

Operations: 3 a rotated element (two products and a sum), 4 and 10 an
element of the gate's forward and backward; memory bounds every one."""

from __future__ import annotations

from yardstick.roofline import BF16

F32 = 4


def rope_fwd_work(views: int, patches: int, dim: int, heads: int) -> tuple[float, float]:
    rotated = views * patches * 2 * dim
    tables = 2 * patches * (dim // heads // 2)
    return 2.0 * BF16 * rotated + F32 * tables, 3.0 * rotated


def rope_bwd_work(views: int, patches: int, dim: int, heads: int) -> tuple[float, float]:
    return rope_fwd_work(views, patches, dim, heads)


def swiglu_fwd_work(rows: int, hidden: int) -> tuple[float, float]:
    return BF16 * rows * 3.0 * hidden, 4.0 * rows * hidden


def swiglu_bwd_work(rows: int, hidden: int) -> tuple[float, float]:
    return BF16 * rows * 5.0 * hidden, 10.0 * rows * hidden
