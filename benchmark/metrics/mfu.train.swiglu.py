"""mfu.train.swiglu: the training step's share of the card's dense bf16
peak for a DINOv3-block model, ``train_slices_per_s`` times the model
FLOPs of a training slice (``yardstick.flops_rope.train_flops_per_slice``:
the SwiGLU block's three MLP matrices, two views, student forward and
backward and teacher forward, recomputation not counted) over the peak."""

from harness import readers
from yardstick import flops_rope


def read(run):
    return readers.mfu_pct(run, flops_rope.train_flops_per_slice)
