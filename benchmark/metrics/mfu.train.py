"""mfu.train: the training step's share of the card's dense bf16 peak,
``train_slices_per_s`` times the model FLOPs of a training slice
(``yardstick.flops.train_flops_per_slice``: two views, student forward and
backward and teacher forward, recomputation not counted) over the peak."""

from harness import readers
from yardstick import flops


def read(run):
    return readers.mfu_pct(run, flops.train_flops_per_slice)
