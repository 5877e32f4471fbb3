"""mfu.train.cards: a data-parallel training cell's share of its cards'
dense bf16 peak: the global ``train_slices_per_s`` times the model FLOPs of
a training slice (``yardstick.flops.train_flops_per_slice``) over the peak
of one card times the mix's ``ranks``."""

from harness import readers
from yardstick import flops


def read(run):
    value = readers.mfu_pct(run, flops.train_flops_per_slice)
    return None if value is None else value / int(run.mix["ranks"])
