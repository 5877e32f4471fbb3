"""mfu.embed: the embedding path's share of the card's dense bf16 peak,
``embed_slices_per_s`` times the backbone's forward FLOPs of one view (no
head: the embedding path runs none) over the peak."""

from harness import readers
from yardstick import flops


def read(run):
    return readers.mfu_pct(run, flops.embed_flops_per_slice)
