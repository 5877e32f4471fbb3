"""embed_attn_fwd_roofline: kernel 1 in the traced embedding requests:
the sum of the roofline bounds of the calls they make, at the cell's
shapes (each series' full batches and its shorter last batch, one call
per block), over the launches' device time."""

from harness import readers


def read(run):
    return readers.attention_fwd_pct(run)
