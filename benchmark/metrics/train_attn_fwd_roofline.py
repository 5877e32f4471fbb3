"""train_attn_fwd_roofline: kernel 1 (the packed attention forward,
device kernels named ``attention_fwd_sm90`` with the packed rounding) in
the traced training steps: the sum of the roofline bounds
(``yardstick.roofline.attention_fwd_work``) of the calls the steps make,
at the cell's shapes (each micro-step's two views through the student,
the teacher and any recomputation, one call per block), over the
launches' device time."""

from harness import readers


def read(run):
    return readers.attention_fwd_pct(run)
