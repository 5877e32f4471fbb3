"""train_attn_bwd_roofline: kernels 2/3 (the packed attention backward, the
``attention_bwd_sm90_dq`` and ``_dkv`` launches of one call) in the traced
training steps: the sum of the roofline bounds
(``yardstick.roofline.attention_bwd_work``) of the calls the steps make,
at the cell's shapes (one per block and micro-step), over the device time
of both launches."""

from harness import readers


def read(run):
    return readers.attention_bwd_pct(run)
