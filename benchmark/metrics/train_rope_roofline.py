"""train_rope_roofline: the RoPE kernels' share of their roofline in the
traced training steps: the bytes bounds (``yardstick.roofline_rope``: q
and k of the patch rows and the tables, forward and backward alike) of the
calls that the traced work makes, at the cell's shapes, over the device
time of the ``dinox_rope`` launches."""

from harness import readers_rope
from yardstick import roofline_rope


def read(run):
    def fwd(views):
        s = readers_rope.shape(run)
        return roofline_rope.rope_fwd_work(views, s["patches"], s["dim"], s["heads"])

    def bwd(views):
        s = readers_rope.shape(run)
        return roofline_rope.rope_bwd_work(views, s["patches"], s["dim"], s["heads"])

    return readers_rope.roofline_pct(run, "dinox_rope", fwd, bwd)
