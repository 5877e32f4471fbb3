"""train_swiglu_roofline: the SwiGLU gate kernels' share of their roofline
in the traced training steps: the bytes bounds
(``yardstick.roofline_rope``) of the forward and backward calls that the
traced work makes (each call one view batch's tokens by ``ffn_hidden``),
over the device time of the ``dinox_swiglu`` launches."""

from harness import readers_rope
from yardstick import roofline_rope


def read(run):
    def fwd(views):
        s = readers_rope.shape(run)
        return roofline_rope.swiglu_fwd_work(views * s["tokens"], s["hidden"])

    def bwd(views):
        s = readers_rope.shape(run)
        return roofline_rope.swiglu_bwd_work(views * s["tokens"], s["hidden"])

    return readers_rope.roofline_pct(run, "dinox_swiglu", fwd, bwd)
