"""train_swiglu_device_ms: device ms per optimizer step of the SwiGLU gate's
kernels (device kernels whose names hold ``dinox_swiglu``: forward and
backward) in the traced sub-window, over the steps the ``dinox.train.step``
spans count. Standard error gets their launches beside the traced work's
(``harness.readers_rope``)."""

from harness import readers_rope


def read(run):
    return readers_rope.device_ms(run, "dinox_swiglu")
