"""train_backward_device_ms: device ms per optimizer step of the work
launched under ``dinox.train.backward`` (autograd's backward,
recomputation included), in the traced sub-window (``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "backward")
