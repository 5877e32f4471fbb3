"""train_reduce_device_ms: device ms per optimizer step of the work launched
under ``dinox.train.reduce`` (the data group's gradient all-reduce, nested
in the update) in the traced sub-window (``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "reduce")
