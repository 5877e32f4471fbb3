"""train_forward_device_ms: device ms per optimizer step of the work launched
under ``dinox.train.student`` and ``dinox.train.teacher`` (the forwards
and heads), in the traced sub-window (``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "student", "teacher")
