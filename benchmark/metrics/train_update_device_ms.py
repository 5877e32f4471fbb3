"""train_update_device_ms: device ms per optimizer step of the work launched
under ``dinox.train.update`` (accumulation, metric means, the gradient
norm, AdamW, the EMA, the LR), in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "update")
