"""train_augment_device_ms: device ms per optimizer step of the kernels,
copies and sets launched under ``dinox.train.augment`` (the draws, their
copy to the card, the views), in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "augment")
