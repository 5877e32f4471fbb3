"""train_augment_idle_ms: device idle ms per optimizer step at the gaps whose
midpoint lies in ``dinox.train.augment``, in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_idle_ms(run, "augment")
