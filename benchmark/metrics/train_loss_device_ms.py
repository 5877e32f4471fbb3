"""train_loss_device_ms: device ms per optimizer step of the work launched
under ``dinox.train.loss`` and not under its nested teacher (DINO, the
centre, Gram, KoLeo, the telemetry), in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_device_ms(run, "loss")
