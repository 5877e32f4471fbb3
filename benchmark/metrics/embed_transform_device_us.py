"""embed_transform_device_us: device us per slice embedded of the work
launched under ``dinox.embed.transform`` (the evaluation transform), in
the traced sub-window (``harness.spans``)."""

from harness import spans


def read(run):
    return spans.embed_device_us(run, "transform")
