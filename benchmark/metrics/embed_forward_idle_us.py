"""embed_forward_idle_us: device idle us per slice embedded at the gaps whose
midpoint lies in ``dinox.embed.forward`` (the card waiting on the
forward's enqueue), in the traced sub-window (``harness.spans``)."""

from harness import spans


def read(run):
    return spans.embed_idle_us(run, "forward")
