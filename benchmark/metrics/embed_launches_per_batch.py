"""embed_launches_per_batch: kernel events launched under
``dinox.embed.forward``, per forward call, in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.embed_launches_per_batch(run)
