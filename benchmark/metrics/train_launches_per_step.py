"""train_launches_per_step: kernel events launched under
``dinox.train.step``, per optimizer step, in the traced sub-window
(``harness.spans``)."""

from harness import spans


def read(run):
    return spans.train_launches_per_step(run)
