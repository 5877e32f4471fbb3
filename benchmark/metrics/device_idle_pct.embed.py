"""device_idle_pct.embed: the share of the traced embedding sub-window in
which no kernel, copy or set runs on the card."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
