"""device_idle_pct.train: the share of the traced training sub-window in
which no kernel, copy or set runs on the card (the union of the device
intervals)."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
