"""One general driver per kind of traffic mix (``mixes/<name>.json``'s
``kind``): ``pretrain`` and ``embed_series``. A driver builds the program's
state and the inputs from the seed (:meth:`setup`), runs the measured
window (:meth:`window`) and the traced sub-window (:meth:`traced`), frees
the program's state (:meth:`release`) and compares what the window's path
produced with the reference (:meth:`check`)."""

from __future__ import annotations

import importlib


def driver_class(kind: str):
    return importlib.import_module(f"harness.drivers.{kind}").Driver
