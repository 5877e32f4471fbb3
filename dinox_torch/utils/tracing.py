"""Phase spans for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler is on and one shared null context otherwise, so a span costs one
flag check when nothing traces. The ranges land in the profiler's Chrome
trace beside the ops and kernels they enclose, on the same clock.

The program's spans are named ``dinox.<family>.<phase>``:

- ``dinox.train.step``, one optimizer step (``train.step``), and inside it,
  per micro-step, ``augment``, ``student``, ``loss`` (with ``teacher``
  nested in it) and ``backward``; ``update`` at each accumulation and
  after the micro-steps (with ``reduce`` nested in it on a mesh). Every op
  the step runs lies under exactly one of these leaves (``loss`` counted
  without its ``teacher``, ``update`` without its ``reduce``).
- ``dinox.embed.transform`` (``ops.augment.eval_transform``) and
  ``dinox.embed.forward`` (``zoo.hub.LoadedModel``).
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A profiler range named *name* while a profiler is on, else a null context."""
    return record_function(name) if _profiler._is_profiler_enabled else _OFF
