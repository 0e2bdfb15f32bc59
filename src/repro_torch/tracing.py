"""The program's spans, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` named
``"repro_torch." + name`` while a ``torch.profiler.profile`` records, and a
shared null context otherwise: with the profiler off a span costs one flag
test, and nothing is recorded or kept.  Each span the profiler records has
its name, its start and end on the same clock as the device's activity,
and its thread; nesting gives its parent, and the number of spans of a
name is that name's count.  Names are fixed per kind of work and carry no
attributes (a unit's rank, chunk and item follow from its order on its
thread and the plan's tick table).

The spans, by module:

* ``launch/train.py::train_step``: ``step.value_and_grad``,
  ``step.optimizer`` (the update and its application);
* ``core/pipeline.py``: ``grad.forward`` and ``grad.backward`` around the
  loss and its ``autograd.grad`` (the whole-sequence step and the
  pipelined step in one process); ``pipe.fwd``, ``pipe.bwd``,
  ``pipe.bwd_input``, ``pipe.bwd_weight`` around each unit of the tick
  loop, ``pipe.shift`` around each ring shift, ``pipe.prologue`` and
  ``pipe.finish`` around the per-unit gradients' set-up and sums,
  ``pipe.head`` around the last stage's head and loss;
* ``distributed/transport.py::DistRing.shift``: ``ring.header`` (the
  header's exchange, through the host's read of it) and ``ring.payload``;
* ``models/moe.py``: ``moe.route``, ``moe.dispatch``, ``moe.experts``,
  ``moe.combine``, ``moe.shared``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``PREFIX + name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
