"""Named host spans at the port's layer boundaries, for torch.profiler.

`with span("slot_engine.step"): ...` opens a `record_function` only while
a profiler is recording: the span then lies in the trace on the clock of
the device operations, so a gap or a kernel can be put down to the part
of the program the host was in. With no profiler on, a span costs one C
call and constructs nothing. The profiler being on is the only switch.

Spans are opened per tick, per frame step and per part of a train step,
never per leaf, slot or stream.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: `record_function(name)` under a recording
    profiler, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
