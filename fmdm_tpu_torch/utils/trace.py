"""
Spans: named phases of the port's work, recorded while a ``torch.profiler``
session is active and never otherwise.

    with span("train.forward"):
        ...

With no session active, :func:`span` makes one check and returns a shared
no-op; nothing is allocated or recorded. Inside a session a span

- enters ``torch.profiler.record_function(name)``, so a profile that records
  CPU activity shows it on the profiler's clock above the ops and kernels it
  launched;
- takes its host start and end (``time.perf_counter_ns``) and, once CUDA is
  in use in the process, a pair of timing events on the current stream: the
  device time between them is the span's kernels and any idle among them;
- knows its parent, the enclosing span on the same thread. A thread with no
  span open of its own (autograd's device worker thread during
  ``backward()``, which inherits the caller's profiler session) takes the
  innermost span open on another thread, which is the one around the
  ``backward()`` call while that call waits;
- knows its unit, the index of its root span (a step, a call) since the last
  :func:`clear`.

Finished spans stay in memory, in one list for the process, until
:func:`clear`; :func:`spans` returns them. There is no setting and no file:
a span is recorded exactly when the session that records the kernels is.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    id: int                    # in opening order since the last clear()
    parent: Optional[int]      # the enclosing span's id; None for a root
    unit: int                  # index of the root span this one belongs to
    host_ms: float
    device_ms: Optional[float]  # None where no CUDA events were recorded


class _Off:
    """What :func:`span` returns outside a profiler session."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()   # guards the state below: spans close on autograd's thread too
_open: List["_Recording"] = []     # open spans of every thread, in opening order
_done: List["_Recording"] = []
_next_id = 0
_next_unit = 0
_local = threading.local()  # .stack: this thread's open spans


class _Recording:
    __slots__ = ("name", "id", "parent", "unit", "t0", "t1", "events", "_range", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id, _next_unit
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            outer = stack[-1] if stack else (_open[-1] if _open else None)
            self.id, _next_id = _next_id, _next_id + 1
            if outer is None:
                self.parent, self.unit, _next_unit = None, _next_unit, _next_unit + 1
            else:
                self.parent, self.unit = outer.id, outer.unit
            _open.append(self)
        stack.append(self)
        self._stack = stack
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._stack.pop()
        with _lock:
            _open.remove(self)
            _done.append(self)
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` session is active, and a shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name)


def spans() -> List[Span]:
    """The finished spans in opening order (a parent before its children).
    Device times are read once each end event has completed (this waits)."""
    with _lock:
        done = sorted(_done, key=lambda r: r.id)
    out = []
    for r in done:
        device_ms = None
        if r.events is not None:
            r.events[1].synchronize()
            device_ms = r.events[0].elapsed_time(r.events[1])
        out.append(Span(r.name, r.id, r.parent, r.unit, (r.t1 - r.t0) / 1e6, device_ms))
    return out


def clear() -> None:
    """Forget the finished spans; ids and units count from 0 again."""
    global _next_id, _next_unit
    with _lock:
        _done.clear()
        if not _open:
            _next_id = _next_unit = 0
