"""Spans of the serve path, on the clock the profiler stamps device
operations with.

``span(name, **fields)`` records only while a torch profiler session is
active (``torch.autograd.profiler._is_profiler_enabled``). Otherwise it
reads that flag and returns one shared no-op context: it allocates nothing
on the host or the card and never synchronizes.

A recorded span keeps its name; its start and end in ``time.time_ns()``,
the Unix-epoch nanoseconds on which kineto stamps host and device
operations (the card test in ``tests/test_torch_tracing.py`` holds a span's
kernels inside it within 50 us); the id of the span open around it
(``parent``); the id of the outermost span open (``wave``: every span of
one ``serve.wave`` shares it); and its fields.

Where CUDA is in use, a timed span also records a pair of timing events on
the current stream, taken from a reused pool. ``spans()``, which the caller
reads after its own synchronize, resolves them into ``device_s``, the
stream's time from the span's start to its end; a span itself never
synchronizes. A span is timed as the span open around it is, and a span
with none around it is timed. The engine leaves decode's spans untimed:
each decode step ends in the host's read of its tokens, so its device work
lies inside its host interval, while an event record costs tens of
microseconds under the profiler and would lengthen the host-paced steps.

At most ``CAPACITY`` spans are kept, the oldest dropped first. Spans are
opened and closed on one thread (the engine's).

``spans()`` is read beside ``torch.profiler``'s own timeline: the profiler's
``kineto_results.events()`` give ``start_ns()`` on the same clock, so a
device operation belongs to the span whose ``[start_ns, end_ns]`` holds it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    id: int
    name: str
    start_ns: int
    parent: Optional[int]
    wave: int
    fields: Dict[str, Any]
    timed: bool = True
    end_ns: Optional[int] = None  # None while open
    device_s: Optional[float] = None  # set by ``spans()`` from the events
    events: Optional[Tuple[Any, Any]] = dataclasses.field(default=None, repr=False)


class Recorder:
    """The kept spans, the stack of open ones and the pool of idle timing
    events."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.kept: Deque[Span] = collections.deque()
        self.open: List[Span] = []
        self.pool: list = []
        self.next_id = 0

    def start(self, name: str, timed: Optional[bool], fields: Dict[str, Any]) -> Span:
        if len(self.kept) == self.capacity:
            self._release(self.kept.popleft())
        parent = self.open[-1] if self.open else None
        if timed is None:
            timed = parent.timed if parent else True
        s = Span(self.next_id, name, time.time_ns(), parent.id if parent else None,
                 self.open[0].id if self.open else self.next_id, fields, timed)
        self.next_id += 1
        if timed and torch.cuda.is_initialized():
            s.events = (self._event(), self._event())
            s.events[0].record()
        self.kept.append(s)
        self.open.append(s)
        return s

    def end(self, s: Span) -> None:
        if s.events is not None:
            s.events[1].record()
        s.end_ns = time.time_ns()
        self.open.pop()

    def resolve(self) -> List[Span]:
        for s in self.kept:
            if s.events is not None and s.end_ns is not None:
                s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                self._release(s)
        return list(self.kept)

    def _event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)

    def _release(self, s: Span) -> None:
        if s.events is not None:
            self.pool.extend(s.events)
            s.events = None


class _Open:
    __slots__ = ("recorder", "name", "timed", "fields", "span")

    def __init__(self, recorder: Recorder, name: str, timed: Optional[bool],
                 fields: Dict[str, Any]):
        self.recorder, self.name, self.timed, self.fields = recorder, name, timed, fields

    def __enter__(self) -> Span:
        self.span = self.recorder.start(self.name, self.timed, self.fields)
        return self.span

    def __exit__(self, *exc) -> None:
        self.recorder.end(self.span)


_RECORDER = Recorder()


def span(name: str, timed: Optional[bool] = None, **fields):
    """A context that records a span while the profiler is on, else the
    shared no-op context. ``timed``: whether it records timing events
    (None: as the span open around it)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(_RECORDER, name, timed, fields)


def spans() -> List[Span]:
    """The kept spans in the order they began, each closed one's events
    resolved into ``device_s`` (call it after synchronizing the work)."""
    return _RECORDER.resolve()
