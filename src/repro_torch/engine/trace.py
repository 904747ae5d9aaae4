"""Spans of the serving path, kept in memory.

A ``Tracer`` attached to an ``EngineCore`` and its executor (their
``tracer`` attributes, ``None`` by default) records where each batch's host
time goes: the ``tick`` and, nested in it, the scheduling, the executor's
``dispatch`` and ``wait`` and the steps they run. Each span is a ``Span``
(name, start and end on one host clock, the enclosing span, the batch id,
attributes), appended when it opens. Beside the spans it keeps one
``Queued`` record per admitted request: its admission and the tick that
first scheduled it, on the clock the caller passes as ``now``.

Spans are stamped with ``time.perf_counter_ns``; ``offset_ns``, measured
once when the tracer is made, puts them on ``torch.profiler``'s clock (epoch
nanoseconds), so that they line up with the device's kernels and copies in
the same trace. ``take()`` hands the records over and clears them; there is
no exporter.

With no tracer a site runs its plain path (``span`` returns one shared
no-op context): no clock read, no CUDA event, no record.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

_clock = time.perf_counter_ns

NO_SPAN = contextlib.nullcontext()


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: Optional["Span"]
    batch: Optional[int]
    attrs: dict


@dataclass(slots=True)
class Queued:
    """A request from its admission to the tick that first scheduled it
    (``scheduled`` None until then), on the caller's clock."""
    req_id: str
    rel_id: str
    admit: float
    scheduled: Optional[float] = None


@dataclass
class Records:
    spans: List[Span] = field(default_factory=list)
    requests: Dict[str, Queued] = field(default_factory=dict)


def _profiler_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few paired reads: the profiler stamps host events in epoch ns."""
    best = None
    for _ in range(8):
        a = _clock()
        wall = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class Tracer:
    def __init__(self):
        self.offset_ns = _profiler_offset_ns()
        self.records = Records()
        self._open: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, batch: Optional[int] = None,
             **attrs) -> Iterator[Span]:
        """Record ``name`` around the block. The batch id defaults to the
        enclosing span's."""
        parent = self._open[-1] if self._open else None
        if batch is None and parent is not None:
            batch = parent.batch
        s = Span(name, _clock(), 0, parent, batch, attrs)
        self.records.spans.append(s)
        self._open.append(s)
        try:
            yield s
        finally:
            s.end_ns = _clock()
            self._open.pop()

    def note(self, **attrs) -> None:
        """Add ``attrs`` to the outermost open span (the batch's tick)."""
        if self._open:
            self._open[0].attrs.update(attrs)

    def drop(self, s: Span) -> None:
        """Forget ``s`` and every span recorded after it (a tick that ran
        no batch)."""
        spans = self.records.spans
        i = len(spans) - 1
        while spans[i] is not s:
            i -= 1
        del spans[i:]

    def admitted(self, rel_id: str, req_ids, now: float) -> None:
        for rid in req_ids:
            self.records.requests[rid] = Queued(rid, rel_id, now)

    def scheduled(self, reqs, now: float) -> None:
        """``reqs`` are in a batch of the tick at ``now``."""
        for r in reqs:
            q = self.records.requests.get(r.req_id)
            if q is not None and q.scheduled is None:
                q.scheduled = now

    def take(self) -> Records:
        """The records so far; the tracer starts anew (call between
        ticks)."""
        out, self.records = self.records, Records()
        return out


def span(tracer: Optional[Tracer], name: str, **attrs):
    """``tracer.span(name, **attrs)``, or the shared no-op without one."""
    return NO_SPAN if tracer is None else tracer.span(name, **attrs)
