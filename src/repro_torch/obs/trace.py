"""Span/event tracer on the injectable-clock convention (DESIGN.md §12;
``repro/obs/trace.py``).

A ``Trace`` records a forest of nested ``Span``s — wall-clock intervals
with a dotted name and static attributes — plus point-in-time events.
Timestamps come from one injectable ``clock()`` callable exactly like
the streaming service's latency stamps (serve/clock.py): the default is
``time.perf_counter``; tests inject a ``ManualClock`` and assert span
durations against exact values instead of wall-clock noise.

Span names of the port:

  session.run / session.prepare / session.iter / session.chunk /
      obs.profile — ``Session.run(trace=)`` (``exec/session.py``);
      ``session.iter`` carries ``mode``/``count``, ``session.chunk``
      ``branch``/``count``/``cap``, one per host dispatch
  batch.run / batch.dispatch — the barrier batch (``exec/batch.py``)
  stream.pump / stream.dispatch — the stream service (``serve/stream.py``)

A span reads the host clock only: it never synchronizes with the device
and reads nothing back from it.

``to_chrome()`` exports the Chrome trace-event JSON format (complete
``"X"`` events with microsecond ``ts``/``dur``, instants as ``"i"``),
loadable directly in Perfetto / ``chrome://tracing``.

Deep code attaches spans without threading a trace argument through
every signature via the AMBIENT trace: ``tracing(trace)`` installs a
trace for the dynamic extent of a block, ``maybe_span(name, **attrs)``
opens a span on the innermost installed trace — or no-ops (a shared
null context) when none is installed, so instrumented hot loops cost
one dict lookup per iteration when telemetry is off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Span:
    """One timed interval: name, [start, end), static attrs, children."""

    name: str
    start: float
    end: "float | None" = None
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> "float | None":
        return None if self.end is None else self.end - self.start

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass
class Event:
    """One instantaneous marker."""

    name: str
    ts: float
    attrs: dict = dataclasses.field(default_factory=dict)


class Trace:
    """A span forest + event list with one injectable timestamp source."""

    def __init__(self, clock=None):
        self.clock = clock or time.perf_counter
        self.spans: list[Span] = []     # roots
        self.events: list[Event] = []
        self._stack: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name=name, start=self.clock(), attrs=attrs)
        parent = self._stack[-1] if self._stack else None
        (parent.children if parent else self.spans).append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.end = self.clock()

    def event(self, name: str, **attrs) -> Event:
        ev = Event(name=name, ts=self.clock(), attrs=attrs)
        self.events.append(ev)
        return ev

    def walk(self):
        """Depth-first over every span in the forest."""
        for sp in self.spans:
            yield from sp.walk()

    def find(self, name: str) -> list[Span]:
        """Every span with this exact name, depth-first order."""
        return [sp for sp in self.walk() if sp.name == name]

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the "trace events" array format).

        Complete spans become ``ph: "X"`` duration events with
        microsecond ``ts``/``dur`` relative to the trace's earliest
        timestamp; events become thread-scoped instants (``ph: "i"``).
        The dict round-trips through ``json.dump`` straight into
        Perfetto / ``chrome://tracing``.
        """
        stamps = [sp.start for sp in self.walk()] + \
            [ev.ts for ev in self.events]
        t0 = min(stamps) if stamps else 0.0
        out = []
        for sp in self.walk():
            dur = 0.0 if sp.end is None else sp.end - sp.start
            out.append({"name": sp.name, "cat": "repro", "ph": "X",
                        "ts": (sp.start - t0) * 1e6, "dur": dur * 1e6,
                        "pid": 0, "tid": 0, "args": dict(sp.attrs)})
        for ev in self.events:
            out.append({"name": ev.name, "cat": "repro", "ph": "i",
                        "ts": (ev.ts - t0) * 1e6, "s": "t",
                        "pid": 0, "tid": 0, "args": dict(ev.attrs)})
        return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# ambient trace — instrumentation points without signature threading
# ---------------------------------------------------------------------------

_AMBIENT: list[Trace] = []
_NULL = contextlib.nullcontext()


def current_trace() -> "Trace | None":
    """The innermost trace installed by ``tracing()``, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def tracing(trace: Trace):
    """Install ``trace`` as the ambient trace for the block. Nests —
    the innermost installation wins, restored on exit."""
    _AMBIENT.append(trace)
    try:
        yield trace
    finally:
        _AMBIENT.pop()


def maybe_span(name: str, **attrs):
    """A span on the ambient trace, or a shared no-op context manager
    when no trace is installed (telemetry off: ~one list peek)."""
    tr = current_trace()
    return _NULL if tr is None else tr.span(name, **attrs)


def maybe_event(name: str, **attrs) -> None:
    tr = current_trace()
    if tr is not None:
        tr.event(name, **attrs)
