"""Span tracer on the injectable-clock convention (DESIGN.md §12;
``repro/obs/trace.py``), with a device clock and the profiler's ranges.

A ``Trace`` records a forest of nested ``Span``s — intervals with a
dotted name and static attributes. Host timestamps come from one
injectable ``clock()`` callable exactly like the streaming service's
latency stamps (serve/clock.py): the default is ``time.perf_counter``;
tests inject a ``ManualClock`` and assert span durations against exact
values instead of wall-clock noise.

Span names of the port (this list is the schema):

  session.run / obs.profile — ``Session.run(trace=)``
      (``exec/session.py``), around the run and its work profile
  session.prepare — the prepared-graph lookup (or build) of a run
  session.iter — one host-loop iteration (``mode``, ``count``); read by
      ``pipe.turnaround_ms``
  session.count — the host loop's read of the worklist count, the
      Pipe's one synchronisation an iteration; read by
      ``pipe.turnaround_ms``
  session.chunk — one outlined chunk (``branch``, ``count``, ``cap``)
  session.readback — the colors' copy to the host and ``finalize``
  ipgc.hub — the hub side-channel of a step (``part``: ``forbidden``,
      ``lose``): the ``hub_forbidden`` or ``hub_lose`` kernel
      (``_hub_forbidden``, ``_hub_lose``), its zeroed table, the hub-only
      (N+1) flag array and the fold of the hub flags into the rows'; read
      by ``steps.hub_ms``. ``entries``: the COO tail's length T (a host
      int); ``visited``: the entries whose source's gate let them through
      (a device counter, ``span_counter``); read by
      ``steps.hub_visit_pct``
  ipgc.state — a step's O(N) state rewrites (``_set_rows``,
      ``_set_rows_drop`` of colors, base and mask; the dense steps'
      concatenations), the values they write and the padding fills; read
      by ``steps.state_ms``
  ipgc.assign / ipgc.resolve / ipgc.compact — the rest of a two-phase
      step: ``mex_window``, ``conflict`` and the worklist's compaction
      with their row selects and ``where``s; in a fused step
      ``ipgc.compact`` is the ``fused_compact`` pass and its row selects
  batch.run / batch.dispatch — the barrier batch (``exec/batch.py``)
  stream.pump / stream.dispatch — the stream service (``serve/stream.py``)
  tune.sweep / tune.candidate — the tile tuner (``kernels/tune.py``)

The ``ipgc.*`` spans cover the four ELL steps of ``core/ipgc.py`` (not
the csr-segment variants) and never nest in one another, so each
PyTorch op of such a step falls in exactly one of them.

When spans are on. ``maybe_span`` opens a span on the ambient trace of
the calling thread (``tracing``) — or, with none installed, a
``torch.profiler.record_function`` range while torch's profiler records,
else the shared null context: no span, no range, no CUDA event, no
allocation. The step spans (``step_span``) go on a trace only inside its
``run_scope``, which ``Session.run`` enters for the stretch of one
coloring: the stream's and the batch's lane steps stay off their traces.

The profiler's trace. While the profiler records, every span also opens
``record_function(name)``, so the profiler shows it as a
``user_annotation`` on the host and a ``gpu_user_annotation`` over the
device operations it launched.

The device clock. Inside ``run_scope(device)`` on a CUDA device a span
also records a timing ``torch.cuda.Event`` on the device's current
stream when it opens and when it closes — except while that stream is
being captured into a CUDA graph, where an event would time the capture,
not the work. ``device_start``/``device_end`` are the device's seconds
since the trace's origin event (recorded when its first run scope
opens). They are resolved when the trace is first read (``walk``,
``find``, ``to_chrome``, ``resolve``): after the run, whose own readback
has synchronised, so neither the loop nor the run pays for a
synchronisation or for reading the events back. A span's device time is
the device's wall time between its two events, idle included.

Device counters. ``span_counter(sp, name, device)`` hands the code inside
an open span an int64[1] zero on the device, which the work adds to: a
slot of a zeroed buffer the trace keeps per device, so a counter costs no
allocation and no fill of its own. The trace reads it into
``sp.attrs[name]`` when it resolves the events, one copy of each buffer
to the host. None while spans are off or the device's current stream is
being captured.

``to_chrome()`` exports the Chrome trace-event JSON format (complete
``"X"`` events with microsecond ``ts``/``dur``): each span on the host
track (``tid`` 0) and each device-timed span again on a device track
(``tid`` 1), loadable directly in Perfetto / ``chrome://tracing``.

The ambient trace is per thread (a ``contextvars`` variable): a trace a
stream installs on its pump thread never sees a caller's spans, nor the
other way round; the off check is one lookup.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
from torch.autograd.profiler import record_function

#: torch's own check of a recording profiler (~0.1 µs)
_profiler_enabled = torch.autograd._profiler_enabled
#: device counters a buffer (``span_counter``)
_COUNTER_SLOTS = 1024


@dataclasses.dataclass
class Span:
    """One timed interval: name, [start, end), static attrs, children;
    ``device_start``/``device_end`` in seconds since the trace's origin
    event where the span was device-timed, else None."""

    name: str
    start: float
    end: "float | None" = None
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    device_start: "float | None" = None
    device_end: "float | None" = None
    #: the (open, close) CUDA events until the trace resolves them
    events: "tuple | None" = dataclasses.field(default=None, repr=False,
                                               compare=False)
    #: attr name -> (buffer, slot) of a device counter (``span_counter``)
    #: until resolved
    counters: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def seconds(self) -> "float | None":
        return None if self.end is None else self.end - self.start

    @property
    def device_seconds(self) -> "float | None":
        if self.device_start is None or self.device_end is None:
            return None
        return self.device_end - self.device_start

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class Trace:
    """A span forest with one injectable host timestamp source and, once
    a run scope on a CUDA device has opened, a device clock."""

    def __init__(self, clock=None):
        self.clock = clock or time.perf_counter
        self.spans: list[Span] = []     # roots
        self._stack: list[Span] = []
        #: the device clock's zero: a CUDA event and the host time at
        #: which it was recorded
        self.device_origin = None
        self.device_origin_host: "float | None" = None
        self._device: "torch.device | None" = None   # events recorded on
        self._in_run = False
        self._pending: list[Span] = []
        #: device -> [zeroed int64 counter buffer, its next free slot]
        self._counters: dict = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name=name, start=self.clock(), attrs=attrs)
        parent = self._stack[-1] if self._stack else None
        (parent.children if parent else self.spans).append(sp)
        self._stack.append(sp)
        rf = record_function(name) if _profiler_enabled() else None
        if rf is not None:
            rf.__enter__()
        opened = self._mark()
        try:
            yield sp
        finally:
            if opened is not None:
                closed = self._mark()
                if closed is not None:
                    sp.events = (opened, closed)
            if sp.events is not None or sp.counters:
                self._pending.append(sp)
            if rf is not None:
                rf.__exit__(None, None, None)
            self._stack.pop()
            sp.end = self.clock()

    def _mark(self):
        """A timing event recorded on the device clock's current stream;
        None without a device clock or while that stream is captured."""
        if self._device is None or torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    @contextlib.contextmanager
    def run_scope(self, device=None):
        """The stretch of one run: step spans (``step_span``) go on this
        trace inside it. On a CUDA ``device`` every span opened inside it
        is device-timed too; the first scope records the origin event."""
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type != "cuda":
            dev = None
        if dev is not None and self.device_origin is None:
            self.device_origin_host = self.clock()
            self.device_origin = torch.cuda.Event(enable_timing=True)
            self.device_origin.record(torch.cuda.current_stream(dev))
        prev = (self._device, self._in_run)
        self._device, self._in_run = dev, True
        try:
            yield self
        finally:
            self._device, self._in_run = prev

    def counter(self, device: torch.device) -> tuple:
        """The next free slot of this trace's zeroed counter buffer on
        ``device``: ``(buffer, slot)``."""
        got = self._counters.get(device)
        if got is None or got[1] == got[0].shape[0]:
            got = [torch.zeros(_COUNTER_SLOTS, dtype=torch.int64,
                               device=device), 0]
            self._counters[device] = got
        got[1] += 1
        return got[0], got[1] - 1

    def resolve(self) -> None:
        """Turn the closed spans' events into ``device_start`` and
        ``device_end``, waiting for each closing event, and their device
        counters into attrs."""
        pending, self._pending = self._pending, []
        host: dict = {}
        for sp in pending:
            if sp.events is not None:
                opened, closed = sp.events
                closed.synchronize()
                sp.device_start = \
                    self.device_origin.elapsed_time(opened) * 1e-3
                sp.device_end = self.device_origin.elapsed_time(closed) * 1e-3
                sp.events = None
            for name, (buf, slot) in sp.counters.items():
                if id(buf) not in host:
                    host[id(buf)] = buf.tolist()
                sp.attrs[name] = host[id(buf)][slot]
            sp.counters = {}

    def walk(self):
        """Depth-first over every span in the forest, device times
        resolved."""
        self.resolve()
        for sp in self.spans:
            yield from sp.walk()

    def find(self, name: str) -> list[Span]:
        """Every span with this exact name, depth-first order."""
        return [sp for sp in self.walk() if sp.name == name]

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the "trace events" array format).

        Complete spans become ``ph: "X"`` duration events with
        microsecond ``ts``/``dur`` relative to the trace's earliest host
        timestamp, on ``tid`` 0. Each device-timed span is written again
        on ``tid`` 1, the device track: its ``ts`` counts from the origin
        event, which is placed at the host time of its recording (noted
        in ``args`` as ``device_origin_us``), so the two tracks line up
        to within the device's queue at that moment. The dict
        round-trips through ``json.dump`` straight into Perfetto /
        ``chrome://tracing``.
        """
        stamps = [sp.start for sp in self.walk()]
        if self.device_origin_host is not None:
            stamps.append(self.device_origin_host)
        t0 = min(stamps) if stamps else 0.0
        out = []
        for sp in self.walk():
            dur = 0.0 if sp.end is None else sp.end - sp.start
            out.append({"name": sp.name, "cat": "repro", "ph": "X",
                        "ts": (sp.start - t0) * 1e6, "dur": dur * 1e6,
                        "pid": 0, "tid": 0, "args": dict(sp.attrs)})
        if self.device_origin_host is not None:
            origin_us = (self.device_origin_host - t0) * 1e6
            for sp in self.walk():
                if sp.device_seconds is None:
                    continue
                out.append({"name": sp.name, "cat": "repro.device",
                            "ph": "X",
                            "ts": origin_us + sp.device_start * 1e6,
                            "dur": sp.device_seconds * 1e6,
                            "pid": 0, "tid": 1,
                            "args": {**sp.attrs,
                                     "device_origin_us": origin_us}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# ambient trace — instrumentation points without signature threading
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch.obs.trace", default=None)
_NULL = contextlib.nullcontext()


def current_trace() -> "Trace | None":
    """The innermost trace this thread installed with ``tracing()``, or
    None."""
    return _CURRENT.get()


def profiling() -> bool:
    """Whether torch's profiler is recording."""
    return _profiler_enabled()


@contextlib.contextmanager
def tracing(trace: Trace):
    """Install ``trace`` as this thread's ambient trace for the block.
    Nests — the innermost installation wins, restored on exit."""
    token = _CURRENT.set(trace)
    try:
        yield trace
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def _range(name: str):
    """A profiler range that yields no span."""
    with record_function(name):
        yield None


def maybe_span(name: str, **attrs):
    """A span on the ambient trace; with none, a profiler range while the
    profiler records; else the shared no-op context manager."""
    tr = _CURRENT.get()
    if tr is not None:
        return tr.span(name, **attrs)
    return _range(name) if _profiler_enabled() else _NULL


def span_counter(sp: "Span | None", name: str, device
                 ) -> "torch.Tensor | None":
    """An int64[1] zero on ``device`` that the trace reads into
    ``sp.attrs[name]`` when it resolves ``sp``; None where ``sp`` is None
    (spans off: ``step_span`` and ``maybe_span`` yield None then) or while
    the device's current stream is being captured."""
    tr = _CURRENT.get()
    if sp is None or tr is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return None
    buf, slot = tr.counter(dev)
    sp.counters[name] = (buf, slot)
    return buf[slot:slot + 1]


def step_span(name: str, **attrs):
    """``maybe_span`` for a step's phase: it goes on the ambient trace
    only inside that trace's ``run_scope``."""
    tr = _CURRENT.get()
    if tr is not None and tr._in_run:
        return tr.span(name, **attrs)
    return _range(name) if _profiler_enabled() else _NULL
