"""Continuous-batching coloring service — the streaming layer over
``Session``'s cache (DESIGN.md §11, §14; ``repro/serve/stream.py``).

``Session.run_batch`` (exec/batch.py) is a *barrier* batch: all lanes
start together and the trips run until the slowest lane drains, so one
hollywood-sized request stalls 63 small ones. A ``StreamSession`` keeps
the same per-lane step semantics but breaks the barrier into *chunks*:

  submit(g) --> bounded FIFO queue --> admit into a free lane -->
  chunked dispatch (``LaneState.run`` with a finite trip budget) -->
  harvest drained lanes --> refill from the queue --> repeat

Scheduling contract:

  * **Admission** happens only at chunk boundaries (``pump``), in the
    order chosen by the configured ``AdmissionPolicy``
    (core/policy.py): FIFO (the default — oldest first, skip-blocked),
    priority classes, or earliest-deadline-first with shed-on-hopeless
    (a ticket whose deadline cannot be met given the observed per-rung
    service times is rejected with a reason instead of occupying a
    lane). A request whose lane group is full never blocks requests
    bound for groups with space.
  * **Lane groups** are keyed (node rung, resolved window, layout
    kind) — the same ``pick_bucket`` ladder as ``run_batch``, anchored
    at ``StreamConfig.max_nodes``. A group's ``ShapeClass`` grows
    *sticky-monotone* (``grow_shape_class``): resident lanes' carried
    state depends only on ``n_pad``, so growth re-pads the flattened
    graph arrays without touching colors/aux/worklists.
  * **Adaptive lane width** (DESIGN.md §14): with
    ``adaptive_lanes=True`` a group starts at ``b=1`` and doubles on
    queue pressure up to ``lanes_resolved``; at chunk boundaries a
    group whose resident set fits a smaller power of two for
    ``shrink_after`` consecutive rounds compacts, retiring inert
    lanes — a rung with two resident members runs (and pays for) a
    ``b=2`` group, not the configured width. Width changes append or
    drop *inert* lanes only, so resident lanes' state is bit-untouched.
  * **Backpressure**: the queue is bounded (``max_queue``); overload
    resolves via the shed policy — ``"reject-new"`` bounces the
    incoming request, ``"shed-oldest"`` bounces the oldest queued one,
    or a callable picks the victim. A bounced ticket comes back
    ``status="rejected"`` with a human-readable ``reason`` — the
    service never blocks and never raises for load, and a shed
    *callable that itself raises* rejects the incoming ticket with the
    exception text as the reason instead of losing the request.
  * **Async front-end** (``serving()``): the pump loop runs on a
    daemon thread while any number of producer threads call
    ``submit()``; the bounded queue is the only shared state (guarded
    by one lock), every device-touching structure — lane groups,
    carried state, the session cache pins, the CUDA graph captures —
    stays on the pump thread (a CUDA call from another thread during a
    capture fails the capture, and that failure surfaces).
  * **Latency accounting**: every ticket is stamped at enqueue, admit
    and drain through one injectable ``clock`` (serve/clock.py), so
    ``queue_seconds + service_seconds == total_seconds`` exactly.
    (``ManualClock`` is not thread-safe: drive it only from
    single-threaded ``pump()``/``drain()`` loops, not under
    ``serving()``.)

Bit-identity guarantee (tests/test_torch_stream.py): a streamed result
equals the solo ``Session.run`` of the same request under the host
regime — colors, color count, iteration count, and reconstructed D/S
trace — for ANY arrival order, lane count, chunk cadence, admission
order, or grow/shrink schedule. Chunk boundaries only partition the
trips of *independent* lanes; per-lane step semantics are exactly
``run_batch``'s (itself proven bit-identical to the solo host loop), a
refill replaces the lane's entire state, and width changes touch inert
lanes only — so residency history cannot leak between requests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque

from repro_torch.core import ipgc
from repro_torch.core.engine import ColoringResult, resolve_plan
from repro_torch.core.policy import (Timer, device_threshold,
                                     make_admission_policy,
                                     make_chunk_policy, make_policy)
from repro_torch.core.worklist import bucket_capacities, pick_bucket
from repro_torch.exec.batch import (COUNT, IT, ND, NS, _pow2,
                                    fresh_lane_state, grow_shape_class,
                                    regraph, shape_class_for, take_lanes,
                                    widen_lanes)
from repro_torch.exec.spec import ExecutionSpec
from repro_torch.graphs.csr import Graph
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import (DEPTH_EDGES, LATENCY_EDGES,
                                     SLACK_EDGES, MetricsRegistry)
from repro_torch.obs.report import RunReport


class _ShedPolicyError(Exception):
    """A user shed callable raised — converted to a rejected ticket."""


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Scheduling knobs of a ``StreamSession`` (perf-only: none of these
    change results — the bit-identity contract holds for any values)."""

    #: MAXIMUM resident lanes per shape-class group, rounded up to a
    #: power of two (``lanes_resolved`` — surfaced in ``report()``).
    #: With ``adaptive_lanes`` each group starts at 1 and grows on
    #: demand; without, every group runs the full resolved width.
    lanes: int = 8
    #: demand-grown lane width: double on queue pressure, compact at
    #: chunk boundaries when residency fits a smaller power of two
    adaptive_lanes: bool = True
    #: consecutive under-occupied rounds before a group compacts
    shrink_after: int = 2
    #: refill cadence: int = fixed trips per dispatch, "auto" = drain-
    #: rate-steered AdaptiveChunk, or a policy object (core/policy.py).
    #: A policy *object* is shared by every lane group; int/"auto" get
    #: one instance per group.
    chunk: "int | str | object" = "auto"
    #: admission order + deadline shedding: "fifo", "priority", "edf",
    #: or an AdmissionPolicy object (core/policy.py)
    admission: "str | object" = "fifo"
    #: queue bound — submissions beyond it trigger the shed policy
    max_queue: int = 64
    #: admission control: requests above this are rejected, and the
    #: node-rung ladder (pick_bucket) is anchored here
    max_nodes: int = 1 << 20
    #: overload policy: "reject-new", "shed-oldest", or a callable
    #: ``(queued: tuple[Ticket], incoming: Ticket) -> Ticket`` returning
    #: the victim (the incoming ticket or a queued one)
    shed: "str | object" = "reject-new"
    #: map each result's colors through its graph's Permutation
    map_to_original: bool = False
    #: timestamp source for latency accounting; None = time.perf_counter
    clock: "object | None" = None
    #: optional ``obs.Trace``: pump rounds and chunk dispatches record
    #: spans on it (installed as the ambient trace for each pump)
    trace: "object | None" = None

    def __post_init__(self):
        if isinstance(self.lanes, bool) or not isinstance(self.lanes, int) \
                or self.lanes < 1:
            raise ValueError(
                "lanes must be a positive int (the max resident lanes "
                "per group, rounded up to a power of two), got "
                f"{self.lanes!r}")
        if isinstance(self.shrink_after, bool) \
                or not isinstance(self.shrink_after, int) \
                or self.shrink_after < 1:
            raise ValueError(
                f"shrink_after must be a positive int, got "
                f"{self.shrink_after!r}")

    @property
    def lanes_resolved(self) -> int:
        """The actual per-group lane bound: ``lanes`` rounded up to a
        power of two (so a group's widths are few: 1, 2, 4, ...)."""
        return _pow2(self.lanes)


@dataclasses.dataclass(eq=False)
class Ticket:
    """One request's handle: status, result, and latency stamps.

    Identity semantics (``eq=False``): a ticket IS the request — queue
    membership and shed-victim checks compare by object, never by field
    values, so two requests for the same graph stay distinct.
    """

    seq: int
    graph: object
    n_nodes: int
    #: admission class for ``admission="priority"`` (higher runs first)
    priority: int = 0
    #: absolute deadline on the service clock (set via ``submit``'s
    #: relative ``deadline_s``); admission="edf" orders and sheds on it
    deadline_at: "float | None" = None
    #: "queued" -> "admitted" -> "done" | "failed"; or "rejected"
    status: str = "queued"
    reason: "str | None" = None
    result: "ColoringResult | None" = None
    enqueue_s: "float | None" = None
    admit_s: "float | None" = None
    drain_s: "float | None" = None
    admit_round: "int | None" = None
    drain_round: "int | None" = None
    #: chunk dispatches this request was resident for
    chunks: int = 0
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def wait(self, timeout: "float | None" = None) -> bool:
        """Block until the ticket reaches a terminal status (producer-
        thread surface of the async front-end). True = finished."""
        return self._event.wait(timeout)

    @property
    def finished(self) -> bool:
        return self.status in ("done", "failed", "rejected")

    @property
    def queue_seconds(self) -> "float | None":
        if self.admit_s is None:
            return None
        return self.admit_s - self.enqueue_s

    @property
    def service_seconds(self) -> "float | None":
        if self.drain_s is None or self.admit_s is None:
            return None
        return self.drain_s - self.admit_s

    @property
    def total_seconds(self) -> "float | None":
        if self.drain_s is None:
            return None
        return self.drain_s - self.enqueue_s

    @property
    def deadline_met(self) -> "bool | None":
        """None when no deadline was set (or the ticket never drained)."""
        if self.deadline_at is None or self.drain_s is None:
            return None
        return self.drain_s <= self.deadline_at


class _LaneGroup:
    """Resident lanes of one (node rung, window, layout kind) bucket.

    Holds the flattened graph + per-lane carried state (one
    ``exec.batch.LaneState``, with its captured trip) between chunk
    dispatches. All device state is owned here (not by the session
    cache), so cache eviction between rounds can never corrupt a live
    stream — it only costs a re-pad on the next shape-class growth.
    Everything in this class is pump-thread-only (DESIGN.md §14).
    """

    def __init__(self, stream: "StreamSession", rung: int, window: int,
                 kind: str, first_ig):
        self.stream = stream
        self.rung, self.window, self.kind = rung, window, kind
        self.sc = shape_class_for([first_ig], rung, window, kind)
        self.b_max = stream.config.lanes_resolved
        self.adaptive = stream.config.adaptive_lanes
        self.b = 1 if self.adaptive else self.b_max
        self.max_b = self.b
        self.grows = 0
        self.shrinks = 0
        self._low_rounds = 0
        self.chunk_policy = (stream._shared_chunk
                             or make_chunk_policy(stream.config.chunk))
        #: the resident request of each lane (its prepared graph is the
        #: lane group's ``state.lanes[lane]``)
        self.tickets: "list[Ticket | None]" = [None] * self.b
        #: per-rung service-time distribution — the EDF shed estimator
        self.h_service = stream.metrics.histogram(
            f"stream.service_seconds.{rung}.{window}.{kind}",
            LATENCY_EDGES)
        self.state = fresh_lane_state(self.sc, stream._alg, self.b,
                                      stream.session.device)
        stream.restacks += 1

    # -- lane management -----------------------------------------------------

    def free_lane(self) -> "int | None":
        for i, t in enumerate(self.tickets):
            if t is None:
                return i
        return None

    @property
    def resident(self) -> int:
        return sum(t is not None for t in self.tickets)

    def try_grow(self) -> "int | None":
        """Demand growth: double the lane axis (adaptive groups under
        queue pressure) by appending inert filler lanes; returns the
        first new free lane, or None at the width cap / fixed mode."""
        if not self.adaptive or self.b >= self.b_max:
            return None
        b_new = min(self.b * 2, self.b_max)
        self.state = widen_lanes(self.state, b_new)
        lane = self.b
        self.tickets.extend([None] * (b_new - self.b))
        self.b = b_new
        self.max_b = max(self.max_b, b_new)
        self.grows += 1
        self._low_rounds = 0
        return lane

    def maybe_shrink(self) -> bool:
        """Shrink-on-idle at a chunk boundary: if the resident set has
        fit a smaller power of two for ``shrink_after`` consecutive
        rounds, compact to it — resident lanes keep their carried state
        verbatim (they are *selected*, never rebuilt), so a mid-flight
        request rides through the width change bit-identically."""
        if not self.adaptive:
            return False
        target = _pow2(max(self.resident, 1))
        if target >= self.b:
            self._low_rounds = 0
            return False
        self._low_rounds += 1
        if self._low_rounds < self.stream.config.shrink_after:
            return False
        keep = [i for i, t in enumerate(self.tickets) if t is not None]
        idx = keep + [i for i in range(self.b)
                      if self.tickets[i] is None][:target - len(keep)]
        self.state = take_lanes(self.state, idx)
        self.tickets = [self.tickets[i] for i in idx]
        self.b = target
        self.shrinks += 1
        self._low_rounds = 0
        return True

    def _restack(self) -> None:
        """Rebuild the flattened graph under the current ShapeClass.

        Carried per-lane state (colors / aux / worklist / counters)
        depends only on ``n_pad`` — constant within a group — so it is
        deliberately NOT touched here; only the graph arrays re-pad, from
        the lanes' prepared graphs. The new arrays mean a new capture.
        """
        self.state = regraph(self.state, self.sc)
        self.stream.restacks += 1

    def admit(self, lane: int, tk: Ticket, ig) -> None:
        st = self.stream
        grown = grow_shape_class(self.sc, ig)
        if grown != self.sc:
            self.sc = grown
            self._restack()
        self.tickets[lane] = tk
        self.state.admit(lane, ig, device_threshold(st._pol, ig.n_nodes),
                         st.spec.max_iter)
        tk.status = "admitted"
        tk.admit_s = st.clock()
        tk.admit_round = st.round

    # -- one chunk dispatch + harvest ----------------------------------------

    def dispatch(self) -> int:
        """Run one chunk over the resident lanes; harvest drained ones.
        Returns the number of requests that finished this round."""
        st = self.stream
        resident = self.resident
        if resident == 0:
            return 0
        chunk = int(self.chunk_policy())
        with obs_trace.maybe_span("stream.dispatch", rung=self.rung,
                                  window=self.window, kind=self.kind,
                                  resident=resident, b=self.b,
                                  chunk=chunk), \
                Timer() as t:
            trips = self.state.run(chunk, step=st._step, window=self.window,
                                   force_hub=st._force_hub)
        st.dispatch_seconds += t.seconds
        st.dispatches += 1
        st.lane_rounds += self.b
        st.occupied_lane_rounds += resident
        counts, iters_np = self.state.host[COUNT], self.state.host[IT]
        nd_np, ns_np = self.state.host[ND], self.state.host[NS]
        finished = 0
        for lane, tk in enumerate(self.tickets):
            if tk is None:
                continue
            tk.chunks += 1
            done = int(counts[lane]) == 0
            capped = int(iters_np[lane]) >= st.spec.max_iter
            if not (done or capped):
                continue
            self._harvest(lane, tk, counts, iters_np, nd_np, ns_np, done)
            finished += 1
        self.chunk_policy.observe_round(finished, resident, trips)
        return finished

    def _harvest(self, lane, tk, counts, iters_np, nd_np, ns_np,
                 done) -> None:
        st = self.stream
        g = tk.graph
        rn = self.state.lanes[lane].n_nodes
        if done:
            # only the drained lane's own rows come back to the host
            final, n_colors = st._alg.finalize(
                self.state.harvest_colors(lane, rn))
            if (st.config.map_to_original
                    and getattr(g, "perm", None) is not None):
                final = g.perm.colors_to_original(final)
            tk.status = "done"
            tk.drain_s = st.clock()
            tk.drain_round = st.round
            tk.result = ColoringResult(
                colors=final, n_colors=n_colors,
                iterations=int(iters_np[lane]),
                mode_trace=("D" * int(nd_np[lane])
                            + "S" * int(ns_np[lane])),
                counts=[rn], tti=[],
                total_seconds=tk.service_seconds or 0.0,
                host_dispatches=tk.chunks)
        else:
            tk.status = "failed"
            tk.drain_s = st.clock()
            tk.drain_round = st.round
            tk.reason = (f"hit max_iter={st.spec.max_iter} with "
                         f"{int(counts[lane])} undrained nodes")
        self.h_service.observe(tk.service_seconds)
        st._observe_latency(tk)
        st._note_finished(tk)
        # free the lane; its stale state stays inert (count == 0, or
        # iters >= max_iter keeps the lane out of the active mask) and
        # is fully overwritten by the next admit
        self.tickets[lane] = None
        self.state.lanes[lane] = None


class StreamSession:
    """Continuous-batching coloring service over one ``Session``.

    Construct via ``Session.stream(spec, config)``. The execution
    configuration (algorithm, fused family, policy thresholds) is frozen
    at construction with exactly ``run_batch``'s resolution rules, so
    every admission runs the same lane step — and the admission contract
    is the same loud ``spec.validate_batchable()``.

    Threading discipline (DESIGN.md §14): ``submit()`` is thread-safe
    and host-only (type/layout/load validation, no device work); the
    queue, seq counter, outcome counters and live count are the only
    lock-guarded state. ``pump()``/``drain()`` — and everything they
    reach: lane groups, carried device state, session-cache pins — must
    run on ONE thread (the caller's, or the daemon thread ``serving()``
    starts).
    """

    def __init__(self, session, spec: ExecutionSpec,
                 config: "StreamConfig | None" = None):
        self.session = session
        self.spec = spec
        self.config = config or StreamConfig()
        self._alg = spec.validate_batchable()
        self._fused = self._alg.resolve_fused(spec.fused, default=False)
        self._step = self._alg.lane_step(self._fused)
        self._force_hub = ipgc.force_hub_enabled()
        self._pol = make_policy(spec.mode, spec.h)
        self._caps = bucket_capacities(self.config.max_nodes,
                                       ratio=spec.bucket_ratio)
        # a chunk policy OBJECT is shared across groups; int/"auto"
        # resolve per group (each group adapts its own cadence)
        if isinstance(self.config.chunk, (int, str)):
            make_chunk_policy(self.config.chunk)   # validate the knob early
            self._shared_chunk = None
        else:
            self._shared_chunk = make_chunk_policy(self.config.chunk)
        self._admission = make_admission_policy(self.config.admission)
        self.clock = self.config.clock or time.perf_counter
        #: guards the producer-facing state ONLY: queue, seq, counters,
        #: live count (everything else is pump-thread-only)
        self._lock = threading.RLock()
        self._queue: deque[Ticket] = deque()
        self._groups: dict[tuple, _LaneGroup] = {}
        self._seq = 0
        self._live = 0
        self._serving = False
        self._serve_exc: "BaseException | None" = None
        self.round = 0
        self.dispatch_seconds = 0.0
        self.dispatches = 0
        self.restacks = 0
        #: lane-occupancy accumulators: lanes paid for vs lanes used,
        #: summed over chunk dispatches
        self.lane_rounds = 0
        self.occupied_lane_rounds = 0
        self.counters = {"submitted": 0, "admitted": 0, "done": 0,
                         "failed": 0, "rejected": 0, "shed_deadline": 0}
        #: per-service metrics (obs/metrics.py): queue-depth and latency
        #: histograms fed by pump/harvest — fixed-bucket, so percentiles
        #: come without storing per-ticket samples
        self.metrics = MetricsRegistry()
        self._h_depth = self.metrics.histogram("stream.queue_depth",
                                               DEPTH_EDGES)
        self._h_queue = self.metrics.histogram("stream.queue_seconds",
                                               LATENCY_EDGES)
        self._h_service = self.metrics.histogram("stream.service_seconds",
                                                 LATENCY_EDGES)
        self._h_total = self.metrics.histogram("stream.total_seconds",
                                               LATENCY_EDGES)
        self._h_slack = self.metrics.histogram("stream.deadline_slack",
                                               SLACK_EDGES)
        self._outcomes = self.metrics.group(
            "stream.outcome",
            keys=("done", "failed", "rejected", "shed_deadline"))
        self._g_resident = self.metrics.gauge("stream.resident_lanes")
        self._g_width = self.metrics.gauge("stream.lane_width")

    # -- client surface ------------------------------------------------------

    @property
    def queue_len(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def idle(self) -> bool:
        """True when every submitted request has reached a terminal
        status (counted race-free, so it is exact even mid-pump)."""
        with self._lock:
            return self._live == 0

    def submit(self, g, *, priority: int = 0,
               deadline_s: "float | None" = None) -> Ticket:
        """Enqueue one request; never blocks, never raises for load.

        Structural errors (wrong type, a layout the batched Pipe cannot
        stack) raise exactly like ``run_batch``; *load* problems come
        back as a rejected ticket with a reason. ``priority`` feeds
        ``admission="priority"``; ``deadline_s`` (relative to enqueue,
        on the service clock) feeds ``admission="edf"`` ordering and
        shed-on-hopeless. Thread-safe and host-only — producer threads
        may call this while the pump loop runs (``serving()``).
        """
        if not isinstance(g, Graph):
            raise TypeError(
                "StreamSession needs host Graph objects (it pads and "
                f"stacks prepared arrays); got {type(g).__name__}")
        # host-side layout gate (resolve_plan touches no device arrays):
        # a rejected layout must fail loudly at submit, and the pump
        # thread owns all device work, so the eager prepare happens at
        # admission instead
        plan = resolve_plan(g, self.spec.layout)
        if plan is not None and plan.kind == "csr-segment":
            raise NotImplementedError(
                "the streaming service has no csr-segment lanes (per-"
                "graph edge arrays are not lane-stacked); pass "
                "layout='ell-tail' to stream this graph")
        with self._lock:
            tk = Ticket(seq=self._seq, graph=g, n_nodes=g.n_nodes,
                        priority=int(priority))
            self._seq += 1
            self._live += 1
            self.counters["submitted"] += 1
            tk.enqueue_s = self.clock()
            if deadline_s is not None:
                tk.deadline_at = tk.enqueue_s + float(deadline_s)
            if g.n_nodes > self.config.max_nodes:
                return self._reject(
                    tk, f"graph has {g.n_nodes} nodes, above the service "
                        f"bound max_nodes={self.config.max_nodes}")
            if len(self._queue) >= self.config.max_queue:
                try:
                    victim = self._pick_victim(tk)
                except _ShedPolicyError as e:
                    return self._reject(tk, str(e))
                if victim is tk:
                    return self._reject(
                        tk, f"queue full ({self.config.max_queue} "
                            "waiting) and shed policy rejects new "
                            "requests")
                self._queue.remove(victim)
                self._reject(
                    victim, f"queue full: shed in favour of newer "
                            f"request #{tk.seq}")
            self._queue.append(tk)
        return tk

    def pump(self) -> dict:
        """One scheduling round: admit, dispatch each group one chunk,
        harvest, then let under-occupied adaptive groups compact.
        Refill happens ONLY here — between chunk dispatches — and only
        on the pump thread.

        Telemetry per round: the queue depth entering the round lands in
        the ``stream.queue_depth`` histogram; with ``config.trace`` set,
        the round runs under a ``stream.pump`` span (with per-group
        ``stream.dispatch`` child spans)."""
        self.round += 1
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            self._h_depth.observe(len(pending))
        ambient = (obs_trace.tracing(self.config.trace)
                   if self.config.trace is not None
                   else contextlib.nullcontext())
        with ambient, obs_trace.maybe_span("stream.pump", round=self.round,
                                           queued=len(pending)):
            with self.session.pin():
                admitted, leftover = self._admit(pending)
                finished = 0
                for key in sorted(self._groups):
                    finished += self._groups[key].dispatch()
                for key in sorted(self._groups):
                    self._groups[key].maybe_shrink()
        resident = sum(g.resident for g in self._groups.values())
        self._g_resident.set(resident)
        self._g_width.set(sum(g.b for g in self._groups.values()))
        with self._lock:
            self.counters["admitted"] += admitted
            # leftovers are older than anything submitted during the
            # round: restore them at the head, in order
            self._queue.extendleft(reversed(leftover))
            queued = len(self._queue)
        return {"round": self.round, "admitted": admitted,
                "finished": finished, "queued": queued,
                "resident": resident}

    def drain(self, *, max_stall: "int | None" = None) -> None:
        """Pump until every submitted request reaches a terminal status
        (or, under ``serving()``, wait for the pump thread to get there).

        The stall guard bounds no-progress rounds: a resident lane
        advances >= 1 iteration per round (chunk >= 1), so within
        ``max_iter`` rounds it must drain or fail — more stalled rounds
        than that means the scheduler is wedged, and the service raises
        instead of hanging.
        """
        if self._serving:
            while not self.idle:
                if self._serve_exc is not None:
                    raise RuntimeError(
                        "stream pump thread failed") from self._serve_exc
                time.sleep(5e-4)
            return
        limit = (max_stall if max_stall is not None
                 else self.spec.max_iter + 2)
        stall = 0
        while not self.idle:
            info = self.pump()
            if info["admitted"] or info["finished"]:
                stall = 0
            else:
                stall += 1
                if stall > limit:
                    raise RuntimeError(
                        f"stream starvation: {stall} rounds with no "
                        f"admission or drain (queue={self.queue_len})")

    @contextlib.contextmanager
    def serving(self, *, poll_s: float = 5e-4,
                max_stall: "int | None" = None):
        """Async front-end: run the pump loop on a daemon thread while
        the caller (and any other producer threads) ``submit()``.

        Host admission/harvest overlaps device chunk execution: the
        producer side only ever touches the lock-guarded queue, the
        pump thread owns every device-touching structure. On exit the
        context waits for the backlog to drain, stops the thread, and
        re-raises anything the pump loop raised (including the stall
        guard — a wedged scheduler fails loudly, it never hangs).
        ``ManualClock`` is not supported here: timestamps now come from
        two threads.
        """
        if self._serving:
            raise RuntimeError("stream is already serving")
        stop = threading.Event()
        self._serve_exc = None
        limit = (max_stall if max_stall is not None
                 else self.spec.max_iter + 2)

        def loop():
            stall = 0
            try:
                while True:
                    if self.idle:
                        if stop.is_set():
                            return
                        stall = 0
                        time.sleep(poll_s)
                        continue
                    info = self.pump()
                    if info["admitted"] or info["finished"]:
                        stall = 0
                    else:
                        stall += 1
                        if stall > limit:
                            raise RuntimeError(
                                f"stream starvation: {stall} rounds "
                                "with no admission or drain "
                                f"(queue={info['queued']})")
            except BaseException as e:   # surfaced to the producer side
                self._serve_exc = e

        th = threading.Thread(target=loop, name="stream-pump", daemon=True)
        self._serving = True
        th.start()
        try:
            yield self
            while not self.idle and self._serve_exc is None:
                time.sleep(poll_s)
        finally:
            stop.set()
            th.join()
            self._serving = False
        if self._serve_exc is not None:
            exc, self._serve_exc = self._serve_exc, None
            raise exc

    def run(self, graphs) -> "list[ColoringResult]":
        """Batch-compatible convenience: stream ``graphs`` and return
        results in input order (pumping for queue space instead of
        shedding, so no request is lost to backpressure)."""
        if self._serving:
            raise RuntimeError(
                "run() drives the pump synchronously; use submit()/"
                "drain() inside serving()")
        tickets = []
        for g in graphs:
            while self.queue_len >= self.config.max_queue:
                self.pump()
            tickets.append(self.submit(g))
        self.drain()
        out = []
        for tk in tickets:
            if tk.status != "done":
                raise RuntimeError(
                    f"stream request #{tk.seq} {tk.status}: {tk.reason}")
            out.append(tk.result)
        return out

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            queued = len(self._queue)
        occ = (self.occupied_lane_rounds / self.lane_rounds
               if self.lane_rounds else None)
        lane_groups = {
            "/".join(map(str, key)): {
                "b": grp.b, "b_max": grp.b_max, "max_b": grp.max_b,
                "resident": grp.resident, "grows": grp.grows,
                "shrinks": grp.shrinks}
            for key, grp in self._groups.items()}
        return {**counters, "rounds": self.round,
                "dispatches": self.dispatches,
                "restacks": self.restacks,
                "dispatch_seconds": round(self.dispatch_seconds, 6),
                "groups": len(self._groups), "queued": queued,
                "lanes_resolved": self.config.lanes_resolved,
                "adaptive_lanes": self.config.adaptive_lanes,
                "lane_rounds": self.lane_rounds,
                "occupied_lane_rounds": self.occupied_lane_rounds,
                "lane_occupancy": None if occ is None else round(occ, 4),
                "lane_groups": lane_groups}

    def report(self) -> RunReport:
        """Service-level ``RunReport`` (DESIGN.md §12): the scheduling
        counters — including the RESOLVED lane bound (``lanes`` rounded
        up to a power of two) and per-group adaptive widths — plus the
        queue-depth/latency/occupancy instruments the pump/harvest loop
        has accumulated so far. ``to_json()`` is the machine-readable
        service snapshot ``bench_engine_modes --stream`` records."""
        return RunReport(
            regime="stream", algo=str(self.spec.algo),
            graph=f"<stream:{self.counters['submitted']} submitted>",
            host_dispatches=self.dispatches,
            timing={"total_seconds": self.dispatch_seconds,
                    "dispatch_seconds": self.dispatch_seconds,
                    "dispatches": self.dispatches},
            trace=self.config.trace,
            extra={"stream": self.stats(),
                   "metrics": self.metrics.as_dict()})

    # -- scheduling internals ------------------------------------------------

    def _reject(self, tk: Ticket, reason: str, *,
                outcome: str = "rejected") -> Ticket:
        with self._lock:
            tk.status = "rejected"
            tk.reason = reason
            self.counters["rejected"] += 1
            if outcome == "shed_deadline":
                self.counters["shed_deadline"] += 1
            self._outcomes[outcome] += 1
            self._live -= 1
        tk._event.set()
        return tk

    def _pick_victim(self, incoming: Ticket) -> Ticket:
        shed = self.config.shed
        if shed == "reject-new":
            return incoming
        if shed == "shed-oldest":
            return self._queue[0]
        try:
            victim = shed(tuple(self._queue), incoming)
        except Exception as e:
            # a misbehaving user callback must yield a reason-carrying
            # rejected ticket, never a hang or a lost request
            raise _ShedPolicyError(
                f"shed policy raised {type(e).__name__}: {e}") from e
        if victim is not incoming and victim not in self._queue:
            raise ValueError(
                "shed policy must return the incoming ticket or a "
                "queued one")
        return victim

    def _group_for(self, ig, window: int) -> _LaneGroup:
        key = (pick_bucket(self._caps, ig.n_nodes), window, ig.layout_kind)
        grp = self._groups.get(key)
        if grp is None:
            grp = self._groups[key] = _LaneGroup(self, *key, ig)
        return grp

    def _admit(self, pending: "list[Ticket]") -> "tuple[int, list]":
        """Admission scan in policy order with skip-blocked: a full
        group does not block requests bound for groups with space, and
        a blocked adaptive group first tries to grow. Hopeless tickets
        (policy-judged against the group's observed service times) are
        shed here with a reason instead of occupying a lane."""
        if not pending:
            return 0, []
        ordered = list(self._admission.order(tuple(pending), self.clock))
        if len(ordered) != len(pending) or \
                {id(t) for t in ordered} != {id(t) for t in pending}:
            raise ValueError(
                "admission policy order() must return a permutation of "
                "the queued tickets")
        admitted = 0
        leftover: list[Ticket] = []
        for tk in ordered:
            ig, window, _ = self.session._prepare(self.spec, tk.graph,
                                                  self._alg)
            grp = self._group_for(ig, window)
            reason = self._admission.hopeless(
                tk, self.clock, grp.h_service.percentile(90))
            if reason is not None:
                self._reject(tk, reason, outcome="shed_deadline")
                continue
            lane = grp.free_lane()
            if lane is None:
                lane = grp.try_grow()
            if lane is None:
                leftover.append(tk)
                continue
            grp.admit(lane, tk, ig)
            admitted += 1
        return admitted, leftover

    # -- bookkeeping hooks used by _LaneGroup._harvest -----------------------

    def _note_finished(self, tk: Ticket) -> None:
        with self._lock:
            self.counters[tk.status] += 1
            self._outcomes[tk.status] += 1
            self._live -= 1
        tk._event.set()

    def _observe_latency(self, tk: Ticket) -> None:
        """Feed a terminal ticket's stamps into the latency histograms
        (every harvested ticket has all three stamps; rejected tickets
        never reach here)."""
        self._h_queue.observe(tk.queue_seconds)
        self._h_service.observe(tk.service_seconds)
        self._h_total.observe(tk.total_seconds)
        if tk.deadline_at is not None:
            self._h_slack.observe(tk.deadline_at - tk.drain_s)
