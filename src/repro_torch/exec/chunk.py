"""The outlined regime's chunk (``repro/exec/session.py::_chunk_impl``).

A chunk runs IPGC-style trips at one capacity bucket while the reference's
trip condition holds, ``count > 0 and it < max_iter and count > low``. A
``"cond"`` chunk's trip is dense when ``count > thresh``; a ``"dense"`` or
``"sparse"`` chunk runs one kind only. The state of a run lives in static
buffers (``TripState``: colors, aux, mask, the items at the largest
capacity, and the counters ``[count, nd, it, ns]``), so that every trip
reads and writes the same addresses: a trip calls the algorithm's step on
the buffers (the items of bucket ``c`` are the prefix view ``items[:c]``)
and copies the step's outputs back into them, then counts itself (``it``,
and ``nd`` or ``ns``) on the device.

Two implementations, chosen by the device the prepared graph lies on:

* CPU: each trip runs eagerly.
* CUDA: each (capacity, kind) trip is captured once as a CUDA graph, and a
  trip is one replay. The CUDA graph API of the PyTorch this port runs on
  has no conditional nodes (``CUDAGraph.begin_capture_to_if_node`` is
  missing from PyTorch 2.11), so a graph holds one trip and cannot decide
  for itself whether to run: the host reads the counters once per replay
  (four int32 in one copy) and evaluates the trip condition, and in a
  ``"cond"`` chunk the kind of the next trip, from that read. The per-op
  launches of the host loop are gone; one count read per trip remains,
  as in the host loop.

In both, the host reads the counters once per trip and nothing else. Every
replay runs with CUDA's sync debug mode at "error"; only the read runs
outside it. A failed capture or replay raises: a CUDA graph never falls
back to eager execution or to the CPU.

Before a graph is captured, its trip runs once on a side stream on clones
of the state (never on the live state), so that the kernels are built and
loaded and every PyTorch op has run once; the warm-up's intermediates are
then returned to the device, so that the capture's pool can take their
memory (a lane group's trip may need tens of GB). The graphs of one runner
share one memory pool (``torch.cuda.graph_pool_handle``): a trip's
intermediates are freed at the end of its capture, and only one graph
replays at a time.

Counters: ``kernels._build.KERNEL_LAUNCHES`` and ``core.ipgc``'s counters
move when a step's Python runs, so here once per warm-up and once per
capture. ``REPLAYED_LAUNCHES`` adds, per replay, the kernel launches the
replayed trip captured: the launches of the trips that ran.
``CHUNK_COUNTS`` counts chunks, counter reads, graphs captured and the
microseconds spent capturing them (warm-up included).

``TripState``, ``capture_trip`` and ``replay`` are shared with the lane
runner of the batched Pipe (``exec/batch.py``), whose trips and reads the
same counters count.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.worklist import Worklist
from repro_torch.kernels import _build
from repro_torch.obs.metrics import CounterGroup

#: the CUDA kernel launches of the replayed trips, per kernel source
REPLAYED_LAUNCHES = CounterGroup("outlined.replayed_launches",
                                 _build.SOURCES)
#: chunks run, counter reads (one per trip), graphs captured and the
#: microseconds their warm-up and capture took
CHUNK_COUNTS = CounterGroup("outlined.chunks",
                            ("chunks", "reads", "graphs", "capture_us"))

#: the counters' slots in ``TripState.ctr``: a dense trip adds one to
#: ``ctr[1:3]`` (nd, it), a sparse trip to ``ctr[2:4]`` (it, ns)
COUNT, ND, IT, NS = range(4)


@dataclasses.dataclass
class TripState:
    """The mutable state of a run, at static addresses. A lane group
    (``exec/batch.py``) keeps a column of counters per lane and its
    per-lane limits in ``lim``."""

    colors: torch.Tensor      # int32[N+1]
    aux: torch.Tensor         # the algorithm's aux (IPGC bases, JPL round)
    mask: torch.Tensor        # bool[N]
    items: torch.Tensor       # int32[capacity], the largest bucket
    #: int32[4] (a lane group: int32[4, b]): count, nd, it, ns
    ctr: torch.Tensor
    #: a lane group's int32[2, b]: threshold, max_iter
    lim: "torch.Tensor | None" = None

    def clone(self) -> "TripState":
        return TripState(*(None if t is None else t.clone()
                           for t in self.tensors()))

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@dataclasses.dataclass(frozen=True)
class ChunkResult:
    count: int     # the worklist count after the chunk
    it: int        # the run's iteration count after the chunk
    nd: int        # dense trips of the chunk
    ns: int        # sparse trips of the chunk


class _Trip:
    """One captured trip: the CUDA graph and the kernel launches it holds."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = {k: v for k, v in launches.items() if v}


def capture_trip(trip, state, *, pool, stream) -> _Trip:
    """Capture ``trip(state)`` as a CUDA graph in ``pool`` on the side
    ``stream``, after one warm-up ``trip(state.clone())`` there (the
    kernels built and loaded, every PyTorch op run once, the live state
    untouched) whose intermediates go back to the device before the
    capture. A failed capture raises."""
    t0 = time.perf_counter()
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        trip(state.clone())
    cur.wait_stream(stream)
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    before = _build.KERNEL_LAUNCHES.as_dict()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        trip(state)
    launches = {k: v - before[k] for k, v in _build.KERNEL_LAUNCHES.items()}
    CHUNK_COUNTS["graphs"] += 1
    CHUNK_COUNTS["capture_us"] += int((time.perf_counter() - t0) * 1e6)
    return _Trip(graph, launches)


def replay(trip: _Trip) -> None:
    """One replay of a captured trip with CUDA's sync debug mode at
    "error", counted in ``REPLAYED_LAUNCHES``."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trip.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    for k, v in trip.launches.items():
        REPLAYED_LAUNCHES[k] += v


class ChunkRunner:
    """The static state of outlined runs on one prepared graph, and the
    trips captured on it.

    ``alg.step_fns(fused)`` gives the steps; ``window`` and ``force_hub``
    are fixed per runner, as they are per chunk program in the reference.
    ``capacity`` is the largest bucket (``caps[0]``). A runner serves one
    run at a time; ``reset`` starts a run.
    """

    def __init__(self, ig, alg, *, fused: bool, window: int,
                 force_hub: bool, capacity: int):
        self.ig = ig
        self.alg = alg
        self.window = window
        self.force_hub = force_hub
        self.dense_fn, self.sparse_fn = alg.step_fns(fused)
        colors, aux, wl = alg.init_state(ig)
        self.state = TripState(colors, aux, wl.mask,
                               torch.empty(capacity, dtype=torch.int32,
                                           device=ig.device),
                               torch.zeros(4, dtype=torch.int32,
                                           device=ig.device))
        self.cuda = ig.device.type == "cuda"
        if not self.cuda and ig.device.type != "cpu":
            raise ValueError(f"no chunk runner for tensors on {ig.device}")
        self.trips: dict[tuple[int, bool], _Trip] = {}
        self.pool = self.stream = None
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(ig.device)

    @property
    def colors(self) -> torch.Tensor:
        return self.state.colors

    def reset(self) -> None:
        """Load the algorithm's initial state into the buffers: everything
        active, the items padded with the ``N`` sentinel to the capacity
        (``resize_items`` to ``caps[0]``), count ``N`` and no trips."""
        n = self.ig.n_nodes
        colors, aux, wl = self.alg.init_state(self.ig)
        s = self.state
        s.colors.copy_(colors)
        s.aux.copy_(aux)
        s.mask.copy_(wl.mask)
        s.items.fill_(n)
        s.items[:n].copy_(wl.items)
        s.ctr.zero_()
        s.ctr[COUNT] = n

    def _trip(self, s: TripState, cap: int, dense: bool) -> None:
        """One trip on the buffers of ``s``: the step, its outputs copied
        back, the trip counted."""
        items = s.items[:cap]
        step = self.dense_fn if dense else self.sparse_fn
        colors, aux, wl = step(self.ig, s.colors, s.aux,
                               Worklist(mask=s.mask, items=items,
                                        count=s.ctr[COUNT]),
                               window=self.window, force_hub=self.force_hub)
        s.colors.copy_(colors)
        s.aux.copy_(aux)
        s.mask.copy_(wl.mask)
        items.copy_(wl.items)
        s.ctr[COUNT].copy_(wl.count)
        first = ND if dense else IT
        s.ctr[first:first + 2].add_(1)

    def _captured(self, cap: int, dense: bool) -> _Trip:
        """The CUDA graph of one trip at ``cap``, captured at first use."""
        trip = self.trips.get((cap, dense))
        if trip is None:
            trip = self.trips[(cap, dense)] = capture_trip(
                lambda s: self._trip(s, cap, dense), self.state,
                pool=self.pool, stream=self.stream)
        return trip

    def _run_trip(self, cap: int, dense: bool) -> None:
        if self.cuda:
            replay(self._captured(cap, dense))
        else:
            self._trip(self.state, cap, dense)

    def run(self, cap: int, *, branch: str, thresh: int, low: int,
            max_iter: int, count: int, it: int) -> ChunkResult:
        """One chunk at capacity ``cap`` from the host's last read
        (``count``, ``it``): trips while the trip condition holds, each
        dense or sparse as ``branch`` says (``"cond"``: dense when
        ``count > thresh``), one counter read after each."""
        if branch not in ("dense", "sparse", "cond"):
            raise ValueError(f"unknown chunk branch {branch!r}")
        CHUNK_COUNTS["chunks"] += 1
        self.state.ctr[ND::2].zero_()
        nd = ns = 0
        while count > 0 and it < max_iter and count > low:
            dense = branch == "dense" or (branch == "cond" and count > thresh)
            self._run_trip(cap, dense)
            count, nd, it, ns = self.state.ctr.tolist()  # the one read
            CHUNK_COUNTS["reads"] += 1
        return ChunkResult(count=count, it=it, nd=nd, ns=ns)
