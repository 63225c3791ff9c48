"""Execution sessions (``repro/exec/session.py``: host, outlined and dist
regimes).

A ``Session`` owns the device it runs on and a keyed cache of prepared
graphs: ``Session.run(spec, g)`` prepares ``g`` once per (graph, spec)
pair and drives the host-loop Pipe. The loop reads back one scalar per
iteration, the worklist ``count`` — exactly what IrGL's Pipe uses for its
worklist-size check — picks dense or sparse from it (the paper's H
policy) and a capacity bucket, and dispatches the step. The steps read
nothing else back, so that read is the iteration's only synchronisation.

The outlined regime runs one chunk per capacity bucket (``exec/chunk.py``);
the host re-enters only at bucket boundaries. Its chunk runners (the
static state buffers and, on a CUDA device, the captured trips) live in
the prepared graph's cache entry and go with it.

The dist regime runs the same loop over the distributed steps
(``core/distributed.py``) on a partitioned graph; the partition is cached
per (graph content, shard count, balance), so every algorithm run on one
partition builds it once, and an equal graph rebuilt per request reuses
it. With ``exchange="boundary"|"auto"`` the colors are per-shard views,
each iteration's packed-buffer capacity is picked from the partition's
boundary ladder and the last iteration's changed-boundary count, and the
iteration's one read brings back the count and the exchange stats
together; the exchange trace (``'b'`` packed, ``'d'`` dense swap, ``'m'``
mixed) and the byte ledger follow the reference.

``Session.run(trace=)`` returns a ``RunReport`` (DESIGN.md §12): the
host loops open ``session.prepare``, ``session.iter``, ``session.count``,
``session.chunk`` and ``session.readback`` spans, the steps their
``ipgc.*`` spans (``obs/trace.py``), and after the timed run the steps
run once more, uncaptured, on clones of the initial state, to count
their launches, gathers and exchanges per iteration (cached per
configuration; the kernel launches of that run are scoped away). The
run's spans come back on ``ColoringResult.spans``; on a CUDA device the
host and outlined regimes' spans are device-timed by CUDA events that the
trace resolves when it is first read, after the run, so tracing reads
nothing more back and adds no synchronisation to the run. While torch's
profiler records, an untraced run traces itself into a run-local trace
the same way.

``run_batch`` colors many graphs at once as flattened lane groups
(``exec/batch.py``), and ``stream`` opens the continuous-batching service
over this session (``serve/stream.py``). Both pin the cache entries a run
touches (``pin``), so a bounded session never evicts a live run's own
entries mid-flight.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import ipgc
from repro_torch.core.engine import (ColoringResult, adaptive_window,
                                     resolve_plan)
from repro_torch.core.policy import (AutoTuned, Policy, Timer,
                                     device_threshold, exchange_threshold,
                                     make_policy, measure_launches)
from repro_torch.core.worklist import (bucket_capacities, chunk_lower_bounds,
                                       pick_bucket, resize_items)
from repro_torch.device import resolve_device
from repro_torch.exec.chunk import ChunkRunner
from repro_torch.exec.spec import ExecutionSpec
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partition import boundary_info, prepare_partition
from repro_torch.kernels._build import KERNEL_LAUNCHES
from repro_torch.kernels.tune import resolve_tile_rows
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.report import (RunReport, dense_exchange_bytes,
                                    dense_swap_bytes, exchange_section,
                                    packed_exchange_bytes, totals_from_trace)


@dataclasses.dataclass
class CacheStats:
    """Hit/miss counters for the session's prepared-graph cache."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}

    def reset(self) -> None:
        self.hits = 0
        self.misses = 0
        self.evictions = 0


@dataclasses.dataclass
class _DispatchMeter:
    """Per-run dispatch accounting, filled by the host loops when a run is
    traced (DESIGN.md §12).

    ``first - best`` is the report's *compile proxy*: the first dispatch of
    a cold entry pays the kernels' build and load (and, outlined on a
    card, the trips' captures), steady-state dispatches don't — a proxy,
    exact only when steady-state dispatches are homogeneous. ``statics``
    snapshots the loop's resolved static arguments so the work profile
    runs exactly the steps the run used.
    """

    dispatch_seconds: float = 0.0
    first: "float | None" = None
    best: "float | None" = None
    n: int = 0
    statics: "dict | None" = None

    def add(self, seconds: float) -> None:
        self.dispatch_seconds += seconds
        if self.first is None:
            self.first = seconds
        self.best = seconds if self.best is None else min(self.best, seconds)
        self.n += 1

    def timing(self, total_seconds: float) -> dict:
        first = self.first or 0.0
        best = self.best or 0.0
        return {
            "total_seconds": total_seconds,
            "dispatch_seconds": self.dispatch_seconds,
            "dispatches": self.n,
            "first_dispatch_seconds": first,
            "best_dispatch_seconds": best,
            "compile_proxy_seconds": max(0.0, first - best),
            "host_overhead_seconds": max(
                0.0, total_seconds - self.dispatch_seconds),
        }


#: id(graph) -> its content key, dropped when the graph is collected
_CONTENT_KEYS: dict[int, tuple] = {}


def _content_key(g: Graph) -> tuple:
    """Graph half of the partition and dist cache keys: by content — name,
    sizes, layout plan and a digest of the CSR arrays (``row_ptr``,
    ``col_idx``), memoised per graph object. An equal graph rebuilt per
    request hits (the reference's ``steps_cache`` contract); a relabeled
    graph with the same name and sizes does not."""
    key = _CONTENT_KEYS.get(id(g))
    if key is None:
        h = hashlib.blake2b(digest_size=16)
        for a in (g.arrays.row_ptr, g.arrays.col_idx):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(memoryview(a).cast("B"))
        key = ("content", g.name, g.n_nodes, g.n_edges, g.layout,
               h.hexdigest())
        _CONTENT_KEYS[id(g)] = key
        weakref.finalize(g, _CONTENT_KEYS.pop, id(g), None)
    return key


#: the step family ``fused=None`` runs in the outlined regime, per device
#: type: two-phase on the CPU (the reference's choice off the TPU); fused
#: on CUDA, which ``chip_smoke.py`` measured faster outlined on europe and
#: level with the two-phase family on kron (PERF.md §6)
OUTLINED_FUSED = {"cpu": False, "cuda": True}


class Session:
    """The device and the prepared-graph cache behind ``engine.color``.

    ``device`` defaults to the CUDA device (``repro_torch.device``).
    ``max_entries`` bounds the cache FIFO-style; ``None`` keeps every
    entry. ``cache``: the dict to keep the entries in (a fresh one by
    default); ``color_distributed``'s ``steps_cache`` arrives here.
    """

    def __init__(self, device=None, max_entries: "int | None" = None,
                 cache: "dict | None" = None):
        self.device = resolve_device(device)
        self.cache: dict = {} if cache is None else cache
        self.max_entries = max_entries
        self.stats = CacheStats()
        self._pin_depth = 0
        self._pinned: set = set()
        #: reentrant: a ``build`` may look up other entries, and a stream's
        #: pump thread shares the session with its caller
        self._lock = threading.RLock()

    @staticmethod
    def graph_key(g) -> tuple:
        """Graph half of the keys of the entries made from ``g`` (``"prep"``,
        ``"runners"``, ``run_batch``'s ``"stack"``): identity + static
        fields. Every entry holds a reference to ``g``, so the id cannot be
        recycled while the entry lives."""
        if isinstance(g, Graph):
            return ("graph", id(g), g.name, g.n_nodes, g.n_edges)
        return ("ig", id(g), g.n_nodes, g.ell_width, g.n_hub, g.layout_kind)

    @contextlib.contextmanager
    def pin(self):
        """Exempt every entry touched inside the block from FIFO eviction,
        so a multi-entry run (``run_batch``, a stream round) never evicts
        its own entries mid-flight. While pinned the bound may be
        exceeded; the outermost exit re-applies it against the oldest
        unpinned entries. Nests."""
        with self._lock:
            self._pin_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._pin_depth -= 1
                if self._pin_depth == 0:
                    self._pinned.clear()
                    self._evict()

    def _evict(self) -> None:
        if self.max_entries is None:
            return
        while len(self.cache) > self.max_entries:
            # FIFO: the entry just added is last, so it never evicts
            # itself; a live run's pinned entries are skipped
            victim = next((k for k in self.cache if k not in self._pinned),
                          None)
            if victim is None:
                return
            self.cache.pop(victim)
            self.stats.evictions += 1

    def cached(self, key: tuple, build):
        with self._lock:
            hit = key in self.cache
            if hit:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
                self.cache[key] = build()
            entry = self.cache[key]
            if self._pin_depth > 0:
                self._pinned.add(key)
            if not hit:
                self._evict()
            return entry

    def run(self, spec: ExecutionSpec, g, *, policy: "Policy | None" = None,
            collect_tti: bool = False, devices=None, trace=None):
        """Color one graph (a host ``Graph`` or a prepared ``IPGCGraph``
        on this session's device) as ``spec`` says. ``devices`` is the
        dist regime's mesh, one device per shard (see
        ``core.distributed.resolve_mesh``; None deals ``spec.n_shards``
        shards on this session's kind of device).

        ``trace`` turns on telemetry (DESIGN.md §12): ``True`` for a fresh
        ``obs.Trace``, or a ``Trace`` to append to (e.g. with an injected
        clock). A traced run returns a ``RunReport``: the same
        ``ColoringResult`` (under ``.result``, with passthrough
        properties) plus the spans, the per-iteration launch, gather and
        exchange profiles, the compile-vs-execute split and a cache
        snapshot. In its timed window a traced run launches the kernels
        an untraced run launches and reads back nothing more.

        Without ``trace`` the run's spans go to the thread's ambient
        trace, or, while torch's profiler records, to a run-local one;
        either comes back as ``ColoringResult.spans``. With neither, the
        run opens no span and ``spans`` is None."""
        if trace is None or trace is False:
            tr = obs_trace.current_trace()
            if tr is None and not obs_trace.profiling():
                return self._execute(spec, g, policy=policy,
                                     collect_tti=collect_tti, devices=devices)
            tr = tr or obs_trace.Trace()
            with obs_trace.tracing(tr):
                return self._scoped(tr, spec, lambda: self._execute(
                    spec, g, policy=policy, collect_tti=collect_tti,
                    devices=devices))
        tr = obs_trace.Trace() if trace is True else trace
        meter = _DispatchMeter()
        stats0 = dataclasses.replace(self.stats)
        with obs_trace.tracing(tr):
            with tr.span("session.run", regime=spec.regime, mode=spec.mode,
                         algo=str(spec.algo), graph=self._graph_name(g)):
                result = self._scoped(tr, spec, lambda: self._execute(
                    spec, g, policy=policy, collect_tti=collect_tti,
                    devices=devices, meter=meter))
                with tr.span("obs.profile"):
                    profile = self._work_profile(meter)
        return self._assemble_report(spec, g, result, meter, profile,
                                     stats0, tr)

    def _scoped(self, tr, spec: ExecutionSpec, execute) -> ColoringResult:
        """``execute()`` inside ``tr``'s run scope, the result handed back
        with ``spans=tr``. The host and outlined regimes on a CUDA device
        time their spans on the device too; the dist regime's, which span
        several devices, keep the host clock alone."""
        with tr.run_scope(None if spec.regime == "dist" else self.device):
            result = execute()
        result.spans = tr
        return result

    def _execute(self, spec: ExecutionSpec, g, *, policy, collect_tti,
                 devices, meter=None) -> ColoringResult:
        if spec.regime == "dist":
            return self._run_dist(spec, g, policy=policy,
                                  collect_tti=collect_tti, devices=devices,
                                  meter=meter)
        if spec.regime == "outlined":
            return self._run_outlined(spec, g, policy=policy,
                                      collect_tti=collect_tti, meter=meter)
        return self._run_host(spec, g, policy=policy,
                              collect_tti=collect_tti, meter=meter)

    @staticmethod
    def _graph_name(g) -> str:
        name = getattr(g, "name", None)
        return name if name else f"<prepared n={g.n_nodes}>"

    def partition(self, g: Graph, n_shards: int, *, balance: bool = True):
        """``prepare_partition(g, n_shards)``, cached: ``(g2, new_of_old)``
        with ``g2`` padded to equal, degree-balanced owner blocks."""
        return self._partition(g, n_shards, balance)[:2]

    def _partition(self, g: Graph, n_shards: int, balance: bool):
        """The partition entry ``(g2, new_of_old, memo)``; ``memo`` keeps
        the partition's ``BoundaryInfo`` once a boundary-exchange build
        has made it (a pass over every edge), for every algorithm and
        exchange run on this partition."""
        key = ("partition", _content_key(g), n_shards, balance)
        return self.cached(key, lambda: (*prepare_partition(
            g, n_shards, balance=balance), {}))

    def run_batch(self, spec: ExecutionSpec, graphs,
                  *, map_to_original: bool = False, trace=None):
        """Color many graphs at once (``exec/batch.py``); results in input
        order, each equal to ``run(spec, g)`` in the host regime.
        ``map_to_original=True`` maps each lane's colors back through its
        graph's ``Permutation``.

        With ``trace`` (True or a ``Trace``), returns a batch-level
        ``RunReport`` instead: ``.result`` holds the results,
        ``extra["lanes"]`` the per-lane summaries, and the trace one
        ``batch.dispatch`` span per shape-class bucket."""
        from repro_torch.exec import batch as _batch
        if trace is None or trace is False:
            return _batch.run_batch(self, spec, graphs,
                                    map_to_original=map_to_original)
        tr = obs_trace.Trace() if trace is True else trace
        stats0 = dataclasses.replace(self.stats)
        graphs = list(graphs)
        with obs_trace.tracing(tr):
            with tr.span("batch.run", graphs=len(graphs)) as sp:
                results = _batch.run_batch(
                    self, spec, graphs, map_to_original=map_to_original)
        lanes = [{"graph": g.name, "n_nodes": g.n_nodes,
                  "n_colors": r.n_colors, "iterations": r.iterations,
                  "mode_trace": r.mode_trace}
                 for g, r in zip(graphs, results)]
        return RunReport(
            regime="batch", algo=str(spec.algo), graph=f"<{len(graphs)}>",
            n_nodes=sum(g.n_nodes for g in graphs),
            n_colors=max((r.n_colors for r in results), default=0),
            iterations=max((r.iterations for r in results), default=0),
            host_dispatches=len(tr.find("batch.dispatch")),
            timing={"total_seconds": sp.seconds},
            cache=self._cache_section(stats0),
            result=results, trace=tr, extra={"lanes": lanes})

    def stream(self, spec: ExecutionSpec, config=None):
        """A continuous-batching service over this session
        (``serve/stream.py``): requests are submitted as they arrive,
        lanes that drain at a chunk boundary are refilled from the queue,
        and each result equals ``run(spec, g)`` in the host regime."""
        from repro_torch.serve.stream import StreamSession
        return StreamSession(self, spec, config)

    def _cache_section(self, stats0: CacheStats) -> dict:
        """The cache totals and this run's delta."""
        return {**self.stats.as_dict(),
                "run_delta": {
                    "hits": self.stats.hits - stats0.hits,
                    "misses": self.stats.misses - stats0.misses,
                    "evictions": self.stats.evictions - stats0.evictions}}

    # -- telemetry: work profile and report assembly (DESIGN.md §12) ---------

    def _work_profile(self, meter: _DispatchMeter) -> dict:
        """Per-iteration work profile of the run's steps: each step of the
        run's family runs once, uncaptured, on clones of the initial state
        under the scoped counter groups (``measure_launches``), after the
        timed run. Cached under the session's key space: repeated traced
        runs of one configuration pay a dict lookup."""
        s = meter.statics
        if s is None:
            return {}
        if s["kind"] == "dist":
            return self._profile_dist(s)
        alg, ig = s["alg"], s["ig"]
        kw = dict(window=s["window"], force_hub=s["force_hub"],
                  tile_rows=s["tile_rows"])
        key = ("obs-profile", "local", self.graph_key(ig), alg, s["fused"],
               tuple(sorted(kw.items())))

        def build():
            colors, aux, wl = alg.init_state(ig)
            out = {}
            for mode, step in zip(("dense", "sparse"),
                                  alg.step_fns(s["fused"])):
                with ipgc.GATHER_COUNTS.scope() as gc:
                    launches = measure_launches(step, ig, colors, aux, wl,
                                                **kw)
                    gathers = gc.as_dict()
                out[mode] = {"launches": launches, "gathers": gathers}
            return out

        return self.cached(key, build)

    def _profile_dist(self, s: dict) -> dict:
        """Launch, gather and exchange profile of the distributed steps:
        each runs once on the initial sharded state. Launches and gathers
        count once per shard when they run, so they are divided by the
        shard count (the reference counts one shard's program); exchanges
        count once per collective. A boundary step computes both publish
        paths, so it counts a ``boundary_pack`` and a ``dense_swap`` per
        publish, as the reference counts both ``lax.cond`` branches."""
        key = ("obs-profile",) + s["dist_key"]
        n_shards = len(s["mesh"])

        def build():
            alg, ig, mesh = s["alg"], s["ig"], s["mesh"]
            colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
            kw = {}
            if s["exchange"] != "dense":
                colors = dist.shard_views(colors)
                kw = dict(bcap=s["binfo"].capacities[0])
            out = {}
            for mode, step in zip(("dense", "sparse"), s["steps"]):
                with ipgc.LAUNCH_COUNTS.scope() as lc, \
                        ipgc.GATHER_COUNTS.scope() as gc, \
                        dist.EXCHANGE_COUNTS.scope() as ec, \
                        KERNEL_LAUNCHES.scope():
                    step(colors, aux, wl, **kw)
                    out[mode] = {
                        "launches": {k: v // n_shards
                                     for k, v in lc.items()},
                        "gathers": {k: v // n_shards
                                    for k, v in gc.items()},
                        "exchanges": ec.as_dict()}
            return out

        return self.cached(key, build)

    def _assemble_report(self, spec, g, result, meter, profile, stats0,
                         tr) -> RunReport:
        def section(field):
            per_iter = {m: profile[m][field] for m in profile}
            return {"per_iter": per_iter,
                    "total": totals_from_trace(result.mode_trace, per_iter)}

        exchanges = None
        if spec.regime == "dist" and profile:
            per_iter = {m: {k: v for k, v in profile[m]["exchanges"].items()
                            if v} for m in profile}
            # the byte formulas run over the PARTITIONED node count
            # (prepare_partition pads n to a multiple of the shard count)
            exchanges = exchange_section(
                per_iter, meter.statics["ig"].n_nodes, result.mode_trace,
                exchange=meter.statics["exchange"],
                n_shards=len(meter.statics["mesh"]),
                exchange_trace=result.exchange_trace,
                exchange_bytes=result.exchange_bytes)
        alg = spec.resolved_algo()
        return RunReport(
            regime=spec.regime, algo=alg.name, graph=self._graph_name(g),
            n_nodes=g.n_nodes, n_colors=result.n_colors,
            iterations=result.iterations, mode_trace=result.mode_trace,
            host_dispatches=result.host_dispatches,
            counts=list(result.counts),
            timing=meter.timing(result.total_seconds),
            launches=section("launches") if profile else {},
            gathers=section("gathers") if profile else {},
            exchanges=exchanges, cache=self._cache_section(stats0),
            result=result, trace=tr)

    def _prepare(self, spec: ExecutionSpec, g, alg):
        """(prepared IPGCGraph, resolved window, chunk runners), cached per
        graph. The runners dict (the outlined regime's, keyed by step
        family and hub forcing) rides the prep entry, which the host and
        outlined regimes share; it is None for a graph the caller
        prepared, which has no entry."""
        if isinstance(g, ipgc.IPGCGraph):
            if g.device != self.device:
                raise ValueError(f"prepared graph lies on {g.device}, the "
                                 f"session runs on {self.device}")
            if spec.window != "auto":
                return g, spec.window, None
            if alg.uses_window:
                raise ValueError("window='auto' needs a host Graph (it "
                                 "reads the degree histogram)")
            return g, 128, None
        plan = resolve_plan(g, spec.layout)
        key = ("prep", self.graph_key(g), alg, spec.priority, plan,
               spec.window)

        def build():
            if spec.window != "auto":
                window = spec.window
            else:
                window = adaptive_window(g) if alg.uses_window else 128
            ig = alg.prepare(g, priority=spec.priority, plan=plan,
                             device=self.device)
            return g, ig, window, {}

        _, ig, window, runners = self.cached(key, build)
        return ig, window, runners

    def _run_host(self, spec: ExecutionSpec, g, *, policy, collect_tti,
                  meter=None) -> ColoringResult:
        alg = spec.resolved_algo()
        fused = alg.resolve_fused(spec.fused, default=False)
        with obs_trace.maybe_span("session.prepare"):
            ig, window, _ = self._prepare(spec, g, alg)
        n = ig.n_nodes
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(n, ratio=spec.bucket_ratio)
        force_hub = ipgc.force_hub_enabled()
        tile_rows = resolve_tile_rows(spec.tile_rows, ig.layout_kind,
                                      self.device)
        dense_fn, sparse_fn = alg.step_fns(fused)
        if meter is not None:
            meter.statics = dict(kind="host", alg=alg, ig=ig, fused=fused,
                                 window=window, force_hub=force_hub,
                                 tile_rows=tile_rows)

        colors, aux, wl = alg.init_state(ig)
        count = n
        trace: list[str] = []
        counts: list[int] = []
        tti: list[float] = []
        t_start = time.perf_counter()
        it = 0
        while count > 0 and it < spec.max_iter:
            use_dense = bool(pol(count, n))
            counts.append(count)
            with obs_trace.maybe_span(
                    "session.iter", mode="D" if use_dense else "S",
                    count=count), Timer() as t:
                if use_dense:
                    colors, aux, wl = dense_fn(ig, colors, aux, wl,
                                               window=window,
                                               force_hub=force_hub,
                                               tile_rows=tile_rows)
                else:
                    cap = pick_bucket(caps, count)
                    if wl.capacity > cap:
                        wl = resize_items(wl, cap, n)
                    colors, aux, wl = sparse_fn(ig, colors, aux, wl,
                                                window=window,
                                                force_hub=force_hub,
                                                tile_rows=tile_rows)
                with obs_trace.maybe_span("session.count"):
                    count = int(wl.count)  # the Pipe's one scalar read-back
            trace.append("D" if use_dense else "S")
            if meter is not None:
                meter.add(t.seconds)
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe(use_dense, counts[-1], n, t.seconds)
            it += 1

        total = time.perf_counter() - t_start
        with obs_trace.maybe_span("session.readback"):
            final, n_colors = alg.finalize(colors[:n].cpu().numpy())
        return ColoringResult(colors=final, n_colors=n_colors,
                              iterations=it, mode_trace="".join(trace),
                              counts=counts, tti=tti, total_seconds=total,
                              host_dispatches=it)

    # -- outlined Pipe -----------------------------------------------------------

    def _run_outlined(self, spec: ExecutionSpec, g, *, policy, collect_tti,
                      meter=None) -> ColoringResult:
        """The reference's ``_run_outlined``: one chunk per capacity
        bucket, the worklist at ``caps[0]`` from the start; per chunk the
        bucket, the policy's device threshold and the static branch
        (``"dense"`` when the chunk's count range lies above the
        threshold, ``"sparse"`` when below, else ``"cond"``). ``counts``
        and ``tti`` are per chunk, the mode trace comes from the chunks'
        dense/sparse trip counters, and ``host_dispatches`` is the number
        of chunks."""
        alg = spec.resolved_algo()
        fused = alg.resolve_fused(spec.fused,
                                  default=OUTLINED_FUSED[self.device.type])
        with obs_trace.maybe_span("session.prepare"):
            ig, window, runners = self._prepare(spec, g, alg)
            if runners is None:
                _, runners = self.cached(
                    ("runners", self.graph_key(ig), window),
                    lambda: (ig, {}))
        n = ig.n_nodes
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(n, ratio=spec.bucket_ratio)
        lows = chunk_lower_bounds(caps)
        force_hub = ipgc.force_hub_enabled()
        tile_rows = resolve_tile_rows(spec.tile_rows, ig.layout_kind,
                                      self.device)
        if meter is not None:
            meter.statics = dict(kind="outlined", alg=alg, ig=ig,
                                 fused=fused, window=window,
                                 force_hub=force_hub, tile_rows=tile_rows)
        rkey = (fused, force_hub, caps[0])
        runner = runners.get(rkey)
        if runner is None:
            runner = runners[rkey] = ChunkRunner(
                ig, alg, fused=fused, window=window, force_hub=force_hub,
                capacity=caps[0])
        runner.reset(tile_rows)
        count = n

        trace: list[str] = []
        counts: list[int] = []
        tti: list[float] = []
        t_start = time.perf_counter()
        it = 0
        bi = 0
        while count > 0 and it < spec.max_iter:
            while bi < len(caps) - 1 and caps[bi + 1] >= count:
                bi += 1
            thresh = device_threshold(pol, n)
            # chunk counts stay in (lows[bi], caps[bi]]: one kind of trip
            # unless the H flip lands inside this chunk
            if lows[bi] >= thresh:
                branch = "dense"
            elif caps[bi] <= thresh:
                branch = "sparse"
            else:
                branch = "cond"
            counts.append(count)
            with obs_trace.maybe_span("session.chunk", branch=branch,
                                      count=count, cap=caps[bi]), \
                    Timer() as t:
                c = runner.run(caps[bi], branch=branch, thresh=thresh,
                               low=lows[bi], max_iter=spec.max_iter,
                               count=count, it=it)
            count, it = c.count, c.it
            trace.append("D" * c.nd + "S" * c.ns)
            if meter is not None:
                meter.add(t.seconds)
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe_chunk(c.nd, c.ns, (counts[-1] + count) / 2,
                                  t.seconds)

        total = time.perf_counter() - t_start
        with obs_trace.maybe_span("session.readback"):
            final, n_colors = alg.finalize(runner.colors[:n].cpu().numpy())
        return ColoringResult(colors=final, n_colors=n_colors, iterations=it,
                              mode_trace="".join(trace), counts=counts,
                              tti=tti, total_seconds=total,
                              host_dispatches=len(counts))

    # -- sharded distributed Pipe --------------------------------------------

    def _run_dist(self, spec: ExecutionSpec, g, *, policy, collect_tti,
                  devices, meter=None) -> ColoringResult:
        alg = spec.resolved_algo()
        if not alg.shard_safe:
            raise ValueError(
                f"algorithm {alg.name!r} is not shard-safe: "
                f"{alg.shard_unsafe_reason or 'no distributed steps'}")
        if not isinstance(g, Graph):
            raise TypeError("the distributed Pipe partitions a host Graph; "
                            f"got {type(g).__name__}")
        dist.check_exchange(spec.exchange)
        plan = resolve_plan(g, spec.layout)
        if plan is not None and plan.kind == "csr-segment":
            raise NotImplementedError(
                "csr-segment execution has no distributed steps (the "
                "edge-wise segment scatter is not owner-local); pass "
                "layout='ell-tail' to run this graph's ELL+tail arrays "
                "under the distributed Pipe")
        fused = alg.resolve_fused(spec.fused, default=True)
        mesh = dist.resolve_mesh(spec.n_shards, devices, self.device)
        n_shards = len(mesh)
        bnd = spec.exchange != "dense"
        tile_rows = spec.explicit_tile_rows()
        # the exchange joins the key: a dense-built step must never serve
        # a boundary run
        key = ("dist", _content_key(g), mesh, spec.window, spec.priority,
               fused, spec.balance, alg, plan, tile_rows, spec.exchange)
        with obs_trace.maybe_span("session.prepare"):
            g2, new_of_old, memo = self._partition(g, n_shards, spec.balance)

            def build():
                if spec.window != "auto":
                    window = spec.window
                else:
                    window = adaptive_window(g2) if alg.uses_window else 128
                ig = alg.prepare(g2, priority=spec.priority, plan=plan,
                                 device=mesh[0])
                binfo = thresh = None
                if bnd:
                    if "boundary" not in memo:
                        memo["boundary"] = boundary_info(g2, n_shards)
                    binfo = memo["boundary"]
                    thresh = exchange_threshold(ig.n_nodes, n_shards,
                                                spec.exchange)
                steps = alg.make_dist_steps(
                    ig, mesh, window=window, fused=fused,
                    exchange=spec.exchange, boundary=binfo, thresh=thresh,
                    tile_rows=tile_rows)
                return ig, window, steps, binfo

            ig, window, steps, binfo = self.cached(key, build)
        dense_fn, sparse_fn = steps
        n = ig.n_nodes
        if meter is not None:
            meter.statics = dict(kind="dist", alg=alg, ig=ig, mesh=mesh,
                                 exchange=spec.exchange, binfo=binfo,
                                 steps=steps, dist_key=key)
        block = n // n_shards
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(block, ratio=spec.bucket_ratio)
        epi = dense_fn.exchanges_per_iter

        colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
        count = n
        xtrace: list[str] = []
        xbytes: list[int] = []
        if bnd:
            # per-shard color views (DESIGN.md §13): every view starts as
            # the initial vector, then tracks owned + ghost slots
            colors = dist.shard_views(colors)
            bcaps = list(binfo.capacities)
            prev_mx = block    # changed-boundary high-water, predicts bcap
        trace: list[str] = []
        counts: list[int] = []
        tti: list[float] = []
        t_start = time.perf_counter()
        it = 0
        while count > 0 and it < spec.max_iter:
            use_dense = bool(pol(count, n))
            counts.append(count)
            with obs_trace.maybe_span(
                    "session.iter", mode="D" if use_dense else "S",
                    count=count), Timer() as t:
                if use_dense:
                    if bnd:
                        bcap = pick_bucket(
                            bcaps, min(block, max(8, 2 * prev_mx)))
                        colors, aux, wl, xs = dense_fn(colors, aux, wl,
                                                       bcap=bcap)
                    else:
                        colors, aux, wl = dense_fn(colors, aux, wl)
                else:
                    # any shard's live count is <= min(global count, block)
                    cap = pick_bucket(caps, min(count, block))
                    if wl.capacity > cap:
                        wl = dist.resize_worklist(wl, cap, n)
                    if bnd:
                        # the changed boundary slots are also <= the
                        # worklist capacity a sparse iteration runs at
                        bcap = pick_bucket(
                            bcaps, min(cap, block, max(8, 2 * prev_mx)))
                        colors, aux, wl, xs = sparse_fn(colors, aux, wl,
                                                        bcap=bcap)
                    else:
                        colors, aux, wl = sparse_fn(colors, aux, wl)
                if bnd:
                    # the iteration's one read: the count and both stats
                    count, npk, prev_mx = torch.cat(
                        [wl.count.view(1), xs]).tolist()
                    xtrace.append("b" if npk == epi
                                  else ("d" if npk == 0 else "m"))
                    xbytes.append(
                        npk * packed_exchange_bytes(bcap, n_shards)
                        + (epi - npk) * dense_swap_bytes(n))
                else:
                    count = int(wl.count)  # the Pipe's single read-back
            trace.append("D" if use_dense else "S")
            if meter is not None:
                meter.add(t.seconds)
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe(use_dense, counts[-1], n, t.seconds)
            it += 1

        total = time.perf_counter() - t_start
        if bnd:
            full = dist.views_to_colors(colors, n_shards, n)
        else:
            full = colors[0][:n].cpu().numpy()
            xtrace = ["d"] * it
            xbytes = [epi * dense_exchange_bytes(n)] * it
        final, n_colors = alg.finalize(full[new_of_old[:g.n_nodes]])
        return ColoringResult(colors=final, n_colors=n_colors, iterations=it,
                              mode_trace="".join(trace), counts=counts,
                              tti=tti, total_seconds=total,
                              host_dispatches=it,
                              exchange_trace="".join(xtrace),
                              exchange_bytes=xbytes)


_DEFAULT_SESSIONS: dict[str, Session] = {}


def default_session(device=None) -> Session:
    """The process-wide session of a device, behind plain ``engine.color``
    calls; bounded, since its entries pin graphs."""
    dev = resolve_device(device)
    key = str(dev)
    if key not in _DEFAULT_SESSIONS:
        _DEFAULT_SESSIONS[key] = Session(dev, max_entries=256)
    return _DEFAULT_SESSIONS[key]


def reset_default_session() -> None:
    """Drop the process-default sessions (tests; frees pinned graphs and
    the outlined regime's captured trips)."""
    _DEFAULT_SESSIONS.clear()
