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
it.

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

from repro_torch.core import distributed as dist
from repro_torch.core import ipgc
from repro_torch.core.engine import (ColoringResult, adaptive_window,
                                     resolve_plan)
from repro_torch.core.policy import (AutoTuned, Policy, Timer,
                                     device_threshold, make_policy)
from repro_torch.core.worklist import (bucket_capacities, chunk_lower_bounds,
                                       pick_bucket, resize_items)
from repro_torch.device import resolve_device
from repro_torch.exec.chunk import ChunkRunner
from repro_torch.exec.spec import ExecutionSpec
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partition import prepare_partition
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.report import RunReport, dense_exchange_bytes


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
            collect_tti: bool = False, devices=None) -> ColoringResult:
        """Color one graph (a host ``Graph`` or a prepared ``IPGCGraph``
        on this session's device) as ``spec`` says. ``devices`` is the
        dist regime's mesh, one device per shard (see
        ``core.distributed.resolve_mesh``; None deals ``spec.n_shards``
        shards on this session's kind of device)."""
        if spec.regime == "dist":
            return self._run_dist(spec, g, policy=policy,
                                  collect_tti=collect_tti, devices=devices)
        if spec.regime == "outlined":
            return self._run_outlined(spec, g, policy=policy,
                                      collect_tti=collect_tti)
        return self._run_host(spec, g, policy=policy,
                              collect_tti=collect_tti)

    def partition(self, g: Graph, n_shards: int, *, balance: bool = True):
        """``prepare_partition(g, n_shards)``, cached: ``(g2, new_of_old)``
        with ``g2`` padded to equal, degree-balanced owner blocks."""
        key = ("partition", _content_key(g), n_shards, balance)
        return self.cached(key, lambda: prepare_partition(
            g, n_shards, balance=balance))

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

    def _run_host(self, spec: ExecutionSpec, g, *, policy,
                  collect_tti) -> ColoringResult:
        alg = spec.resolved_algo()
        fused = alg.resolve_fused(spec.fused, default=False)
        ig, window, _ = self._prepare(spec, g, alg)
        n = ig.n_nodes
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(n, ratio=spec.bucket_ratio)
        force_hub = ipgc.force_hub_enabled()
        dense_fn, sparse_fn = alg.step_fns(fused)

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
            with Timer() as t:
                if use_dense:
                    colors, aux, wl = dense_fn(ig, colors, aux, wl,
                                               window=window,
                                               force_hub=force_hub)
                else:
                    cap = pick_bucket(caps, count)
                    if wl.capacity > cap:
                        wl = resize_items(wl, cap, n)
                    colors, aux, wl = sparse_fn(ig, colors, aux, wl,
                                                window=window,
                                                force_hub=force_hub)
                count = int(wl.count)  # the Pipe's single scalar read-back
            trace.append("D" if use_dense else "S")
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe(use_dense, counts[-1], n, t.seconds)
            it += 1

        total = time.perf_counter() - t_start
        final, n_colors = alg.finalize(colors[:n].cpu().numpy())
        return ColoringResult(colors=final, n_colors=n_colors,
                              iterations=it, mode_trace="".join(trace),
                              counts=counts, tti=tti, total_seconds=total,
                              host_dispatches=it)

    # -- outlined Pipe -----------------------------------------------------------

    def _run_outlined(self, spec: ExecutionSpec, g, *, policy,
                      collect_tti) -> ColoringResult:
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
        ig, window, runners = self._prepare(spec, g, alg)
        if runners is None:
            _, runners = self.cached(("runners", self.graph_key(ig), window),
                                     lambda: (ig, {}))
        n = ig.n_nodes
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(n, ratio=spec.bucket_ratio)
        lows = chunk_lower_bounds(caps)
        force_hub = ipgc.force_hub_enabled()
        rkey = (fused, force_hub, caps[0])
        runner = runners.get(rkey)
        if runner is None:
            runner = runners[rkey] = ChunkRunner(
                ig, alg, fused=fused, window=window, force_hub=force_hub,
                capacity=caps[0])
        runner.reset()
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
            with Timer() as t:
                c = runner.run(caps[bi], branch=branch, thresh=thresh,
                               low=lows[bi], max_iter=spec.max_iter,
                               count=count, it=it)
            count, it = c.count, c.it
            trace.append("D" * c.nd + "S" * c.ns)
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe_chunk(c.nd, c.ns, (counts[-1] + count) / 2,
                                  t.seconds)

        total = time.perf_counter() - t_start
        final, n_colors = alg.finalize(runner.colors[:n].cpu().numpy())
        return ColoringResult(colors=final, n_colors=n_colors, iterations=it,
                              mode_trace="".join(trace), counts=counts,
                              tti=tti, total_seconds=total,
                              host_dispatches=len(counts))

    # -- sharded distributed Pipe --------------------------------------------

    def _run_dist(self, spec: ExecutionSpec, g, *, policy, collect_tti,
                  devices) -> ColoringResult:
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
        g2, new_of_old = self.partition(g, n_shards, balance=spec.balance)
        key = ("dist", _content_key(g), mesh, spec.window, spec.priority,
               fused, spec.balance, alg, plan)

        def build():
            if spec.window != "auto":
                window = spec.window
            else:
                window = adaptive_window(g2) if alg.uses_window else 128
            ig = alg.prepare(g2, priority=spec.priority, plan=plan,
                             device=mesh[0])
            dense_fn, sparse_fn = alg.make_dist_steps(
                ig, mesh, window=window, fused=fused, exchange=spec.exchange)
            return ig, window, dense_fn, sparse_fn

        ig, window, dense_fn, sparse_fn = self.cached(key, build)
        n = ig.n_nodes
        block = n // n_shards
        pol = policy or make_policy(spec.mode, spec.h)
        caps = bucket_capacities(block, ratio=spec.bucket_ratio)
        epi = dense_fn.exchanges_per_iter

        colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
        count = n
        trace: list[str] = []
        counts: list[int] = []
        tti: list[float] = []
        t_start = time.perf_counter()
        it = 0
        while count > 0 and it < spec.max_iter:
            use_dense = bool(pol(count, n))
            counts.append(count)
            with Timer() as t:
                if use_dense:
                    colors, aux, wl = dense_fn(colors, aux, wl)
                else:
                    # any shard's live count is <= min(global count, block)
                    cap = pick_bucket(caps, min(count, block))
                    if wl.capacity > cap:
                        wl = dist.resize_worklist(wl, cap, n)
                    colors, aux, wl = sparse_fn(colors, aux, wl)
                count = int(wl.count)  # the Pipe's single scalar read-back
            trace.append("D" if use_dense else "S")
            if collect_tti:
                tti.append(t.seconds)
            if isinstance(pol, AutoTuned):
                pol.observe(use_dense, counts[-1], n, t.seconds)
            it += 1

        total = time.perf_counter() - t_start
        full = colors[0][:n].cpu().numpy()
        final, n_colors = alg.finalize(full[new_of_old[:g.n_nodes]])
        return ColoringResult(colors=final, n_colors=n_colors, iterations=it,
                              mode_trace="".join(trace), counts=counts,
                              tti=tti, total_seconds=total,
                              host_dispatches=it, exchange_trace="d" * it,
                              exchange_bytes=[epi * dense_exchange_bytes(n)]
                              * it)


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
