"""Execution sessions (``repro/exec/session.py``, host and dist regimes).

A ``Session`` owns the device it runs on and a keyed cache of prepared
graphs: ``Session.run(spec, g)`` prepares ``g`` once per (graph, spec)
pair and drives the host-loop Pipe. The loop reads back one scalar per
iteration, the worklist ``count`` — exactly what IrGL's Pipe uses for its
worklist-size check — picks dense or sparse from it (the paper's H
policy) and a capacity bucket, and dispatches the step. The steps read
nothing else back, so that read is the iteration's only synchronisation.

The dist regime runs the same loop over the distributed steps
(``core/distributed.py``) on a partitioned graph; the partition is cached
per (graph, shard count, balance), so every algorithm run on one
partition builds it once.
"""
from __future__ import annotations

import dataclasses
import threading
import time


from repro_torch.core import distributed as dist
from repro_torch.core import ipgc
from repro_torch.core.engine import (ColoringResult, adaptive_window,
                                     resolve_plan)
from repro_torch.core.policy import AutoTuned, Policy, Timer, make_policy
from repro_torch.core.worklist import (bucket_capacities, pick_bucket,
                                       resize_items)
from repro_torch.device import resolve_device
from repro_torch.exec.spec import NOT_PORTED, ExecutionSpec
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partition import prepare_partition
from repro_torch.obs.report import dense_exchange_bytes


@dataclasses.dataclass
class CacheStats:
    """Hit/miss counters for the session's prepared-graph cache."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0


def _graph_key(g) -> tuple:
    """Graph half of the cache key: identity + static fields. Every entry
    holds a reference to ``g``, so the id cannot be recycled while the
    entry lives."""
    if isinstance(g, Graph):
        return ("graph", id(g), g.name, g.n_nodes, g.n_edges)
    return ("ig", id(g), g.n_nodes, g.ell_width, g.n_hub, g.layout_kind)


class Session:
    """The device and the prepared-graph cache behind ``engine.color``.

    ``device`` defaults to the CUDA device (``repro_torch.device``).
    ``max_entries`` bounds the cache FIFO-style; ``None`` keeps every
    entry.
    """

    def __init__(self, device=None, max_entries: "int | None" = None):
        self.device = resolve_device(device)
        self.cache: dict = {}
        self.max_entries = max_entries
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def cached(self, key: tuple, build):
        with self._lock:
            if key in self.cache:
                self.stats.hits += 1
                return self.cache[key]
            self.stats.misses += 1
            entry = self.cache[key] = build()
            while (self.max_entries is not None
                   and len(self.cache) > self.max_entries):
                self.cache.pop(next(iter(self.cache)))
                self.stats.evictions += 1
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
        if spec.regime != "host":
            raise NotImplementedError(NOT_PORTED[spec.regime])
        return self._run_host(spec, g, policy=policy,
                              collect_tti=collect_tti)

    def partition(self, g: Graph, n_shards: int, *, balance: bool = True):
        """``prepare_partition(g, n_shards)``, cached: ``(g2, new_of_old)``
        with ``g2`` padded to equal, degree-balanced owner blocks."""
        key = ("partition", _graph_key(g), n_shards, balance)
        _, g2, new_of_old = self.cached(key, lambda: (
            g, *prepare_partition(g, n_shards, balance=balance)))
        return g2, new_of_old

    def run_batch(self, spec: ExecutionSpec, graphs):
        raise NotImplementedError(NOT_PORTED["batch"])

    def _prepare(self, spec: ExecutionSpec, g, alg):
        """(prepared IPGCGraph, resolved window), cached per graph."""
        if isinstance(g, ipgc.IPGCGraph):
            if g.device != self.device:
                raise ValueError(f"prepared graph lies on {g.device}, the "
                                 f"session runs on {self.device}")
            if spec.window != "auto":
                return g, spec.window
            if alg.uses_window:
                raise ValueError("window='auto' needs a host Graph (it "
                                 "reads the degree histogram)")
            return g, 128
        plan = resolve_plan(g, spec.layout)
        key = ("prep", _graph_key(g), alg, spec.priority, plan, spec.window)

        def build():
            if spec.window != "auto":
                window = spec.window
            else:
                window = adaptive_window(g) if alg.uses_window else 128
            ig = alg.prepare(g, priority=spec.priority, plan=plan,
                             device=self.device)
            return g, ig, window

        _, ig, window = self.cached(key, build)
        return ig, window

    def _run_host(self, spec: ExecutionSpec, g, *, policy,
                  collect_tti) -> ColoringResult:
        alg = spec.resolved_algo()
        fused = alg.resolve_fused(spec.fused, default=False)
        ig, window = self._prepare(spec, g, alg)
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
        key = ("dist", _graph_key(g), mesh, spec.window, spec.priority,
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
            return g, ig, window, dense_fn, sparse_fn

        _, ig, window, dense_fn, sparse_fn = self.cached(key, build)
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
    """Drop the process-default sessions (tests; frees pinned graphs)."""
    _DEFAULT_SESSIONS.clear()
