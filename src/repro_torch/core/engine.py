"""Hybrid coloring engine — the host-side analogue of IrGL's ``Pipe``
(``repro/core/engine.py``).

Two dispatch regimes (DESIGN.md §4):

* ``color`` — the host-loop Pipe: the steps keep static shapes and the
  host reads back one scalar (``count``) per iteration, picks dense or
  sparse (the paper's H policy) and a capacity bucket, and dispatches the
  step.
* ``color_outlined_hybrid`` — the outlined Pipe: iterations run as chunks,
  one per capacity bucket, whose trips are dense or sparse as the count
  compares with the policy's threshold, fixed for the chunk; the host
  re-enters the Pipe only when the count crosses a bucket boundary or the
  loop drains (``exec/chunk.py``: on a CUDA device each trip is a replay
  of a captured CUDA graph).

Both are thin dispatchers over ``repro_torch.exec.Session``, which owns the
device and the prepared-graph cache.

The worklist state is maintained by *both* steps (the paper's
contribution), so a mode switch costs nothing: the sparse phase only ever
*slices* the already-compacted items down to a smaller bucket.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np

from repro_torch.core.policy import Policy
from repro_torch.graphs.csr import Graph

# Outlining as the default path is gated behind this env flag, read once at
# import: with REPRO_OUTLINE_HYBRID=1, ``color`` routes through the outlined
# regime. Callers toggle it after import with ``set_outline_default`` or
# the ``outlined`` context manager.
_OUTLINE_ENV = os.environ.get("REPRO_OUTLINE_HYBRID", "0") == "1"
_outline_override: "bool | None" = None


def set_outline_default(value: "bool | None") -> None:
    """Override (or with ``None`` reset) the outline-by-default routing."""
    global _outline_override
    _outline_override = value


def outline_default() -> bool:
    return _OUTLINE_ENV if _outline_override is None else _outline_override


@contextlib.contextmanager
def outlined(value: "bool | None"):
    """Scoped ``set_outline_default``: restores the previous override
    (including the no-override ``None``) on exit."""
    global _outline_override
    prev = _outline_override
    set_outline_default(value)
    try:
        yield
    finally:
        _outline_override = prev


@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray          # [N] final colors (>= 0 everywhere)
    n_colors: int
    iterations: int
    mode_trace: str             # 'D'/'S' per iteration
    counts: list[int]           # worklist size per host dispatch: one entry
    #                             per iteration for the host loop, one per
    #                             chunk for the outlined regime
    tti: list[float]            # wall seconds (collect_tti), same
    #                             granularity as counts
    total_seconds: float
    host_dispatches: int = 0    # iterations (host loop) or chunks
    #                             (outlined) the host dispatched
    # dist regime only (DESIGN.md §13): per-iteration exchange-path trace
    # ('d' dense, 'b' packed, 'm' mixed) and the bytes each iteration
    # moved per shard
    exchange_trace: str = ""
    exchange_bytes: list = dataclasses.field(default_factory=list)


def resolve_plan(g, layout):
    """Resolve an engine-level ``layout=`` argument to a ``LayoutPlan``
    (DESIGN.md §8): ``None`` -> the plan the graph was assembled under; a
    kind string re-dispatches execution on the same arrays (every
    assembly keeps CSR and ELL+tail complete); a ``LayoutPlan`` passes
    through."""
    from repro_torch.graphs.layout import LAYOUT_KINDS, LayoutPlan
    plan = getattr(g, "layout", None)
    if layout is None:
        return plan
    if isinstance(layout, LayoutPlan):
        return layout
    if layout not in LAYOUT_KINDS:
        raise ValueError(f"unknown layout {layout!r}; valid: "
                         f"{LAYOUT_KINDS} (or a LayoutPlan)")
    return dataclasses.replace(plan or LayoutPlan(), kind=layout)


def adaptive_window(g: Graph, *, lo: int = 32, hi: int = 128) -> int:
    """Color-window heuristic: mex(v) <= deg(v) and IPGC's color count
    tracks the *typical* degree, so a window ~2x the median degree covers
    almost all assignments in one pass while hubs advance their base. A
    graph with no nodes gets ``lo``; the result is clamped to
    ``[lo, hi]``."""
    deg = np.asarray(g.arrays.degrees)
    if deg.size == 0:
        return lo
    med = int(np.median(deg))
    return int(min(max(-(-2 * (med + 1) // 32) * 32, lo), hi))


def color(
    g,
    *,
    mode: str = "hybrid",
    algo: "str | object" = "ipgc",
    h: float = 0.6,
    window: "int | str" = "auto",
    bucket_ratio: int = 2,
    max_iter: int = 10_000,
    priority: str = "hash",
    policy: "Policy | None" = None,
    collect_tti: bool = False,
    fused: "bool | None" = None,   # None = the regime's default (host
    #                                loop two-phase, outlined per device,
    #                                dist fused)
    outline: "bool | None" = None,  # None -> set_outline_default()/env
    layout: "str | object | None" = None,
    device=None,                   # None = the CUDA device
    n_shards: "int | None" = None,  # dist-* modes: shard count
    exchange: str = "dense",       # dist-* modes: color publication path
    devices=None,                  # dist-* modes: one device per shard
    trace=None,                    # True / obs.Trace: return a RunReport
    tile_rows: "int | str | None" = "auto",  # row kernels' rows a block;
    #                                "auto" = tuned on CUDA, None on CPU
) -> ColoringResult:
    """Color ``g`` (a host ``Graph``, or an ``IPGCGraph`` prepared on
    ``device``) with the hybrid Pipe on the process-default session of
    ``device``: the host loop, or with ``outline`` (None consults
    ``outline_default()``) the outlined regime. ``mode="dist-*"`` runs the
    distributed Pipe over
    ``devices`` (else ``n_shards`` shards on ``device``'s kind; see
    ``core.distributed.resolve_mesh``); with ``devices`` and no
    ``device`` the session is that of the first shard's device.
    ``exchange`` is the dist Pipe's color publication (``"dense"``,
    ``"boundary"`` or ``"auto"``, DESIGN.md §13). ``trace`` (True or an
    ``obs.Trace``) returns a ``RunReport`` instead of the bare result
    (``Session.run``). ``tile_rows`` is the row kernels' rows a block
    (``kernels.tune.resolve_tile_rows``); it never changes a result."""
    from repro_torch.exec import default_session, spec_for
    spec = spec_for(mode=mode, algo=algo, h=h, window=window,
                    bucket_ratio=bucket_ratio, max_iter=max_iter,
                    priority=priority, fused=fused, outline=outline,
                    layout=layout, n_shards=n_shards, exchange=exchange,
                    tile_rows=tile_rows)
    if device is None and devices is not None:
        device = list(devices)[0]
    return default_session(device).run(spec, g, policy=policy,
                                       collect_tti=collect_tti,
                                       devices=devices, trace=trace)


# ---------------------------------------------------------------------------
# outlined Pipe (iteration outlining with bucket exits)
# ---------------------------------------------------------------------------


def color_outlined_hybrid(
    g,
    *,
    mode: str = "hybrid",
    algo: "str | object" = "ipgc",
    h: float = 0.6,
    window: "int | str" = "auto",
    bucket_ratio: int = 2,
    max_iter: int = 10_000,
    priority: str = "hash",
    policy: "Policy | None" = None,
    collect_tti: bool = False,
    fused: "bool | None" = None,
    layout: "str | object | None" = None,
    device=None,
    trace=None,
    tile_rows: "int | str | None" = "auto",
) -> ColoringResult:
    """Outlined hybrid Pipe: at most ``len(caps) + 1`` host dispatches.

    Iteration for iteration equal to the host-loop ``color`` with the same
    ``fused`` setting and a fixed-H policy: within a chunk at bucket
    ``caps[i]`` the count stays in ``(caps[i+1], caps[i]]``, so the host
    loop would have picked the same bucket, and a trip's
    ``count > threshold`` is the comparison the host policy makes.
    ``counts`` and ``tti`` are recorded per chunk, and ``mode_trace`` is
    rebuilt per chunk from the dense/sparse trip counters on the device
    (exact for monotone policies). AutoTuned policies refresh their
    threshold between chunks (``observe_chunk``). ``fused=None`` resolves
    per device type (``exec.session.OUTLINED_FUSED``). ``trace`` and
    ``tile_rows`` as in ``color``.
    """
    from repro_torch.exec import ExecutionSpec, default_session
    spec = ExecutionSpec(
        regime="outlined", mode=mode, algo=algo, layout=layout, h=h,
        window=window, bucket_ratio=bucket_ratio, max_iter=max_iter,
        priority=priority, fused=fused, tile_rows=tile_rows)
    return default_session(device).run(spec, g, policy=policy,
                                       collect_tti=collect_tti, trace=trace)


def color_outlined(
    g: Graph,
    *,
    window: "int | str" = "auto",
    max_iter: int = 10_000,
    priority: str = "hash",
    device=None,
) -> ColoringResult:
    """IrGL's iteration outlining, dense-only: the whole Pipe is one chunk
    of two-phase IPGC dense trips, with no capacity bucketing and no H
    policy (``mode_trace`` is ``"O"`` per iteration, one host dispatch, no
    ``counts``). The minimal form of the outlining idiom; the general
    regime is ``color_outlined_hybrid``."""
    from repro_torch.algos import get_algorithm
    from repro_torch.core import ipgc
    from repro_torch.exec.chunk import ChunkRunner
    if window == "auto":
        window = adaptive_window(g)
    ig = ipgc.prepare(g, priority=priority, device=device)
    n = ig.n_nodes
    t0 = time.perf_counter()
    runner = ChunkRunner(ig, get_algorithm("ipgc"), fused=False,
                         window=window, force_hub=ipgc.force_hub_enabled(),
                         capacity=n)
    runner.reset()
    iters = runner.run(n, branch="dense", thresh=-1, low=0,
                       max_iter=max_iter, count=n, it=0).it
    colors = runner.colors[:n].cpu().numpy()
    total = time.perf_counter() - t0
    return ColoringResult(colors=colors,
                          n_colors=int(colors.max()) + 1 if n else 0,
                          iterations=iters, mode_trace="O" * iters,
                          counts=[], tti=[], total_seconds=total,
                          host_dispatches=1)
