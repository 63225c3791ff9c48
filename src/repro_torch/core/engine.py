"""Hybrid coloring engine — the host-side analogue of IrGL's ``Pipe``
(``repro/core/engine.py``, host regime).

``color`` is the host-loop Pipe: the steps keep static shapes and the
host reads back one scalar (``count``) per iteration, picks dense or
sparse (the paper's H policy) and a capacity bucket, and dispatches the
step. It is a thin dispatcher over ``repro_torch.exec.Session``, which
owns the device and the prepared-graph cache.

The worklist state is maintained by *both* steps (the paper's
contribution), so a mode switch costs nothing: the sparse phase only ever
*slices* the already-compacted items down to a smaller bucket.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policy import Policy
from repro_torch.graphs.csr import Graph


@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray          # [N] final colors (>= 0 everywhere)
    n_colors: int
    iterations: int
    mode_trace: str             # 'D'/'S' per iteration
    counts: list[int]           # worklist size per iteration
    tti: list[float]            # wall seconds per iteration (collect_tti)
    total_seconds: float
    host_dispatches: int = 0    # step dispatches from the host loop
    # dist regime only (DESIGN.md §13): per-iteration exchange-path trace
    # ('d' dense) and the bytes each iteration moved per shard
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
    fused: "bool | None" = None,   # None = the host loop's two-phase steps
    outline: bool = False,         # the outlined regime is not ported yet
    layout: "str | object | None" = None,
    device=None,                   # None = the CUDA device
    n_shards: "int | None" = None,  # dist-* modes: shard count
    exchange: str = "dense",       # dist-* modes: color publication path
    devices=None,                  # dist-* modes: one device per shard
) -> ColoringResult:
    """Color ``g`` (a host ``Graph``, or an ``IPGCGraph`` prepared on
    ``device``) with the hybrid Pipe on the process-default session of
    ``device``. ``mode="dist-*"`` runs the distributed Pipe over
    ``devices`` (else ``n_shards`` shards on ``device``'s kind; see
    ``core.distributed.resolve_mesh``); with ``devices`` and no
    ``device`` the session is that of the first shard's device."""
    from repro_torch.exec import default_session, spec_for
    spec = spec_for(mode=mode, algo=algo, h=h, window=window,
                    bucket_ratio=bucket_ratio, max_iter=max_iter,
                    priority=priority, fused=fused, outline=outline,
                    layout=layout, n_shards=n_shards, exchange=exchange)
    if device is None and devices is not None:
        device = list(devices)[0]
    return default_session(device).run(spec, g, policy=policy,
                                       collect_tti=collect_tti,
                                       devices=devices)
