"""Hybrid direction-optimizing BFS — the paper's future work, on the same
substrate as the coloring engine (the port of ``repro/core/bfs.py``).

  * top-down (data-driven): expand the frontier worklist through ELL
    rows, O(frontier edges);
  * bottom-up (topology-driven): every unvisited node probes its
    neighbours for frontier membership (the ``frontier_probe`` kernel on a
    CUDA device), O(N·K) but no scatter conflicts;
  * both steps emit the same (mask, items, count) worklist state, so the
    switch is free in either direction — unlike Beamer's queue<->bitmap
    conversions (the distinction the paper draws).

The BFS frontier is not monotone, so the host loop's capacity bucket can
grow back; ``_resize`` then recompacts the items from the mask. Like the
coloring steps, the BFS steps are shape-static and read nothing back: the
loop reads one scalar per level, ``count``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import ipgc
from repro_torch.core.worklist import (Worklist, bucket_capacities,
                                       compact_mask, pick_bucket)
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.csr_segment import flags_at

MODES = ("hybrid", "topdown", "bottomup")


def topdown_step(ig: ipgc.IPGCGraph, dist: torch.Tensor, wl: Worklist,
                 level: int) -> tuple[torch.Tensor, Worklist]:
    """Data-driven expansion: scatter from the frontier rows."""
    n = ig.n_nodes
    items = wl.items
    valid = items < n
    safe = torch.where(valid, items, 0)
    nbrs = torch.where(valid[:, None], ig.ell_idx[safe], n)     # (C, K)
    reach = flags_at(n + 1, nbrs)
    # hub tails: frontier hub u reaches v
    t_hit = ig.tail_valid & wl.mask[ig.tail_src]
    reach |= flags_at(n + 1, torch.where(t_hit, ig.tail_dst, n))
    new = reach[:n] & (dist < 0)
    dist2 = torch.where(new, level + 1, dist)
    items2, count = compact_mask(new, wl.capacity, n)
    return dist2, Worklist(mask=new, items=items2, count=count)


def bottomup_step(ig: ipgc.IPGCGraph, dist: torch.Tensor, wl: Worklist,
                  level: int) -> tuple[torch.Tensor, Worklist]:
    """Topology-driven probe: unvisited nodes look for frontier parents —
    and still emit the compacted worklist (the paper's contribution)."""
    n = ig.n_nodes
    fmask_ext = torch.cat([wl.mask, wl.mask.new_zeros(1)])
    has_parent = ops.frontier_probe(
        fmask_ext[ig.ell_idx],
        torch.ones(n, dtype=torch.bool, device=dist.device))
    # hub tails: v unvisited, tail entry (v, u) with u in the frontier
    t_hit = ig.tail_valid & fmask_ext[ig.tail_dst]
    hub_hit = flags_at(n + 1, torch.where(t_hit, ig.tail_src, n))
    new = (dist < 0) & (has_parent | hub_hit[:n])
    dist2 = torch.where(new, level + 1, dist)
    items2, count = compact_mask(new, wl.capacity, n)
    return dist2, Worklist(mask=new, items=items2, count=count)


@dataclasses.dataclass
class BFSResult:
    dist: np.ndarray
    levels: int
    mode_trace: str
    total_seconds: float


def _resize(wl: Worklist, cap: int, n: int) -> Worklist:
    cur = wl.capacity
    if cap == cur:
        return wl
    if cap < cur:
        return Worklist(wl.mask, wl.items[:cap], wl.count)
    # growing: the compacted items may have been truncated at the old
    # capacity (BFS frontiers are not monotone) — recompact from the mask
    items, _ = ops.compact(wl.mask, capacity=cap, sentinel=n)
    return Worklist(wl.mask, items, wl.count)


def bfs(g: Graph, source: int = 0, *, mode: str = "hybrid", h: float = 0.05,
        max_levels: int = 100_000, device=None) -> BFSResult:
    """Levels from ``source`` on the CUDA device (``device="cpu"`` for the
    plain PyTorch path). mode: hybrid | topdown | bottomup. ``h``: switch
    to bottom-up when the frontier exceeds h*N (Beamer's alpha-style
    heuristic on node count; the worklist is maintained throughout, so
    switching is free)."""
    if mode not in MODES:
        raise ValueError(f"unknown BFS mode {mode!r}; valid: {MODES}")
    ig = ipgc.prepare(g, device=device)
    n = ig.n_nodes
    dev = ig.device
    caps = bucket_capacities(n, ratio=2)
    dist = torch.full((n,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    items = torch.full((caps[-1],), n, dtype=torch.int32, device=dev)
    items[0] = source
    wl = Worklist(mask=mask, items=items,
                  count=torch.ones((), dtype=torch.int32, device=dev))
    t0 = time.perf_counter()
    trace = []
    level = 0
    count = 1
    while count > 0 and level < max_levels:
        bottom = mode == "bottomup" or (mode == "hybrid" and count > h * n)
        if bottom:
            wl = _resize(wl, caps[0], n)   # mask is what matters here
            dist, wl = bottomup_step(ig, dist, wl, level)
            trace.append("B")
        else:
            wl = _resize(wl, pick_bucket(caps, count), n)
            dist, wl = topdown_step(ig, dist, wl, level)
            trace.append("T")
        count = int(wl.count)          # the one read-back per level
        level += 1
    return BFSResult(dist=dist.cpu().numpy(), levels=level,
                     mode_trace="".join(trace),
                     total_seconds=time.perf_counter() - t0)


def bfs_reference(g: Graph, source: int = 0) -> np.ndarray:
    """Host BFS oracle over the CSR (a numpy copy of the reference's)."""
    a = g.arrays
    rp, ci = np.asarray(a.row_ptr), np.asarray(a.col_idx)
    dist = np.full(g.n_nodes, -1, np.int32)
    dist[source] = 0
    q = deque([source])
    while q:
        u = q.popleft()
        for v in ci[rp[u]:rp[u + 1]]:
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist
