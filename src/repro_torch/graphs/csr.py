"""Graph data structures + the pipeline facade.

Host-side construction is numpy, a copy of ``repro.graphs`` kept in this
package so that the port imports nothing of ``repro``; ``core.ipgc.prepare``
moves the arrays to the device. Construction itself is a staged pipeline
(DESIGN.md §8):

    ingest.py     edge-list sources (generators, .mtx, SNAP) + normalize
    transform.py  pluggable node reorderings (permutation + inverse map)
    layout.py     LayoutPlan selection (degree histogram) + assembly
    registry.py   ``get_dataset`` — one cached entry point over all of it

Layouts (see layout.LayoutPlan for the per-kind kernel contract)
-------
CSR      row_ptr[N+1], col_idx[E]     — segment-op paths, sampling, and
                                         the csr-segment execution layout.
ELL      ell_idx[N, K] (pad = N)      — row-tile kernel paths. K is the ELL
                                         width (plan.ell_width, mult of 8).
COO tail tail_src[T], tail_dst[T]     — hub overflow (ell-tail) or whole
                                         hub rows (hub-split). Padded
                                         with (N, N).

Color conventions
-----------------
colors : int32[N + 1]. colors[N] is the sentinel slot (PAD_COLOR) so that
gathers through ELL padding are branch-free.
NO_COLOR  = -1  (uncolored / active)
PAD_COLOR = -2  (sentinel; never equals a real color or NO_COLOR)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

NO_COLOR = np.int32(-1)
PAD_COLOR = np.int32(-2)


class GraphArrays(NamedTuple):
    """Host-side graph arrays (all int32 numpy arrays)."""

    n_nodes: int          # static
    n_edges: int          # static (directed entry count = 2x undirected)
    ell_width: int        # static
    row_ptr: np.ndarray   # [N+1]
    col_idx: np.ndarray   # [E]
    degrees: np.ndarray   # [N]
    ell_idx: np.ndarray   # [N, K] neighbour ids, padded with N
    tail_src: np.ndarray  # [T] hub-overflow edges (padded with N)
    tail_dst: np.ndarray  # [T]
    priority: np.ndarray  # [N] random tie-break priorities (static hash)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Host-side graph with metadata.

    ``layout`` is the static LayoutPlan the arrays were assembled under
    (engines dispatch their step variants on it); ``perm`` is the
    reordering that produced this labeling (None or identity for
    unreordered graphs) — map per-node results back to original ids via
    ``perm.colors_to_original``.
    """

    name: str
    n_nodes: int
    n_edges: int          # undirected edge count
    arrays: GraphArrays
    layout: "object" = None   # layout.LayoutPlan (lazy-typed: no cycle)
    perm: "object" = None     # transform.Permutation | None

    @property
    def ell_width(self) -> int:
        return self.arrays.ell_width


def _splitmix32(x: np.ndarray) -> np.ndarray:
    """Deterministic per-node hash used for conflict-resolution priority."""
    x = x.astype(np.uint32)
    x = (x + np.uint32(0x9E3779B9)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    # keep positive int32 (the priority pad slot is -1)
    return (x >> np.uint32(1)).astype(np.int32)


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    *,
    name: str = "graph",
    ell_cap: "int | None" = 128,
    symmetrize: bool = True,
    layout: "str | object" = "ell-tail",   # kind, "auto", or a LayoutPlan
    reorder: str = "identity",
    seed: int = 0,
) -> Graph:
    """Build a Graph from an edge list via the staged pipeline: self loops
    and duplicate edges removed (``ingest.normalize``), then reorder, plan
    and assembly (DESIGN.md §8). The defaults reproduce the historical
    single-layout construction."""
    from repro_torch.graphs import ingest, layout as layout_mod

    return layout_mod.run_pipeline(
        ingest.from_arrays(src, dst, n_nodes, name=name),
        symmetrize=symmetrize, reorder=reorder, seed=seed, layout=layout,
        ell_cap=ell_cap)
