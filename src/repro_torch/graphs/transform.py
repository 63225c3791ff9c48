"""Node reordering — stage 2 of the staged graph pipeline (DESIGN.md §8).

Vertex ordering is a first-order lever on both color count and speed
(Chen et al., "Efficient and High-quality Sparse Graph Coloring on the
GPU"), so the pipeline treats it as a pluggable transform rather than an
accident of the input labeling. A reordering is a ``Permutation`` object
carrying BOTH directions of the relabeling:

  new_of_old[i]  the pipeline-internal label of original node i
  old_of_new[j]  the original label of internal node j

Engines color the *reordered* graph; results are mapped back to the
original node ids via ``colors_to_original`` (the inverse map applied to
the output colors — ``colors_old[i] = colors_new[new_of_old[i]]``), so a
caller never observes internal labels. The convention is tested end to
end: every registered reorder must round-trip through
``verify_coloring`` on the original ids (tests/test_pipeline.py).

Registered reorderings (``REORDERINGS``):

  identity     no-op (the bit-identity baseline)
  degree-sort  descending-degree relabeling (hubs first — the classic
               first-fit quality ordering)
  bfs-rcm      reverse Cuthill–McKee-style BFS levels, frontier sorted by
               degree (bandwidth reduction: neighbours get nearby labels,
               which tightens ELL tiles and window reuse)
  shuffle      seeded random permutation (worst-case locality control)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.ingest import EdgeList


@dataclasses.dataclass(frozen=True, eq=False)
class Permutation:
    """A node relabeling with its inverse map (see module docstring)."""

    name: str
    new_of_old: np.ndarray    # int64[N]

    def __post_init__(self):
        object.__setattr__(self, "new_of_old",
                           np.asarray(self.new_of_old, dtype=np.int64))

    @property
    def n_nodes(self) -> int:
        return len(self.new_of_old)

    @property
    def old_of_new(self) -> np.ndarray:
        inv = np.empty(self.n_nodes, dtype=np.int64)
        inv[self.new_of_old] = np.arange(self.n_nodes)
        return inv

    @property
    def is_identity(self) -> bool:
        return bool(np.array_equal(self.new_of_old,
                                   np.arange(self.n_nodes)))

    def apply(self, edges: EdgeList) -> EdgeList:
        """Relabel an edge list into the permuted id space."""
        if self.is_identity:
            return edges
        p = self.new_of_old
        return EdgeList(name=edges.name, n_nodes=edges.n_nodes,
                        src=p[edges.src], dst=p[edges.dst])

    def colors_to_original(self, colors: np.ndarray) -> np.ndarray:
        """Map per-node output (colors) back to the original labeling."""
        colors = np.asarray(colors)
        return colors[self.new_of_old]


def identity_perm(n_nodes: int) -> Permutation:
    return Permutation("identity", np.arange(n_nodes, dtype=np.int64))


def _degree_sort(edges: EdgeList, seed: int) -> Permutation:
    deg = edges.degrees()
    order = np.argsort(-deg, kind="stable")         # old ids, hubs first
    new_of_old = np.empty(edges.n_nodes, dtype=np.int64)
    new_of_old[order] = np.arange(edges.n_nodes)
    return Permutation("degree-sort", new_of_old)


def _bfs_rcm(edges: EdgeList, seed: int) -> Permutation:
    """Reverse Cuthill–McKee-style ordering, one BFS frontier at a time.

    Classic RCM orders within a frontier by (parent position, degree);
    this vectorised variant sorts each whole frontier by (first-parent
    position, degree) — the same bandwidth-reduction behaviour without a
    per-node Python loop. Components are seeded from minimum-degree
    unvisited nodes; the final order is reversed (the "R" in RCM).
    """
    n = edges.n_nodes
    deg = edges.degrees()
    # CSR for frontier expansion
    order = np.argsort(edges.src, kind="stable")
    dst_sorted = edges.dst[order]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(edges.src, minlength=n), out=row_ptr[1:])

    visited = np.zeros(n, dtype=bool)
    pos = np.empty(n, dtype=np.int64)
    filled = 0
    min_deg_order = np.argsort(deg, kind="stable")  # component seeds
    seed_i = 0
    while filled < n:
        while seed_i < n and visited[min_deg_order[seed_i]]:
            seed_i += 1
        frontier = np.array([min_deg_order[seed_i]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            pos[frontier] = filled + np.arange(frontier.size)
            filled += frontier.size
            # expand: neighbours of the frontier, tagged with parent rank
            starts = row_ptr[frontier]
            counts = row_ptr[frontier + 1] - starts
            cum = np.concatenate([[0], np.cumsum(counts)])
            idx = (np.arange(cum[-1]) - np.repeat(cum[:-1], counts)
                   + np.repeat(starts, counts))
            parent_rank = np.repeat(np.arange(frontier.size), counts)
            nbrs = dst_sorted[idx]
            fresh = ~visited[nbrs]
            nbrs, parent_rank = nbrs[fresh], parent_rank[fresh]
            # first parent's rank per fresh neighbour, then sort the
            # frontier by (parent rank, degree) — the RCM tie-break
            uniq, first_idx = np.unique(nbrs, return_index=True)
            if uniq.size:
                key = np.lexsort((deg[uniq], parent_rank[first_idx]))
                frontier = uniq[key]
                visited[frontier] = True
            else:
                frontier = uniq
    new_of_old = (n - 1) - pos                       # reverse
    return Permutation("bfs-rcm", new_of_old)


def _shuffle(edges: EdgeList, seed: int) -> Permutation:
    rng = np.random.default_rng(seed)
    return Permutation("shuffle",
                       rng.permutation(edges.n_nodes).astype(np.int64))


REORDERINGS = {
    "identity": lambda edges, seed: identity_perm(edges.n_nodes),
    "degree-sort": _degree_sort,
    "bfs-rcm": _bfs_rcm,
    "shuffle": _shuffle,
}


def reorder(edges: EdgeList, how: str | Permutation = "identity",
            *, seed: int = 0) -> tuple[EdgeList, Permutation]:
    """Apply a registered (or caller-supplied) reordering to a normalized
    edge list; returns the relabeled edges and the permutation (whose
    inverse maps results back — see module docstring)."""
    if isinstance(how, Permutation):
        perm = how
    else:
        try:
            fn = REORDERINGS[how]
        except KeyError:
            raise ValueError(f"unknown reorder {how!r}; registered: "
                             f"{sorted(REORDERINGS)}") from None
        perm = fn(edges, seed)
    if len(perm.new_of_old) != edges.n_nodes:
        raise ValueError(f"permutation covers {len(perm.new_of_old)} nodes, "
                         f"graph has {edges.n_nodes}")
    return perm.apply(edges), perm
