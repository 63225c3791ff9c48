"""Node partitioning for the distributed coloring engine (a numpy copy of
``repro/graphs/partition.py``, without the boundary sets of the packed
exchange).

Strategy: block partition of degree-balanced node ids across the shards.
Each shard owns a contiguous node block and the ELL rows for it; the only
cross-shard value at runtime is the color vector (exchanged once per fused
iteration — DESIGN.md §2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph, build_graph


def balance_permutation(g: Graph, n_shards: int, seed: int = 0) -> np.ndarray:
    """Return a node permutation that balances total degree across blocks.

    Greedy LPT over degree: sort by degree desc, deal round-robin snake-wise
    into shards, then concatenate. Keeps hub nodes spread across shards (no
    shard owns all hubs). The per-shard lists line up with the equal
    ``shard_bounds`` blocks only when ``n_nodes % n_shards == 0``;
    ``prepare_partition`` pads the graph first so that they do.
    """
    deg = np.asarray(g.arrays.degrees)
    order = np.argsort(-deg, kind="stable")
    n = g.n_nodes
    pad = (-n) % n_shards
    padded = np.concatenate([order, np.full(pad, -1, dtype=order.dtype)])
    rows = padded.reshape(-1, n_shards)
    rows[1::2] = rows[1::2, ::-1]  # snake to balance within-chunk skew
    shards = []
    for s in range(n_shards):
        col = rows[:, s]
        shards.append(col[col >= 0].astype(np.int64))
    return np.concatenate(shards)


def repartition(g: Graph, n_shards: int, *, balance: bool = True,
                seed: int = 0) -> tuple[Graph, np.ndarray]:
    """Relabel nodes so that shard s owns the contiguous block
    [s*B, (s+1)*B). Returns (new graph, old->new label map)."""
    if balance:
        perm = balance_permutation(g, n_shards, seed)
    else:
        perm = np.arange(g.n_nodes, dtype=np.int64)
    new_of_old = np.empty(g.n_nodes, dtype=np.int64)
    new_of_old[perm] = np.arange(g.n_nodes)
    deg = np.asarray(g.arrays.degrees)
    src = np.repeat(np.arange(g.n_nodes), deg)
    dst = np.asarray(g.arrays.col_idx)
    g2 = build_graph(new_of_old[src], new_of_old[dst], g.n_nodes,
                     name=g.name + f"@p{n_shards}",
                     ell_cap=g.ell_width, symmetrize=False,
                     layout=_plan_of(g))
    return g2, new_of_old


def _plan_of(g: Graph):
    """The graph's LayoutPlan, for plan-preserving rebuilds (relabeling
    keeps the degree multiset, so the original plan stays exact); plan-less
    graphs rebuild under the historical ell-tail rule."""
    return g.layout if g.layout is not None else "ell-tail"


def prepare_partition(g: Graph, n_shards: int, *, balance: bool = True,
                      align: int = 8, seed: int = 0
                      ) -> tuple[Graph, np.ndarray]:
    """Pad + repartition a graph for the distributed coloring engine.

    Pads the node count up to ``n_shards * ceil(ceil(n/S)/align)*align``
    with isolated (degree-0) nodes so that every shard owns an equal,
    ``align``-multiple block, then relabels via ``repartition`` so total
    degree is balanced across blocks. Padding BEFORE balancing keeps the
    snake deal's columns exactly block-sized, so shard s truly owns
    ``[s*B, (s+1)*B)``.

    Returns ``(g2, new_of_old)``; ``new_of_old[:g.n_nodes]`` maps original
    ids into ``g2``'s labeling (the padding nodes occupy the remaining new
    ids and are colored trivially — strip them by mapping back).
    """
    block = -(-g.n_nodes // n_shards)
    block = -(-block // align) * align
    n_pad = block * n_shards
    if n_pad != g.n_nodes:
        deg = np.asarray(g.arrays.degrees)
        src = np.repeat(np.arange(g.n_nodes), deg)
        dst = np.asarray(g.arrays.col_idx)
        g = build_graph(src, dst, n_pad, name=g.name,
                        ell_cap=g.ell_width, symmetrize=False,
                        layout=_plan_of(g))
    return repartition(g, n_shards, balance=balance, seed=seed)


def shard_bounds(n_nodes: int, n_shards: int) -> np.ndarray:
    """Block boundaries (padded so every shard has an equal block)."""
    block = -(-n_nodes // n_shards)
    return np.arange(n_shards + 1) * block
