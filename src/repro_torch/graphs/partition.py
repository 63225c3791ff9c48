"""Node partitioning for the distributed coloring engine (a numpy copy of
``repro/graphs/partition.py``), and the boundary sets of the packed
exchange (DESIGN.md §13).

Strategy: block partition of degree-balanced node ids across the shards.
Each shard owns a contiguous node block and the ELL rows for it; the only
cross-shard value at runtime is the color vector (exchanged once per fused
iteration — DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# boundary / ghost sets for the packed exchange path (DESIGN.md §13)
# ---------------------------------------------------------------------------

def _round8(x: int) -> int:
    return int(-(-max(x, 1) // 8) * 8)


def exchange_break_even(n_nodes: int, n_shards: int) -> int:
    """Per-shard packed capacity at which the packed exchange stops
    beating the dense one: a packed publish moves two int32[(S, cap)]
    buffers (ids + colors) per shard — ``8 * cap * S`` bytes — while the
    dense paths move ``~4 * n`` bytes; equality at ``cap = (n+1) // (2S)``.
    """
    return max(8, (n_nodes + 1) // (2 * max(n_shards, 1)))


def boundary_capacities(block: int, max_boundary: int, n_nodes: int,
                        n_shards: int, *, ratio: int = 2,
                        floor: int = 8) -> tuple[int, ...]:
    """Static capacity ladder for the per-shard boundary buffers.

    Floors at 8 (a packed exchange only wins when its buffer is small
    next to ``n / S``) and tops out at the smallest of the shard block,
    the largest per-shard boundary count (no shard can publish more) and
    the byte break-even capacity (``exchange_break_even``: a larger rung
    would cost more bytes than the dense fallback it replaces).
    Descending, 8-aligned, deduped; never empty.
    """
    top = min(max(block, 1), _round8(max_boundary),
              _round8(exchange_break_even(n_nodes, n_shards)))
    caps: list[int] = []
    c = max(top, floor)
    while c > floor:
        caps.append(_round8(c))
        c //= ratio
    caps.append(floor)
    out: list[int] = []
    for x in caps:
        if not out or x < out[-1]:
            out.append(x)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BoundaryInfo:
    """Partition-time boundary sets of an already-partitioned graph
    (equal blocks: ``n_nodes % n_shards == 0``).

    ``is_boundary[u]``: u has a neighbour outside its own block, i.e. some
    other shard reads u's color (u is a ghost of that shard).
    ``counts[s]``: the boundary vertices shard s owns; ``max_boundary``
    bounds any shard's packed publish, and ``capacities`` is the static
    buffer ladder built from it (``boundary_capacities``).
    """

    n_nodes: int
    n_shards: int
    block: int
    is_boundary: np.ndarray          # bool[n]
    counts: tuple                    # per-shard boundary counts
    max_boundary: int
    capacities: tuple                # descending static bcap ladder


def _edges(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The CSR edge list ``(src, dst)`` as int64."""
    n = g.n_nodes
    deg = np.asarray(g.arrays.degrees)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = np.asarray(g.arrays.col_idx).astype(np.int64)
    return src, dst


def boundary_info(g: Graph, n_shards: int) -> BoundaryInfo:
    """The boundary sets of a ``prepare_partition``-ed graph. Symmetric
    for symmetric graphs: u is a ghost of shard s iff s owns a neighbour
    of u iff u is a boundary vertex of its own shard."""
    n = g.n_nodes
    if n % n_shards != 0:
        raise ValueError(
            f"boundary_info needs equal blocks (n={n} % shards="
            f"{n_shards} != 0); run prepare_partition first")
    blk = n // n_shards
    src, dst = _edges(g)
    cross = (src // blk) != (dst // blk)
    isb = np.zeros(n, dtype=bool)
    isb[src[cross]] = True
    counts = tuple(int(isb[s * blk:(s + 1) * blk].sum())
                   for s in range(n_shards))
    max_b = max(counts) if counts else 0
    caps = boundary_capacities(blk, max_b, n, n_shards)
    return BoundaryInfo(n_nodes=n, n_shards=n_shards, block=blk,
                        is_boundary=isb, counts=counts, max_boundary=max_b,
                        capacities=caps)


def ghost_ids(g: Graph, n_shards: int, s: int) -> np.ndarray:
    """Remote vertices shard ``s`` reads: every neighbour of an owned
    vertex that lives outside block ``s``, sorted and unique. The steps
    never build it: publishing every changed boundary vertex covers all
    ghosts."""
    blk = g.n_nodes // n_shards
    src, dst = _edges(g)
    mine = (src // blk) == s
    remote = (dst // blk) != s
    return np.unique(dst[mine & remote])
