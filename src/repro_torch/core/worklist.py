"""Persistent worklist state — the paper's central data structure
(``repro/core/worklist.py``).

The worklist is maintained through *all* iterations, in both
topology-driven and data-driven phases, so mode switches are free. The
"push with atomics" idiom becomes ordered stream compaction (DESIGN.md §2);
the dual representation is:

  mask  : bool[N]   dense active flags   (what topology-driven sweeps read)
  items : int32[C]  compacted active ids (what data-driven gathers read)
  count : int32[]   number of valid entries in ``items``, on the device

Both step families emit *both* representations. Capacity ``C`` is bucketed
on the host; the active set of IPGC shrinks monotonically, so buckets only
ever step down. Every helper here is shape-static and reads nothing back
to the host: on a CUDA device the compactions run the ``compact`` kernel
(``torch.nonzero`` would synchronise to size its output), so the Pipe's
``count`` read stays the one read-back per iteration.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Worklist:
    mask: torch.Tensor    # bool[N]
    items: torch.Tensor   # int32[C], padded with N
    count: torch.Tensor   # int32[]

    @property
    def capacity(self) -> int:
        return self.items.shape[0]


def full_worklist(n_nodes: int, device) -> Worklist:
    """All nodes active (IPGC initial state: everything uncolored)."""
    return Worklist(
        mask=torch.ones(n_nodes, dtype=torch.bool, device=device),
        items=torch.arange(n_nodes, dtype=torch.int32, device=device),
        count=torch.full((), n_nodes, dtype=torch.int32, device=device),
    )


def stacked_worklist(real_ns: "list[int]", n_pad: int, device) -> Worklist:
    """Lane-stacked worklists for batched execution (DESIGN.md §9): lane
    ``i`` holds graph ``i``'s full worklist (its first ``real_ns[i]``
    nodes active) in the shared ``n_pad`` shape class — pad rows inactive
    in ``mask`` and the ``n_pad`` sentinel in ``items``; ``count`` is per
    lane. Shapes ``(B, n_pad)``, ``(B, n_pad)`` and ``(B,)``."""
    lanes = torch.arange(n_pad, dtype=torch.int32, device=device)
    ns = torch.tensor(list(real_ns), dtype=torch.int32, device=device)
    mask = lanes[None, :] < ns[:, None]
    items = torch.where(mask, lanes[None, :], n_pad).to(torch.int32)
    return Worklist(mask=mask, items=items, count=ns)


def compact_mask(mask: torch.Tensor, capacity: int, n_nodes: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense mask -> compacted items (the atomic-push replacement): the
    set indices ascending, padded with ``n_nodes`` to ``capacity``, and
    the popcount."""
    return ops.compact(mask, capacity, n_nodes)


def compact_items(items: torch.Tensor, keep: torch.Tensor, n_nodes: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter the existing worklist in O(C) — the data-driven phase never
    touches O(N) state to rebuild its own worklist."""
    return ops.compact(keep, items.shape[0], n_nodes, items)


def bucket_capacities(n_nodes: int, *, ratio: int = 4,
                      floor: int = 1024) -> list[int]:
    """Geometric capacity ladder N, N/r, N/r^2, ... (static-shape buckets)."""
    caps = []
    c = n_nodes
    while c > floor:
        caps.append(int(-(-c // 8) * 8))
        c //= ratio
    caps.append(min(int(-(-floor // 8) * 8), int(-(-n_nodes // 8) * 8)))
    out: list[int] = []
    for x in caps:
        if not out or x < out[-1]:
            out.append(x)
    return out


def pick_bucket(caps: list[int], count: int) -> int:
    """Smallest capacity >= count (host-side Pipe decision)."""
    best = caps[0]
    for c in caps:
        if c >= count:
            best = c
    return best


def chunk_lower_bounds(caps: list[int]) -> list[int]:
    """Exit thresholds of the outlined chunks: the chunk at ``caps[i]``
    runs while ``count > caps[i+1]`` (0 for the last bucket), so the host
    re-enters only at bucket boundaries."""
    return [*caps[1:], 0]


def resize_block(items: torch.Tensor, capacity: int,
                 n_nodes: int) -> torch.Tensor:
    """Resize one compacted items block to a new capacity: shrinking is a
    slice (valid only when the live count is <= ``capacity`` — the ladder
    guarantees it); growing pads with the ``n_nodes`` sentinel."""
    c = items.shape[0]
    if capacity == c:
        return items
    if capacity < c:
        return items[:capacity]
    pad = torch.full((capacity - c,), n_nodes, dtype=items.dtype,
                     device=items.device)
    return torch.cat([items, pad])


def resize_items(wl: Worklist, capacity: int, n_nodes: int) -> Worklist:
    """Host-side bucket change (a slice of the already-compacted items)."""
    return Worklist(mask=wl.mask,
                    items=resize_block(wl.items, capacity, n_nodes),
                    count=wl.count)
