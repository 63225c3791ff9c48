"""Plain IPGC, the coloring that the benchmark holds the port against.

IPGC (Deveci et al. 2016) as the paper's engine runs it, written out in
plain PyTorch from its published semantics, over an edge list and nothing
else. It imports nothing of the program and works out again from the edge
list what the program's set-up derives:

* the graph: both directions of every edge, self loops dropped, duplicates
  removed;
* the tie-break priority of node ``v``: the splitmix32 hash of ``v``,
  shifted right by one bit;
* the color window ``W``: about twice the median degree, rounded up to a
  multiple of 32 and held to [32, 128].

Each iteration, over the active (uncolored) nodes:

1. assign: a node takes the first color of ``[base, base + W)`` that no
   neighbour holds; where all ``W`` are taken, its ``base`` moves up by
   ``W`` and it stays active and uncolored;
2. resolve: a node colored in this iteration loses its color where a
   neighbour holds the same color with a higher (priority, id) pair; it
   stays active.

The loop ends when no node is active. ``bytes_needed`` counts the work
that each iteration needs, whatever the implementation reads: for each
active node its adjacency (4 bytes an entry), each neighbour's color and
priority (4 + 4 bytes) and its own color written (4 bytes).
"""
from __future__ import annotations

import dataclasses

import torch

NO_COLOR = -1
MAX_ITER = 10_000
_M32 = 0xFFFFFFFF


def normalize(src: torch.Tensor, dst: torch.Tensor, n: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Directed entries ``(s, d)``, int64, sorted by (s, d): both
    directions of each edge, no self loops, no duplicates."""
    if n * n >= 2 ** 62:
        raise ValueError(f"{n} nodes: the (s, d) key would overflow int64")
    s = torch.cat([src, dst]).to(torch.int64)
    d = torch.cat([dst, src]).to(torch.int64)
    keep = s != d
    key = torch.unique(s[keep] * n + d[keep])
    return key // n, key % n


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x, c < 2**32``, in int64 without
    overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def priorities(n: int, device) -> torch.Tensor:
    """int64[n]: splitmix32 of each node id, shifted right by one bit."""
    x = (torch.arange(n, dtype=torch.int64, device=device)
         + 0x9E3779B9) & _M32
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    return x >> 1


def color_window(degrees: torch.Tensor, lo: int = 32, hi: int = 128) -> int:
    """About twice the median degree (the mean of the two middle degrees,
    rounded down, for an even count), rounded up to a multiple of 32 and
    held to ``[lo, hi]``."""
    n = degrees.numel()
    if n == 0:
        return lo
    srt = torch.sort(degrees).values
    med = int(srt[n // 2]) if n % 2 else \
        (int(srt[n // 2 - 1]) + int(srt[n // 2])) // 2
    return int(min(max(-(-2 * (med + 1) // 32) * 32, lo), hi))


@dataclasses.dataclass
class Coloring:
    colors: torch.Tensor     # int64[n], NO_COLOR where uncolored
    iterations: int
    window: int
    bytes_needed: int        # the work of all iterations, as above


def ipgc(s: torch.Tensor, d: torch.Tensor, n: int) -> Coloring:
    """Color the normalized graph ``(s, d)`` of ``n`` nodes."""
    dev = s.device
    prio = priorities(n, dev)
    window = color_window(torch.bincount(s, minlength=n))
    colors = torch.full((n,), NO_COLOR, dtype=torch.int64, device=dev)
    base = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    slot = torch.empty(n, dtype=torch.int64, device=dev)
    es, ed = s, d                   # the entries of the active nodes
    it = total = 0
    while it < MAX_ITER:
        act = torch.nonzero(active).squeeze(1)
        m = act.numel()
        if m == 0:
            break
        keep = active[es]
        es, ed = es[keep], ed[keep]
        total += 12 * es.numel() + 4 * m
        # assign
        slot[act] = torch.arange(m, device=dev)
        cv = colors[ed]
        rel = cv - base[es]
        ok = (cv >= 0) & (rel >= 0) & (rel < window)
        forb = torch.zeros((m, window), dtype=torch.bool, device=dev)
        forb[slot[es[ok]], rel[ok]] = True
        free = ~forb
        has = free.any(dim=1)
        first = free.to(torch.uint8).argmax(dim=1)
        got = act[has]
        colors[got] = base[got] + first[has]
        base[act[~has]] += window
        newly = torch.zeros(n, dtype=torch.bool, device=dev)
        newly[got] = True
        # resolve
        sel = newly[es]
        us, vs = es[sel], ed[sel]
        pu, pv = prio[us], prio[vs]
        hit = (colors[us] == colors[vs]) & ((pv > pu) | ((pv == pu)
                                                        & (vs > us)))
        lose = torch.zeros(n, dtype=torch.bool, device=dev)
        lose[us[hit]] = True
        colors[lose] = NO_COLOR
        active = lose | (active & ~newly)
        it += 1
    return Coloring(colors=colors, iterations=it, window=window,
                    bytes_needed=total)


def conflicts(s: torch.Tensor, d: torch.Tensor, colors: torch.Tensor) -> int:
    """Edges of ``(s, d)`` whose two ends hold one color (each once)."""
    same = (colors[s] == colors[d]) & (colors[s] >= 0) & (s < d)
    return int(same.sum())
