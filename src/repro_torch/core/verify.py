"""Coloring verification of the port (``repro/core/verify.py``).

A numpy function over the host graph's CSR: it checks a coloring of tens
of millions of nodes on the host without building edge-sized tensors on
the device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph


class InvalidColoringError(AssertionError):
    """A coloring violated validity (conflict edge / uncolored node)."""


def coloring_stats(g: Graph, colors: np.ndarray) -> dict:
    """Conflict/uncolored/chromatic counts over the CSR edge set."""
    colors = np.asarray(colors)[: g.n_nodes]
    s = np.repeat(np.arange(g.n_nodes, dtype=np.int32),
                  np.asarray(g.arrays.degrees))
    d = np.asarray(g.arrays.col_idx)
    cs = colors[s]
    conflicts = int(np.count_nonzero((cs == colors[d]) & (cs >= 0)))
    uncolored = int(np.count_nonzero(colors < 0))
    n_colors = (int(colors.max()) + 1
                if colors.size and colors.max() >= 0 else 0)
    return {"conflicts": conflicts // 2, "uncolored": uncolored,
            "n_colors": n_colors}


def verify_coloring(g: Graph, colors: np.ndarray, *,
                    require_complete: bool = True,
                    context: str = "") -> dict:
    """Raise ``InvalidColoringError`` unless ``colors`` is a proper (and,
    by default, complete) coloring of ``g``; return the stats otherwise."""
    stats = coloring_stats(g, colors)
    where = f"{context}: " if context else ""
    if stats["conflicts"]:
        raise InvalidColoringError(
            f"{where}invalid coloring of {g.name!r}: "
            f"{stats['conflicts']} conflicting edge(s)")
    if require_complete and stats["uncolored"]:
        raise InvalidColoringError(
            f"{where}incomplete coloring of {g.name!r}: "
            f"{stats['uncolored']} uncolored node(s)")
    return stats
