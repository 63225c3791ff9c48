"""Baselines the paper compares against (``repro/core/baselines.py``).

* ``jpl_color`` — Jones–Plassmann–Luby independent-set coloring, the
  algorithm cuSPARSE's ``csrcolor`` implements: every round is a dense
  sweep over all N rows (no worklist); local max and local min of the
  round's random priorities take colors 2r / 2r+1. Very fast per round
  but many more colors — the paper's Table IV gap. The reference writes
  it in plain ``jnp`` with no Pallas kernel, so the port writes it in
  PyTorch ops, with the hash of ``algos/jpl.round_hash``.
* ``vb_color`` — Deveci et al. vertex-based speculative coloring (what the
  Kokkos implementation in the paper runs): IPGC's assign/resolve steps
  with a 32-wide window and a hash tie-break, data-driven throughout.

Both run on the CUDA device unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.algos.jpl import LARGE, round_hash
from repro_torch.core import ipgc
from repro_torch.core.engine import ColoringResult, color
from repro_torch.graphs.csr import Graph

NO_COLOR = ipgc.NO_COLOR


def _jpl_round(ig: ipgc.IPGCGraph, colors: torch.Tensor, rnd: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One JPL round: independent-set extraction by per-round random
    priority; local max -> color 2r, local min -> color 2r+1. Returns the
    new colors and the device-side count of uncolored nodes."""
    n = ig.n_nodes
    ids = torch.arange(n, dtype=torch.int32, device=colors.device)
    un = colors[:n] == NO_COLOR
    pr = torch.where(un, round_hash(ids, rnd), -1)
    pr_ext = torch.cat([pr, pr.new_full((1,), -1)])

    nbr_pr = pr_ext[ig.ell_idx]                       # (N, K); pad -> -1
    nbr_max = nbr_pr.amax(1)
    nbr_min = torch.where(nbr_pr >= 0, nbr_pr, LARGE).amin(1)

    # hub tails: fold the COO contributions with scatter max/min on node ids
    src = ig.tail_src.to(torch.int64)
    tpr = pr_ext[ig.tail_dst]
    nbr_max.scatter_reduce_(0, src, torch.where(ig.tail_valid, tpr, -1),
                            "amax", include_self=True)
    nbr_min.scatter_reduce_(
        0, src, torch.where(ig.tail_valid & (tpr >= 0), tpr, LARGE), "amin",
        include_self=True)

    is_max = un & (pr > nbr_max)
    is_min = un & (pr < nbr_min) & ~is_max
    newc = torch.where(is_max, 2 * rnd,
                       torch.where(is_min, 2 * rnd + 1, colors[:n]))
    remaining = (newc == NO_COLOR).sum(dtype=torch.int32)
    return torch.cat([newc, colors[n:]]), remaining


def jpl_color(g: Graph, *, max_rounds: int = 10_000,
              device=None) -> ColoringResult:
    """Color ``g`` with plain JPL rounds until no node is uncolored."""
    ig = ipgc.prepare(g, device=device)
    colors = ipgc.init_colors(ig.n_nodes, ig.device)
    rnd = torch.zeros((), dtype=torch.int32, device=ig.device)
    t0 = time.perf_counter()
    rounds = 0
    remaining = ig.n_nodes
    counts = []
    while remaining > 0 and rounds < max_rounds:
        counts.append(remaining)
        colors, rem = _jpl_round(ig, colors, rnd)
        rnd = rnd + 1
        remaining = int(rem)          # the one read-back per round
        rounds += 1
    final = colors[:ig.n_nodes].cpu().numpy()
    # JPL leaves palette gaps; the chromatic count is the distinct count
    n_colors = len(np.unique(final[final >= 0]))
    return ColoringResult(colors=final, n_colors=n_colors, iterations=rounds,
                          mode_trace="J" * rounds, counts=counts, tti=[],
                          total_seconds=time.perf_counter() - t0)


def vb_color(g: Graph, **kw) -> ColoringResult:
    """Kokkos-style (Deveci VB): data-driven speculative coloring with a
    32-wide forbidden window and a hash tie-break like Kokkos's
    ``rand(v)`` comparison (a monotonic id tie-break degenerates to O(N)
    rounds on chain graphs). ``device`` and the other ``color`` keywords
    pass through."""
    return color(g, mode="data", window=kw.pop("window", 32),
                 priority="hash", **kw)
