"""The kernel wrappers the engine calls.

Each wrapper dispatches on where its operands lie: a CPU tensor goes to
the kernel's plain PyTorch version (``*_plain``), a CUDA tensor to the
hand-written CUDA kernel (``*_cuda``), which launches or raises. There is
no fallback from one to the other. ``KERNEL_LAUNCHES`` counts the CUDA
launches of each wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import KERNEL_LAUNCHES  # noqa: F401
from repro_torch.kernels.compact import compact_cuda, compact_plain
from repro_torch.kernels.conflict import (conflict_cuda,
                                          conflict_rows_plain)
from repro_torch.kernels.frontier import (frontier_probe_cuda,
                                          frontier_probe_plain)
from repro_torch.kernels.fused_compact import (fused_compact_cuda,
                                               fused_compact_rows_plain)
from repro_torch.kernels.fused_step import (fused_step_cuda,
                                            fused_step_rows_plain)
from repro_torch.kernels.jpl_prio import jpl_extrema_cuda, jpl_extrema_plain
from repro_torch.kernels.mex_window import mex_window_cuda, mex_window_plain


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def mex_window(nc: torch.Tensor, base: torch.Tensor,
               extra_forb: "torch.Tensor | None",
               window: int) -> torch.Tensor:
    """First free window index per row, -1 if the window is full.

    nc (R, K) int32 neighbour colors (pad/uncolored < 0); base (R,) int32;
    extra_forb (R, W) bool or None.
    """
    fn = mex_window_cuda if _on_cuda(nc) else mex_window_plain
    return fn(nc, base, extra_forb, window)


def conflict(colors: torch.Tensor, priority: torch.Tensor,
             ell_idx: torch.Tensor, rows: "torch.Tensor | None",
             cu: torch.Tensor, pu: torch.Tensor, ids: torch.Tensor,
             newly: torch.Tensor) -> torch.Tensor:
    """Per-row lose flags of the newly colored rows: same color >= 0 as a
    neighbour with a higher (priority, id).

    colors, priority int32[N+1] (slot N the pad id's); ell_idx (Rg, K)
    int32, pad N; rows int32[R] graph rows (values >= Rg are empty rows)
    or None for all Rg rows; cu, pu, ids int32[R]; newly bool[R]. The
    neighbours are gathered inside the kernel (see ``kernels/conflict.py``).
    """
    fn = conflict_cuda if _on_cuda(colors) else conflict_rows_plain
    return fn(colors, priority, ell_idx, rows, cu, pu, ids, newly)


def compact(mask: torch.Tensor, capacity: "int | None" = None,
            sentinel: "int | None" = None,
            values: "torch.Tensor | None" = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ordered compaction; ``capacity`` and ``sentinel`` default to N."""
    n = mask.shape[0]
    capacity = n if capacity is None else capacity
    sentinel = n if sentinel is None else sentinel
    fn = compact_cuda if _on_cuda(mask) else compact_plain
    return fn(mask, capacity, sentinel, values)


def fused_compact(colors, priority, ell_idx, rows, base, cu, pu, ids,
                  active, pending, hub_forb, hub_lose, hub_slot, window: int,
                  *, capacity: int, n_sentinel: int):
    """One IPGC iteration over R rows: ``(new_colors, new_base, still,
    items[capacity], count)``. The graph operands are those of
    ``conflict``; base, cu, pu, ids int32[R], active, pending bool[R]; the
    hub variant takes the (n_hub+1, W) forbidden and (n_hub+1,) lose
    tables and hub_slot int32[Rg] (see ``kernels/fused_compact.py``)."""
    fn = fused_compact_cuda if _on_cuda(colors) else fused_compact_rows_plain
    return fn(colors, priority, ell_idx, rows, base, cu, pu, ids, active,
              pending, hub_forb, hub_lose, hub_slot, window,
              capacity=capacity, n_sentinel=n_sentinel)


def fused_step(colors, priority, ell_idx, rows, base, cu, pu, ids, pending,
               hub_forb, hub_lose, hub_slot, window: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(lose, first)`` of a distributed fused step: the conflict
    flag of the pending rows (with the hub lose flag ORed in) and the first
    free window index, -1 when the window is full. The graph operands are
    those of ``conflict`` (the shard's ELL tile and rows); base, cu, pu, ids
    int32[R], pending bool[R]; the hub variant takes the (n_hub+1, W)
    forbidden and (n_hub+1,) lose tables and hub_slot int32[Rg] (see
    ``kernels/fused_step.py``)."""
    fn = fused_step_cuda if _on_cuda(colors) else fused_step_rows_plain
    return fn(colors, priority, ell_idx, rows, base, cu, pu, ids, pending,
              hub_forb, hub_lose, hub_slot, window)


def jpl_extrema(npr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (max, min of the entries >= 0) of JPL neighbour priorities;
    npr (R, K) int32 with inactive entries -1 (see ``kernels/jpl_prio.py``)."""
    fn = jpl_extrema_cuda if _on_cuda(npr) else jpl_extrema_plain
    return fn(npr)


def frontier_probe(nbr: torch.Tensor,
                   unvisited: torch.Tensor) -> torch.Tensor:
    """Per-row ``any(nbr) & unvisited``: nbr (R, K) bool, unvisited (R,)
    bool (see ``kernels/frontier.py``)."""
    fn = frontier_probe_cuda if _on_cuda(nbr) else frontier_probe_plain
    return fn(nbr, unvisited)
