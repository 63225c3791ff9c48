"""The kernel wrappers the engine calls.

Each wrapper dispatches on where its operands lie: a CPU tensor goes to
the kernel's plain PyTorch version (``*_plain``), a CUDA tensor to the
hand-written CUDA kernel (``*_cuda``), which launches or raises. There is
no fallback from one to the other. ``KERNEL_LAUNCHES`` counts the CUDA
launches of each wrapper.

The five row kernels the reference tiles (``mex_window``, ``conflict``,
``fused_compact``, ``fused_step``, ``jpl_extrema``) take ``tile_rows``:
the rows one thread block owns (``csrc/rows.cuh``), None for the default
block. It is a pure performance knob: every value gives the same result,
and the plain versions ignore it. ``compact`` keeps its own tile and
``frontier_probe`` its fixed block, as the reference's ``ops`` does.

Each call goes through ``obs.opcost_hooks.kernel_call``, which does
nothing but call it unless an op counter runs (``launch/opcost.py``);
then the call counts as one op of its operands' and outputs' bytes (the
extension call is no ATen op the counter could see), and of the FLOPs by
type that the wrapper gives (the int8 decode's products).

The int8 decode's two products (``q8_scores``, ``q8_values``) also take
``meta`` tensors, where the dry run counts the card's path: there they
return the output's shape and type.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import q8_dot
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
from repro_torch.kernels.hub import (hub_forbidden_cuda, hub_forbidden_plain,
                                     hub_lose_cuda, hub_lose_plain)
from repro_torch.kernels.jpl_prio import (jpl_extrema_cuda,
                                          jpl_extrema_rows_plain)
from repro_torch.kernels.mex_window import (mex_window_cuda,
                                            mex_window_rows_plain)
from repro_torch.obs.opcost_hooks import kernel_call


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def mex_window(colors: torch.Tensor, ell_idx: torch.Tensor,
               rows: "torch.Tensor | None", base: torch.Tensor,
               active: torch.Tensor, hub_forb: "torch.Tensor | None",
               hub_slot: "torch.Tensor | None", window: int,
               tile_rows: "int | None" = None) -> torch.Tensor:
    """First free window index per active row, -1 if the window is full
    and for the rows that are not active.

    colors int32[N+1] (slot N the pad id's); ell_idx (Rg, K) int32, pad N;
    rows int32[R] graph rows (values >= Rg are empty rows) or None for all
    Rg rows; base int32[R]; active bool[R]; on a graph with hubs the
    (n_hub+1, W) forbidden table and hub_slot int32[Rg], else both None.
    The neighbours are gathered inside the kernel (see
    ``kernels/mex_window.py``).
    """
    args = (colors, ell_idx, rows, base, active, hub_forb, hub_slot, window)
    if _on_cuda(colors):
        return kernel_call("mex_window", mex_window_cuda, *args, tile_rows)
    return kernel_call("mex_window", mex_window_rows_plain, *args)


def conflict(colors: torch.Tensor, priority: torch.Tensor,
             ell_idx: torch.Tensor, rows: "torch.Tensor | None",
             cu: torch.Tensor, pu: torch.Tensor, ids: torch.Tensor,
             newly: torch.Tensor, tile_rows: "int | None" = None
             ) -> torch.Tensor:
    """Per-row lose flags of the newly colored rows: same color >= 0 as a
    neighbour with a higher (priority, id).

    colors, priority int32[N+1] (slot N the pad id's); ell_idx (Rg, K)
    int32, pad N; rows int32[R] graph rows (values >= Rg are empty rows)
    or None for all Rg rows; cu, pu, ids int32[R]; newly bool[R]. The
    neighbours are gathered inside the kernel (see ``kernels/conflict.py``).
    """
    args = (colors, priority, ell_idx, rows, cu, pu, ids, newly)
    if _on_cuda(colors):
        return kernel_call("conflict", conflict_cuda, *args, tile_rows)
    return kernel_call("conflict", conflict_rows_plain, *args)


def compact(mask: torch.Tensor, capacity: "int | None" = None,
            sentinel: "int | None" = None,
            values: "torch.Tensor | None" = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ordered compaction; ``capacity`` and ``sentinel`` default to N."""
    n = mask.shape[0]
    capacity = n if capacity is None else capacity
    sentinel = n if sentinel is None else sentinel
    fn = compact_cuda if _on_cuda(mask) else compact_plain
    return kernel_call("compact", fn, mask, capacity, sentinel, values)


def fused_compact(colors, priority, ell_idx, rows, base, cu, pu, ids,
                  active, pending, hub_forb, hub_lose, hub_slot, window: int,
                  *, capacity: int, n_sentinel: int,
                  tile_rows: "int | None" = None):
    """One IPGC iteration over R rows: ``(new_colors, new_base, still,
    items[capacity], count)``. The graph operands are those of
    ``conflict``; base, cu, pu, ids int32[R], active, pending bool[R]; the
    hub variant takes the (n_hub+1, W) forbidden and (n_hub+1,) lose
    tables and hub_slot int32[Rg] (see ``kernels/fused_compact.py``)."""
    args = (colors, priority, ell_idx, rows, base, cu, pu, ids, active,
            pending, hub_forb, hub_lose, hub_slot, window)
    if _on_cuda(colors):
        return kernel_call("fused_compact", fused_compact_cuda, *args,
                           capacity=capacity, n_sentinel=n_sentinel,
                           tile_rows=tile_rows)
    return kernel_call("fused_compact", fused_compact_rows_plain, *args,
                       capacity=capacity, n_sentinel=n_sentinel)


def fused_step(colors, priority, ell_idx, rows, base, cu, pu, ids, pending,
               hub_forb, hub_lose, hub_slot, window: int,
               tile_rows: "int | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(lose, first)`` of a distributed fused step: the conflict
    flag of the pending rows (with the hub lose flag ORed in) and the first
    free window index, -1 when the window is full. The graph operands are
    those of ``conflict`` (the shard's ELL tile and rows); base, cu, pu, ids
    int32[R], pending bool[R]; the hub variant takes the (n_hub+1, W)
    forbidden and (n_hub+1,) lose tables and hub_slot int32[Rg] (see
    ``kernels/fused_step.py``)."""
    args = (colors, priority, ell_idx, rows, base, cu, pu, ids, pending,
            hub_forb, hub_lose, hub_slot, window)
    if _on_cuda(colors):
        return kernel_call("fused_step", fused_step_cuda, *args, tile_rows)
    return kernel_call("fused_step", fused_step_rows_plain, *args)


def hub_forbidden(tail_src, tail_dst, tail_valid, hub_slot, colors, base,
                  gate, window: int, n_hub: int, visited=None
                  ) -> torch.Tensor:
    """The (n_hub+1, W) hub forbidden table from the COO tail, each entry
    gated by its source: tail_src, tail_dst int32[T], tail_valid bool[T];
    hub_slot int32[N] (every source's slot), gate bool[N]; colors
    int32[N+1], base int32[N]; visited None or an int64[1] counter of the
    entries let through (see ``kernels/hub.py``)."""
    args = (tail_src, tail_dst, tail_valid, hub_slot, colors, base, gate,
            window, n_hub, visited)
    fn = hub_forbidden_cuda if _on_cuda(colors) else hub_forbidden_plain
    return kernel_call("hub", fn, *args)


def hub_lose(tail_src, tail_dst, tail_valid, hub_slot, colors, priority,
             flags, n_hub: int, visited=None) -> torch.Tensor:
    """The (n_hub+1,) hub lose flags from the COO tail, each entry gated by
    its source's ``flags`` bool[N] (the newly-colored or pending rows);
    the other operands as for ``hub_forbidden``, priority int32[N+1]."""
    args = (tail_src, tail_dst, tail_valid, hub_slot, colors, priority,
            flags, n_hub, visited)
    fn = hub_lose_cuda if _on_cuda(colors) else hub_lose_plain
    return kernel_call("hub", fn, *args)


def jpl_extrema(ell_idx: torch.Tensor, rows: "torch.Tensor | None",
                source, tile_rows: "int | None" = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (max, min of the entries >= 0) of JPL neighbour priorities;
    max -1 and min ``LARGE`` for a row without a real neighbour. ell_idx
    and rows as for ``mex_window``; ``source`` is ``Table(prio)`` (int32[N+1]
    priorities) or ``Hash(colors, rnd)`` (the round hash of each uncolored
    neighbour, -1 for the others; ``rnd`` a 0-d int32 round). The
    neighbours are gathered inside the kernel (see
    ``kernels/jpl_prio.py``)."""
    if _on_cuda(ell_idx):
        return kernel_call("jpl_prio", jpl_extrema_cuda, ell_idx, rows,
                           source, tile_rows)
    return kernel_call("jpl_prio", jpl_extrema_rows_plain, ell_idx, rows,
                       source)


def frontier_probe(nbr: torch.Tensor,
                   unvisited: torch.Tensor) -> torch.Tensor:
    """Per-row ``any(nbr) & unvisited``: nbr (R, K) bool, unvisited (R,)
    bool (see ``kernels/frontier.py``)."""
    fn = frontier_probe_cuda if _on_cuda(nbr) else frontier_probe_plain
    return kernel_call("frontier", fn, nbr, unvisited)


def _q8(route: dict, a: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """One int8 decode product, by ``route[device type]`` of its rows."""
    kind = a.device.type
    if kind not in route:
        raise ValueError(f"no kernel for tensors on {a.device}")
    return kernel_call("q8_dot", route[kind], a, cache,
                       flops=q8_dot.flops(a, cache))


def q8_scores(qq: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """The int8 decode's scores, exact in int32: qq (B, Hk, G, D) int8,
    k_q (B, S, Hk, D) int8 -> (B, Hk, G, S) int32 (see
    ``kernels/q8_dot.py``)."""
    return _q8({"cuda": q8_dot.scores_cuda, "cpu": q8_dot.scores_plain,
                "meta": q8_dot.scores_meta}, qq, k_q)


def q8_values(pq: torch.Tensor, v_q: torch.Tensor) -> torch.Tensor:
    """The int8 decode's values, exact in int32: pq (B, Hk, G, S) int8,
    v_q (B, S, Hk, D) int8 -> (B, Hk, G, D) int32."""
    return _q8({"cuda": q8_dot.values_cuda, "cpu": q8_dot.values_plain,
                "meta": q8_dot.values_meta}, pq, v_q)
