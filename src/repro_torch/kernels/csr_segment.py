"""Edge-wise segment primitives for the ``csr-segment`` execution layout
(DESIGN.md §8), as PyTorch scatters (``repro/kernels/csr_segment.py``).

When a graph's ``LayoutPlan`` is ``csr-segment``, the IPGC steps run over
the full directed edge set (``edge_src``/``edge_dst``, CSR expanded at
prepare time) instead of gathering padded ELL tiles: one scatter per
phase, O(E + N·W) per iteration. The reference has no Pallas kernel here,
so neither has the port: these are PyTorch ops on either device.

Padding contract: ``edge_src`` is clipped to [0, N-1], ``edge_dst`` pads
with N (the color sentinel slot). Padded lanes are inert by construction:
``colors[N] == PAD_COLOR`` (-2) never compares equal to a real color and
never lands in a window.

PyTorch has no dropping scatter, so an entry that must not land goes to
one extra slot past the end, which is sliced off (``flags_at``).
"""
from __future__ import annotations

import torch


def flags_at(size: int, index: torch.Tensor) -> torch.Tensor:
    """bool[size] that is True at every entry of ``index`` (an index of
    ``size`` or more must not occur; callers route dropped lanes to one
    extra slot and slice it off)."""
    out = torch.zeros(size, dtype=torch.bool, device=index.device)
    out.index_put_((index.reshape(-1),),
                   torch.ones((), dtype=torch.bool, device=index.device))
    return out


def edge_forbidden(es: torch.Tensor, ec: torch.Tensor,
                   base_src: torch.Tensor, n_rows: int,
                   window: int) -> torch.Tensor:
    """(N, W) forbidden bitmap from an edge-wise OR-scatter.

    ``es``: i32[E] source rows (clipped); ``ec``: i32[E] dst colors
    (PAD_COLOR on padded lanes); ``base_src``: i32[E] window base of the
    source row.
    """
    rel = ec - base_src
    ok = (ec >= 0) & (rel >= 0) & (rel < window)
    flat = torch.where(ok, es.to(torch.int64) * window + rel,
                       n_rows * window)
    return flags_at(n_rows * window + 1, flat)[:-1].view(n_rows, window)


def edge_conflict(es: torch.Tensor, ed: torch.Tensor, cu_e: torch.Tensor,
                  cv_e: torch.Tensor, pu_e: torch.Tensor, pv_e: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """bool[N] per-row conflict flags from an edge-wise segment-any: row u
    loses iff some incident edge (u, v) has ``c_v == c_u >= 0`` and v wins
    the (priority, id) tie-break."""
    lose_e = ((cu_e >= 0) & (cu_e == cv_e)
              & ((pv_e > pu_e) | ((pv_e == pu_e) & (ed > es))))
    return flags_at(n_rows + 1, torch.where(lose_e, es, n_rows))[:n_rows]


def edge_fused(es, ed, cu_e, cv_e, pu_e, pv_e, base_src, n_rows: int,
               window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Conflict flags and forbidden bitmap from one shared edge gather."""
    return (edge_conflict(es, ed, cu_e, cv_e, pu_e, pv_e, n_rows),
            edge_forbidden(es, cv_e, base_src, n_rows, window))
