"""Fused resolve + windowed mex of the distributed fused steps
(``csrc/fused_step.cu``): per row the lose flag and the first free window
index, ``-1`` when the whole window is forbidden. The oracle is
``repro.kernels.ref.fused_step_ref``, which takes the neighbour tiles and
the hub bitmap pre-gathered (``fused_step_plain``, the Pallas signature).
The kernel gathers them itself from the ``colors`` and ``priority``
vectors, the shard's ELL tile, the rows to update and, in the hub variant,
the per-hub tables, and ORs the hub lose flag of the pending rows in
(``fused_step_rows_plain`` is its plain twin).

Two variants: no-hub (``hub_forb``, ``hub_lose`` and ``hub_slot`` are
None) and hub (all three given).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conflict import (conflict_plain, gather_rows,
                                          require_graph)
from repro_torch.kernels.fused_compact import check_hub, hub_rows
from repro_torch.kernels.mex_window import MAX_WINDOW, mex_window_plain


def fused_step_plain(nc, npr, nbr_ids, base, cu, pu, ids, pending,
                     extra_forb, window: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version over pre-gathered tiles; returns
    ``(lose, first)``."""
    lose = conflict_plain(nc, npr, nbr_ids, cu, pu, ids) & pending
    return lose, mex_window_plain(nc, base, extra_forb, window)


def fused_step_rows_plain(colors, priority, ell_idx, rows, base, cu, pu, ids,
                          pending, hub_forb, hub_lose, hub_slot,
                          window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the kernel: gather the neighbour tiles and the hub
    rows, ``fused_step_plain``, then OR in the hub lose flag of the pending
    rows; rows ``>= Rg`` are not pending and read no neighbour."""
    nbr, ok = gather_rows(ell_idx, rows, colors.shape[0] - 1)
    pending = pending & ok
    extra = hl = None
    if check_hub("fused_step", hub_forb, hub_lose, hub_slot):
        extra, hl = hub_rows(hub_forb, hub_lose, hub_slot, rows)
    lose, first = fused_step_plain(colors[nbr], priority[nbr], nbr, base, cu,
                                   pu, ids, pending, extra, window)
    if hl is not None:
        lose = lose | (hl & pending)
    return lose, first


_ARGTYPES = ((ctypes.c_void_p,) * 14
             + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def fused_step_cuda(colors, priority, ell_idx, rows, base, cu, pu, ids,
                    pending, hub_forb, hub_lose, hub_slot, window: int,
                    tile_rows: "int | None" = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (one launch; none for zero rows;
    ``tile_rows`` rows a block, None the default block)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"fused_step: the CUDA kernel takes windows of "
                         f"1..{MAX_WINDOW} colors, got {window}")
    tile = _build.tile_arg(tile_rows, "fused_step")
    hub = check_hub("fused_step", hub_forb, hub_lose, hub_slot)
    dev = colors.device
    r, rg = require_graph("fused_step", colors, priority, ell_idx, rows, dev)
    for name, t in (("base", base), ("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"fused_step {name}", torch.int32, (r,), dev)
    _build.require(pending, "fused_step pending", torch.bool, (r,), dev)
    n_hub = 0
    if hub:
        n_hub = hub_forb.shape[0] - 1
        _build.require(hub_forb, "fused_step hub_forb", torch.bool,
                       (n_hub + 1, window), dev)
        _build.require(hub_lose, "fused_step hub_lose", torch.bool,
                       (n_hub + 1,), dev)
        _build.require(hub_slot, "fused_step hub_slot", torch.int32, (rg,),
                       dev)
    lose = torch.empty(r, dtype=torch.bool, device=dev)
    first = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return lose, first
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("fused_step", "fused_step_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(colors.data_ptr(), priority.data_ptr(), ell_idx.data_ptr(),
                 ptr(rows), base.data_ptr(), cu.data_ptr(), pu.data_ptr(),
                 ids.data_ptr(), pending.data_ptr(), ptr(hub_forb),
                 ptr(hub_lose), ptr(hub_slot), lose.data_ptr(),
                 first.data_ptr(), r, rg, ell_idx.shape[1], window,
                 colors.shape[0] - 1, n_hub, tile,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_step")
    _build.KERNEL_LAUNCHES["fused_step"] += 1
    return lose, first
