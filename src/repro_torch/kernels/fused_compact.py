"""One IPGC iteration in one pass (``csrc/fused_compact.cu``): resolve,
windowed mex, new color and base, and the ordered emission of the
surviving rows' ``ids``. The oracle is
``repro.kernels.ref.fused_compact_ref``, which takes the neighbour tiles
and the hub bitmap pre-gathered (``fused_compact_plain``, the Pallas
signature). The kernel gathers them itself from the ``colors`` and
``priority`` vectors, the graph's ELL tile, the rows to update and, in the
hub variant, the per-hub tables (``fused_compact_rows_plain`` is its plain
twin).

Two variants: no-hub (``hub_forb``, ``hub_lose`` and ``hub_slot`` are
None) and hub (all three given).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.graphs.csr import NO_COLOR
from repro_torch.kernels import _build
from repro_torch.kernels.compact import compact_plain, scratch
from repro_torch.kernels.conflict import (conflict_plain, gather_rows,
                                          require_graph)
from repro_torch.kernels.mex_window import MAX_WINDOW, mex_window_plain


def fused_compact_plain(nc, npr, nbr_ids, base, cu, pu, ids, active, pending,
                        extra_forb, hub_lose, window: int, *, capacity: int,
                        n_sentinel: int):
    """Plain PyTorch version over pre-gathered tiles; returns
    ``(new_colors, new_base, still, items, count)`` like the kernel."""
    lose = conflict_plain(nc, npr, nbr_ids, cu, pu, ids) & pending
    if hub_lose is not None:
        lose = lose | (hub_lose & pending)
    first = mex_window_plain(nc, base, extra_forb, window)
    has = first >= 0
    need = lose | (active & (cu < 0))
    new_c = torch.where(need & has, base + first,
                        torch.where(lose, int(NO_COLOR), cu))
    new_base = torch.where(need & ~has, base + window, base)
    items, count = compact_plain(need, capacity, n_sentinel, ids)
    return new_c, new_base, need, items, count


def check_hub(what: str, hub_forb, hub_lose, hub_slot) -> bool:
    """Whether the hub tables are given (the hub variant); raises when
    only some of them are."""
    given = [t is not None for t in (hub_forb, hub_lose, hub_slot)]
    if any(given) != all(given):
        raise ValueError(f"{what}: hub_forb, hub_lose and hub_slot come "
                         "together (the hub variant) or not at all")
    return all(given)


def hub_rows(hub_forb, hub_lose, hub_slot, rows
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (R, W) forbidden rows and (R,) lose flags of ``rows`` at their
    hub slots, false where the slot is ``n_hub`` or the row is empty
    (table row ``n_hub`` is never read)."""
    n_hub = hub_forb.shape[0] - 1
    slot, _ = gather_rows(hub_slot[:, None], rows, n_hub)
    is_hub = slot[:, 0] < n_hub
    return (hub_forb[slot[:, 0]] & is_hub[:, None],
            hub_lose[slot[:, 0]] & is_hub)


def fused_compact_rows_plain(colors, priority, ell_idx, rows, base, cu, pu,
                             ids, active, pending, hub_forb, hub_lose,
                             hub_slot, window: int, *, capacity: int,
                             n_sentinel: int):
    """Plain twin of the kernel: gather the neighbour tiles and the hub
    rows (table row ``n_hub`` is never read), then
    ``fused_compact_plain``; rows ``>= Rg`` are neither active nor
    pending."""
    nbr, ok = gather_rows(ell_idx, rows, colors.shape[0] - 1)
    extra = hl = None
    if check_hub("fused_compact", hub_forb, hub_lose, hub_slot):
        extra, hl = hub_rows(hub_forb, hub_lose, hub_slot, rows)
    return fused_compact_plain(colors[nbr], priority[nbr], nbr, base, cu, pu,
                               ids, active & ok, pending & ok, extra, hl,
                               window, capacity=capacity,
                               n_sentinel=n_sentinel)


_ARGTYPES = ((ctypes.c_void_p,) * 19
             + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def fused_compact_cuda(colors, priority, ell_idx, rows, base, cu, pu, ids,
                       active, pending, hub_forb, hub_lose, hub_slot,
                       window: int, *, capacity: int, n_sentinel: int,
                       tile_rows: "int | None" = None):
    """Launch the CUDA kernels (two launches: the row pass, then the
    one-pass emission of ``compact.cuh``; one for zero rows).
    ``tile_rows`` is the row pass's rows a block, None its default block;
    the emission keeps its own tile."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"fused_compact: the CUDA kernel takes windows of "
                         f"1..{MAX_WINDOW} colors, got {window}")
    tile = _build.tile_arg(tile_rows, "fused_compact")
    hub = check_hub("fused_compact", hub_forb, hub_lose, hub_slot)
    dev = colors.device
    r, rg = require_graph("fused_compact", colors, priority, ell_idx, rows,
                          dev)
    for name, t in (("base", base), ("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"fused_compact {name}", torch.int32, (r,), dev)
    for name, t in (("active", active), ("pending", pending)):
        _build.require(t, f"fused_compact {name}", torch.bool, (r,), dev)
    n_hub = 0
    if hub:
        n_hub = hub_forb.shape[0] - 1
        _build.require(hub_forb, "fused_compact hub_forb", torch.bool,
                       (n_hub + 1, window), dev)
        _build.require(hub_lose, "fused_compact hub_lose", torch.bool,
                       (n_hub + 1,), dev)
        _build.require(hub_slot, "fused_compact hub_slot", torch.int32,
                       (rg,), dev)
    new_c = torch.empty(r, dtype=torch.int32, device=dev)
    new_base = torch.empty(r, dtype=torch.int32, device=dev)
    still = torch.empty(r, dtype=torch.bool, device=dev)
    items = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("fused_compact", "fused_compact_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(colors.data_ptr(), priority.data_ptr(), ell_idx.data_ptr(),
                 ptr(rows), base.data_ptr(), cu.data_ptr(), pu.data_ptr(),
                 ids.data_ptr(), active.data_ptr(), pending.data_ptr(),
                 ptr(hub_forb), ptr(hub_lose), ptr(hub_slot),
                 new_c.data_ptr(), new_base.data_ptr(), still.data_ptr(),
                 items.data_ptr(), count.data_ptr(),
                 scratch(r, dev).data_ptr(), r, rg, ell_idx.shape[1],
                 window, colors.shape[0] - 1, n_hub, capacity, n_sentinel,
                 int(NO_COLOR), tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_compact")
    _build.KERNEL_LAUNCHES["fused_compact"] += 2 if r else 1
    return new_c, new_base, still, items, count
