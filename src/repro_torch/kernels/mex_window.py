"""Windowed mex of the two-phase IPGC assign (``csrc/mex_window.cu``).

For each active row, the first free index of the color window
``[base, base+W)`` given its neighbours' colors (pad and uncolored are
< 0) and, for a hub row, its row of the hub forbidden table; -1 when the
whole window is forbidden, and for a row that is not active. The oracle is
``repro.kernels.ref.mex_window_ref``, which takes the neighbour colors and
the hub bitmap pre-gathered as (R, K) and (R, W) tiles
(``mex_window_plain``, the Pallas signature). The kernel gathers them
itself from the ``colors`` vector, the graph's ELL tile, the rows to
update and, on a graph with hubs, the (n_hub+1, W) table of
``ipgc._hub_forbidden`` read at each row's hub slot
(``mex_window_rows_plain`` is its plain twin).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conflict import gather_rows, hub_rows
from repro_torch.kernels.csr_segment import flags_at

#: widest window the CUDA kernel takes (eight 32-bit bitmap words)
MAX_WINDOW = 256


def mex_window_plain(nc: torch.Tensor, base: torch.Tensor,
                     extra_forb: "torch.Tensor | None",
                     window: int) -> torch.Tensor:
    """Plain PyTorch version over pre-gathered tiles: OR-scatter the
    in-window colors into an ``(R, W)`` bitmap (one flat index per entry;
    out-of-window entries go to a dropped extra slot), then take the first
    free slot."""
    r = nc.shape[0]
    rel = nc - base[:, None]
    ok = (nc >= 0) & (rel >= 0) & (rel < window)
    rows = torch.arange(r, device=nc.device, dtype=torch.int64)[:, None]
    flat = torch.where(ok, rows * window + rel, r * window)
    forb = flags_at(r * window + 1, flat)[:-1].view(r, window)
    if extra_forb is not None:
        forb = forb | extra_forb
    free = ~forb
    first = free.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(free.any(dim=1), first, -1)


def mex_window_rows_plain(colors, ell_idx, rows, base, active, hub_forb,
                          hub_slot, window: int) -> torch.Tensor:
    """Plain twin of the kernel: gather the neighbour colors and the hub
    rows, ``mex_window_plain``, -1 for the rows that are not active; rows
    ``>= Rg`` read no neighbour."""
    nbr, _ = gather_rows(ell_idx, rows, colors.shape[0] - 1)
    extra = None
    if hub_forb is not None:
        extra, = hub_rows(hub_slot, rows, hub_forb)
    first = mex_window_plain(colors[nbr], base, extra, window)
    return torch.where(active, first, -1)


_ARGTYPES = ((ctypes.c_void_p,) * 8
             + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def mex_window_cuda(colors, ell_idx, rows, base, active, hub_forb, hub_slot,
                    window: int, tile_rows: "int | None" = None
                    ) -> torch.Tensor:
    """Launch the CUDA kernel (one launch; none for zero rows;
    ``tile_rows`` rows a block, None the default block)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"mex_window: the CUDA kernel takes windows of 1.."
                         f"{MAX_WINDOW} colors, got {window}")
    if (hub_forb is None) != (hub_slot is None):
        raise ValueError("mex_window: hub_forb and hub_slot come together "
                         "(a graph with hubs) or not at all")
    tile = _build.tile_arg(tile_rows, "mex_window")
    dev = colors.device
    n1 = colors.shape[0]
    rg, k = ell_idx.shape
    _build.require(colors, "mex_window colors", torch.int32, (n1,), dev)
    _build.require(ell_idx, "mex_window ell_idx", torch.int32, (rg, k), dev)
    r = rg
    if rows is not None:
        r = rows.shape[0]
        _build.require(rows, "mex_window rows", torch.int32, (r,), dev)
    _build.require(base, "mex_window base", torch.int32, (r,), dev)
    _build.require(active, "mex_window active", torch.bool, (r,), dev)
    n_hub = 0
    if hub_forb is not None:
        n_hub = hub_forb.shape[0] - 1
        _build.require(hub_forb, "mex_window hub_forb", torch.bool,
                       (n_hub + 1, window), dev)
        _build.require(hub_slot, "mex_window hub_slot", torch.int32, (rg,),
                       dev)
    out = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return out
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("mex_window", "mex_window_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(colors.data_ptr(), ell_idx.data_ptr(), ptr(rows),
                 base.data_ptr(), active.data_ptr(), ptr(hub_forb),
                 ptr(hub_slot), out.data_ptr(), r, rg, k, window, n1 - 1,
                 n_hub, tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mex_window")
    _build.KERNEL_LAUNCHES["mex_window"] += 1
    return out
