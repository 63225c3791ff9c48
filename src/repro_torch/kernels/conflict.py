"""Conflict detection with one-endpoint resolution (``csrc/conflict.cu``).

Row u loses iff its own color is >= 0 and some neighbour holds the same
color with a higher (priority, id) pair. The oracle is
``repro.kernels.ref.conflict_ref``, which takes the neighbour tiles
pre-gathered (``conflict_plain``, the Pallas signature). The kernel
gathers them itself: it takes the ``colors`` and ``priority`` vectors, the
graph's ELL tile and the rows to check (``conflict_rows_plain`` is its
plain twin).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def conflict_plain(nc: torch.Tensor, npr: torch.Tensor,
                   nbr_ids: torch.Tensor, cu: torch.Tensor, pu: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over pre-gathered (R, K) tiles (the predicate
    of ``ipgc._conflict_rows``)."""
    same = (nc == cu[:, None]) & (cu >= 0)[:, None]
    higher = (npr > pu[:, None]) | ((npr == pu[:, None])
                                    & (nbr_ids > ids[:, None]))
    return (same & higher).any(dim=1)


def gather_rows(ell_idx: torch.Tensor, rows: "torch.Tensor | None",
                pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (R, K) neighbour ids of ``rows`` in the (Rg, K) tile
    ``ell_idx`` (all of it when ``rows`` is None), and which rows are
    graph rows: a row ``>= Rg`` is empty, all ``pad``."""
    rg, k = ell_idx.shape
    if rows is None:
        return ell_idx, torch.ones(rg, dtype=torch.bool,
                                   device=ell_idx.device)
    ok = rows < rg
    if rg == 0:
        return ell_idx.new_full((rows.shape[0], k), pad), ok
    nbr = ell_idx[torch.where(ok, rows, 0).long()]
    return torch.where(ok[:, None], nbr, pad), ok


def hub_rows(hub_slot, rows, *tables) -> tuple:
    """Each (n_hub+1, ...) hub table's rows at the hub slots of ``rows``
    (all Rg rows when None), false where the slot is ``n_hub`` or the row
    is empty (table row ``n_hub`` is never read)."""
    n_hub = tables[0].shape[0] - 1
    slot, _ = gather_rows(hub_slot[:, None], rows, n_hub)
    slot = slot[:, 0]
    is_hub = slot < n_hub
    return tuple(t[slot] & is_hub.view(-1, *(1,) * (t.dim() - 1))
                 for t in tables)


def conflict_rows_plain(colors, priority, ell_idx, rows, cu, pu, ids,
                        newly) -> torch.Tensor:
    """Plain twin of the kernel: gather the neighbour tiles, then
    ``conflict_plain``, for the newly colored graph rows only."""
    nbr, ok = gather_rows(ell_idx, rows, colors.shape[0] - 1)
    lose = conflict_plain(colors[nbr], priority[nbr], nbr, cu, pu, ids)
    return lose & newly & ok


_ARGTYPES = ((ctypes.c_void_p,) * 9
             + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p))


def require_graph(what: str, colors, priority, ell_idx, rows,
                  dev) -> tuple[int, int]:
    """Validate the graph operands of the gathering kernels; returns
    ``(R, Rg)``."""
    n1 = colors.shape[0]
    rg, k = ell_idx.shape
    _build.require(colors, f"{what} colors", torch.int32, (n1,), dev)
    _build.require(priority, f"{what} priority", torch.int32, (n1,), dev)
    _build.require(ell_idx, f"{what} ell_idx", torch.int32, (rg, k), dev)
    if rows is None:
        return rg, rg
    _build.require(rows, f"{what} rows", torch.int32, (rows.shape[0],), dev)
    return rows.shape[0], rg


def conflict_cuda(colors, priority, ell_idx, rows, cu, pu, ids,
                  newly, tile_rows: "int | None" = None) -> torch.Tensor:
    """Launch the CUDA kernel (one launch; none for zero rows;
    ``tile_rows`` rows a block, None the default block)."""
    tile = _build.tile_arg(tile_rows, "conflict")
    dev = colors.device
    r, rg = require_graph("conflict", colors, priority, ell_idx, rows, dev)
    for name, t in (("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"conflict {name}", torch.int32, (r,), dev)
    _build.require(newly, "conflict newly", torch.bool, (r,), dev)
    out = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return out
    fn = _build.function("conflict", "conflict_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(colors.data_ptr(), priority.data_ptr(), ell_idx.data_ptr(),
                 None if rows is None else rows.data_ptr(), cu.data_ptr(),
                 pu.data_ptr(), ids.data_ptr(), newly.data_ptr(),
                 out.data_ptr(), r, rg, ell_idx.shape[1],
                 colors.shape[0] - 1, tile,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conflict")
    _build.KERNEL_LAUNCHES["conflict"] += 1
    return out
