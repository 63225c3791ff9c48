"""One IPGC iteration in one pass (``csrc/fused_compact.cu``): resolve,
windowed mex, new color and base, and the ordered emission of the
surviving rows' ``ids``. The oracle is
``repro.kernels.ref.fused_compact_ref``.

Two variants: no-hub (``extra_forb`` and ``hub_lose`` are None) and hub
(both given).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.graphs.csr import NO_COLOR
from repro_torch.kernels import _build
from repro_torch.kernels.compact import compact_plain, scratch
from repro_torch.kernels.conflict import conflict_plain
from repro_torch.kernels.mex_window import MAX_WINDOW, mex_window_plain


def fused_compact_plain(nc, npr, nbr_ids, base, cu, pu, ids, active, pending,
                        extra_forb, hub_lose, window: int, *, capacity: int,
                        n_sentinel: int):
    """Plain PyTorch version; returns ``(new_colors, new_base, still,
    items, count)`` like the kernel."""
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


_ARGTYPES = ((ctypes.c_void_p,) * 17
             + (ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def fused_compact_cuda(nc, npr, nbr_ids, base, cu, pu, ids, active, pending,
                       extra_forb, hub_lose, window: int, *, capacity: int,
                       n_sentinel: int):
    """Launch the CUDA kernels (four launches: the row pass, then the
    count, scan and write of the emission)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"fused_compact: the CUDA kernel takes windows of "
                         f"1..{MAX_WINDOW} colors, got {window}")
    if (extra_forb is None) != (hub_lose is None):
        raise ValueError("fused_compact: extra_forb and hub_lose come "
                         "together (the hub variant) or not at all")
    r, k = nc.shape
    dev = nc.device
    for name, t in (("nc", nc), ("npr", npr), ("nbr_ids", nbr_ids)):
        _build.require(t, f"fused_compact {name}", torch.int32, (r, k), dev)
    for name, t in (("base", base), ("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"fused_compact {name}", torch.int32, (r,), dev)
    for name, t in (("active", active), ("pending", pending)):
        _build.require(t, f"fused_compact {name}", torch.bool, (r,), dev)
    if extra_forb is not None:
        _build.require(extra_forb, "fused_compact extra_forb", torch.bool,
                       (r, window), dev)
        _build.require(hub_lose, "fused_compact hub_lose", torch.bool, (r,),
                       dev)
    new_c = torch.empty(r, dtype=torch.int32, device=dev)
    new_base = torch.empty(r, dtype=torch.int32, device=dev)
    still = torch.empty(r, dtype=torch.bool, device=dev)
    items = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("fused_compact", "fused_compact_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(nc.data_ptr(), npr.data_ptr(), nbr_ids.data_ptr(),
                 base.data_ptr(), cu.data_ptr(), pu.data_ptr(),
                 ids.data_ptr(), active.data_ptr(), pending.data_ptr(),
                 ptr(extra_forb), ptr(hub_lose), new_c.data_ptr(),
                 new_base.data_ptr(), still.data_ptr(), items.data_ptr(),
                 count.data_ptr(), scratch(r, dev).data_ptr(), r, k, window,
                 capacity, n_sentinel, int(NO_COLOR),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_compact")
    _build.KERNEL_LAUNCHES["fused_compact"] += 4
    return new_c, new_base, still, items, count
