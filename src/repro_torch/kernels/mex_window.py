"""Windowed mex over pre-gathered neighbour colors (``csrc/mex_window.cu``).

For each row, the first free index of the color window ``[base, base+W)``
given the row's K neighbour colors (pad and uncolored are < 0) and an
optional extra ``(R, W)`` forbidden bitmap (hub tails); -1 when the whole
window is forbidden. The oracle is ``repro.kernels.ref.mex_window_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_segment import flags_at

#: widest window the CUDA kernel takes (eight 32-bit bitmap words)
MAX_WINDOW = 256


def mex_window_plain(nc: torch.Tensor, base: torch.Tensor,
                     extra_forb: "torch.Tensor | None",
                     window: int) -> torch.Tensor:
    """Plain PyTorch version: OR-scatter the in-window colors into an
    ``(R, W)`` bitmap (one flat index per entry; out-of-window entries go
    to a dropped extra slot), then take the first free slot."""
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


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def mex_window_cuda(nc: torch.Tensor, base: torch.Tensor,
                    extra_forb: "torch.Tensor | None",
                    window: int) -> torch.Tensor:
    """Launch the CUDA kernel (one launch)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"mex_window: the CUDA kernel takes windows of 1.."
                         f"{MAX_WINDOW} colors, got {window}")
    r, k = nc.shape
    dev = nc.device
    _build.require(nc, "mex_window nc", torch.int32, (r, k), dev)
    _build.require(base, "mex_window base", torch.int32, (r,), dev)
    if extra_forb is not None:
        _build.require(extra_forb, "mex_window extra_forb", torch.bool,
                       (r, window), dev)
    out = torch.empty(r, dtype=torch.int32, device=dev)
    fn = _build.function("mex_window", "mex_window_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(nc.data_ptr(), base.data_ptr(),
                 None if extra_forb is None else extra_forb.data_ptr(),
                 out.data_ptr(), r, k, window,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mex_window")
    _build.KERNEL_LAUNCHES["mex_window"] += 1
    return out
