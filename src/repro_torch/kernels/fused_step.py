"""Fused resolve + windowed mex over one neighbour-color tile
(``csrc/fused_step.cu``): per row the lose flag and the first free window
index, ``-1`` when the whole window is forbidden. The oracle is
``repro.kernels.ref.fused_step_ref``.

Two variants: no-hub (``extra_forb`` is None) and hub.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conflict import conflict_plain
from repro_torch.kernels.mex_window import MAX_WINDOW, mex_window_plain


def fused_step_plain(nc, npr, nbr_ids, base, cu, pu, ids, pending,
                     extra_forb, window: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version; returns ``(lose, first)`` like the kernel."""
    lose = conflict_plain(nc, npr, nbr_ids, cu, pu, ids) & pending
    return lose, mex_window_plain(nc, base, extra_forb, window)


_ARGTYPES = ((ctypes.c_void_p,) * 11
             + (ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def fused_step_cuda(nc, npr, nbr_ids, base, cu, pu, ids, pending,
                    extra_forb, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (one launch; none for zero rows)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"fused_step: the CUDA kernel takes windows of "
                         f"1..{MAX_WINDOW} colors, got {window}")
    r, k = nc.shape
    dev = nc.device
    for name, t in (("nc", nc), ("npr", npr), ("nbr_ids", nbr_ids)):
        _build.require(t, f"fused_step {name}", torch.int32, (r, k), dev)
    for name, t in (("base", base), ("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"fused_step {name}", torch.int32, (r,), dev)
    _build.require(pending, "fused_step pending", torch.bool, (r,), dev)
    if extra_forb is not None:
        _build.require(extra_forb, "fused_step extra_forb", torch.bool,
                       (r, window), dev)
    lose = torch.empty(r, dtype=torch.bool, device=dev)
    first = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return lose, first
    fn = _build.function("fused_step", "fused_step_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(nc.data_ptr(), npr.data_ptr(), nbr_ids.data_ptr(),
                 base.data_ptr(), cu.data_ptr(), pu.data_ptr(),
                 ids.data_ptr(), pending.data_ptr(),
                 None if extra_forb is None else extra_forb.data_ptr(),
                 lose.data_ptr(), first.data_ptr(), r, k, window,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_step")
    _build.KERNEL_LAUNCHES["fused_step"] += 1
    return lose, first
