"""Bottom-up BFS frontier probe (``csrc/frontier.cu``).

``nbr`` (R, K) bool (neighbour k of row r is in the frontier),
``unvisited`` (R,) bool -> (R,) bool: some neighbour is in the frontier
and the row is unvisited. The oracle is
``repro.kernels.ref.frontier_probe_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def frontier_probe_plain(nbr: torch.Tensor,
                         unvisited: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    return nbr.any(1) & unvisited


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_void_p)


def frontier_probe_cuda(nbr: torch.Tensor,
                        unvisited: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (one launch)."""
    r, k = nbr.shape
    dev = nbr.device
    _build.require(nbr, "frontier_probe nbr", torch.bool, (r, k), dev)
    _build.require(unvisited, "frontier_probe unvisited", torch.bool, (r,),
                   dev)
    out = torch.empty(r, dtype=torch.bool, device=dev)
    fn = _build.function("frontier", "frontier_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(nbr.data_ptr(), unvisited.data_ptr(), out.data_ptr(), r, k,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "frontier_probe")
    _build.KERNEL_LAUNCHES["frontier"] += 1
    return out
