"""Conflict detection with one-endpoint resolution (``csrc/conflict.cu``).

Row u loses iff its own color is >= 0 and some neighbour holds the same
color with a higher (priority, id) pair. The oracle is
``repro.kernels.ref.conflict_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def conflict_plain(nc: torch.Tensor, npr: torch.Tensor,
                   nbr_ids: torch.Tensor, cu: torch.Tensor, pu: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the predicate of ``ipgc._conflict_rows``)."""
    same = (nc == cu[:, None]) & (cu >= 0)[:, None]
    higher = (npr > pu[:, None]) | ((npr == pu[:, None])
                                    & (nbr_ids > ids[:, None]))
    return (same & higher).any(dim=1)


_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_void_p)


def conflict_cuda(nc: torch.Tensor, npr: torch.Tensor, nbr_ids: torch.Tensor,
                  cu: torch.Tensor, pu: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (one launch)."""
    r, k = nc.shape
    dev = nc.device
    for name, t in (("nc", nc), ("npr", npr), ("nbr_ids", nbr_ids)):
        _build.require(t, f"conflict {name}", torch.int32, (r, k), dev)
    for name, t in (("cu", cu), ("pu", pu), ("ids", ids)):
        _build.require(t, f"conflict {name}", torch.int32, (r,), dev)
    out = torch.empty(r, dtype=torch.bool, device=dev)
    fn = _build.function("conflict", "conflict_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(nc.data_ptr(), npr.data_ptr(), nbr_ids.data_ptr(),
                 cu.data_ptr(), pu.data_ptr(), ids.data_ptr(),
                 out.data_ptr(), r, k,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conflict")
    _build.KERNEL_LAUNCHES["conflict"] += 1
    return out
