"""Per-row extrema of JPL neighbour priorities (``csrc/jpl_prio.cu``).

``npr`` (R, K) int32, inactive entries -1 -> ``(max (R,), min (R,))``:
the row max, and the min of the entries >= 0 (``LARGE`` when there is
none). The oracle is ``repro.kernels.ref.jpl_extrema_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the masked min of a row with no active entry
LARGE = 0x7FFFFFFF


def jpl_extrema_plain(npr: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``algos/jpl._extrema`` of the reference)."""
    return npr.amax(1), torch.where(npr >= 0, npr, LARGE).amin(1)


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_void_p)


def jpl_extrema_cuda(npr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (one launch)."""
    r, k = npr.shape
    dev = npr.device
    _build.require(npr, "jpl_extrema npr", torch.int32, (r, k), dev)
    if k == 0 and r:
        raise ValueError("jpl_extrema: rows of zero width have no max")
    out_max = torch.empty(r, dtype=torch.int32, device=dev)
    out_min = torch.empty(r, dtype=torch.int32, device=dev)
    fn = _build.function("jpl_prio", "jpl_extrema_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(npr.data_ptr(), out_max.data_ptr(), out_min.data_ptr(), r,
                 k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "jpl_extrema")
    _build.KERNEL_LAUNCHES["jpl_prio"] += 1
    return out_max, out_min
