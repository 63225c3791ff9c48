"""Ordered stream compaction (``csrc/compact.cu``).

``mask`` bool[N] -> (items int32[capacity], count int32[]): the indices
(or, with ``values``, the values at the indices) of the set entries in
ascending order, padded with ``sentinel``; ``count`` is the number of set
entries, also when it exceeds ``capacity``. With the defaults
(``capacity = sentinel = N``, no values) this is
``repro.kernels.ref.compact_ref``; ``values`` gives
``worklist.compact_items`` and the emission of ``fused_compact``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: flags per scan tile, and output slots per fill block (compact::kTile)
TILE = 8192


def compact_plain(mask: torch.Tensor, capacity: int, sentinel: int,
                  values: "torch.Tensor | None" = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ranks from a cumulative sum, one scatter
    (unselected entries and ranks past ``capacity`` go to a dropped slot).
    Shape-static: no ``nonzero``, no read-back."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    if values is None:
        values = torch.arange(n, dtype=torch.int32, device=mask.device)
    out = torch.full((capacity + 1,), sentinel, dtype=torch.int32,
                     device=mask.device)
    out.index_put_((torch.where(mask & (rank < capacity), rank, capacity),),
                   values)
    return out[:capacity], mask.sum(dtype=torch.int32)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)


def scratch(n: int, device) -> torch.Tensor:
    """The per-call state of a compaction over ``n`` flags
    (``compact::state_words``): the tile ticket and one status word per
    scan tile, 64 bits each. ``torch.empty`` launches nothing; the launch
    function zeroes it with a ``cudaMemsetAsync`` on the same stream."""
    return torch.empty(max(-(-n // TILE), 1) + 1, dtype=torch.int64,
                       device=device)


def compact_cuda(mask: torch.Tensor, capacity: int, sentinel: int,
                 values: "torch.Tensor | None" = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (one launch, after a memset of its state)."""
    n = mask.shape[0]
    dev = mask.device
    _build.require(mask, "compact mask", torch.bool, (n,), dev)
    if values is not None:
        _build.require(values, "compact values", torch.int32, (n,), dev)
    items = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    fn = _build.function("compact", "compact_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(mask.data_ptr(),
                 None if values is None else values.data_ptr(), n, capacity,
                 sentinel, items.data_ptr(), count.data_ptr(),
                 scratch(n, dev).data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "compact")
    _build.KERNEL_LAUNCHES["compact"] += 1
    return items, count
