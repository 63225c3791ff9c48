"""Per-row extrema of JPL neighbour priorities (``csrc/jpl_prio.cu``).

For each row, the max of its neighbours' priorities and the min of those
>= 0 (``LARGE`` when there is none). The oracle is
``repro.kernels.ref.jpl_extrema_ref``, which takes the priorities
pre-gathered as an (R, K) tile whose inactive entries are -1
(``jpl_extrema_plain``, the Pallas signature). The kernel gathers them
itself from the graph's ELL tile and the rows to update, reading each
neighbour ``v``'s priority from one of two sources
(``jpl_extrema_rows_plain`` is its plain twin):

- ``Table(prio)``: ``prio[v]``, an int32[N+1] table (the dense round's
  priorities, -1 where a node is not pending);
- ``Hash(colors, rnd)``: ``round_hash(v, rnd)`` where ``colors[v]`` is
  ``NO_COLOR``, else -1 (the sparse and distributed rounds: neighbour
  activity read from the colors). ``rnd`` is a 0-d int32 round that the
  kernel reads on the device.

A row with no real neighbour (a row >= Rg, or one whose first ELL entry is
the pad id) gives max -1 and min ``LARGE``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.graphs.csr import NO_COLOR
from repro_torch.kernels import _build
from repro_torch.kernels.conflict import gather_rows

#: the masked min of a row with no active entry
LARGE = 0x7FFFFFFF
_M32 = 0xFFFFFFFF


class Table(NamedTuple):
    """Neighbour priorities read from an int32[N+1] table."""

    prio: torch.Tensor


class Hash(NamedTuple):
    """Neighbour priorities hashed from the id and a 0-d int32 round where
    the neighbour is uncolored, -1 elsewhere."""

    colors: torch.Tensor
    rnd: torch.Tensor


def _mul32_(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` in place, for int64 ``x`` in [0, 2**32): the
    constant is split in 16-bit halves so no product reaches 2**48."""
    hi = x * (c >> 16)
    hi &= 0xFFFF
    hi <<= 16
    x.mul_(c & 0xFFFF).add_(hi).bitwise_and_(_M32)
    return x


def round_hash(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-round priority: the reference's uint32 splitmix-ish mixer of
    (id, round), as a nonnegative int32. Computed in int64 and masked to
    32 bits (PyTorch has no uint32 shift on the CPU); in place on one
    int64 copy of ``x``, so a call holds two int64 temporaries of its
    size at most. ``csrc/jpl_prio.cu`` computes the same bits in uint32."""
    seed = _mul32_((r.to(torch.int64) + 1) & _M32, 0x9E3779B9)
    h = x.to(torch.int64)                  # the one full-size copy
    h.add_(seed).bitwise_and_(_M32)
    h.bitwise_xor_(h >> 16)
    _mul32_(h, 0x85EBCA6B)
    h.bitwise_xor_(h >> 13)
    _mul32_(h, 0xC2B2AE35)
    h.bitwise_xor_(h >> 16)
    return (h >> 1).to(torch.int32)


def jpl_extrema_plain(npr: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version over a pre-gathered (R, K) tile
    (``algos/jpl._extrema`` of the reference)."""
    return npr.amax(1), torch.where(npr >= 0, npr, LARGE).amin(1)


def _vector(source) -> torch.Tensor:
    """The source's int32[N+1] vector (slot N the pad id's)."""
    if isinstance(source, Table):
        return source.prio
    if isinstance(source, Hash):
        return source.colors
    raise TypeError(f"jpl_extrema: the source is a Table or a Hash, got "
                    f"{type(source).__name__}")


def jpl_extrema_rows_plain(ell_idx, rows, source
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the kernel: gather the neighbour ids, read or hash
    their priorities, then ``jpl_extrema_plain``. Every row gets one more
    padding lane and padding reads -1, so a row without a real neighbour
    has max -1 and min ``LARGE``, as on the card."""
    pad = _vector(source).shape[0] - 1
    nbr, _ = gather_rows(ell_idx, rows, pad)
    nbr = torch.cat([nbr, nbr.new_full((nbr.shape[0], 1), pad)], dim=1)
    if isinstance(source, Table):
        npr = source.prio[nbr]
    else:
        npr = torch.where(source.colors[nbr] == int(NO_COLOR),
                          round_hash(nbr, source.rnd), -1)
    return jpl_extrema_plain(torch.where(nbr == pad, -1, npr))


_ARGTYPES = ((ctypes.c_void_p,) * 6
             + (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def jpl_extrema_cuda(ell_idx, rows, source, tile_rows: "int | None" = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (one launch; none for zero rows;
    ``tile_rows`` rows a block, None the default block)."""
    tile = _build.tile_arg(tile_rows, "jpl_extrema")
    vec = _vector(source)
    dev = vec.device
    n1 = vec.shape[0]
    rg, k = ell_idx.shape
    _build.require(ell_idx, "jpl_extrema ell_idx", torch.int32, (rg, k), dev)
    r = rg
    if rows is not None:
        r = rows.shape[0]
        _build.require(rows, "jpl_extrema rows", torch.int32, (r,), dev)
    hashed = isinstance(source, Hash)
    _build.require(vec, "jpl_extrema " + ("colors" if hashed else "prio"),
                   torch.int32, (n1,), dev)
    if hashed:
        _build.require(source.rnd, "jpl_extrema rnd", torch.int32, (), dev)
    out_max = torch.empty(r, dtype=torch.int32, device=dev)
    out_min = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return out_max, out_min
    fn = _build.function("jpl_prio", "jpl_extrema_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(ell_idx.data_ptr(), None if rows is None else rows.data_ptr(),
                 vec.data_ptr(), source.rnd.data_ptr() if hashed else None,
                 out_max.data_ptr(), out_min.data_ptr(), r, rg, k, n1 - 1,
                 int(NO_COLOR), tile,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "jpl_extrema")
    _build.KERNEL_LAUNCHES["jpl_prio"] += 1
    return out_max, out_min
