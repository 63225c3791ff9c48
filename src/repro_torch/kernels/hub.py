"""The hub side-channel of the ELL steps (``csrc/hub.cu``).

A hub (a row of degree > K) keeps the neighbours past its ELL row in the
COO tail: ``tail_src``, ``tail_dst``, ``tail_valid`` (padding entries are
invalid), its slot in the hub tables ``hub_slot[tail_src]`` (where an entry
is valid, ``hub_slot[tail_src] == tail_slot``). Two tables per iteration:

* ``hub_forbidden``: the (n_hub+1, W) forbidden table, True at
  ``[slot, c - base[src]]`` for each valid entry whose destination's color
  ``c >= 0`` falls in its source's window;
* ``hub_lose``: the (n_hub+1,) lose flags, True at the slot of each valid
  entry whose source holds a color >= 0 that its destination shares with a
  higher (priority, id).

Row ``n_hub`` (where non-hub rows read) stays False. Each entry is first
gated by its source (``gate[tail_src]``): an entry whose gate is off adds
nothing. The gate of ``hub_lose`` is the newly-colored or pending flags
that the reference's predicate already carries, so its table is the
reference's (``repro/core/ipgc.py::_hub_lose``). The gate of
``hub_forbidden`` is the caller's active rows: its table equals the
reference's ``_hub_forbidden`` on every row whose gate is on, and is False
elsewhere, so a caller passes a superset of the rows that read the table.

``visited``: None or an int64[1] counter on the tables' device, to which
the call adds the entries its gate let through (the ``ipgc.hub`` span's
``visited``, ``obs/trace.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_segment import flags_at

#: widest window the CUDA kernel takes (the row kernels' limit too)
MAX_WINDOW = 256


def _slots(hub_slot, tail_src, n_hub: int):
    """The entries' hub slots and whether each is a real one (< n_hub)."""
    slot = hub_slot[tail_src]
    return slot, (slot >= 0) & (slot < n_hub)


def hub_forbidden_plain(tail_src, tail_dst, tail_valid, hub_slot, colors,
                        base, gate, window: int, n_hub: int,
                        visited=None) -> torch.Tensor:
    """Plain twin of ``hub_forbidden_kernel``: the reference's scatter with
    the gate."""
    on = gate[tail_src]
    if visited is not None:
        visited += on.sum()
    tc = colors[tail_dst]               # PAD_COLOR for padded entries
    rel = tc - base[tail_src]
    slot, real = _slots(hub_slot, tail_src, n_hub)
    ok = on & tail_valid & real & (tc >= 0) & (rel >= 0) & (rel < window)
    flat = torch.where(ok, slot.to(torch.int64) * window + rel,
                       (n_hub + 1) * window)
    return flags_at((n_hub + 1) * window + 1, flat)[:-1].view(n_hub + 1,
                                                              window)


def hub_lose_plain(tail_src, tail_dst, tail_valid, hub_slot, colors,
                   priority, flags, n_hub: int, visited=None
                   ) -> torch.Tensor:
    """Plain twin of ``hub_lose_kernel``: the reference's scatter, gated by
    ``flags`` (which its predicate holds)."""
    on = flags[tail_src]
    if visited is not None:
        visited += on.sum()
    cu = colors[tail_src]
    cv = colors[tail_dst]
    pu = priority[tail_src]
    pv = priority[tail_dst]
    slot, real = _slots(hub_slot, tail_src, n_hub)
    lose = (on & tail_valid & real & (cu >= 0) & (cu == cv)
            & ((pv > pu) | ((pv == pu) & (tail_dst > tail_src))))
    return flags_at(n_hub + 2, torch.where(lose, slot, n_hub + 1))[:n_hub + 1]


def _require_tail(what, tail_src, tail_dst, tail_valid, hub_slot, gate,
                  visited, dev) -> tuple[int, int]:
    """Check the operands the two kernels share (the tail arrays also for
    alignment: a whole allocation is); returns (T, N)."""
    t = tail_src.shape[0]
    n = hub_slot.shape[0]
    _build.require(tail_src, f"{what} tail_src", torch.int32, (t,), dev)
    _build.require(tail_dst, f"{what} tail_dst", torch.int32, (t,), dev)
    _build.require(tail_valid, f"{what} tail_valid", torch.bool, (t,), dev)
    _build.require(hub_slot, f"{what} hub_slot", torch.int32, (n,), dev)
    _build.require(gate, f"{what} gate", torch.bool, (n,), dev)
    if visited is not None:
        _build.require(visited, f"{what} visited", torch.int64, (1,), dev)
    # the kernels load 4 entries at once: 16 bytes of ids, 4 of flags
    for arr, name, align in ((tail_src, "tail_src", 16),
                             (tail_dst, "tail_dst", 16),
                             (tail_valid, "tail_valid", 4)):
        if arr.data_ptr() % align:
            raise ValueError(f"{what} {name}: expected a {align}-byte "
                             "aligned tensor")
    return t, n


def _ptr(t):
    return None if t is None else t.data_ptr()


_FORB_ARGTYPES = ((ctypes.c_void_p,) * 7
                  + (ctypes.c_int, ctypes.c_int64, ctypes.c_int)
                  + (ctypes.c_void_p,) * 3)
_LOSE_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int64, ctypes.c_int)
                  + (ctypes.c_void_p,) * 3)


def hub_forbidden_cuda(tail_src, tail_dst, tail_valid, hub_slot, colors,
                       base, gate, window: int, n_hub: int,
                       visited=None) -> torch.Tensor:
    """Zero the table and launch ``hub_forbidden_kernel`` into it (one
    memset and one launch; no launch for an empty tail)."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"hub_forbidden: the CUDA kernel takes windows of "
                         f"1..{MAX_WINDOW} colors, got {window}")
    dev = colors.device
    t, n = _require_tail("hub_forbidden", tail_src, tail_dst, tail_valid,
                         hub_slot, gate, visited, dev)
    _build.require(colors, "hub_forbidden colors", torch.int32, (n + 1,),
                   dev)
    _build.require(base, "hub_forbidden base", torch.int32, (n,), dev)
    out = torch.empty((n_hub + 1, window), dtype=torch.bool, device=dev)
    fn = _build.function("hub", "hub_forbidden_launch", _FORB_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(tail_src.data_ptr(), tail_dst.data_ptr(),
                 tail_valid.data_ptr(), hub_slot.data_ptr(),
                 colors.data_ptr(), base.data_ptr(), gate.data_ptr(), window,
                 t, n_hub, out.data_ptr(), _ptr(visited),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hub_forbidden")
    _build.KERNEL_LAUNCHES["hub"] += int(t > 0)
    return out


def hub_lose_cuda(tail_src, tail_dst, tail_valid, hub_slot, colors,
                  priority, flags, n_hub: int, visited=None) -> torch.Tensor:
    """Zero the flags and launch ``hub_lose_kernel`` into them (one memset
    and one launch; no launch for an empty tail)."""
    dev = colors.device
    t, n = _require_tail("hub_lose", tail_src, tail_dst, tail_valid,
                         hub_slot, flags, visited, dev)
    _build.require(colors, "hub_lose colors", torch.int32, (n + 1,), dev)
    _build.require(priority, "hub_lose priority", torch.int32, (n + 1,),
                   dev)
    out = torch.empty(n_hub + 1, dtype=torch.bool, device=dev)
    fn = _build.function("hub", "hub_lose_launch", _LOSE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(tail_src.data_ptr(), tail_dst.data_ptr(),
                 tail_valid.data_ptr(), hub_slot.data_ptr(),
                 colors.data_ptr(), priority.data_ptr(), flags.data_ptr(), t,
                 n_hub, out.data_ptr(), _ptr(visited),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hub_lose")
    _build.KERNEL_LAUNCHES["hub"] += int(t > 0)
    return out
