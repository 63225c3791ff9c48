"""Scoped counter groups (the ``CounterGroup`` of ``repro/obs/metrics.py``).

The engine counts what it launches and gathers in named counter families:
``core.ipgc.LAUNCH_COUNTS`` (logical passes per step),
``core.ipgc.GATHER_COUNTS`` (neighbour-color gathers per step) and
``kernels.ops.KERNEL_LAUNCHES`` (CUDA kernel launches per wrapper). The
port runs eagerly, so every counter moves when the code runs, not when it
is traced.
"""
from __future__ import annotations

import contextlib


class CounterGroup:
    """A named family of integer counters with a fixed key set.

    Supports ``group[k] += 1``, ``dict(group)``-style reads through
    ``as_dict``, ``in`` and iteration. ``scope()`` zeroes every counter
    for the duration of a block and restores the outer values on exit,
    so one measurement can never leak into another. Scopes nest.
    """

    def __init__(self, name: str, keys):
        self.name = name
        self._v = dict.fromkeys(keys, 0)

    def __getitem__(self, k):
        return self._v[k]

    def __setitem__(self, k, v) -> None:
        if k not in self._v:
            raise KeyError(
                f"unknown counter {k!r} in group {self.name!r}; "
                f"schema: {tuple(self._v)}")
        self._v[k] = v

    def __contains__(self, k) -> bool:
        return k in self._v

    def __iter__(self):
        return iter(self._v)

    def __len__(self) -> int:
        return len(self._v)

    def items(self):
        return self._v.items()

    def __repr__(self) -> str:
        return f"CounterGroup({self.name!r}, {self._v})"

    def as_dict(self) -> dict:
        return dict(self._v)

    def reset(self) -> None:
        for k in self._v:
            self._v[k] = 0

    @contextlib.contextmanager
    def scope(self):
        """Zero the group for the block; restore outer values on exit."""
        saved = dict(self._v)
        self.reset()
        try:
            yield self
        finally:
            self._v.update(saved)
