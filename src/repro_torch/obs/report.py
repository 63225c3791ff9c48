"""Byte accounting of the distributed Pipe (from ``repro/obs/report.py``;
the rest of ``RunReport`` is not ported yet, ROADMAP Queue A item 7)."""
from __future__ import annotations


def dense_exchange_bytes(n_global: int) -> int:
    """Per-shard bytes of ONE ``color_psum``: the summed delta is an
    ``int32[n_global + 1]`` (the +1 is the gather-sentinel slot),
    independent of the edge count."""
    return 4 * (n_global + 1)
