"""Byte rule of ``hub_lose_kernel`` (``csrc/hub.cu``), called through
``ops.hub_lose``: the hub lose flags of a step, one pass over the COO tail
gated by each entry's source (its newly-colored or pending flag).

What the tail handed needs, each byte once: every entry's source id (4);
the flag of each distinct source (1). An entry whose flag is on reads its
destination and valid flag (5); each distinct source whose flag is on
reads its color, priority and hub slot (12) and, where it is a hub, has
its lose flag written (1). A valid entry whose source holds a color reads
its destination's color (4), and its destination's priority only where
the two colors are equal (4). Nothing the flags skip counts.
"""
from pathlib import Path

from bench.catalog import load_module

#: the forbidden rule, whose entry and distinct sources this rule shares
_FORBIDDEN = load_module(Path(__file__).with_name("hub_forbidden_kernel.py"),
                        "kernels")
ENTRY = _FORBIDDEN.entry("hub_lose")
distinct_sources = _FORBIDDEN.distinct_sources


def bytes_of(call, out) -> int:
    a = call.args
    src, dst, valid, flags = (a["tail_src"], a["tail_dst"], a["tail_valid"],
                              a["flags"])
    colors = a["colors"]
    sources = distinct_sources(call, src)
    on = flags[src]
    n = 4 * src.numel() + sources.numel() + 5 * int(on.sum())
    live = sources[flags[sources]]
    n += 12 * live.numel() + int((a["hub_slot"][live] < a["n_hub"]).sum())
    cu = colors[src]
    read = on & valid & (cu >= 0)
    n += 4 * int(read.sum())
    n += 4 * int((read & (colors[dst] == cu)).sum())
    return n
