"""Byte rule of ``hub_forbidden_kernel`` (``csrc/hub.cu``), called through
``ops.hub_forbidden``: the hub forbidden table of a step, one pass over
the COO tail gated by each entry's source.

What the tail handed needs, each byte once: every entry's source id (4);
the gate flag of each distinct source (1). An entry whose gate is on reads
its destination and valid flag (5) and, where valid, its destination's
color (4); each distinct source whose gate is on reads its window base and
hub slot (4 + 4) and, where it is a hub, has its table row written (one
byte a color of the window). Nothing the gate skips counts.
"""


def entry(fn: str) -> str:
    """``ops.<fn>``; in a program without the hub kernels (whose traced
    runs read these rules too) ``ops.frontier_probe``, which no coloring
    calls, so that the rule counts nothing there."""
    from repro_torch.kernels import ops

    return ("repro_torch.kernels.ops:"
            + (fn if hasattr(ops, fn) else "frontier_probe"))


ENTRY = entry("hub_forbidden")


def distinct_sources(call, tail_src):
    """The distinct sources of the tail, cached per tail array (the lose
    rule's too)."""
    import torch

    key = ("hub_sources", tail_src.data_ptr(), tuple(tail_src.shape))
    got = call._rec.entries.get(key)
    if got is None:
        got = torch.unique(tail_src).long()
        call._rec.entries[key] = got
    return got


def bytes_of(call, out) -> int:
    a = call.args
    src, valid, gate = a["tail_src"], a["tail_valid"], a["gate"]
    sources = distinct_sources(call, src)
    on = gate[src]
    n = 4 * src.numel() + sources.numel()
    n += 5 * int(on.sum()) + 4 * int((on & valid).sum())
    live = sources[gate[sources]]
    n += 8 * live.numel()
    n += a["window"] * int((a["hub_slot"][live] < a["n_hub"]).sum())
    return n
