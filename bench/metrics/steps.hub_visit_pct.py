"""steps: the share of the COO tail's entries that the hub side-channel's
gates let through, in percent: 100 x the ``visited`` over the ``entries``
of the profiled coloring's ``ipgc.hub`` spans (``ColoringResult.spans``;
``visited`` is a device counter the ``hub_forbidden`` and ``hub_lose``
kernels add to, ``entries`` the tail's length). None where the coloring
has no such spans or they carry no counter (a program without the gated
kernels)."""


def read(ctx):
    tr = getattr(ctx.results[0], "spans", None) if ctx.results else None
    if tr is None:
        return None
    spans = tr.find("ipgc.hub")
    entries = sum(sp.attrs.get("entries", 0) for sp in spans)
    visited = [sp.attrs.get("visited") for sp in spans]
    if not spans or entries <= 0 or None in visited:
        return None
    return 100.0 * sum(visited) / entries
