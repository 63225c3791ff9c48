"""Byte rule of ``conflict_kernel`` (``csrc/conflict.cu``), called
through ``ops.conflict``: the resolve of the two-phase step.

What the rows handed need, each byte once: every graph row handed reads
its newly-colored flag and writes its lose flag (1 + 1 bytes), and its row
id where the call names rows (4). A newly colored row reads its color,
priority and id (12), each real ELL entry (4) and that neighbour's color
(4), and the neighbour's priority only where the two colors are equal (4).
Padding rows and entries count nothing.
"""

ENTRY = "repro_torch.kernels.ops:conflict"


def bytes_of(call, out) -> int:
    a = call.args
    colors, ell, rows, cu, newly = (a["colors"], a["ell_idx"], a["rows"],
                                    a["cu"], a["newly"])
    pad = colors.shape[0] - 1
    idx, ok = call.handed(ell, rows)
    sel = newly if ok is None else newly[ok]
    live = idx[sel]
    own = (cu if ok is None else cu[ok])[sel]
    n = (2 + (4 if rows is not None else 0)) * idx.numel()
    n += 12 * live.numel()
    n += 8 * int(call.row_entries(ell, pad)[live].sum())
    n += 4 * call.same_color_neighbours(ell, live, colors, own, pad)
    return n
