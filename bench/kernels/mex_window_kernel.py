"""Byte rule of ``mex_window_kernel`` (``csrc/mex_window.cu``), called
through ``ops.mex_window``: the windowed mex of the two-phase assign.

What the rows handed need, each byte once: every graph row handed reads
its active flag and writes its first free index (4 bytes), and its row id
where the call names rows (4). An active row reads its window base (4),
each real ELL entry (4) and that neighbour's color (4); on a graph with
hubs its hub slot (4) and, for a hub row, its row of the forbidden table
(one byte a color of the window). Padding rows and entries count nothing.
"""

ENTRY = "repro_torch.kernels.ops:mex_window"


def bytes_of(call, out) -> int:
    a = call.args
    colors, ell, rows, active = (a["colors"], a["ell_idx"], a["rows"],
                                 a["active"])
    pad = colors.shape[0] - 1
    idx, ok = call.handed(ell, rows)
    live = idx[active if ok is None else active[ok]]
    n = (5 + (4 if rows is not None else 0)) * idx.numel()
    n += 4 * live.numel()
    n += 8 * int(call.row_entries(ell, pad)[live].sum())
    if a["hub_forb"] is not None:
        n_hub = a["hub_forb"].shape[0] - 1
        n += 4 * live.numel()
        n += a["window"] * int((a["hub_slot"][live] < n_hub).sum())
    return n
