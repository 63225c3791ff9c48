"""Byte rule of ``compact::scan_kernel`` (``csrc/compact.cuh``), called
through ``ops.compact``: the ordered compaction behind the worklist.

What the flags need, each byte once: each real flag is read (1 byte; with
``values``, a flag over a ``sentinel`` value is padding and counts
nothing); each emitted entry is written (4) and, with ``values``, its
value read (4); the count is written (4). The sentinel padding of the
output counts nothing.
"""

ENTRY = "repro_torch.kernels.ops:compact"


def bytes_of(call, out) -> int:
    a = call.args
    mask, values = a["mask"], a["values"]
    capacity = mask.shape[0] if a["capacity"] is None else a["capacity"]
    sentinel = mask.shape[0] if a["sentinel"] is None else a["sentinel"]
    emitted = min(int(out[1]), capacity)
    if values is None:
        return mask.shape[0] + 4 * emitted + 4
    real = int((values != sentinel).sum())
    return real + 8 * emitted + 4
