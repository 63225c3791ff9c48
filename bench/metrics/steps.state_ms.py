"""steps: device milliseconds a coloring inside the program's
``ipgc.state`` spans (the steps' O(N) state rewrites in ``core/ipgc.py``:
``_set_rows``/``_set_rows_drop`` of colors, base and mask, and the padding
fills), read from the profiled coloring's spans (``ColoringResult.spans``).
A span's device time is the device's wall time between its two CUDA
events, idle included, so this is not a sum of operation durations as
``steps.aten_ms`` is. None where the coloring has no such spans or they
carry no device times (the CPU, or a program without device-timed
spans)."""


def read(ctx):
    tr = getattr(ctx.results[0], "spans", None) if ctx.results else None
    if tr is None:
        return None
    times = [sp.device_seconds for sp in tr.find("ipgc.state")]
    if not times or None in times:
        return None
    return 1e3 * sum(times)
