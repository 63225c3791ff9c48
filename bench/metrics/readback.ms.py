"""readback: device milliseconds a coloring in copies from the device to
the host: the colors that ``Session.run`` hands back
(``ColoringResult.colors``) and the Pipe's reads of the worklist count,
from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.readback_s <= 0:
        return None
    return 1e3 * t.readback_s / t.colorings
