"""steps: device milliseconds a coloring in device operations that are
neither the port's own CUDA kernels nor copies to the host: PyTorch's ops
of ``core/ipgc.py`` (the hub side-channel among them) with their
device-side copies and fills, from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1e3 * t.other_s / t.colorings
