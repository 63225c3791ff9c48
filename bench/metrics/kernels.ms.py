"""kernels: device milliseconds a coloring in the port's CUDA kernels
(``kernels/csrc/*.cu``), from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.kernel_s <= 0:
        return None
    return 1e3 * t.kernel_s / t.colorings
