"""Pipe: share of a profiled coloring's iterations that ran the sparse,
data-driven step (``S`` in ``ColoringResult.mode_trace``)."""


def read(ctx):
    if not ctx.results or not ctx.results[0].mode_trace:
        return None
    trace = ctx.results[0].mode_trace
    return 100.0 * trace.count("S") / len(trace)
