"""Pipe: iterations of a profiled coloring (``ColoringResult.iterations``)."""


def read(ctx):
    return ctx.results[0].iterations if ctx.results else None
