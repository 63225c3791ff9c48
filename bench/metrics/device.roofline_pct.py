"""device: the bytes that the algorithm's iterations need (the plain
reference's count over its own worklists) over the colorings' device span
at the card's memory bandwidth, in percent. The count does not depend on
how the program does the work."""


def read(ctx):
    t = ctx.trace
    if (t is None or t.span_s <= 0 or not ctx.reference_bytes
            or ctx.hbm_bytes_per_s is None):
        return None
    seconds = t.span_s / t.colorings
    return 100.0 * ctx.reference_bytes / (seconds * ctx.hbm_bytes_per_s)
