"""device: share of the traced colorings' window in which no device
operation runs, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
