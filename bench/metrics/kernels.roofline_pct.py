"""kernels: the bytes that the port's kernels' calls need (``bench/kernels``
rules, from the rows each call was handed) over their device time at the
card's memory bandwidth (``bench/peaks.json``), in percent."""


def read(ctx):
    t = ctx.trace
    if (t is None or t.kernel_s <= 0 or not ctx.kernel_bytes
            or ctx.hbm_bytes_per_s is None):
        return None
    seconds = t.kernel_s / t.colorings
    return 100.0 * ctx.kernel_bytes / (seconds * ctx.hbm_bytes_per_s)
