"""Pipe: device milliseconds a coloring between the end of an iteration's
step work and the start of the next iteration: from the device start of
an iteration's ``session.count`` span (the host loop's read of the
worklist count, ``exec/session.py``) to the device start of the next
``session.iter`` span, summed over the profiled coloring's iterations
(``ColoringResult.spans``). It is the device's wait on the host loop: the
count's copy, the host's wake-up and its Python up to the next launch. A
span's device time is the device's wall time between CUDA events, idle
included, not a sum of operation durations. None where the coloring has
no such spans or they carry no device times (the CPU, or a program
without device-timed spans)."""


def read(ctx):
    tr = getattr(ctx.results[0], "spans", None) if ctx.results else None
    if tr is None:
        return None
    iters = tr.find("session.iter")
    counts = [next((c for c in it.children if c.name == "session.count"),
                   None) for it in iters]
    if not iters or any(c is None or c.device_start is None
                        for c in counts) \
            or any(it.device_start is None for it in iters):
        return None
    return 1e3 * sum(nxt.device_start - c.device_start
                     for c, nxt in zip(counts, iters[1:]))
