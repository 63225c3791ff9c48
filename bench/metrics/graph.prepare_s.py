"""prepare: seconds of ``Session._prepare`` (``core/ipgc.py::prepare``, host
to device), by the harness's clock, synchronised."""


def read(ctx):
    return ctx.setup["prepare_s"]
